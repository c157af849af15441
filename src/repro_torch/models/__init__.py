"""The paper's CNNs in PyTorch (port of ``repro.models``, CNN part)."""
