"""The paper's contribution in PyTorch: int8 quantisation, the ROM-CiM
macro model with its 5-bit ADC, and the ReBranch layers (port of
``repro.core``)."""
