"""PyTorch / CUDA port of the YOLoC ROM-CiM + ReBranch stack.

Mirrors the layout of the JAX package ``repro`` module for module
(``repro_torch.core.quant`` <-> ``repro.core.quant``, ...) and is held to
its numerics by the ``tests/test_torch_*.py`` parity tests.  The port
imports ``torch`` only; the Pallas TPU kernels on its path are replaced by
hand-written CUDA kernels for Hopper (``repro_torch/kernels/csrc``), each
beside a plain PyTorch version of the same function.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`).
"""
