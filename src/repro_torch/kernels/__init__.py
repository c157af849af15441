"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions
(port of ``repro.kernels``).  Sources live in ``csrc/``; ``_build``
compiles them with nvcc at first use."""
