"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions
(port of ``repro.kernels``).  Sources live in ``csrc/``; ``_build``
compiles them with nvcc at first use.

The primitives the engines call are in ``kernels.ops``.  ``cim_conv`` is
exported here as ``repro.kernels`` exports it; ``cim_matmul``,
``rebranch_matmul`` and ``rebranch_conv`` stay the names of the
submodules that hold the kernels' wrappers.
"""

from repro_torch.kernels.ops import cim_conv

__all__ = ["cim_conv"]
