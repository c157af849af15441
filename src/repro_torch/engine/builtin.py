"""The stock TrunkEngines, registered at import (port of
``repro.engine.builtin``).  The names are the JAX package's, so a plan
means the same thing in both packages.

int8_native : the core macro model on int8 operands (all fidelity modes).
dequant     : dequantised float trunk on fake-quantised activations.
pallas      : the trunk conv on the hand-written CUDA kernel
              (``kernels/csrc/trunk_conv.cu``; the plain PyTorch version
              on a CPU tensor).
pallas_fused: 'pallas' plus the fused trunk+branch conv on the shared
              patch matrix (inference only).

The 'pallas' matmuls need the ``_cim_kernel`` / ``_rebranch_kernel``
ports, which wait for the LM slice.
"""

from __future__ import annotations

from repro_torch.core import rebranch as rebranch_lib
from repro_torch.engine import base
from repro_torch.engine.registry import register
from repro_torch.kernels import ops as kops

_MATMUL_TODO = ("the 'pallas' matmul kernels (_cim_kernel, _rebranch_kernel) "
                "are not ported yet: ROADMAP Queue 2 items 3 and 4")


class Int8NativeEngine(base.TrunkEngine):
    name = "int8_native"
    capabilities = base.EngineCapabilities(
        fidelity_modes=("ideal", "per_subarray", "bitserial"), epilogue=True)

    def matmul(self, cfg, x, w_q, w_scale):
        return rebranch_lib.trunk_matmul(cfg, x, w_q, w_scale)

    def conv(self, cfg, x, w_q, w_scale, *, stride=1, padding="SAME",
             epilogue=None):
        y = rebranch_lib.trunk_conv(cfg, stride, padding, x, w_q, w_scale)
        return base.finish(y, epilogue)


class DequantEngine(base.TrunkEngine):
    name = "dequant"
    capabilities = base.EngineCapabilities(fidelity_modes=None,
                                           epilogue=True)

    def matmul(self, cfg, x, w_q, w_scale):
        return rebranch_lib.trunk_matmul_dequant(cfg, x, w_q, w_scale)

    def conv(self, cfg, x, w_q, w_scale, *, stride=1, padding="SAME",
             epilogue=None):
        y = rebranch_lib.trunk_conv_dequant(cfg, stride, padding,
                                            x, w_q, w_scale)
        return base.finish(y, epilogue)


class PallasEngine(base.TrunkEngine):
    """Trunk conv on the CUDA kernel (ideal mode on the card; every mode
    through the plain version on the CPU)."""

    name = "pallas"
    capabilities = base.EngineCapabilities(
        fidelity_modes=("ideal", "per_subarray", "bitserial"), epilogue=True)

    def matmul(self, cfg, x, w_q, w_scale):
        raise NotImplementedError(_MATMUL_TODO)

    def conv(self, cfg, x, w_q, w_scale, *, stride=1, padding="SAME",
             epilogue=None):
        y = kops.trunk_conv(cfg, stride, padding, x, w_q, w_scale)
        return base.finish(y, epilogue)


class PallasFusedEngine(PallasEngine):
    """'pallas' plus the fused trunk+branch conv: live-branch sites run
    trunk kernel AND compress sketch on one patch matrix.  Inference
    only (``grads=False``)."""

    name = "pallas_fused"
    capabilities = base.EngineCapabilities(
        fidelity_modes=("ideal", "per_subarray", "bitserial"), grads=False,
        epilogue=True, fused_ops=("conv", "matmul"))

    def fused_matmul(self, cfg, x, w_q, w_scale, c, core, u):
        raise NotImplementedError(_MATMUL_TODO)

    def fused_conv(self, cfg, x, w_q, w_scale, c, core, u, *, stride=1,
                   padding="SAME", epilogue=None):
        y = kops.rebranch_conv(x, w_q, w_scale, c, core, u, stride=stride,
                               padding=padding, cfg=cfg)
        return base.finish(y, epilogue)


register("int8_native", Int8NativeEngine())
register("dequant", DequantEngine())
register("pallas", PallasEngine())
register("pallas_fused", PallasFusedEngine())
