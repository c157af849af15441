"""The stock TrunkEngines, registered at import (port of
``repro.engine.builtin``).  The names are the JAX package's, so a plan
means the same thing in both packages.

int8_native : the core macro model on int8 operands (all fidelity modes).
dequant     : dequantised float trunk on fake-quantised activations.
pallas      : the trunk conv and matmul on the hand-written CUDA kernels
              (``kernels/csrc/trunk_conv.cu``, ``cim_matmul.cu``) in all
              three fidelity modes (the plain PyTorch versions on a CPU
              tensor), under the tuning table's launch plans.
pallas_fused: 'pallas' plus the fused trunk+branch conv (the trunk
              kernel reads the NHWC input itself, the branch compresses
              it once per pixel: no patch matrix on the card) and the
              fused ReBranch matmul (``kernels/csrc/rebranch_matmul.cu``);
              inference only.
"""

from __future__ import annotations

from repro_torch.core import cim as cim_lib
from repro_torch.core import rebranch as rebranch_lib
from repro_torch.engine import base
from repro_torch.engine.registry import register
from repro_torch.kernels import ops as kops

class Int8NativeEngine(base.TrunkEngine):
    name = "int8_native"
    capabilities = base.EngineCapabilities(
        fidelity_modes=("ideal", "per_subarray", "bitserial"), epilogue=True)

    def matmul(self, cfg, x, w_q, w_scale):
        return rebranch_lib.trunk_matmul(cfg, x, w_q, w_scale)

    def matmul_partial(self, cfg, x_q, w_q):
        return cim_lib.cim_matmul_model(x_q, w_q, cfg)

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
    """Trunk conv and matmul on the CUDA kernels, in every fidelity mode
    (through the plain versions on a CPU tensor)."""

    name = "pallas"
    capabilities = base.EngineCapabilities(
        fidelity_modes=("ideal", "per_subarray", "bitserial"), epilogue=True,
        tune=True)

    def matmul(self, cfg, x, w_q, w_scale):
        return kops.trunk_matmul_pallas(cfg, x, w_q, w_scale)

    def matmul_partial(self, cfg, x_q, w_q):
        return kops.cim_matmul(x_q, w_q, cfg)

    def conv(self, cfg, x, w_q, w_scale, *, stride=1, padding="SAME",
             epilogue=None):
        y = kops.trunk_conv(cfg, stride, padding, x, w_q, w_scale)
        return base.finish(y, epilogue)


class PallasFusedEngine(PallasEngine):
    """'pallas' plus the fused trunk+branch conv and matmul: live-branch
    sites run the trunk kernel and the branch in one call (the conv's
    trunk kernel gathers its patches from the NHWC input, its branch
    compresses that input once per pixel; the matmul's kernel sketches x @
    C in the trunk's launch).  Inference only (``grads=False``)."""

    name = "pallas_fused"
    capabilities = base.EngineCapabilities(
        fidelity_modes=("ideal", "per_subarray", "bitserial"), grads=False,
        epilogue=True, tune=True, fused_ops=("conv", "matmul"))

    def fused_matmul(self, cfg, x, w_q, w_scale, c, core, u):
        lead = x.shape[:-1]         # the kernel is 2D: flatten [..., K]
        y = kops.rebranch_matmul(x.reshape(-1, x.shape[-1]), w_q, w_scale,
                                 c, core, u, cfg)
        return y.reshape(*lead, y.shape[-1])

    def fused_partial(self, cfg, x, w_q, c):
        return kops.rebranch_trunk_sketch(x, w_q, c, cfg)

    def fused_conv(self, cfg, x, w_q, w_scale, c, core, u, *, stride=1,
                   padding="SAME", epilogue=None):
        y = kops.rebranch_conv(x, w_q, w_scale, c, core, u, stride=stride,
                               padding=padding, cfg=cfg)
        return base.finish(y, epilogue)


register("int8_native", Int8NativeEngine())
register("dequant", DequantEngine())
register("pallas", PallasEngine())
register("pallas_fused", PallasFusedEngine())
