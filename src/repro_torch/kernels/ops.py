"""Public kernel primitives with their STE backward (port of
``repro.kernels.ops``) — what the 'pallas' engines call.
"""

from __future__ import annotations

import torch

from repro_torch.core import cim as cim_lib
from repro_torch.core import quant
from repro_torch.core.rebranch import trunk_conv_ste_bwd
from repro_torch.kernels import cim_matmul as cm
from repro_torch.kernels import rebranch_conv as rc
from repro_torch.kernels import rebranch_matmul as rm


def cim_matmul(x_q, w_q, cfg: cim_lib.CiMConfig = cim_lib.DEFAULT_CIM):
    """int8 x int8 CiM matmul on the CiM matmul kernel."""
    return cm.cim_matmul(x_q, w_q, cfg)


def cim_conv(x_q, w_q, cfg: cim_lib.CiMConfig = cim_lib.DEFAULT_CIM,
             stride: int = 1, padding: str = "SAME"):
    """int8 x int8 CiM convolution, NHWC x HWIO -> f32 [N, OH, OW, C_out]:
    the im2col patch matrix through the CiM matmul kernel (port of
    ``cim_conv_pallas``)."""
    kh, kw, c_in, c_out = w_q.shape
    p, (n, oh, ow) = rc.patch_matrix(x_q, kh, kw, stride, padding)
    out = cm.cim_matmul(p, w_q.reshape(kh * kw * c_in, c_out), cfg)
    return out.reshape(n, oh, ow, c_out)


class _TrunkMatmulPallas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_q, w_scale, cfg):
        x_q, sx = quant.quantize_activations(x)
        lead = x_q.shape[:-1]       # the kernel is 2D: [..., K] -> [M, K]
        out = cm.cim_matmul(x_q.reshape(-1, x_q.shape[-1]).contiguous(),
                            w_q, cfg)
        out = out.reshape(*lead, out.shape[-1])
        ctx.save_for_backward(w_q, w_scale)
        return (out * sx).to(x.dtype) * w_scale.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        w_q, w_scale = ctx.saved_tensors
        w_deq = w_q.to(g.dtype) * w_scale.to(g.dtype)
        return g @ w_deq.T, None, None, None


def trunk_matmul_pallas(cfg: cim_lib.CiMConfig, x, w_q, w_scale):
    """Frozen-trunk matmul on the CiM matmul kernel, STE backward (drop-in
    for ``core.rebranch.trunk_matmul``, the 'pallas' engine's matmul).
    Activations are quantised per row over the whole K (division form)
    before the kernel."""
    return _TrunkMatmulPallas.apply(x, w_q, w_scale, cfg)


def rebranch_trunk_sketch(x, w_q, c, cfg: cim_lib.CiMConfig = rm.IDEAL):
    """The fused ReBranch matmul kernel's (UNscaled trunk, t1 = x @ C)."""
    return rm.rebranch_trunk_sketch(x, w_q, c, cfg)


def rebranch_matmul(x, w_q, w_scale, c, core, u,
                    cfg: cim_lib.CiMConfig = rm.IDEAL):
    """Fused trunk+branch ReBranch layer forward (inference only)."""
    return rm.rebranch_matmul(x, w_q, w_scale, c, core, u, cfg)


class _TrunkConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_q, w_scale, cfg, stride, padding):
        ctx.save_for_backward(w_q, w_scale)
        ctx.geom = (stride, padding, x.shape)
        return rc.trunk_conv(x, w_q, w_scale, cfg, stride=stride,
                             padding=padding)

    @staticmethod
    def backward(ctx, g):
        stride, padding, x_shape = ctx.geom
        w_q, w_scale = ctx.saved_tensors
        dx = trunk_conv_ste_bwd(stride, padding, x_shape, w_q, w_scale, g)
        return dx, None, None, None, None, None


def trunk_conv(cfg: cim_lib.CiMConfig, stride: int, padding: str,
               x, w_q, w_scale):
    """Frozen-trunk conv on the trunk kernel, STE backward (drop-in for
    ``core.rebranch.trunk_conv``); the kernel reads the NHWC input through
    the im2col map and quantises per (patch row, k-block) inside."""
    return _TrunkConv.apply(x, w_q, w_scale, cfg, stride, padding)


def rebranch_conv(x, w_q, w_scale, c, core, u, stride: int = 1,
                  padding: str = "SAME",
                  cfg: cim_lib.CiMConfig = rc.IDEAL):
    """Fused trunk+branch ReBranch conv forward (inference only): the NHWC
    trunk kernel plus the branch compressed once per pixel, with no patch
    matrix on the card."""
    return rc.rebranch_conv(x, w_q, w_scale, c, core, u, cfg,
                            stride=stride, padding=padding)
