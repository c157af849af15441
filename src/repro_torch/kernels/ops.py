"""Public kernel primitives with their STE backward (port of the conv
half of ``repro.kernels.ops``) — what the 'pallas' engines call.

The matmul primitives (``trunk_matmul_pallas``, ``rebranch_matmul``,
``cim_matmul``) need the ``_cim_kernel`` / ``_rebranch_kernel`` ports and
wait for the LM slice (ROADMAP Queue 2).
"""

from __future__ import annotations

import torch

from repro_torch.core import cim as cim_lib
from repro_torch.core.rebranch import trunk_conv_ste_bwd
from repro_torch.kernels import rebranch_conv as rc


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
    ``core.rebranch.trunk_conv``); quantisation per (patch row, k-block)
    inside the kernel."""
    return _TrunkConv.apply(x, w_q, w_scale, cfg, stride, padding)


def rebranch_conv(x, w_q, w_scale, c, core, u, stride: int = 1,
                  padding: str = "SAME",
                  cfg: cim_lib.CiMConfig = rc.IDEAL):
    """Fused trunk+branch ReBranch conv forward (inference only)."""
    return rc.rebranch_conv(x, w_q, w_scale, c, core, u, cfg,
                            stride=stride, padding=padding)
