"""Plain PyTorch oracles for the kernels (port of ``repro.kernels.ref``).

Each has the kernels' numerics (quantisation granularity, ADC model,
blocking where it affects results) written as directly as possible.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import cim as cim_lib
from repro_torch.core.quant import quant_rows
from repro_torch.core.rebranch import conv_nhwc
from repro_torch.kernels import tiling


def cim_matmul_ref(x_q, w_q, cfg: cim_lib.CiMConfig):
    """Oracle of the CiM matmul kernel: the core macro model."""
    return cim_lib.cim_matmul_model(x_q, w_q, cfg)


def rebranch_matmul_ref(x, w_q, w_scale, c, core, u,
                        cfg: cim_lib.CiMConfig = cim_lib.CiMConfig(
                            mode="ideal")):
    """Oracle of the fused ReBranch matmul: the blocked-quant trunk through
    the core macro model, plus the UNblocked branch ``((x @ C) @ core) @
    U``."""
    acc = _blocked_cim_trunk(x.float(), w_q, cfg)
    trunk = acc * w_scale.reshape(1, -1).float()
    t1 = x.float() @ c.float()
    branch = (t1 @ core.float()) @ u.float()
    return (trunk + branch).to(x.dtype)


def cim_conv_ref(x_q, w_q, cfg: cim_lib.CiMConfig, stride: int = 1,
                 padding: str = "SAME"):
    """Oracle of the int8 conv: im2col through the core macro model."""
    return cim_lib.cim_conv_model(x_q, w_q, cfg, stride, padding)


def _blocked_cim_trunk(p, w_mat, cfg: cim_lib.CiMConfig):
    """Patch matmul with the fused kernels' numerics: per-(row, k-block)
    reciprocal-form quantisation, macro math per block, per-block scale,
    accumulated in ascending k-block order."""
    m, r = p.shape
    bk = tiling.block_k(r, cfg.rows_per_subarray)
    pad = (-r) % bk
    pp = F.pad(p, (0, pad))
    wp = F.pad(w_mat, (0, 0, 0, pad))
    acc = torch.zeros((m, w_mat.shape[1]), dtype=torch.float32,
                      device=p.device)
    for kb in range(pp.shape[1] // bk):
        x_q, scale = quant_rows(pp[:, kb * bk:(kb + 1) * bk].float())
        out = cim_lib.cim_matmul_model(x_q, wp[kb * bk:(kb + 1) * bk], cfg)
        acc = acc + out * scale
    return acc


def trunk_conv_ref(x, w_q, w_scale, cfg: cim_lib.CiMConfig, stride: int = 1,
                   padding: str = "SAME"):
    """Oracle of the float-in fused trunk conv."""
    kh, kw, c_in, c_out = w_q.shape
    patches, (oh, ow) = cim_lib.im2col(x, kh, kw, stride, padding)
    p = patches.reshape(-1, kh * kw * c_in)
    acc = _blocked_cim_trunk(p, w_q.reshape(-1, c_out), cfg)
    out = acc * w_scale.reshape(1, -1).float()
    return out.reshape(x.shape[0], oh, ow, c_out).to(x.dtype)


def rebranch_conv_ref(x, w_q, w_scale, c, core, u,
                      cfg: cim_lib.CiMConfig = cim_lib.CiMConfig(mode="ideal"),
                      stride: int = 1, padding: str = "SAME"):
    """Oracle of the fused ReBranch conv: blocked-quant trunk plus the
    UNfused branch (1x1 compress -> KxK core -> 1x1 decompress convs)."""
    trunk = trunk_conv_ref(x, w_q, w_scale, cfg, stride, padding)
    t = conv_nhwc(x.float(), c.float(), 1, padding)
    t = conv_nhwc(t, core.float(), stride, padding)
    branch = conv_nhwc(t, u.float(), 1, padding)
    return (trunk.float() + branch).to(x.dtype)
