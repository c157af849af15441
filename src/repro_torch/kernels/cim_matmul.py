"""The macro math of one block, ``cim_block_dot`` (port of
``repro.kernels.cim_matmul.cim_block_dot``).

The plain PyTorch version below runs all three fidelity modes; the CUDA
device routine of its ``ideal`` mode is ``csrc/cim_block_dot.cuh``, which
the trunk conv kernel (``csrc/trunk_conv.cu``) calls.  The
``per_subarray``/``bitserial`` device routines and the int8-in
``_cim_kernel`` launch (``cim_matmul_pallas``) are not ported yet
(ROADMAP Queue 2).
"""

from __future__ import annotations

import torch

from repro_torch.core import adc as adc_lib
from repro_torch.core import cim as cim_lib


def cim_block_dot(cfg: cim_lib.CiMConfig, x: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """Mode-dependent macro math for one block: int8 (bm, bk) x int8
    (bk, bn) -> f32 (bm, bn).  ``bk`` holds whole 128-row subarrays, so
    subarray boundaries align with global K offsets."""
    rows = cfg.rows_per_subarray
    if cfg.mode == "ideal":
        return cim_lib.int_dot(x, w)

    if cfg.mode == "per_subarray":
        acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                          device=x.device)
        for si in range(x.shape[1] // rows):
            xs = x[:, si * rows:(si + 1) * rows].float()
            ws = w[si * rows:(si + 1) * rows, :].float()
            acc = acc + adc_lib.signed_adc(xs @ ws, rows * 127.0, cfg)
        return acc

    if cfg.mode == "bitserial":
        mag_bits, act_groups, gmax = adc_lib.bitserial_planes(cfg)
        x_i = x.to(torch.int32)
        w_i = w.to(torch.int32)
        acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                          device=x.device)
        for sa, a_part in ((0, x_i.clamp_min(0)), (1, (-x_i).clamp_min(0))):
            for sw, w_part in ((0, w_i.clamp_min(0)),
                               (1, (-w_i).clamp_min(0))):
                sign = 1.0 if sa == sw else -1.0
                for si in range(x.shape[1] // rows):
                    a_s = a_part[:, si * rows:(si + 1) * rows]
                    w_s = w_part[si * rows:(si + 1) * rows, :]
                    for g in range(act_groups):
                        a_g = ((a_s >> (g * cfg.act_group_bits)) & gmax
                               ).float()
                        for j in range(mag_bits):
                            w_j = ((w_s >> j) & 1).float()
                            counts = a_g @ w_j
                            popcount = w_j.sum(dim=0, keepdim=True)
                            rng = (popcount * gmax).clamp_min(1.0)
                            sensed = adc_lib.adc_transfer(counts, rng, cfg)
                            acc = acc + sign * (4.0 ** g) * (2.0 ** j) * sensed
        return acc

    raise ValueError(f"unknown CiM mode: {cfg.mode!r}")
