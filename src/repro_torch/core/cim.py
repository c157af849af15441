"""Numerical model of the YOLoC ROM-CiM macro (paper §3.1, Fig. 5; port
of ``repro.core.cim``).

A 128x256 1T/cell ROM array: 128 word lines (inputs) summed on each bit
line, bit lines digitised by a column-shared 5-bit ADC.  Three fidelity
modes: ``ideal`` (exact int8 matmul), ``per_subarray`` (each 128-row
partial sum through the ADC once) and ``bitserial`` (2-bit activation
pulse groups x weight bit planes x subarrays, each count through the ADC).

Plain PyTorch; ``kernels.ref`` reuses it as the oracle of the kernels.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import adc as adc_lib


@dataclasses.dataclass(frozen=True)
class CiMConfig:
    rows_per_subarray: int = 128   # WLs summed on one bit line
    adc_bits: int = 5              # paper: 16 column-shared 5-bit ADCs
    act_bits: int = 8              # Table I: 8-bit activations
    weight_bits: int = 8           # Table I: 8-bit weights
    act_group_bits: int = 2        # unary pulse groups: 0..3 pulses per WL
    adc_range_frac: float = 0.5    # ADC range / achievable bit-line count
    psum_range_frac: float = 1.0   # per_subarray signed swing fraction
    mode: str = "per_subarray"     # 'ideal' | 'per_subarray' | 'bitserial'

    @property
    def adc_levels(self) -> int:
        return (1 << self.adc_bits) - 1

    @property
    def act_groups(self) -> int:
        return self.act_bits // self.act_group_bits

    @property
    def group_max(self) -> int:
        return (1 << self.act_group_bits) - 1


DEFAULT_CIM = CiMConfig()


def int_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer ``a @ w`` of integer-valued operands, as f32.

    Runs as a float64 matmul (exact below 2**53, and available on every
    device, unlike an int8 matmul), rounded once to f32 — the same value
    as the int32 dot cast to f32 in the JAX package.
    """
    return torch.matmul(a.to(torch.float64), w.to(torch.float64)).to(
        torch.float32)


def _pad_to_subarrays(a_q, w_q, rows: int):
    k = a_q.shape[-1]
    pad = (-k) % rows
    if pad:
        a_q = F.pad(a_q, (0, pad))
        w_q = F.pad(w_q, (0, 0, 0, pad))
    return a_q, w_q, (k + pad) // rows


def cim_matmul_model(a_q: torch.Tensor, w_q: torch.Tensor,
                     cfg: CiMConfig = DEFAULT_CIM) -> torch.Tensor:
    """Integer-domain CiM matmul: int8 [..., K] x int8 [K, N] -> f32
    [..., N] approximating ``a_q @ w_q``; callers apply float scales."""
    if cfg.mode == "ideal":
        return int_dot(a_q, w_q)
    if cfg.mode == "per_subarray":
        return _per_subarray_model(a_q, w_q, cfg)
    if cfg.mode == "bitserial":
        return _bitserial_model(a_q, w_q, cfg)
    raise ValueError(f"unknown CiM mode: {cfg.mode!r}")


def _per_subarray_model(a_q, w_q, cfg: CiMConfig) -> torch.Tensor:
    """Signed per-subarray partial sums through the ADC."""
    rows = cfg.rows_per_subarray
    a_q, w_q, s = _pad_to_subarrays(a_q, w_q, rows)
    batch = a_q.shape[:-1]
    a3 = a_q.reshape(*batch, s, rows).to(torch.float32)
    w3 = w_q.reshape(s, rows, w_q.shape[-1]).to(torch.float32)
    psums = torch.einsum("...sr,srn->...sn", a3, w3)   # exact: < 2**24
    psums = adc_lib.signed_adc(psums, rows * 127.0, cfg)
    return psums.sum(dim=-2)


def _bitserial_model(a_q, w_q, cfg: CiMConfig) -> torch.Tensor:
    """Paper-faithful bit-serial model with differential (sign-split)
    arrays:  out = A(a+,w+) - A(a+,w-) - A(a-,w+) + A(a-,w-)  with
    A(a', w') = sum_s sum_g sum_j 4^g 2^j ADC(sum_{k in s} a'_g[k] w'_j[k])."""
    rows = cfg.rows_per_subarray
    a_q, w_q, s = _pad_to_subarrays(a_q, w_q, rows)
    batch = a_q.shape[:-1]
    n = w_q.shape[-1]
    a_i = a_q.to(torch.int32)
    w_i = w_q.to(torch.int32)
    a_split = (a_i.clamp_min(0), (-a_i).clamp_min(0))
    w_split = (w_i.clamp_min(0), (-w_i).clamp_min(0))
    mag_bits, act_groups, group_max = adc_lib.bitserial_planes(cfg)

    acc = torch.zeros((*batch, n), dtype=torch.float32, device=a_q.device)
    for sa, a_part in enumerate(a_split):
        a3 = a_part.reshape(*batch, s, rows)
        for sw, w_part in enumerate(w_split):
            sign = 1.0 if sa == sw else -1.0
            w3 = w_part.reshape(s, rows, n)
            for g in range(act_groups):
                a_g = ((a3 >> (g * cfg.act_group_bits)) & group_max
                       ).to(torch.float32)
                for j in range(mag_bits):
                    w_j = ((w3 >> j) & 1).to(torch.float32)
                    counts = torch.einsum("...sr,srn->...sn", a_g, w_j)
                    # tape-out-known per-column sense references
                    popcount = w_j.sum(dim=-2)                   # [s, n]
                    full_range = (popcount * group_max).clamp_min(1.0)
                    sensed = adc_lib.adc_transfer(counts, full_range, cfg)
                    acc = acc + sign * (4.0 ** g) * (2.0 ** j) * sensed.sum(
                        dim=-2)
    return acc


# ---------------------------------------------------------------------------
# Convolution on the macro: im2col lowering
# ---------------------------------------------------------------------------

def conv_pads(size: int, k: int, stride: int, padding: str):
    """XLA-compatible (lo, hi) padding and output size for one spatial
    dim; SAME puts the odd pad at the bottom/right."""
    if padding == "VALID":
        if size < k:
            raise ValueError(f"VALID conv needs size >= kernel ({size} < {k})")
        return (0, 0), (size - k) // stride + 1
    if padding != "SAME":
        raise ValueError(f"unknown padding: {padding!r}")
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return (total // 2, total - total // 2), out


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: str = "SAME"):
    """Conv patches: NHWC -> ([N, OH, OW, kh*kw*C], (OH, OW)).

    Tap-major, input channels fastest — the row order of
    ``w.reshape(kh*kw*C, c_out)`` of an HWIO kernel.  Zero padding;
    dtype-preserving (int8 operands stay int8).
    """
    _, h, w_sz, _ = x.shape
    (ph0, ph1), oh = conv_pads(h, kh, stride, padding)
    (pw0, pw1), ow = conv_pads(w_sz, kw, stride, padding)
    xp = F.pad(x, (0, 0, pw0, pw1, ph0, ph1))
    taps = [xp[:, i:i + (oh - 1) * stride + 1:stride,
               j:j + (ow - 1) * stride + 1:stride, :]
            for i in range(kh) for j in range(kw)]
    return torch.cat(taps, dim=-1), (oh, ow)


def cim_conv_model(x_q: torch.Tensor, w_q: torch.Tensor,
                   cfg: CiMConfig = DEFAULT_CIM, stride: int = 1,
                   padding: str = "SAME") -> torch.Tensor:
    """Integer-domain CiM convolution: int8 NHWC x int8 HWIO -> f32
    [N, OH, OW, C_out], im2col through :func:`cim_matmul_model`."""
    kh, kw, c_in, c_out = w_q.shape
    patches, _ = im2col(x_q, kh, kw, stride, padding)
    return cim_matmul_model(patches, w_q.reshape(kh * kw * c_in, c_out), cfg)
