"""The 5-bit ADC transfer functions of the ROM-CiM macro (paper §3.1;
port of ``repro.core.adc``).

One home for the analogue-to-digital math that the macro model
(``core.cim``) and the plain block dot (``kernels.cim_matmul``) share, so
the comparator-threshold convention cannot drift between them.
"""

from __future__ import annotations

import torch

# Comparator thresholds are biased a hair below the half-step, so integer
# counts landing exactly on a half boundary resolve identically in every
# implementation.
THRESHOLD_BIAS = 1e-3


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar or tensor as f32 on ``like``'s device (dividing by
    a device tensor keeps CUDA from swapping in a reciprocal multiply)."""
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def adc_lsb(full_range, cfg, like: torch.Tensor) -> torch.Tensor:
    """The step of :func:`adc_transfer` for ``full_range`` (a scalar, in
    Python, or a per-column tensor, in f32), on ``like``'s device."""
    if isinstance(full_range, torch.Tensor):      # per-column, in f32
        return (full_range * cfg.adc_range_frac) / _f32(cfg.adc_levels, like)
    return _f32(full_range * cfg.adc_range_frac / cfg.adc_levels, like)


def adc_code(psum: torch.Tensor, lsb: torch.Tensor, cfg) -> torch.Tensor:
    """The output code of :func:`adc_transfer`, in f32: the count in steps
    of ``lsb``, biased, rounded half to even, clipped to the levels."""
    return torch.clamp(torch.round(psum / lsb + THRESHOLD_BIAS),
                       0, cfg.adc_levels)


def adc_transfer(psum: torch.Tensor, full_range, cfg) -> torch.Tensor:
    """5-bit ADC: quantise a non-negative analogue count in
    [0, full_range] (scalar or per-column tensor) to ``cfg.adc_levels``
    uniform steps, clipping above the engineered range."""
    lsb = adc_lsb(full_range, cfg, psum)
    return adc_code(psum, lsb, cfg) * lsb


def signed_lsb(full_range, cfg) -> float:
    """The step of :func:`signed_adc` as a Python double; it is rounded
    once to f32 where it is used (here, and by the CUDA kernels'
    wrappers)."""
    return full_range * cfg.psum_range_frac / (cfg.adc_levels / 2.0)


def signed_adc(psum: torch.Tensor, full_range, cfg) -> torch.Tensor:
    """ADC transfer for signed per-subarray partial sums (per_subarray
    mode): a differential +-full_range swing on the same 2^B levels."""
    half_levels = cfg.adc_levels / 2.0
    lsb = _f32(signed_lsb(full_range, cfg), psum)
    code = torch.clamp(torch.round(psum / lsb + THRESHOLD_BIAS),
                       -half_levels, half_levels)
    return code * lsb


def bitserial_planes(cfg) -> tuple[int, int, int]:
    """(weight magnitude bit planes, activation pulse groups, group max)
    of the differential bit-serial decomposition."""
    mag_bits = cfg.weight_bits - 1              # |w| <= 127 -> 7 planes
    act_groups = -(-(cfg.act_bits - 1) // cfg.act_group_bits)
    return mag_bits, act_groups, cfg.group_max
