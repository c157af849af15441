"""Symmetric int8 quantisation for the ROM/SRAM-CiM split (port of
``repro.core.quant``).

Two forms, kept apart because they differ in the last ulp:

* the DIVISION form (``quantize_weights``, ``quantize_activations``)
  divides by ``127`` and by the scale;
* the RECIPROCAL form (``quant_rows``, ``quant_rows_f32``) multiplies by
  ``f32(1/127)`` and by ``1/scale`` — what the fused trunk kernels compute
  per (row, k-block), and what jitted XLA turns the division form into.

Rounding is ``torch.round`` (half to even, as ``jnp.round``), never
``floor(x + 0.5)``.  Divisions by a constant divide by a tensor on the
operand's device: PyTorch's CUDA division by a host scalar multiplies by
its reciprocal instead, which would move the division form onto the
reciprocal form's bits.
"""

from __future__ import annotations

import numpy as np
import torch

INT8_MAX = 127.0
# np.float32(1/127): the reciprocal form's constant, as XLA folds it
INV_INT8_MAX = float(np.float32(1.0 / INT8_MAX))


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def quantize_weights(w: torch.Tensor, axis=0):
    """Symmetric per-channel int8 quantisation; scales reduce over
    ``axis`` (the contraction axis or axes).  Returns (w_q int8, scale
    f32) with ``w ~= w_q * scale``."""
    absmax = w.abs().amax(dim=axis, keepdim=True)
    scale = absmax.clamp_min(1e-8) / _const(INT8_MAX, absmax)
    w_q = torch.clamp(torch.round(w / scale), -INT8_MAX, INT8_MAX)
    return w_q.to(torch.int8), scale.to(torch.float32)


def quantize_activations(x: torch.Tensor):
    """Dynamic symmetric per-row (last axis) int8 quantisation."""
    return quantize_activations_at(x, x.abs().amax(dim=-1, keepdim=True))


def quantize_activations_at(x: torch.Tensor, absmax: torch.Tensor):
    """:func:`quantize_activations` of ``x`` at a given per-row ``absmax``
    (a row-parallel site quantises its columns at the whole row's)."""
    scale = absmax.clamp_min(1e-8) / _const(INT8_MAX, absmax)
    x_q = torch.clamp(torch.round(x / scale), -INT8_MAX, INT8_MAX)
    return x_q.to(torch.int8), scale


def quant_rows(x: torch.Tensor):
    """Reciprocal-form :func:`quantize_activations`: bit-identical to the
    JITTED ``repro.core.quant.quant_rows`` (see its docstring)."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(1e-8) * _const(INV_INT8_MAX, absmax)
    x_q = torch.clamp(torch.round(x * torch.reciprocal(scale)),
                      -INT8_MAX, INT8_MAX)
    return x_q.to(torch.int8), scale


def quant_rows_f32(x: torch.Tensor):
    """Like :func:`quant_rows` but keeps the quantised values in f32 (the
    clip is a no-op: ``|x| * (1/scale)`` rounds to at most 127)."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(1e-8) * _const(INV_INT8_MAX, absmax)
    return torch.round(x * torch.reciprocal(scale)), scale


def fake_quant_ste(x: torch.Tensor) -> torch.Tensor:
    """Fake-quantise activations with a straight-through gradient."""
    x_q, scale = quantize_activations(x)
    x_hat = x_q.to(x.dtype) * scale.to(x.dtype)
    return x + (x_hat - x).detach()
