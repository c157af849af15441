"""Batch-invariant row shapes.

Continuous batching promises that a request's tokens equal a solo run's,
which needs every op of a decode step to give a row the same bits whether
it runs alone or in a batch.  Elementwise ops, gathers and the port's own
kernels do.  A cuBLAS GEMM or a PyTorch reduction on the card does not:
it picks its kernel, and with it the summation order, from the shape, so
the same row can round differently at M = 1 and M = 8.  Padding the rows
of such an op to a fixed bucket gives it one shape for every batch up to
the bucket, and so the same bits per row.
"""

from __future__ import annotations

import torch

# Rows of a decode step (the pool's slots) up to this many share one shape.
ROW_BUCKET = 16


def padded(x: torch.Tensor) -> torch.Tensor:
    """``x`` with zero rows appended along dim 0 up to a multiple of
    :data:`ROW_BUCKET` (at least one bucket)."""
    m = x.shape[0]
    pad = max(ROW_BUCKET, -(-m // ROW_BUCKET) * ROW_BUCKET) - m
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])


def rowwise(fn, *rows: torch.Tensor):
    """``fn(*rows)`` on row-padded copies of ``rows`` (all with the same
    leading dim M), sliced back to M rows."""
    m = rows[0].shape[0]
    return fn(*(padded(r) for r in rows))[:m]
