"""Batch-invariant row shapes.

Continuous batching promises that a request's tokens equal a solo run's,
which needs every op of a decode step to give a row the same bits whether
it runs alone or in a batch.  Elementwise ops, gathers and the port's own
kernels do.  A cuBLAS GEMM or a PyTorch reduction on the card does not:
it picks its kernel, and with it the summation order, from the shape, so
the same row can round differently at M = 1 and M = 8.  Running such an
op on slices of a fixed number of rows, the last one padded, gives it one
shape for every batch, and so the same bits per row.
"""

from __future__ import annotations

import torch

from repro_torch.launch import cost

# Every batch-variant op sees row slices of exactly this many rows.
ROW_BUCKET = 16


def padded(x: torch.Tensor) -> torch.Tensor:
    """``x`` (at most :data:`ROW_BUCKET` rows) with zero rows appended
    along dim 0 up to :data:`ROW_BUCKET`."""
    pad = ROW_BUCKET - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])


def rowwise(fn, *rows: torch.Tensor):
    """``fn(*rows)`` (all ``rows`` with the same leading dim M, ``fn``
    row-wise), computed on consecutive :data:`ROW_BUCKET`-row slices, the
    last one zero-padded, and concatenated back to M rows: so ``fn`` sees
    ``ROW_BUCKET`` rows whatever M is, and a row gets the same bits in a
    pool of any size as alone."""
    m = rows[0].shape[0]
    if rows[0].device.type == "meta" and m > 2 * ROW_BUCKET:
        return _meta_rowwise(fn, rows, m)
    outs = [fn(*(padded(r[i:i + ROW_BUCKET]) for r in rows))[:m - i]
            for i in range(0, max(m, 1), ROW_BUCKET)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _meta_rowwise(fn, rows, m: int):
    """:func:`rowwise` on ``meta`` tensors (shapes only): every full slice
    runs the same ops on the same shapes, so ``fn`` runs on the first and
    ``launch.cost`` counts it once per full slice; the other full slices'
    outputs are allocated as one block, the padded last slice runs as it
    is, and one concatenation of the same bytes joins them.  A prefill of
    32k tokens then costs a few ops a site."""
    n_full, tail = divmod(m, ROW_BUCKET)
    ins, close = cost.repeated_grad(n_full, *(r[:ROW_BUCKET] for r in rows))
    with cost.repeated(n_full):
        first = close(fn(*ins))
    rest = first.new_empty((n_full - 1, *first.shape))
    outs = [first, rest.reshape(-1, *first.shape[1:])]
    if tail:
        outs.append(fn(*(padded(r[n_full * ROW_BUCKET:]) for r in rows))
                    [:tail])
    return torch.cat(outs)
