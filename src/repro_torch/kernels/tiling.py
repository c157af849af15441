"""The k-partition of the fused trunk kernels (port of
``repro.kernels.tiling.k_partition``).

The k-partition fixes the per-block activation quantisation scales and
the accumulation grouping, i.e. the bits of the result.  The TPU tuning
table does not carry over (its entries are TPU tilings); the port runs
block_k 512 (``BLOCK_K``) always, so its partition is the JAX package's
default one, and its row tiles never change the bits.
"""

from __future__ import annotations

BLOCK_K = 512


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def block_k(k: int, rows: int) -> int:
    """The k-block width for a contraction of ``k``: the kernels' clamp
    rule ``min(BLOCK_K, round_up(k, rows))``."""
    return min(BLOCK_K, _round_up(k, rows))


def k_partition(k: int, rows: int) -> tuple[tuple[int, int], ...]:
    """The (start, end) k-ranges a kernel splits the contraction into."""
    bk = block_k(k, rows)
    return tuple((k0, min(k0 + bk, k)) for k0 in range(0, k, bk))
