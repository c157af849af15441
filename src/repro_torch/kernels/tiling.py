"""The k-partition of the fused trunk kernels (port of
``repro.kernels.tiling.k_partition``), and the split-K rule of the LM
kernels' tensor-core tiles.

The k-partition fixes the per-block activation quantisation scales and
the accumulation grouping, i.e. the bits of the result.  The TPU tuning
table does not carry over (its entries are TPU tilings); the port runs
block_k 512 (``BLOCK_K``) always, so its partition is the JAX package's
default one, and its row tiles never change the bits.

:func:`split_plan` picks the tile height and how the k-blocks of one
launch of a trunk kernel are split over the grid: :func:`split_k` for the
int8 tiles (``ideal``, ``per_subarray``), :func:`split_bitserial` for the
bitserial tile.  Both read the shapes only, never the data or the card,
and a split always falls on k-partition boundaries: every k-block's part
is computed whole by one block and the parts are added in ascending order
(``csrc/mma_tile.cuh``, ``csrc/bitserial_tile.cuh``), so neither the tile
height nor the split moves a bit.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

BLOCK_K = 512
SMS = 132             # streaming multiprocessors of an H100 SXM
TILE_N = 64           # output columns of a tensor-core tile
SPLIT_BELOW = 2 * SMS     # split K where the tile grid has fewer blocks
SPLIT_TARGET = 4 * SMS    # ... aiming at about this many trunk blocks
SKETCH_TARGET = 8 * SMS   # ... and sketch blocks (measured on the H100:
                          # a `down` sketch of 1024 blocks beat 512)
BITSERIAL_TARGET = 8 * SMS   # bitserial trunk blocks, below which K splits


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


class Split(NamedTuple):
    """How one launch of a tensor-core kernel is cut: ``tile_m`` rows per
    tile, ``tiles_n`` column tiles of ``TILE_N``, ``tiles`` (row tile,
    column tile) pairs, ``n_kblocks`` k-blocks of ``k_partition``,
    ``kb_per_split`` consecutive k-blocks per split, ``n_splits`` splits
    (grid = tiles x n_splits blocks).  The kernels take it as it is
    (``csrc/mma_tile.cuh``'s SplitPlan): nothing of it is decided twice."""
    tile_m: int
    tiles_n: int
    tiles: int
    n_kblocks: int
    kb_per_split: int
    n_splits: int

    def scratch_floats(self, m: int, n: int) -> int:
        """f32 parts [n_kblocks, m, n] the ordered reduction needs (0
        without a split)."""
        return self.n_kblocks * m * n if self.n_splits > 1 else 0


def tile_m(m: int) -> int:
    """Tile height: 16 rows for a decode batch (M <= 16), else 64."""
    return 16 if m <= 16 else 64


def make_split(m: int, n: int, k: int, rows: int, tm: int,
               per: int) -> Split:
    """The Split of an [m, k] x [k, n] launch in tiles of ``tm`` rows with
    ``per`` k-blocks per split (clamped to the k-blocks there are)."""
    tiles_n = -(-n // TILE_N)
    nkb = len(k_partition(k, rows))
    per = max(1, min(per, nkb))
    return Split(tm, tiles_n, -(-m // tm) * tiles_n, nkb, per,
                 -(-nkb // per))


@functools.lru_cache(maxsize=None)
def split_k(m: int, n: int, k: int, rows: int = 128) -> Split:
    """The split of an [m, k] x [k, n] launch.  A grid of at least
    ``SPLIT_BELOW`` tiles (two blocks per SM) fills the card and is not
    split; a smaller one gets a k-block dimension of about
    ``SPLIT_TARGET / tiles`` splits, each of whole k-blocks (at most one
    per k-block)."""
    tm = tile_m(m)
    tiles = -(-m // tm) * -(-n // TILE_N)
    nkb = len(k_partition(k, rows))
    if tiles >= SPLIT_BELOW:
        per = nkb
    else:
        per = -(-nkb // min(nkb, math.ceil(SPLIT_TARGET / tiles)))
    return make_split(m, n, k, rows, tm, per)


@functools.lru_cache(maxsize=None)
def split_bitserial(m: int, n: int, k: int, rows: int = 128) -> Split:
    """The split of a bitserial launch, in tiles of 16 rows for M <= 16
    and 32 above (``csrc/bitserial_tile.cuh``: two blocks per SM fit
    beside each other at 32 rows, one at 64).  A bitserial k-block costs
    112 binary counts, each through the ADC, per (row, column, subarray),
    a hundred times an int8 one, so a grid of fewer than
    ``BITSERIAL_TARGET`` tiles is split towards that many blocks, down to
    one k-block per split."""
    tm = 16 if m <= 16 else 32
    tiles = -(-m // tm) * -(-n // TILE_N)
    nkb = len(k_partition(k, rows))
    splits = min(nkb, max(1, math.ceil(BITSERIAL_TARGET / tiles)))
    return make_split(m, n, k, rows, tm, -(-nkb // splits))


def split_plan(m: int, n: int, k: int, mode: str, rows: int = 128) -> Split:
    """The split of an [m, k] x [k, n] trunk launch in CiM ``mode``."""
    if mode == "bitserial":
        return split_bitserial(m, n, k, rows)
    return split_k(m, n, k, rows)


class SketchSplit(NamedTuple):
    """How the sketch x @ C of one fused launch is cut: ``tile_m`` rows
    per tile, ``tiles_n`` column tiles, ``tiles`` (row tile, column tile)
    pairs, ``n_sub`` 128-row sub-blocks of K (``sub_per_kblock`` to a full
    k-block), ``sub_per_split`` consecutive sub-blocks per split,
    ``n_splits`` splits, ``n_kblocks`` k-blocks.  A k-block's part is the
    ordered sum of its sub-blocks' FMA chains, so a split may cut inside a
    k-block: the scratch then holds one part per sub-block
    (``sub_slots``), else one per k-block.  The kernel takes it as it is
    (``csrc/mma_tile.cuh``'s SketchPlan)."""
    tile_m: int
    tiles_n: int
    tiles: int
    n_sub: int
    sub_per_kblock: int
    sub_per_split: int
    n_splits: int
    n_kblocks: int
    sub_slots: bool

    def scratch_floats(self, m: int, cdim: int) -> int:
        if self.n_splits == 1:
            return 0
        return (self.n_sub if self.sub_slots else self.n_kblocks) * m * cdim


def make_sketch_split(m: int, cdim: int, k: int, rows: int, tm: int,
                      per: int) -> SketchSplit:
    """The SketchSplit of an [m, k] x [k, cdim] sketch in tiles of ``tm``
    rows with ``per`` sub-blocks per split (clamped to the sub-blocks
    there are): sub-block slots in the scratch where a split cuts inside
    a k-block."""
    tiles_n = -(-cdim // TILE_N)
    n_sub = -(-k // rows)
    spk = block_k(k, rows) // rows
    per = max(1, min(per, n_sub))
    return SketchSplit(tm, tiles_n, -(-m // tm) * tiles_n, n_sub, spk, per,
                       -(-n_sub // per), len(k_partition(k, rows)),
                       per % spk != 0)


def sketch_tile_m(m: int) -> int:
    """The sketch's tile height: 8 rows for M <= 8 (its f32 FMAs are
    spent on every tile row), 16 for M <= 16, else 64."""
    return 8 if m <= 8 else tile_m(m)


@functools.lru_cache(maxsize=None)
def split_sketch(m: int, cdim: int, k: int, rows: int = 128) -> SketchSplit:
    """The split of the sketch [m, k] x [k, cdim] of a fused launch: as
    :func:`split_k`, aiming at ``SKETCH_TARGET`` blocks, in units of
    ``rows``-row sub-blocks; a split of less than a k-block takes one
    sub-block, a larger one whole k-blocks."""
    tm = sketch_tile_m(m)
    tiles = -(-m // tm) * -(-cdim // TILE_N)
    n_sub = -(-k // rows)
    spk = block_k(k, rows) // rows
    if tiles >= SPLIT_BELOW:
        per = n_sub
    else:
        per = -(-n_sub // min(n_sub, math.ceil(SKETCH_TARGET / tiles)))
        per = 1 if per < spk else min(n_sub, -(-per // spk) * spk)
    return make_sketch_split(m, cdim, k, rows, tm, per)
