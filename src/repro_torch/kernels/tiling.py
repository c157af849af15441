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

:func:`resolve_plan` decides the plan of one launch (port of
``resolve_tiling``): an explicit ``plan=`` wins outright; else the tuning
table's entry (``repro_torch.tune.table``, measured on the H100) if it is
legal for the geometry (:func:`plan_legal`); else the shape rule's plan
(:func:`rule_plan`).  A plan only fixes the tile heights and the splits,
so a legal one never moves a bit either.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

from repro_torch.tune import table as tune_table
from repro_torch.tune.table import Plan

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


# ---------------------------------------------------------------------------
# launch plans: what the kernels compile, the shape rule, the table's guard
# ---------------------------------------------------------------------------

TUNED_KERNELS = ("trunk_conv", "cim_matmul", "rebranch_matmul")


def tall_tile_m(mode: str) -> int:
    """The taller trunk tile: 64 rows, or 32 in bitserial."""
    return 32 if mode == "bitserial" else 64


def trunk_heights(mode: str) -> tuple[int, int]:
    """The trunk tile heights the kernels compile in ``mode``
    (``cim_matmul.cu::launch_mode``, ``trunk_conv.cu::launch_tile``)."""
    return 16, tall_tile_m(mode)


def height_pairs(mode: str, dtype: str, m: int) -> tuple:
    """The (trunk, sketch) tile heights the fused kernel compiles
    (``rebranch_matmul.cu::launch_height``): (16, 8), (16, 16) and (tall,
    64), the last for an f32 x only; a bf16 x at M <= 16 is read as bf16."""
    pairs = ((16, 8), (16, 16))
    if dtype == "bfloat16" and m <= 16:
        return pairs
    return pairs + ((tall_tile_m(mode), 64),)


def legal_sub_per(k: int, rows: int, sub_per: int) -> bool:
    """``split_sketch``'s sub-block rule: a split of one sub-block, or of
    whole k-blocks (the last split may end on K's ragged end)."""
    n_sub = -(-k // rows)
    spk = block_k(k, rows) // rows
    return 1 <= sub_per <= n_sub and (
        sub_per == 1 or sub_per == n_sub or sub_per % spk == 0)


def plan_legal(kernel: str, mode: str, dtype: str, m: int, k: int, n: int,
               rows: int, plan: Plan) -> bool:
    """Whether ``plan`` may run the geometry: a tile height the kernel
    compiles in ``mode`` (for the fused matmul a height pair it compiles),
    splits of whole k-blocks, at most one per k-block, and a sketch split
    that obeys :func:`legal_sub_per`."""
    del n
    if plan.kb_per_split > len(k_partition(k, rows)):
        return False
    if kernel == "rebranch_matmul":
        return (plan.sketch_tile_m is not None
                and (plan.tile_m, plan.sketch_tile_m)
                in height_pairs(mode, dtype, m)
                and legal_sub_per(k, rows, plan.sub_per_split))
    if kernel not in TUNED_KERNELS:
        raise ValueError(f"unknown tunable kernel {kernel!r}")
    return plan.sketch_tile_m is None and plan.tile_m in trunk_heights(mode)


def rule_plan(kernel: str, mode: str, m: int, k: int, n: int,
              rows: int = 128, cdim: int | None = None) -> Plan:
    """The shape rule's plan: :func:`split_plan`'s, and for the fused
    matmul :func:`split_sketch`'s (which needs the sketch width
    ``cdim``)."""
    sp = split_plan(m, n, k, mode, rows)
    if kernel != "rebranch_matmul":
        return Plan(sp.tile_m, sp.kb_per_split)
    ss = split_sketch(m, cdim, k, rows)
    return Plan(sp.tile_m, sp.kb_per_split, ss.tile_m, ss.sub_per_split)


def resolve_plan(kernel: str, mode: str, dtype: str, m: int, k: int, n: int,
                 rows: int, plan: Plan | None = None, *,
                 cdim: int | None = None) -> Plan:
    """The plan of one launch: ``plan`` if given (raising if it is not
    legal: it would reach no kernel), else the table's entry for the
    geometry if it is legal, else :func:`rule_plan`'s.  An illegal table
    entry (a hand edit, a table of another kernel version) is dropped, as
    ``resolve_tiling`` drops a block_k that changes the partition."""
    if plan is not None:
        if not plan_legal(kernel, mode, dtype, m, k, n, rows, plan):
            raise ValueError(f"{plan} is not a legal plan for "
                             f"{tune_table.key(kernel, mode, dtype, m, k, n)}")
        return plan
    entry = tune_table.lookup(kernel, mode, dtype, m, k, n)
    if entry is not None and plan_legal(kernel, mode, dtype, m, k, n, rows,
                                        entry):
        return entry
    return rule_plan(kernel, mode, m, k, n, rows, cdim)


def trunk_split(plan: Plan, m: int, n: int, k: int, rows: int) -> Split:
    """The trunk's Split of ``plan`` for an [m, k] x [k, n] launch."""
    return make_split(m, n, k, rows, plan.tile_m, plan.kb_per_split)


def sketch_split(plan: Plan, m: int, cdim: int, k: int,
                 rows: int) -> SketchSplit:
    """The sketch's SketchSplit of a fused-matmul ``plan``."""
    return make_sketch_split(m, cdim, k, rows, plan.sketch_tile_m,
                             plan.sub_per_split)
