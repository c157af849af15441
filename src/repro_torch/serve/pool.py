"""KV-cache pools: one resident cache, capacity owned by requests (port of
``repro.serve.pool``).

:class:`SlotPool` — dense.  One ``init_cache(n_slots, max_len)`` tree;
each request owns one full-horizon batch row for its lifetime.

:class:`PagedPool` — paged.  The same byte budget carved into fixed-size
physical blocks shared by every row: each request holds a block TABLE,
blocks are reserved at admission and granted on demand as decode
advances.  The attention math is unchanged (``models.layers`` gathers the
logical view through the table, equal to the dense row at every valid
position), so batched tokens equal solo tokens across both layouts.

Admission copies a solo-prefilled (batch=1, dense) cache into the
request's row or blocks, bitwise.  Retirement returns the capacity; a
paged free row's masked decode writes land in the reserved trash block.
Speculative decode grants a whole verify block's positions ahead
(``prepare_tokens``) and truncates the rejected tail afterwards
(``rollback``): lengths reset on every layer and, paged, the tail blocks
return to the free list with the row's reservation re-credited.  The
pools update the cache tensors in place.  A dense pool holds any family's
cache: every leaf carries the batch row at axis 1 under stacked layers
([L, rows, ...]: dense, moe, ssm) and at axis 0 in the hybrid's per-layer
list; an SSM leaf (``conv``, ``h``) has no ``length``.  Only the
transformer family without sliding windows pages
(``api.supports_paging``).

Pool sizing comes from the :class:`~repro_torch.plan.PlacementPlan`'s
SRAM residency: the KV capacity lives in what the branch cores and any
SRAM-resident sites leave of the die's SRAM (:func:`suggest_slots` /
:func:`suggest_paged`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.models import api


def _set_lengths(cache, new_lens: dict[int, int]) -> None:
    """Write per-row ``length`` values into every layer of a serve cache
    (the stacked [L, rows] lengths: only the transformer family rolls
    back), in place."""
    lengths = cache["layers"]["length"]
    rows = sorted(new_lens)
    idx = torch.as_tensor(rows, dtype=torch.long, device=lengths.device)
    vals = torch.as_tensor([new_lens[r] for r in rows], dtype=lengths.dtype,
                           device=lengths.device)
    lengths[:, idx] = vals[None].expand(lengths.shape[0], -1)


class SlotPool:
    """N cache rows + a free list; adoption and release are O(1)."""

    def __init__(self, model, n_slots: int, max_len: int,
                 dtype=torch.float32, device=None):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        self.model = model
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.dtype = dtype
        self.device = device
        self._axis = 1 if model.cfg.scan_layers else 0   # rows' axis
        self.cache = model.init_cache(n_slots, max_len, dtype=dtype,
                                      device=device)
        self._free = list(range(n_slots))[::-1]     # pop() -> slot 0 first

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> int:
        """Rows currently owned by requests (never exceeds n_slots)."""
        return self.n_slots - len(self._free)

    def try_admit(self, total_len: int) -> int | None:
        """A free slot for a request needing ``total_len`` positions, or
        ``None`` when every row is held; raises if it could never fit."""
        if total_len > self.max_len:
            raise ValueError(
                f"request needs {total_len} cache positions but the pool "
                f"was sized for max_len={self.max_len}")
        return self._free.pop() if self._free else None

    def release(self, slot: int) -> None:
        """Return a slot; raises on out-of-range and double-release."""
        if not (0 <= slot < self.n_slots):
            raise ValueError(f"slot {slot} outside pool of {self.n_slots}")
        if slot in self._free:
            raise ValueError(f"slot {slot} double-released")
        self._free.append(slot)

    def prepare_step(self) -> None:
        """Pre-decode hook: dense rows never need new capacity."""

    def prepare_tokens(self, n: int) -> None:
        """Pre-verify hook for an ``n``-token speculative block: dense rows
        span the full horizon, nothing to grant."""

    def rollback(self, new_lens: dict[int, int]) -> None:
        """Truncate rows to ``{slot: new_length}`` after a verify rejected
        part of a draft block: the rows' lengths reset on every layer; the
        rejected entries past them are stale, hidden by the validity mask
        until the next write overwrites them."""
        if new_lens:
            _set_lengths(self.cache, new_lens)

    def adopt(self, slot: int, solo_cache) -> None:
        """Copy a batch=1 cache into ``slot``'s row, leaf by leaf."""
        axis = self._axis
        bridge.tree_map2(self.cache, solo_cache, lambda dst, src: dst.select(
            axis, slot).copy_(src.select(axis, 0)))

    def solo_cache(self):
        """A fresh batch=1 cache with this pool's geometry (for the
        admission prefill)."""
        return self.model.init_cache(1, self.max_len, dtype=self.dtype,
                                     device=self.device)


class PagedPool:
    """Paged KV pool: shared physical blocks, per-request block tables.

    The cache holds ``n_blocks + 1`` physical blocks of ``block_size``
    positions per layer (the extra one is the TRASH block) plus a
    ``[n_rows, max_len/block_size]`` table.  ``try_admit(total)`` reserves
    ``ceil(total/block_size)`` blocks and a row without touching the
    device, so decode can never deadlock on a block that will never free;
    ``adopt`` grants the blocks covering the prefilled prompt and
    scatters the dense solo row into them; ``prepare_step`` grants each
    active row the block holding its next write; ``release`` frees the
    blocks and points the row's table back at the trash block.
    """

    def __init__(self, model, n_rows: int, n_blocks: int, block_size: int,
                 max_len: int, dtype=torch.float32, device=None):
        if n_rows < 1:
            raise ValueError(f"need at least one row, got {n_rows}")
        if max_len % block_size:
            raise ValueError(
                f"block_size {block_size} does not divide max_len "
                f"{max_len} (the logical view must match the dense "
                f"cache geometry exactly)")
        if n_blocks < max_len // block_size:
            raise ValueError(
                f"{n_blocks} blocks of {block_size} cannot hold even "
                f"one full-horizon request (max_len {max_len} needs "
                f"{max_len // block_size}); shrink max_len or grow the "
                f"pool")
        self.model = model
        self.n_rows = int(n_rows)
        self.n_blocks = int(n_blocks)          # usable (trash excluded)
        self.block_size = int(block_size)
        self.max_len = int(max_len)
        self.dtype = dtype
        self.device = device
        self.nb_logical = max_len // block_size
        self.cache = model.init_paged_cache(
            n_rows, n_blocks + 1, block_size, max_len, dtype=dtype,
            device=device)
        self._trash = n_blocks
        self._table = np.full((n_rows, self.nb_logical), self._trash,
                              np.int32)
        self._free_rows = list(range(n_rows))[::-1]   # pop() -> row 0 first
        self._free_blocks = list(range(n_blocks))[::-1]
        self._owed: dict[int, int] = {}      # row -> reserved, not granted
        self._blocks: dict[int, list[int]] = {}   # row -> granted physical
        self._len: dict[int, int] = {}       # row -> next write position
        self._dirty = True                   # host table ahead of device

    @property
    def n_slots(self) -> int:
        """Batch-row count (the scheduler's name for it)."""
        return self.n_rows

    @property
    def free_slots(self) -> int:
        return len(self._free_rows)

    @property
    def occupancy(self) -> int:
        return self.n_rows - len(self._free_rows)

    @property
    def blocks_in_use(self) -> int:
        """Physical blocks granted to live requests."""
        return sum(len(b) for b in self._blocks.values())

    @property
    def blocks_reserved(self) -> int:
        """Blocks promised at admission but not yet granted."""
        return sum(self._owed.values())

    @property
    def live_tokens(self) -> int:
        return sum(self._len.values())

    @property
    def utilization(self) -> float:
        """live_tokens / granted capacity."""
        used = self.blocks_in_use * self.block_size
        return self.live_tokens / used if used else 0.0

    def try_admit(self, total_len: int) -> int | None:
        """Reserve a row + enough blocks for ``total_len`` positions, or
        ``None`` when the pool cannot GUARANTEE the request completes;
        raises if it could never fit."""
        if total_len > self.max_len:
            raise ValueError(
                f"request needs {total_len} cache positions but the "
                f"pool's logical horizon is max_len={self.max_len}")
        if not self._free_rows:
            return None
        need = -(-total_len // self.block_size)
        if need > len(self._free_blocks) - self.blocks_reserved:
            return None
        row = self._free_rows.pop()
        self._owed[row] = need
        self._blocks[row] = []
        return row

    def _grant(self, row: int) -> None:
        if not self._free_blocks:
            raise RuntimeError(
                "no free block for a granted reservation — the "
                "try_admit invariant (reserved <= free) was broken")
        blk = self._free_blocks.pop()
        idx = len(self._blocks[row])
        self._blocks[row].append(blk)
        self._owed[row] = max(0, self._owed[row] - 1)
        self._table[row, idx] = blk
        self._dirty = True

    def prepare_step(self) -> None:
        """Grant every active row the block holding its next write
        position, advance the host-side lengths, and sync the table; the
        scheduler calls this right before each batched decode."""
        self.prepare_tokens(1)

    def prepare_tokens(self, n: int) -> None:
        """Grant every active row the blocks covering its next ``n`` write
        positions (a speculative verify writes a k-token block per row)
        and advance the host-side lengths by ``n``.  Grants stay within
        the admission reservation (the scheduler clamps k to every row's
        remaining budget); ``rollback`` returns what a rejected draft
        leaves unused."""
        if n < 1:
            raise ValueError(f"need at least one token, got {n}")
        for row in self._len:
            pos = self._len[row]
            while (pos + n - 1) // self.block_size >= \
                    len(self._blocks[row]):
                self._grant(row)
            self._len[row] = pos + n
        self.sync()

    def rollback(self, new_lens: dict[int, int]) -> None:
        """Truncate rows to ``{row: new_length}`` after a speculative
        verify rejected part of a draft block.  The device lengths reset
        on every layer (the validity mask hides the rejected entries until
        the next block overwrites them); tail blocks past
        ``ceil(new_length / block_size)`` return to the free list and
        re-credit the row's reservation, so ``free - reserved`` is what it
        was before the speculative grant; the table tail points back at
        the trash block, so the row's masked writes cannot land in blocks
        re-granted to someone else."""
        if not new_lens:
            return
        for row, new_len in new_lens.items():
            if row not in self._blocks:
                raise ValueError(
                    f"rollback of row {row}, which holds no blocks "
                    f"(released, or never admitted)")
            if not (0 <= new_len <= self._len.get(row, 0)):
                raise ValueError(
                    f"rollback of row {row} to length {new_len}, "
                    f"outside [0, {self._len.get(row, 0)}] — rollback "
                    f"only ever truncates")
            keep = -(-new_len // self.block_size)
            tail = self._blocks[row][keep:]
            if tail:
                del self._blocks[row][keep:]
                self._free_blocks.extend(reversed(tail))
                self._owed[row] = self._owed.get(row, 0) + len(tail)
                self._table[row, keep:] = self._trash
                self._dirty = True
            self._len[row] = new_len
        _set_lengths(self.cache, new_lens)
        self.sync()

    def release(self, row: int) -> None:
        """Free a row: blocks return to the free list, the table row points
        back at the trash block."""
        if not (0 <= row < self.n_rows):
            raise ValueError(f"row {row} outside pool of {self.n_rows}")
        if row not in self._blocks:
            raise ValueError(f"row {row} double-released")
        self._free_blocks.extend(reversed(self._blocks.pop(row)))
        self._owed.pop(row, None)
        self._len.pop(row, None)
        self._table[row, :] = self._trash
        self._dirty = True
        self._free_rows.append(row)

    def solo_cache(self):
        """A fresh DENSE batch=1 cache at this pool's logical horizon
        (prefill cannot run against paged state)."""
        return self.model.init_cache(1, self.max_len, dtype=self.dtype,
                                     device=self.device)

    def adopt(self, row: int, solo_cache) -> None:
        """Grant the blocks covering the solo-prefilled prompt and scatter
        its dense KV row into them, bitwise; the row's device length is
        set from the solo cache."""
        if row not in self._blocks:
            raise ValueError(
                f"row {row} was not admitted (call try_admit first)")
        solo = solo_cache["layers"]
        length = int(solo["length"].reshape(-1)[0])
        n_grant = -(-length // self.block_size)
        while len(self._blocks[row]) < n_grant:
            self._grant(row)
        layers = self.cache["layers"]
        phys = torch.as_tensor(self._blocks[row][:n_grant], dtype=torch.long,
                               device=layers["k"].device)
        span, bs = n_grant * self.block_size, self.block_size
        for key in ("k", "v"):
            sl, pl = solo[key], layers[key]   # [L,1,max_len,..] -> [L,P,bs,..]
            blocks = sl[:, 0, :span].reshape(sl.shape[0], n_grant, bs,
                                             *sl.shape[3:])
            pl[:, phys] = blocks.to(pl.dtype)
        layers["length"][:, row] = length
        self._len[row] = length      # joins prepare_step's advance loop
        self.sync()

    def sync(self) -> None:
        """Push the host-side block table into every layer's ``table``."""
        if not self._dirty:
            return
        table = self.cache["layers"]["table"]
        table.copy_(torch.from_numpy(self._table).to(table.device)[None]
                    .expand_as(table))
        self._dirty = False


def cache_bytes_per_slot(model, max_len: int, dtype=torch.float32) -> int:
    """Bytes one slot (batch row) of the cache occupies, from the shapes of
    ``init_cache`` built on the meta device (no allocation)."""
    cache = api.init_cache(model.cfg, 1, max_len, dtype, device="meta")
    return sum(t.numel() * t.element_size()
               for t in bridge.flatten(cache).values())


def suggest_slots(model, plan, max_len: int, *,
                  sram_capacity_bytes: int = 64 << 20,
                  dtype=torch.float32, max_slots: int = 64) -> int:
    """KV slots that fit beside the plan's SRAM-resident weights (branch
    cores + SRAM sites); at least 1, at most ``max_slots``."""
    per_slot = cache_bytes_per_slot(model, max_len, dtype)
    resident = 0
    if plan is not None:
        stats = plan.stats(model.cfg)
        resident = (stats.branch_bits + stats.sram_bits) // 8
    budget = max(0, sram_capacity_bytes - resident)
    return max(1, min(max_slots, budget // per_slot))


def default_block_size(max_len: int) -> int:
    """``max_len // 8`` clamped to [8, 64], lowered to a divisor of
    ``max_len``."""
    block_size = min(64, max(8, max_len // 8))
    while max_len % block_size:
        block_size -= 1
    return block_size


def suggest_paged(model, plan, max_len: int, *,
                  sram_capacity_bytes: int = 64 << 20,
                  dtype=torch.float32, max_rows: int = 64,
                  block_size: int | None = None) -> tuple[int, int, int]:
    """(n_rows, n_blocks, block_size) for a :class:`PagedPool` in the SAME
    byte budget :func:`suggest_slots` would spend on dense rows, with
    twice the rows (capped at ``max_rows``)."""
    dense = suggest_slots(model, plan, max_len,
                          sram_capacity_bytes=sram_capacity_bytes,
                          dtype=dtype, max_slots=max_rows)
    if block_size is None:
        block_size = default_block_size(max_len)
    if max_len % block_size:
        raise ValueError(
            f"block_size {block_size} does not divide max_len {max_len}")
    blocks_per_slot = max_len // block_size
    n_blocks = max(blocks_per_slot, dense * blocks_per_slot)
    n_rows = max(1, min(max_rows, 2 * dense))
    return n_rows, n_blocks, block_size
