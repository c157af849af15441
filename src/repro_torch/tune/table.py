"""The checked-in table of Hopper kernel plans: load / lookup / save (port
of ``repro.tune.table``).

The autotuner (:mod:`repro_torch.tune.autotune`) times the legal plans of
each (kernel, CiM mode, dtype, GEMM geometry) on the card and writes the
fastest to ``hopper_table.json`` beside this module.  The kernel wrappers
consult :func:`lookup` (through ``kernels.tiling.resolve_plan``) whenever
the caller passes no ``plan=``, so the table speeds up every conv and
matmul site without touching a call site.

A plan only says how a launch is cut: the tile height and how many
k-blocks each split takes (for the fused matmul also the sketch's).  A
legal plan never moves a bit (``kernels/tiling.py``), and
``resolve_plan`` drops a table entry that is not legal for its geometry.

The override stack lives in a ``contextvars.ContextVar``: an
:func:`overrides` or :func:`disabled` context reaches the calls of its own
thread (or asyncio task) only.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import json
import os
from typing import Iterator, Mapping, NamedTuple

TILE_HEIGHTS = (16, 32, 64)          # trunk tile heights some mode compiles
SKETCH_HEIGHTS = (8, 16, 64)         # sketch tile heights of the fused matmul

_DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "hopper_table.json")


def _positive_int(name: str, v) -> None:
    if isinstance(v, bool) or not isinstance(v, int) or v < 1:
        raise ValueError(f"{name} must be a positive int, got {v!r}")


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch plan: ``tile_m`` rows per trunk tile and
    ``kb_per_split`` consecutive k-blocks per split of the trunk; for
    ``rebranch_matmul`` also the sketch's ``sketch_tile_m`` and
    ``sub_per_split`` 128-row sub-blocks per split (both None for the
    other kernels).  Whether a plan is legal for a geometry is
    ``kernels.tiling.plan_legal``'s question; this checks the form only."""

    tile_m: int
    kb_per_split: int
    sketch_tile_m: int | None = None
    sub_per_split: int | None = None

    def __post_init__(self):
        _positive_int("kb_per_split", self.kb_per_split)
        if self.tile_m not in TILE_HEIGHTS:
            raise ValueError(f"tile_m must be one of {TILE_HEIGHTS}, got "
                             f"{self.tile_m!r}")
        if (self.sketch_tile_m is None) != (self.sub_per_split is None):
            raise ValueError("sketch_tile_m and sub_per_split come together "
                             f"(got {self.sketch_tile_m!r}, "
                             f"{self.sub_per_split!r})")
        if self.sketch_tile_m is not None:
            _positive_int("sub_per_split", self.sub_per_split)
            if self.sketch_tile_m not in SKETCH_HEIGHTS:
                raise ValueError(f"sketch_tile_m must be one of "
                                 f"{SKETCH_HEIGHTS}, got "
                                 f"{self.sketch_tile_m!r}")

    def to_json(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    @classmethod
    def from_json(cls, d: Mapping) -> "Plan":
        extra = set(d) - {f.name for f in dataclasses.fields(cls)}
        if extra:
            raise ValueError(f"unknown plan fields {sorted(extra)}")
        return cls(tile_m=d["tile_m"], kb_per_split=d["kb_per_split"],
                   sketch_tile_m=d.get("sketch_tile_m"),
                   sub_per_split=d.get("sub_per_split"))


def key(kernel: str, mode: str, dtype: str, m: int, k: int, n: int) -> str:
    """Canonical table key for one kernel geometry (the JAX package's
    format, letter for letter)."""
    return f"{kernel}|{mode}|{dtype}|{m}x{k}x{n}"


# ---------------------------------------------------------------------------
# Table state.  The base table is loaded lazily from the checked-in JSON and
# cached; ``_stack`` holds this context's overrides as frames.  Every state
# has a serial number, so a caller may cache what it resolved per
# (serial, geometry) instead of looking it up on every call.
# ---------------------------------------------------------------------------

class _Frame(NamedTuple):
    serial: int
    entries: dict | None         # None == lookups disabled


_serials = itertools.count(1)
_cache: dict | None = None
_cache_path: str | None = None
_base_serial = next(_serials)
_stack: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_torch_tune_stack", default=())


def load_table(path: str | None = None) -> dict[str, Plan]:
    """Load (and cache) the table.  Missing file -> empty table."""
    global _cache, _cache_path
    p = path or _DEFAULT_PATH
    if _cache is not None and _cache_path == p:
        return _cache
    entries: dict[str, Plan] = {}
    if os.path.exists(p):
        with open(p) as f:
            raw = json.load(f)
        for k, v in raw.get("entries", {}).items():
            entries[k] = Plan.from_json(v)
    _cache, _cache_path = entries, p
    return entries


def save_table(entries: Mapping[str, Plan], path: str,
               meta: Mapping | None = None) -> None:
    """Write a table as deterministic (sorted-key) JSON."""
    doc = {"meta": dict(meta or {}),
           "entries": {k: entries[k].to_json() for k in sorted(entries)}}
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def invalidate_cache() -> None:
    """Drop the loaded table (the next lookup reads the file again) and
    give the base table a new serial."""
    global _cache, _cache_path, _base_serial
    _cache, _cache_path = None, None
    _base_serial = next(_serials)


def serial() -> int:
    """The serial of the table state this context looks up in: it changes
    whenever what :func:`lookup` answers may change."""
    stack = _stack.get()
    return stack[-1].serial if stack else _base_serial


def lookup(kernel: str, mode: str, dtype: str,
           m: int, k: int, n: int) -> Plan | None:
    """The table's plan for a geometry; ``None`` means the shape rule's."""
    stack = _stack.get()
    if stack:
        top = stack[-1].entries
        if top is None:          # disabled() context
            return None
        return top.get(key(kernel, mode, dtype, m, k, n))
    if _cache is None or _cache_path != _DEFAULT_PATH:
        load_table()
    return _cache.get(key(kernel, mode, dtype, m, k, n))


@contextlib.contextmanager
def _push(entries: dict | None) -> Iterator[None]:
    token = _stack.set(_stack.get() + (_Frame(next(_serials), entries),))
    try:
        yield
    finally:
        _stack.reset(token)


def overrides(entries: Mapping[str, Plan]):
    """Replace the active table with ``entries`` inside the context."""
    return _push(dict(entries))


def disabled():
    """Force the shape rule's plans inside the context."""
    return _push(None)
