"""Per-geometry launch-plan search: the engine behind ``python -m
repro_torch.tune`` (port of ``repro.tune.autotune``).

The three kernel wrappers take a :class:`~repro_torch.tune.table.Plan`
(the trunk's tile height and k-blocks per split; the fused matmul's
sketch's too) and consult the checked-in table whenever the caller passes
none.  This module fills that table on the card: it enumerates the legal
plans of a GEMM geometry (:func:`candidates`), runs each on seeded inputs,
checks its output ``torch.equal`` to the shape rule's plan's (dropping and
counting a mismatch, which would be a kernel fault: a legal plan never
moves a bit), times the survivors (CUDA events over a replayed CUDA graph
of launches that cycle through weight copies past the L2, best of
``repeat``) and records the winners.

Geometries come from the model families' conv sites
(``models.cnn.conv_site_shapes``): each site implies one patch GEMM
``(M, K, N) = (N*OH*OW, KH*KW*C_in, C_out)`` that the ``trunk_conv``,
``cim_matmul`` and ``rebranch_matmul`` kernels key on, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math

import torch

from repro_torch.kernels import tiling
from repro_torch.tune import table as tune_table
from repro_torch.tune.table import Plan

ROWS = 128                      # CiMConfig.rows_per_subarray default
# the activation dtype each kernel keys on at a conv site
DTYPES = {"trunk_conv": "float32", "cim_matmul": "int8",
          "rebranch_matmul": "float32"}
# The shape rule's plan of each kernel: the baseline every candidate is
# held to, and the plan a geometry keeps unless another one wins.
KERNEL_DEFAULTS = {name: functools.partial(tiling.rule_plan, name)
                   for name in tiling.TUNED_KERNELS}
L2_BYTES = 50 << 20             # H100 L2; timed weights cycle through 2.5x
MAX_COPIES = 8                  # weight copies cycled at most
MIN_LAUNCHES = 8                # launches per timed graph at least
MARGIN = 0.03                   # a plan replaces the rule's only if it is
                                # this much faster (else: timing noise)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One tunable kernel invocation shape (a table key plus the conv
    metadata needed to rebuild representative inputs)."""

    kernel: str                 # trunk_conv, cim_matmul or rebranch_matmul
    mode: str                   # CiM fidelity mode
    dtype: str                  # activation dtype the kernel keys on
    m: int
    k: int
    n: int
    # trunk_conv only: (kernel size, c_in, c_out, input hw, stride, batch)
    conv: tuple | None = None

    @property
    def key(self) -> str:
        return tune_table.key(self.kernel, self.mode, self.dtype,
                              self.m, self.k, self.n)

    @property
    def cdim(self) -> int:
        """The sketch width of a fused-matmul geometry: K // 4, as the
        JAX package's runner compresses."""
        return max(1, self.k // 4)

    def rule(self) -> Plan:
        return KERNEL_DEFAULTS[self.kernel](self.mode, self.m, self.k,
                                            self.n, cdim=self.cdim)


# ---------------------------------------------------------------------------
# candidate enumeration
# ---------------------------------------------------------------------------

def split_pers(units: int) -> list[int]:
    """Units per split, one per distinct split count (one split first)."""
    out, seen = [], set()
    for s in range(1, units + 1):
        per = -(-units // s)
        if -(-units // per) not in seen:
            seen.add(-(-units // per))
            out.append(per)
    return out


def sketch_pers(k: int, rows: int = ROWS) -> list[int]:
    """Sub-blocks per sketch split that obey ``split_sketch``'s rule (one
    sub-block, or whole k-blocks), one per distinct split count."""
    n_sub = -(-k // rows)
    spk = tiling.block_k(k, rows) // rows
    out, seen = [], set()
    for per in (1, *range(spk, n_sub, spk), n_sub):
        if -(-n_sub // per) not in seen:
            seen.add(-(-n_sub // per))
            out.append(per)
    return out


def candidates(kernel: str, mode: str, m: int, k: int, n: int, *,
               dtype: str | None = None, rows: int = ROWS,
               cdim: int | None = None, fast: bool = True) -> list[Plan]:
    """The legal plans of one geometry, the shape rule's first, then every
    other one with a distinct effective grid: tile heights x split counts
    (x sketch splits for the fused matmul).  ``fast`` sweeps the fused
    matmul's trunk splits at every height pair with the rule's sketch
    split, and the sketch splits at the rule's heights and trunk split,
    instead of the whole product."""
    dtype = dtype or DTYPES[kernel]
    cdim = cdim if cdim is not None else max(1, k // 4)
    default = tiling.rule_plan(kernel, mode, m, k, n, rows, cdim)
    trunk = split_pers(len(tiling.k_partition(k, rows)))
    out = [default]
    if kernel != "rebranch_matmul":
        out += [Plan(tm, per) for tm in tiling.trunk_heights(mode)
                for per in trunk]
    else:
        pairs = tiling.height_pairs(mode, dtype, m)
        sketch = sketch_pers(k, rows)
        if fast:
            out += [Plan(tm, per, tms, default.sub_per_split)
                    for tm, tms in pairs for per in trunk]
            out += [Plan(default.tile_m, default.kb_per_split,
                         default.sketch_tile_m, sp) for sp in sketch]
        else:
            out += [Plan(tm, per, tms, sp) for tm, tms in pairs
                    for per in trunk for sp in sketch]
    uniq = list(dict.fromkeys(out))
    assert all(tiling.plan_legal(kernel, mode, dtype, m, k, n, rows, p)
               for p in uniq)
    return uniq


# ---------------------------------------------------------------------------
# geometry enumeration from the model families' conv sites
# ---------------------------------------------------------------------------

def conv_geometries(models: tuple[str, ...], sizes: tuple[int, ...],
                    modes: tuple[str, ...], kernels: tuple[str, ...],
                    batches: tuple[int, ...] = (1,)) -> list[Geometry]:
    """Deduplicated tunable geometries over the families' conv sites: the
    JAX package's enumeration, key for key.  ``batches`` enumerates
    serving batch sizes (the patch GEMM's M axis is batch*OH*OW)."""
    from repro_torch.models import cnn       # deferred: heavy import

    geoms: dict[str, Geometry] = {}
    for name, size, batch in itertools.product(models, sizes, batches):
        cfg = cnn.CNNConfig(name=name, input_size=size)
        for _, kk, c_in, c_out, out_hw, stride in cnn.conv_site_shapes(cfg):
            m, kdim = batch * out_hw * out_hw, kk * kk * c_in
            if m == 0:
                continue        # pooled below 1px at this input size
            conv = (kk, c_in, c_out, out_hw * stride, stride, batch)
            for mode, kernel in itertools.product(modes, tiling.TUNED_KERNELS):
                if kernel in kernels:
                    g = Geometry(kernel, mode, DTYPES[kernel], m, kdim,
                                 c_out, conv=conv)
                    geoms.setdefault(g.key, g)
    return list(geoms.values())


# ---------------------------------------------------------------------------
# measurement (on the card)
# ---------------------------------------------------------------------------

def _runner(geom: Geometry, device):
    """(fn, args, used): ``fn(*a)`` runs ``geom``'s kernel wrapper on
    seeded inputs on ``device`` under the ambient table context, ``args``
    cycle through weight copies past the L2 (at most ``MAX_COPIES``), and
    ``used()`` is the plan the last launch carried to the kernel."""
    from repro_torch.core import cim as cim_lib
    from repro_torch.kernels import cim_matmul as cm
    from repro_torch.kernels import rebranch_conv as rc
    from repro_torch.kernels import rebranch_matmul as rm

    cfg = cim_lib.CiMConfig(mode=geom.mode)
    gen = torch.Generator(device=device).manual_seed(0)
    k, n = geom.k, geom.n

    def weights(nbytes, make):
        copies = max(1, min(MAX_COPIES, math.ceil(2.5 * L2_BYTES / nbytes)))
        return [make() for _ in range(copies)]

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=device,
                             dtype=torch.int8)

    if geom.kernel == "trunk_conv":
        kk, c_in, c_out, hw, stride, batch = geom.conv
        x = torch.randn((batch, hw, hw, c_in), generator=gen, device=device)
        args = [(w,) for w in weights(k * n,
                                      lambda: int8(kk, kk, c_in, c_out))]
        return ((lambda w: rc.trunk_conv_dot(x, w, stride, "SAME", cfg)),
                args, lambda: cm.launched_plan(rc.last_launch))
    if geom.kernel == "cim_matmul":
        xq = int8(geom.m, k)
        args = [(w,) for w in weights(k * n, lambda: int8(k, n))]
        return ((lambda w: cm.cim_matmul(xq, w, cfg)), args,
                lambda: cm.launched_plan(cm.last_launch))
    if geom.kernel == "rebranch_matmul":
        cdim = geom.cdim
        x = torch.randn((geom.m, k), generator=gen, device=device).to(
            getattr(torch, geom.dtype))
        args = weights(k * n + 4 * k * cdim, lambda: (
            int8(k, n),
            torch.randn((k, cdim), generator=gen, device=device) / k ** .5))
        return ((lambda w, c: rm.rebranch_trunk_sketch(x, w, c, cfg)), args,
                lambda: rm.launched_plan(rm.last_launch))
    raise ValueError(f"unknown tunable kernel {geom.kernel!r}")


def time_best(fn, args: list, repeat: int):
    """(output of ``fn(*args[0])``, best ms per launch): one eager pass
    over ``args`` warms, then ``MIN_LAUNCHES`` or more launches cycling
    through ``args`` are captured in one CUDA graph and replayed
    ``repeat`` times, each replay timed with CUDA events (the device's
    time; the host's per-call cost is left out)."""
    out = fn(*args[0])
    for a in args[1:]:
        fn(*a)
    torch.cuda.synchronize()
    reps = len(args) * -(-MIN_LAUNCHES // len(args))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*args[i % len(args)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = math.inf
    for _ in range(max(1, repeat)):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    del graph
    return out, best


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@dataclasses.dataclass(frozen=True)
class TuneResult:
    geometry: Geometry
    best: Plan
    best_ms: float
    default_ms: float
    n_candidates: int
    n_mismatched: int           # candidates dropped by the bit check

    @property
    def changed(self) -> bool:
        return self.best != self.geometry.rule()

    @property
    def speedup(self) -> float:
        return self.default_ms / max(self.best_ms, 1e-12)


def tune_geometry(geom: Geometry, *, repeat: int = 3, fast: bool = True,
                  device=None) -> TuneResult:
    """Search one geometry on the card: run, check and time every legal
    candidate; a plan other than the rule's wins only by ``MARGIN``.
    Raises if a launch carried another plan than the one asked for (a
    stale plan cache would time the default under every name)."""
    device = device or torch.device("cuda", torch.cuda.current_device())
    fn, args, used = _runner(geom, device)

    def run(plan: Plan):
        out, ms = time_best(fn, args, repeat)
        if used() != plan:
            raise RuntimeError(f"{geom.key}: asked for {plan}, the kernel "
                               f"launched {used()}")
        return out, ms

    default = geom.rule()
    with tune_table.disabled():
        ref, default_ms = run(default)
    cands = candidates(geom.kernel, geom.mode, geom.m, geom.k, geom.n,
                       dtype=geom.dtype, cdim=geom.cdim, fast=fast)
    best, best_ms, mismatched = default, default_ms, 0
    for cand in cands[1:]:
        with tune_table.overrides({geom.key: cand}):
            out, ms = run(cand)
        if not _equal(ref, out):
            mismatched += 1     # not bit-identical: never tabulated
        elif ms < best_ms:
            best, best_ms = cand, ms
        del out
    if best_ms > default_ms * (1 - MARGIN):
        best, best_ms = default, default_ms
    del fn, args, ref
    torch.cuda.empty_cache()
    return TuneResult(geom, best, best_ms, default_ms,
                      n_candidates=len(cands), n_mismatched=mismatched)


def describe(plan: Plan) -> str:
    text = f"tile_m={plan.tile_m} kb_per_split={plan.kb_per_split}"
    if plan.sketch_tile_m is not None:
        text += (f" sketch_tile_m={plan.sketch_tile_m} "
                 f"sub_per_split={plan.sub_per_split}")
    return text


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


# ---------------------------------------------------------------------------
# whole-table generation + consistency check
# ---------------------------------------------------------------------------

def tune_table_for(models: tuple[str, ...], sizes: tuple[int, ...],
                   modes: tuple[str, ...], kernels: tuple[str, ...], *,
                   batches: tuple[int, ...] = (1,), repeat: int = 3,
                   fast: bool = True, log=None,
                   device=None) -> tuple[dict[str, Plan], dict]:
    """(entries, meta) for the conv-site geometries of ``models``, tuned on
    the card; raises if any candidate's bits differ from the rule's."""
    geoms = conv_geometries(models, sizes, modes, kernels, batches)
    entries: dict[str, Plan] = {}
    for i, geom in enumerate(geoms):
        res = tune_geometry(geom, repeat=repeat, fast=fast, device=device)
        if res.n_mismatched:
            raise RuntimeError(f"{geom.key}: {res.n_mismatched} legal "
                               f"plans moved a bit (a kernel fault)")
        entries[geom.key] = res.best
        if log is not None:
            log(f"[{i + 1}/{len(geoms)}] {geom.key}: {describe(res.best)}"
                f"{' (rule)' if not res.changed else ''}  "
                f"{res.best_ms:.4f} ms vs rule {res.default_ms:.4f} ms "
                f"({res.speedup:.3f}x, {res.n_candidates} cands, "
                f"{res.n_mismatched} dropped)")
    meta = {"models": sorted(models), "sizes": sorted(sizes),
            "modes": sorted(modes), "kernels": sorted(kernels),
            "batches": sorted(batches), "repeat": int(repeat),
            "fast": bool(fast), "margin": MARGIN, "device": card(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    return entries, meta


META_REQUIRED = ("models", "sizes", "modes", "kernels", "batches", "device")


def check_table(path: str | None = None, log=print) -> bool:
    """Is the table consistent with the current site shapes?

    Recomputes the expected key set from the table's own meta (models x
    sizes x modes x kernels x batches) and checks that (a) every expected
    geometry has an entry (MISSING), (b) no entry is stale (STALE), (c)
    every entry is a legal plan for its geometry (ILLEGAL), and (d) the
    meta names the enumeration and the card.  Static: no kernel runs, so
    it works on the CPU."""
    import json
    import os

    p = path or tune_table._DEFAULT_PATH
    if not os.path.exists(p):
        log(f"tuning table missing: {p}")
        return False
    with open(p) as f:
        doc = json.load(f)
    meta = doc.get("meta", {})
    if not all(meta.get(f) for f in META_REQUIRED):
        log(f"table meta incomplete (need {META_REQUIRED}): {sorted(meta)}")
        return False
    geoms = conv_geometries(tuple(meta["models"]),
                            tuple(int(s) for s in meta["sizes"]),
                            tuple(meta["modes"]), tuple(meta["kernels"]),
                            tuple(int(b) for b in meta["batches"]))
    expected = {g.key: g for g in geoms}
    ok = True
    for key in sorted(set(expected) - set(doc.get("entries", {}))):
        log(f"MISSING entry for current site geometry: {key}")
        ok = False
    for key, raw in sorted(doc.get("entries", {}).items()):
        if key not in expected:
            log(f"STALE entry (geometry no longer enumerated): {key}")
            ok = False
            continue
        g = expected[key]
        try:
            plan = Plan.from_json(raw)
        except (KeyError, TypeError, ValueError) as e:
            log(f"ILLEGAL entry for {key}: {raw} ({e})")
            ok = False
            continue
        if not tiling.plan_legal(g.kernel, g.mode, g.dtype, g.m, g.k, g.n,
                                 ROWS, plan):
            log(f"ILLEGAL plan {describe(plan)} for {key} (a tile height "
                f"the kernel does not compile, or splits off k-blocks)")
            ok = False
    if ok:
        log(f"tuning table OK: {len(doc['entries'])} entries cover "
            f"{len(expected)} current site geometries ({meta['device']})")
    return ok
