"""Multi-pod dry run: every (arch x shape x mesh) cell's real step, run as
its ranks see it on the ``meta`` device (port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell's step (train_step for
train_4k, prefill_step for prefill_32k, serve_step for decode shapes)
against ``ShapeDtypeStruct`` inputs on the production mesh of 512 forced
host devices, and records per device the memory analysis, the HLO's
FLOPs and bytes and the collective bytes.  The port has no compiler to
ask, so it runs the step itself: this process joins a fake world of 256
(single pod) or 512 (multi pod) ranks (``launch.mesh.init_dry_world``:
every collective returns at once and moves nothing), builds the
production mesh over it, and runs the real step of one rank on ``meta``
tensors: the parameters are the rank's blocks (``shard_params`` of
``bridge.abstract``'s whole tree: nothing is initialised), the inputs
``launch.steps.input_specs``, the cache ``init_cache`` under the mesh.
Nothing is computed and no device is needed; the step runs under
``launch.cost.count()``, which gives the record:

  * ``flops``, ``hbm_bytes``, ``collective_bytes``, ``collectives`` (the
    conventions of ``launch/cost.py``), ``bytes_sent`` by kind;
  * ``argument_bytes_per_dev``: the rank's parameters, optimizer state,
    inputs and cache; ``output_bytes_per_dev``: what the step returns
    beyond them; ``temp_bytes_per_dev``: the peak of the storages alive
    at once during the step beyond both (the meta storages' creation and
    release, tracked by weak references); ``peak_bytes_per_dev``: their
    sum, as the reference adds its three;
  * ``run_s`` in place of the reference's ``lower_s``/``compile_s``.

A rank plays any coordinate of the mesh through :class:`RankMesh`, so one
world serves every rank.  Ranks differ (``sharding.k_layout`` deals
uneven k-blocks), so each model coordinate of data coordinate 0 runs and
the record is the rank with the largest ``peak_bytes_per_dev``
(``rank``, with every run rank's peak in ``ranks``); ``--fast`` runs
the first and last model coordinate.  A cell whose step raises naming
``sharding.LM_SLICE`` is not ported yet: it prints ``[not ported:
5(d)(...)]`` with the sub-slice of ROADMAP item 5(d) that raised (the
family's) and is counted apart; any other exception is a ``[FAIL]``.

``--shape cnn_serve`` runs the H-sharded CNN cells (DarkNet-19 and
ResNet-18 on 'pallas_sharded', :data:`CNN_SERVE`) over a fake world of 8
ranks; the ranks of a CNN cell run in threads that take turns (one runs
at a time), because a rank learns H from the others' slab heights
(``sharding.global_h``, :meth:`RankMesh.dry_sizes`).  ``--shape fig12``
walks ROM/SRAM area budgets through ``plan.sweep``/``plan.solve`` (the
paper's Fig. 12), records equal to the reference's.  The reference's
``--no-donate`` has no counterpart: the port donates nothing.

Usage (a host-only tool, as the reference):

  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch yi_34b]
      [--shape decode_32k] [--single-pod|--multi-pod] [--fast]
      [--out out.json]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import threading
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import bridge, configs, deploy, optim
from repro_torch.core import rebranch
from repro_torch.distributed import sharding as shd
from repro_torch.launch import cost
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib

CNN_SERVE = {
    "darknet19": (64, 8),
    "resnet18": (64, 8),
}
CNN_SERVE_DEVICES = 8

# model -> iso-area baseline weight-reload factor (the reference's)
FIG12_MODELS = {"darknet19": 3.0, "resnet18": 1.0, "tiny_yolo": 1.0}

# the sub-slices of ROADMAP item 5(d) a cell still waits for: the
# families (the dense layouts, i, training over the model axis, ii, and
# the moe family's serving and training, iii, are ported)
SUB_SLICES = {"ssm": "5(d)(iv)", "hybrid": "5(d)(iv)", "vlm": "5(d)(v)",
              "audio": "5(d)(v)"}
SIZE_TIMEOUT_S = 120


# ---------------------------------------------------------------------------
# a world and its ranks
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def dry_world(world_size: int):
    """This process as rank 0 of a fake world of ``world_size`` ranks
    (``launch.mesh.init_dry_world``), destroyed on exit."""
    mesh_lib.init_dry_world(0, world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


class _Sizes:
    """The slab sizes the ranks of one line exchange (``global_h``), for
    ranks run side by side in threads that take turns: one thread runs at
    a time (:meth:`turn`), and it hands the turn on only while it waits
    in :meth:`exchange` for the line's other sizes.  So no two ranks' ops
    ever interleave: a fake group takes one ``batch_isend_irecv`` at a
    time (its coalescing state is per group, and every rank's view of the
    mesh shares this process's groups), and storage finalizers and
    warnings are process-wide.

    The ranks cannot simply run one after another: ``global_h`` needs
    the whole H, and a rank's own slab does not fix it (over 4 ranks,
    rank 0 holds 4 rows of any H from 13 to 16), so each rank's forward
    waits at every exchange for the sizes of ranks that have not run
    that far.  The threads are that loop, suspended at the exchanges."""

    def __init__(self):
        self.cond = threading.Condition()
        self.posted = {}
        self.failed = False
        self.busy = False

    def _take(self, ready, what: str):
        """Wait (holding ``cond``) until ``ready()`` and the turn is free,
        then take the turn."""
        if not self.cond.wait_for(
                lambda: (ready() and not self.busy) or self.failed,
                SIZE_TIMEOUT_S):
            raise RuntimeError(f"dry run: {what} timed out")
        if self.failed:
            raise RuntimeError("dry run: another rank failed")
        self.busy = True

    @contextlib.contextmanager
    def turn(self):
        """Run the block as the one thread running."""
        with self.cond:
            self._take(lambda: True, "the turn")
        try:
            yield
        finally:
            with self.cond:
                self.busy = False
                self.cond.notify_all()

    def exchange(self, key, n: int, coord: int, size: int) -> list:
        with self.cond:
            got = self.posted.setdefault(key, {})
            got[coord] = size
            self.busy = False
            self.cond.notify_all()
            self._take(lambda: len(got) == n, f"slab sizes of {key}")
            return [got[q] for q in range(n)]

    def fail(self):
        with self.cond:
            self.failed = True
            self.cond.notify_all()


class RankMesh(mesh_lib.Mesh):
    """``mesh`` as the rank at ``coords`` (axis -> coordinate) sees it: the
    same axes and process groups, this rank's coordinates.  With ``sizes``
    (ranks run side by side in threads) :meth:`dry_sizes` gives
    ``sharding.global_h`` the slab sizes of every rank of a line."""

    def __init__(self, mesh: mesh_lib.Mesh, coords: dict,
                 sizes: _Sizes | None = None):
        super().__init__(mesh.device_mesh, mesh.backend)
        self.coords = {a: int(coords.get(a, 0)) for a in self.axis_names}
        self.rank = 0
        for a in self.axis_names:
            self.rank = self.rank * self.shape[a] + self.coords[a]
        self._sizes = sizes
        self._calls = {}

    def coordinate(self, axis: str) -> int:
        return self.coords[axis]

    def dry_sizes(self, axis: str, size: int) -> list:
        if self._sizes is None:
            raise RuntimeError(f"rank {self.rank} runs alone: no slab sizes "
                               f"of the other ranks on {axis!r}")
        line = tuple(c for a, c in self.coords.items() if a != axis)
        call = self._calls[axis, line] = self._calls.get((axis, line), 0) + 1
        return self._sizes.exchange((axis, line, call), self.shape[axis],
                                    self.coords[axis], size)


def mesh_name(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


# ---------------------------------------------------------------------------
# one rank's step, measured
# ---------------------------------------------------------------------------

def _storages(tree) -> dict:
    """id(storage) -> nbytes of the tensors of ``tree``, each storage once."""
    out = {}
    for t in bridge.flatten(tree).values():
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            out[id(s)] = s.nbytes()
    return out


def measure(fn, args, mesh=None):
    """``fn()`` (a step on ``args``) under ``launch.cost.count()``: (the
    reference's per-device fields of ``analyse_compiled``, the record);
    ``mesh`` None: one device."""
    t0 = time.perf_counter()
    with cost.count() as rec:
        out = fn()
    run_s = time.perf_counter() - t0
    arg = _storages(args)
    outs = [t for t in bridge.flatten(out).values()
            if isinstance(t, torch.Tensor)
            and id(t.untyped_storage()) not in arg]
    out_bytes = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                 for t in outs}
    temp = rec.peak_excluding(
        s for s in (rec.serial_of(t) for t in outs) if s is not None)
    argument, output = sum(arg.values()), sum(out_bytes.values())
    return {
        "mesh": None if mesh is None else mesh_name(mesh),
        "devices": 1 if mesh is None else mesh.size,
        "rank": getattr(mesh, "rank", None),
        "flops": rec["flops"], "hbm_bytes": rec["hbm_bytes"],
        "collective_bytes": rec["collective_bytes"],
        "collectives": rec.summary()["collectives"],
        "bytes_sent": dict(rec["bytes_sent"]),
        "wire_bytes": dict(rec["wire_bytes"]),
        "fallbacks": rec["fallbacks"],
        "kernels": {k: {f: v[f] for f in ("launches", "flops",
                                          "trunk_flops", "bytes")}
                    for k, v in rec["kernels"].items()},
        "argument_bytes_per_dev": argument,
        "output_bytes_per_dev": output,
        "temp_bytes_per_dev": temp,
        "peak_bytes_per_dev": argument + output + temp,
        "run_s": round(run_s, 3),
    }, rec


def whole_params(model):
    """The model's whole parameter tree as meta tensors (no init)."""
    return bridge.abstract(lambda: model.init(seed=0, device="cpu"))


def lm_rank(cfg, kind: str, seq: int, gbatch: int, mesh, whole,
            engine=None) -> dict:
    """One rank's step of an LM cell over ``mesh`` (a :class:`RankMesh`)
    from the ``whole`` meta tree, measured (:func:`measure`).  A train
    cell runs ``launch.steps.make_train_step``'s step as it runs on a
    rank: the rank's rows of the batch of ``gbatch``, ``cfg.remat`` (its
    layers checkpointed; on meta one layer runs for all, its backward and
    recompute counted per layer), the vocab-parallel loss, the
    gradients' reductions and AdamW."""
    model = deploy.compile_model(cfg, engine=engine, mesh=mesh)
    params = model.shard_params(whole)
    specs = steps_lib.input_specs(cfg, seq, gbatch, kind)
    if kind == "train":
        trainable, frozen = rebranch.partition(params)
        args = (trainable, frozen, optim.init(trainable),
                steps_lib.local_batch(cfg, mesh, specs, gbatch))
        step = steps_lib.make_train_step(cfg, model=model,
                                         global_batch=gbatch)

        def run():
            with shd.use_mesh(mesh):
                return step(*args)
        return measure(run, args, mesh)[0]
    if kind == "prefill":
        step = steps_lib.make_prefill_step(cfg, gbatch, seq, model=model,
                                           device="meta")
        args = (params, specs)
    else:
        cache = model.init_cache(gbatch, seq, device="meta")
        step = steps_lib.make_serve_step(cfg, model=model)
        args = (params, specs, cache)
    return measure(lambda: step(*args), args, mesh)[0]


def default_ranks(mesh, fast: bool = False) -> list:
    """Each model coordinate of data (and pod) coordinate 0; ``fast`` the
    first and last."""
    n = mesh.shape.get("model", 1)
    coords = sorted({0, n - 1}) if fast else range(n)
    return [{"model": m} for m in coords]


def lower_cell(arch: str, shape_name: str, mesh, *, fast: bool = False,
               cfg=None, ranks=None, engine=None, seq=None,
               gbatch=None) -> dict:
    """Run one cell's step as each of ``ranks`` (default
    :func:`default_ranks`) on ``mesh`` (a mesh over a dry world); the
    record of the rank with the largest ``peak_bytes_per_dev``, and in
    ``ranks`` every run rank's.  ``cfg``, ``seq``, ``gbatch`` and
    ``engine`` replace the cell's (a smoke config, a cut)."""
    cfg = cfg or configs.get(arch)
    cell = {s: (q, b, k) for s, q, b, k in configs.cells(arch)}
    q, b, kind = cell[shape_name]
    seq, gbatch = seq or q, gbatch or b
    t0 = time.perf_counter()
    whole = None
    per_rank = []
    for coords in ranks or default_ranks(mesh, fast):
        view = RankMesh(mesh, coords)
        if whole is None:
            # the whole tree once (every rank cuts its blocks from it); a
            # family the mesh refuses raises here, before any init
            whole = whole_params(deploy.compile_model(cfg, engine=engine,
                                                      mesh=view))
        per_rank.append(lm_rank(cfg, kind, seq, gbatch, view, whole, engine))
    rec = dict(max(per_rank, key=lambda r: r["peak_bytes_per_dev"]))
    rec.update(arch=arch, shape=shape_name, kind=kind, seq=seq,
               global_batch=gbatch, run_s=round(time.perf_counter() - t0, 1),
               ranks=[{k: r[k] for k in ("rank", "peak_bytes_per_dev",
                                         "argument_bytes_per_dev", "flops",
                                         "collective_bytes", "bytes_sent")}
                      for r in per_rank])
    return rec


# ---------------------------------------------------------------------------
# cnn_serve cells: H-sharded CNN inference on the halo-exchange engine
# ---------------------------------------------------------------------------

def cnn_serve_config(name: str, size: int):
    from repro_torch.core import cim as cim_lib
    from repro_torch.models import cnn as cnn_lib
    spec = dataclasses.replace(rebranch.ReBranchSpec(),
                               trunk_impl="pallas_sharded",
                               cim=cim_lib.CiMConfig(mode="ideal"))
    return cnn_lib.CNNConfig(name=name, input_size=size, rebranch=spec,
                             fuse_bn_act=True)


def lower_cnn_cell(name: str, mesh, *, size=None, gbatch=None) -> dict:
    """One H-sharded CNN forward on 'pallas_sharded' (:data:`CNN_SERVE`,
    or ``size``/``gbatch``), every rank of ``mesh`` in a thread of its
    own, the threads taking turns (:class:`_Sizes`); the record of the
    rank with the largest peak, the halo exchange in ``collectives``'
    collective-permute bytes."""
    s0, b0 = CNN_SERVE.get(name, (None, None))
    size, gbatch = size or s0, gbatch or b0
    cfg = cnn_serve_config(name, size)
    whole = whole_params(deploy.compile_model(cfg))
    x = torch.empty((gbatch, size, size, 3), device="meta")
    sizes = _Sizes()
    names = mesh.axis_names
    results, errors = [None] * mesh.size, []

    def one(r: int):
        coords, rest = {}, r
        for a in reversed(names):
            coords[a], rest = rest % mesh.shape[a], rest // mesh.shape[a]
        try:
            with sizes.turn():
                view = RankMesh(mesh, coords, sizes)
                model = deploy.compile_model(cfg, mesh=view)
                results[r] = measure(lambda: model.forward(whole, x),
                                     (whole, x), view)[0]
        except BaseException as e:        # noqa: BLE001 - re-raised below
            errors.append(e)
            sizes.fail()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(r,))
               for r in range(mesh.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    rec = dict(max(results, key=lambda r: r["peak_bytes_per_dev"]))
    rec.update(arch=name, shape="cnn_serve", kind="cnn_serve", seq=size,
               global_batch=gbatch,
               run_s=round(time.perf_counter() - t0, 1),
               ranks=[{k: r[k] for k in ("rank", "peak_bytes_per_dev",
                                         "flops", "collective_bytes",
                                         "bytes_sent")} for r in results])
    return rec


# ---------------------------------------------------------------------------
# fig12 cells: cost-driven ROM/SRAM placement sweeps (analytic)
# ---------------------------------------------------------------------------

def run_fig12(name: str, fast: bool = False):
    """Budget sweep for one paper CNN: records of the solved placement at
    each area budget (area map + energy ratios), plus the per-site
    residency map at the all-ROM design point."""
    from repro_torch import plan as plan_lib
    from repro_torch.configs.paper_models import PAPER_MODELS

    cfg = PAPER_MODELS[name]
    reload_factor = FIG12_MODELS[name]
    records = []
    points = 3 if fast else 9
    for rec in plan_lib.sweep(cfg, points, reload_factor=reload_factor):
        plan = rec.pop("plan")
        stats = plan.stats(cfg)
        rec.update(
            arch=name, shape="fig12", kind="fig12",
            rom_mbit=round(stats.rom_bits / 1e6, 2),
            branch_mbit=round(stats.branch_bits / 1e6, 2),
            sram_mbit=round(stats.sram_bits / 1e6, 2),
            total_gmacs=round(stats.total_macs / 1e9, 3))
        records.append(rec)
    design = plan_lib.solve(cfg)
    tree = plan_lib.site_tree(cfg)
    records[0]["area_map"] = [
        {"site": s.name, "residency": design.residency(s.name),
         "weights": s.total_weights, "gmacs": round(s.total_macs / 1e9, 3)}
        for s in tree]
    return records


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def sub_slice(arch: str) -> str:
    """The sub-slice of ROADMAP item 5(d) a refused cell waits for: the
    family's, else the layouts' (i)."""
    return SUB_SLICES.get(configs.get(arch).family) or "5(d)(i)"


def _not_ported(e: Exception) -> bool:
    return isinstance(e, NotImplementedError) and "5(d)" in str(e)


def _ok_line(tag: str, rec: dict) -> str:
    return (f"[ok] {tag}: peak={rec['peak_bytes_per_dev'] / 2 ** 30:.2f}"
            f"GiB/dev (rank {rec['rank']}) flops={rec['flops']:.3g} "
            f"hbm={rec['hbm_bytes'] / 2 ** 30:.2f}GiB "
            f"coll={rec['collective_bytes'] / 2 ** 20:.1f}MiB "
            f"(run {rec['run_s']}s, {len(rec['ranks'])} ranks)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="only the 2x16x16 mesh")
    ap.add_argument("--single-pod", action="store_true",
                    help="only the 16x16 mesh")
    ap.add_argument("--out", default=None, help="write JSON records here")
    ap.add_argument("--fast", action="store_true",
                    help="first and last model coordinate; trimmed fig12")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else configs.ALL_ARCHS
    cnn_archs = [a for a in archs if a in CNN_SERVE]
    lm_archs = [a for a in archs if a not in CNN_SERVE
                and args.shape not in ("cnn_serve", "fig12")]
    meshes = []
    if not args.multi_pod:
        meshes.append(("single_pod", False))
    if not args.single_pod:
        meshes.append(("multi_pod", True))

    records, failures, refused = [], [], []
    for name, multi_pod in meshes if lm_archs else ():
        with dry_world(512 if multi_pod else 256):
            mesh = mesh_lib.make_production_mesh(backend=mesh_lib.FAKE,
                                                 multi_pod=multi_pod)
            for arch in lm_archs:
                for shape_name, *_ in configs.cells(arch):
                    if args.shape and shape_name != args.shape:
                        continue
                    tag = f"{arch} x {shape_name} x {name}"
                    try:
                        rec = lower_cell(arch, shape_name, mesh,
                                         fast=args.fast)
                        rec["mesh_name"] = name
                        records.append(rec)
                        print(_ok_line(tag, rec), flush=True)
                    except Exception as e:
                        if not _not_ported(e):
                            failures.append((tag, repr(e)))
                            print(f"[FAIL] {tag}: {e!r}", flush=True)
                            traceback.print_exc()
                            continue
                        sub = sub_slice(arch)
                        refused.append({"arch": arch, "shape": shape_name,
                                        "mesh_name": name, "not_ported": sub,
                                        "error": str(e)})
                        print(f"[not ported: {sub}] {tag}: {e}", flush=True)

    if args.shape in (None, "fig12"):
        fig12_archs = ([args.arch] if args.arch in FIG12_MODELS
                       else [] if args.arch else list(FIG12_MODELS))
        for name in fig12_archs:
            tag = f"{name} x fig12"
            try:
                recs = run_fig12(name, fast=args.fast)
                records.extend(recs)
                lo, hi = recs[0], recs[-1]
                n_sram = ", ".join(
                    f"{r['sram_sites']}/{r['rom_sites'] + r['sram_sites']}"
                    for r in recs)
                print(f"[ok] {tag}: area {lo['area_mm2']}->"
                      f"{hi['area_mm2']}mm2, eff {lo['efficiency_x']}x->"
                      f"{hi['efficiency_x']}x, sram sites [{n_sram}]",
                      flush=True)
            except Exception as e:
                failures.append((tag, repr(e)))
                print(f"[FAIL] {tag}: {e!r}", flush=True)
                traceback.print_exc()

    if args.shape in (None, "cnn_serve"):
        names = cnn_archs if args.arch else list(CNN_SERVE)
        with dry_world(CNN_SERVE_DEVICES) if names else \
                contextlib.nullcontext():
            for name in names:
                tag = f"{name} x cnn_serve x cnn_{CNN_SERVE_DEVICES}dev"
                try:
                    mesh = mesh_lib.make_cnn_serve_mesh(
                        CNN_SERVE_DEVICES, backend=mesh_lib.FAKE)
                    rec = lower_cnn_cell(name, mesh)
                    rec["mesh_name"] = f"cnn_{CNN_SERVE_DEVICES}dev"
                    records.append(rec)
                    print(_ok_line(tag, rec), flush=True)
                except Exception as e:
                    failures.append((tag, repr(e)))
                    print(f"[FAIL] {tag}: {e!r}", flush=True)
                    traceback.print_exc()

    if args.out:
        with open(args.out, "w") as f:
            json.dump(records + refused, f, indent=1)
    print(f"\n{len(records)} records ok, {len(refused)} cells not ported, "
          f"{len(failures)} failed")
    for tag, err in failures:
        print(f"  FAIL {tag}: {err[:200]}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
