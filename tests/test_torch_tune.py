"""The port's launch-plan tuning (``repro_torch.tune``) on the CPU: the
table's mechanics against the JAX package's ``repro.tune.table``, the
conv-site enumeration key for key against ``repro.tune.autotune``, the
legality guard of ``kernels.tiling.resolve_plan``, the plan each kernel
wrapper's launch struct carries (the stale-cache trap), the static check
of the checked-in ``hopper_table.json``, and the ``tune=`` policy of
``deploy.compile_model`` and the registry.

No model forward runs through JAX here; the CPU forwards are the port's
(plain versions, which take no plan).
"""

import json
import shutil
import threading

import numpy as np
import pytest
import torch

from repro.kernels.tiling import k_partition as ref_k_partition
from repro.tune import autotune as ref_autotune
from repro_torch import deploy
from repro_torch.core import cim
from repro_torch.kernels import cim_matmul as cm
from repro_torch.kernels import rebranch_conv as rc
from repro_torch.kernels import rebranch_matmul as rm
from repro_torch.kernels import tiling
from repro_torch.models import cnn
from repro_torch.scenario import branch as branch_lib
from repro_torch.serve import registry
from repro_torch.tune import autotune, table
from repro_torch.tune.table import Plan

MODES = ("ideal", "per_subarray", "bitserial")
KERNELS = ("trunk_conv", "cim_matmul", "rebranch_matmul")
FAMILIES = ("darknet19", "resnet18", "tiny_yolo", "vgg8")
QUIET = dict(log=lambda *a, **k: None)


# ---------------------------------------------------------------------------
# table mechanics
# ---------------------------------------------------------------------------

def test_round_trip_is_deterministic(tmp_path):
    entries = {table.key("cim_matmul", "ideal", "int8", 64, 576, 64):
               Plan(64, 1),
               table.key("rebranch_matmul", "bitserial", "bfloat16", 8, 2048,
                         256): Plan(16, 2, 8, 1)}
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    table.save_table(entries, str(a), meta={"models": ["x"]})
    table.save_table(dict(reversed(list(entries.items()))), str(b),
                     meta={"models": ["x"]})
    assert a.read_text() == b.read_text()
    try:
        assert table.load_table(str(a)) == entries
    finally:
        table.invalidate_cache()
    # the key format is the JAX package's, letter for letter
    assert table.key("trunk_conv", "ideal", "float32", 8, 256, 8) == \
        "trunk_conv|ideal|float32|8x256x8"


def test_lookup_unseen_key_is_none():
    assert table.lookup("cim_matmul", "ideal", "int8", 3, 5, 7) is None


def test_overrides_and_disabled_stack():
    """The JAX package's ``TestTable.test_overrides_and_disabled_stack``
    sequence, with a Plan."""
    k = table.key("trunk_conv", "ideal", "float32", 8, 256, 8)
    t = Plan(16, 1)
    with table.overrides({k: t}):
        assert table.lookup("trunk_conv", "ideal", "float32",
                            8, 256, 8) == t
        with table.disabled():
            assert table.lookup("trunk_conv", "ideal", "float32",
                                8, 256, 8) is None
        assert table.lookup("trunk_conv", "ideal", "float32",
                            8, 256, 8) == t
    assert table.lookup("trunk_conv", "ideal", "float32", 8, 256, 8) is None


def test_override_stack_is_per_thread():
    k = table.key("trunk_conv", "ideal", "float32", 8, 256, 8)
    seen = {}
    inside, release = threading.Event(), threading.Event()

    def other():
        with table.disabled():
            seen["disabled_serial"] = table.serial()
            inside.set()
            release.wait(10)

    th = threading.Thread(target=other)
    with table.overrides({k: Plan(16, 1)}):
        th.start()
        inside.wait(10)
        # the other thread's disabled() does not reach this one
        assert table.lookup("trunk_conv", "ideal", "float32",
                            8, 256, 8) == Plan(16, 1)
        assert table.serial() != seen["disabled_serial"]
        release.set()
        th.join()
        out = []
        t2 = threading.Thread(target=lambda: out.append(
            table.lookup("trunk_conv", "ideal", "float32", 8, 256, 8)))
        t2.start()
        t2.join()
    assert out == [None]           # nor does this thread's override reach it


@pytest.mark.parametrize("bad", [
    dict(tile_m=48, kb_per_split=1), dict(tile_m=64, kb_per_split=0),
    dict(tile_m=64, kb_per_split=1, sketch_tile_m=32, sub_per_split=1),
    dict(tile_m=16, kb_per_split=1, sketch_tile_m=8),
    dict(tile_m=16, kb_per_split=True)])
def test_plan_validation(bad):
    with pytest.raises(ValueError):
        Plan(**bad)
    raw = {k: v for k, v in bad.items() if v is not None}
    with pytest.raises(ValueError):
        Plan.from_json(raw)
    with pytest.raises(ValueError):
        Plan.from_json({"tile_m": 16, "kb_per_split": 1, "block_k": 512})


# ---------------------------------------------------------------------------
# enumeration parity and legality
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", (32, 416))
@pytest.mark.parametrize("family", FAMILIES)
def test_conv_geometries_match_the_reference_key_for_key(family, size):
    args = ((family,), (size,), MODES, KERNELS, (1, 8))
    got = autotune.conv_geometries(*args)
    want = ref_autotune.conv_geometries(*args)
    assert [g.key for g in got] == [g.key for g in want]
    assert [g.conv for g in got] == [g.conv for g in want]


def _legal_case_geoms():
    geoms = autotune.conv_geometries(("tiny_yolo", "resnet18"), (32,), MODES,
                                     KERNELS, (1, 8))
    # and the LM's shapes: Gemma-2B's linears at decode and prefill rows
    for m in (1, 8, 16, 128):
        for k, n in ((2048, 2048), (2048, 256), (16384, 2048)):
            for mode in MODES:
                geoms.append(autotune.Geometry("rebranch_matmul", mode,
                                               "bfloat16", m, k, n))
                geoms.append(autotune.Geometry("cim_matmul", mode, "int8",
                                               m, k, n))
    return geoms


def test_every_candidate_is_legal_on_the_reference_partition():
    n_cands = 0
    for g in _legal_case_geoms():
        blocks = tiling.k_partition(g.k, autotune.ROWS)
        assert blocks == ref_k_partition(g.k, 512, autotune.ROWS)
        bounds = {b[0] for b in blocks} | {g.k}
        subs = set(range(0, g.k, autotune.ROWS)) | {g.k}
        cands = autotune.candidates(g.kernel, g.mode, g.m, g.k, g.n,
                                    dtype=g.dtype, cdim=g.cdim)
        assert cands[0] == g.rule()
        assert len(set(cands)) == len(cands)
        for p in cands:
            n_cands += 1
            assert tiling.plan_legal(g.kernel, g.mode, g.dtype, g.m, g.k,
                                     g.n, autotune.ROWS, p)
            sp = tiling.trunk_split(p, g.m, g.n, g.k, autotune.ROWS)
            assert sp.tile_m in tiling.trunk_heights(g.mode)
            # every split starts on a k-block boundary of the partition
            starts = {blocks[s][0] for s in range(0, sp.n_kblocks,
                                                   sp.kb_per_split)}
            assert starts <= bounds and len(starts) == sp.n_splits
            if p.sketch_tile_m is not None:
                ss = tiling.sketch_split(p, g.m, g.cdim, g.k, autotune.ROWS)
                cuts = {min(i * ss.sub_per_split * autotune.ROWS, g.k)
                        for i in range(ss.n_splits)}
                assert cuts <= (subs if ss.sub_per_split == 1 else bounds)
                assert (p.tile_m, p.sketch_tile_m) in tiling.height_pairs(
                    g.mode, g.dtype, g.m)
    assert n_cands > 500


def test_candidates_cover_distinct_grids():
    # K = 4608: 9 k-blocks -> split counts 1, 2, 3, 5, 9 at both heights
    cands = autotune.candidates("cim_matmul", "ideal", 8, 4608, 512)
    grids = {(p.tile_m, -(-9 // p.kb_per_split)) for p in cands}
    assert grids == {(tm, s) for tm in (16, 64) for s in (1, 2, 3, 5, 9)}
    full = autotune.candidates("rebranch_matmul", "ideal", 64, 4608, 512,
                               fast=False)
    fast = autotune.candidates("rebranch_matmul", "ideal", 64, 4608, 512)
    assert set(fast) < set(full)
    # a bf16 x at M <= 16 is read as bf16: no 64-row (f32 only) pair
    bf = autotune.candidates("rebranch_matmul", "ideal", 8, 2048, 2048,
                             dtype="bfloat16", fast=False)
    assert {p.tile_m for p in bf} == {16}


def test_resolve_plan_guard_and_explicit_plan():
    m, k, n = 8, 4608, 512                # 9 k-blocks, 36 sub-blocks
    rule = tiling.rule_plan("rebranch_matmul", "ideal", m, k, n, 128, 1152)
    key_r = table.key("rebranch_matmul", "ideal", "bfloat16", m, k, n)
    key_c = table.key("cim_matmul", "bitserial", "int8", m, k, n)
    illegal = [
        (key_r, Plan(64, 1, 64, 4)),       # tall pair with a bf16 x, M <= 16
        (key_r, Plan(16, 1, 8, 2)),        # 2 sub-blocks: inside a k-block
        (key_r, Plan(16, 10, 8, 4)),       # more k-blocks than there are
        (key_r, Plan(16, 1)),              # no sketch plan
        (key_c, Plan(64, 1)),              # 64 rows: not in bitserial
        (key_c, Plan(16, 1, 8, 1)),        # a sketch plan on kernel 4
    ]
    for key, bad in illegal:
        kernel, mode, dtype = key.split("|")[:3]
        with table.overrides({key: bad}):
            got = tiling.resolve_plan(kernel, mode, dtype, m, k, n, 128,
                                      cdim=1152)
        assert got == tiling.rule_plan(kernel, mode, m, k, n, 128, 1152)
        with pytest.raises(ValueError, match="not a legal plan"):
            tiling.resolve_plan(kernel, mode, dtype, m, k, n, 128, bad,
                                cdim=1152)
    good = Plan(16, 3, 16, 8)
    with table.overrides({key_r: good}):
        assert tiling.resolve_plan("rebranch_matmul", "ideal", "bfloat16",
                                   m, k, n, 128, cdim=1152) == good
        # an explicit plan wins outright over the table
        assert tiling.resolve_plan("rebranch_matmul", "ideal", "bfloat16",
                                   m, k, n, 128, rule, cdim=1152) == rule
    assert tiling.resolve_plan("rebranch_matmul", "ideal", "bfloat16", m, k,
                               n, 128, cdim=1152) == rule


# ---------------------------------------------------------------------------
# the launch structs under overrides (the stale-cache trap)
# ---------------------------------------------------------------------------

def _launch_plans(kernel, geom, cfg):
    """(plan, scratch floats) each wrapper's launch helper makes for geom
    under the ambient table context."""
    if kernel == "cim_matmul":
        launch, floats = cm._launch(geom.m, geom.k, geom.n, cfg)
        return cm.launched_plan(launch), floats
    if kernel == "trunk_conv":
        kk, c_in, c_out, hw, stride, batch = geom.conv
        launch, floats = rc.conv_launch((batch, hw, hw, c_in),
                                        (kk, kk, c_in, c_out), stride,
                                        "SAME", cfg)
        return cm.launched_plan(launch), floats
    launch, ft, fs = rm._launch(geom.m, geom.k, geom.n, geom.cdim, cfg,
                                geom.dtype == "bfloat16")
    return rm.launched_plan(launch), (ft, fs)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("mode", MODES)
def test_wrappers_launch_the_override_plan(kernel, mode):
    cfg = cim.CiMConfig(mode=mode)
    geoms = [g for g in autotune.conv_geometries(
        ("tiny_yolo",), (32,), (mode,), (kernel,), (1, 8))]
    checked = 0
    entries = table.load_table()
    for g in geoms:
        rule = g.rule()
        before = _launch_plans(kernel, g, cfg)     # fills the plan cache
        assert before[0] == entries.get(g.key, rule)
        for cand in autotune.candidates(kernel, mode, g.m, g.k, g.n,
                                        dtype=g.dtype, cdim=g.cdim):
            with table.overrides({g.key: cand}):
                plan, floats = _launch_plans(kernel, g, cfg)
                with table.disabled():
                    assert _launch_plans(kernel, g, cfg)[0] == rule
            assert plan == cand
            # the scratch is sized from the plan launched
            sp = tiling.trunk_split(cand, g.m, g.n, g.k, 128)
            want = sp.scratch_floats(g.m, g.n)
            if kernel == "rebranch_matmul":
                ss = tiling.sketch_split(cand, g.m, g.cdim, g.k, 128)
                want = (want, ss.scratch_floats(g.m, g.cdim))
            assert floats == want
            checked += 1
        assert _launch_plans(kernel, g, cfg) == before
    assert checked >= len(geoms)


def test_without_an_entry_the_rule_is_launched():
    """A geometry the table does not hold (Gemma-2B's decode linears)
    launches the shape rule's plans, as before the table existed."""
    cfg = cim.CiMConfig(mode="ideal")
    assert table.lookup("cim_matmul", "ideal", "int8", 8, 16384, 2048) \
        is None
    launch, _ = cm._launch(8, 16384, 2048, cfg)
    assert cm.launched_plan(launch) == Plan(
        tiling.split_k(8, 2048, 16384).tile_m,
        tiling.split_k(8, 2048, 16384).kb_per_split)
    launch, _, _ = rm._launch(8, 16384, 2048, 4096, cfg, True)
    assert rm.launched_plan(launch) == tiling.rule_plan(
        "rebranch_matmul", "ideal", 8, 16384, 2048, 128, 4096)


def test_explicit_plan_reaches_the_launch():
    cfg = cim.CiMConfig(mode="ideal")
    launch, floats = cm._launch(8, 4608, 512, cfg, Plan(64, 3))
    assert cm.launched_plan(launch) == Plan(64, 3)
    assert launch.plan.n_splits == 3 and floats == 9 * 8 * 512
    launch, _ = rc.conv_launch((1, 4, 4, 512), (3, 3, 512, 64), 1, "SAME",
                               cfg, Plan(16, 9))
    assert cm.launched_plan(launch) == Plan(16, 9)
    launch, _, fs = rm._launch(8, 4608, 512, 1152, cfg, False,
                               Plan(64, 9, 64, 1))
    assert rm.launched_plan(launch) == Plan(64, 9, 64, 1)
    assert launch.sketch.n_splits == 36 and fs == 36 * 8 * 1152


# ---------------------------------------------------------------------------
# the checked-in table
# ---------------------------------------------------------------------------

def test_checked_in_table_passes_the_check():
    assert autotune.check_table(**QUIET)
    meta = json.load(open(table._DEFAULT_PATH))["meta"]
    assert "H100" in meta["device"] and meta["device"].endswith("W")
    assert {"darknet19", "resnet18", "tiny_yolo"} <= set(meta["models"])
    assert {32, 416} <= set(meta["sizes"]) and {1, 8} <= set(meta["batches"])


def _broken_copies(tmp_path):
    doc = json.load(open(table._DEFAULT_PATH))
    key = sorted(doc["entries"])[0]
    ideal = next(k for k in sorted(doc["entries"])
                 if k.startswith("cim_matmul|bitserial|"))

    def edit(fn):
        d = json.loads(json.dumps(doc))
        fn(d)
        return d

    yield "MISSING", edit(lambda d: d["entries"].pop(key))
    yield "STALE", edit(lambda d: d["entries"].__setitem__(
        "cim_matmul|ideal|int8|3x5x7", {"tile_m": 16, "kb_per_split": 1}))
    yield "ILLEGAL", edit(lambda d: d["entries"].__setitem__(
        ideal, {"tile_m": 64, "kb_per_split": 1}))
    yield "ILLEGAL", edit(lambda d: d["entries"].__setitem__(
        ideal, {"tile_m": 16, "kb_per_split": 1, "block_k": 512}))
    yield "meta incomplete", edit(lambda d: d["meta"].pop("device"))
    yield "meta incomplete", edit(lambda d: d["meta"].pop("models"))


def test_check_table_fails_on_broken_copies(tmp_path):
    path = tmp_path / "hopper_table.json"
    shutil.copy(table._DEFAULT_PATH, path)
    assert autotune.check_table(str(path), **QUIET)
    for what, doc in _broken_copies(tmp_path):
        path.write_text(json.dumps(doc))
        lines = []
        assert not autotune.check_table(str(path), log=lines.append), what
        assert any(what in line for line in lines), (what, lines)


def test_cli_check(tmp_path, capsys):
    from repro_torch.tune.__main__ import main
    assert main(["--check"]) == 0
    bad = tmp_path / "t.json"
    bad.write_text(json.dumps({"meta": {}, "entries": {}}))
    assert main(["--check", "--out", str(bad)]) == 1
    if not torch.cuda.is_available():
        assert main([]) == 2        # timing needs the card
    capsys.readouterr()


# ---------------------------------------------------------------------------
# compile_model(tune=), the engines, the registry
# ---------------------------------------------------------------------------

def test_compile_model_tune_gate():
    """The JAX package's ``test_compile_model_tune_gate``."""
    cfg = cnn.CNNConfig(name="vgg8", num_classes=13, input_size=16)
    for engine in ("int8_native", "dequant"):
        with pytest.raises(ValueError, match="tune=True"):
            deploy.compile_model(cfg, engine=engine, tune=True)
        assert deploy.compile_model(cfg, engine=engine,
                                    tune=False).tune is False
    for engine in ("pallas", "pallas_fused"):
        assert deploy.compile_model(cfg, engine=engine,
                                    tune=True).tune is True
    assert deploy.compile_model(cfg, engine="pallas").tune is None
    with pytest.raises(TypeError):
        deploy.compile_model(cfg, mesh=object())       # not a mesh


def test_tune_false_pins_the_rule_for_every_call():
    cfg = cnn.CNNConfig(name="vgg8", num_classes=13, input_size=16)
    key = table.key("trunk_conv", "ideal", "float32", 256, 27, 64)
    seen = []
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, 16, 3), dtype=np.float32))
    outs = {}
    for tune in (None, False):
        model = deploy.compile_model(cfg, engine="pallas", tune=tune)
        apply = model._apply

        def spy(params, batch, c, apply=apply):
            seen.append((tune, table.lookup("trunk_conv", "ideal",
                                            "float32", 256, 27, 64)))
            return apply(params, batch, c)

        model._apply = spy
        params = model.init(seed=0, device="cpu")
        with table.overrides({key: Plan(16, 1)}):
            outs[tune] = model.forward(params, x)
    assert seen == [(None, Plan(16, 1)), (False, None)]
    assert torch.equal(outs[None], outs[False])


def test_registry_forwards_tune():
    cfg = cnn.CNNConfig(name="vgg8", num_classes=13, input_size=16)
    ids = {True: "vgg8-tune-on-test", False: "vgg8-tune-off-test"}
    for tune, mid in ids.items():
        registry.register(registry.ModelEntry(
            model_id=mid, config=lambda: cfg, engine="pallas", tune=tune),
            override=True)
    registry.register(registry.ModelEntry(
        model_id="vgg8-tune-bad-test", config=lambda: cfg, engine="dequant",
        tune=True), override=True)
    try:
        plans = {}
        for tune, mid in ids.items():
            model, plans[tune] = registry.compile_entry(mid)
            assert model.tune is tune
        # tuning moves no bit, so it is in no fingerprint
        assert branch_lib.plan_fingerprint(plans[True]) == \
            branch_lib.plan_fingerprint(plans[False])
        with pytest.raises(ValueError, match="tune=True"):
            registry.compile_entry("vgg8-tune-bad-test")
    finally:
        for mid in (*ids.values(), "vgg8-tune-bad-test"):
            registry.evict(mid)
            registry._REGISTRY.pop(mid, None)


def test_engine_capabilities_tune():
    from repro_torch import engine
    assert engine.get("pallas").capabilities.tune
    assert engine.get("pallas_fused").capabilities.tune
    assert not engine.get("int8_native").capabilities.tune
    assert not engine.get("dequant").capabilities.tune
