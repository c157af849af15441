"""Branch training over a mesh of ``torch.distributed`` ranks against the
JAX package and the port's own unsharded steps, on the CPU.

One spawned world of 4 gloo ranks (``_torch_world.train_world``, started
once for the module; the JAX references compile in this process
meanwhile) holds:
  * the 'pallas_sharded' engine's trunk conv's STE dx and the plain
    sharded conv's dx (and its dw, summed over the data ranks) on meshes
    2x2 and 4x1 at the reference's ``SWEEP`` geometries and three maps
    the halo does not fit (gathered), within 1e-4 of the absmax of the
    reference's ``jax.vjp`` of the unsharded dequantised conv (the
    reference test's tolerance);
  * one CNN step on (pod 2, data 2, model 1) with 3 images: dense VGG-8
    (every conv trainable; its head follows a gather), its mean-reduced
    gradients within 1e-5 of each leaf's absmax of the port's unsharded
    step on the whole batch; VGG-8 and DarkNet-19 at 32 px (five trunk
    convs gathered) with their branches, to the whole quantised step's
    tolerance (see that test); the reduced gradients and the state after
    the update bitwise equal on every rank;
  * the data-parallel LM step (``gemma_2b`` smoke over (4, 1), 8 x 16
    tokens, 2 rows a rank): loss within 1e-5 relative and gradients
    within 1e-5 of each leaf's absmax of the port's single-process step;
    the compressed mean within 0.05 of the absmax of the plain one (the
    reference test's bound); the first loss within 1e-3 of the JAX
    package's single-device step (``test_torch_train.py``'s tolerance);
  * ``all_reduce_int8`` over 4 ranks against the reference's under
    ``jax.vmap(..., axis_name=...)`` within 1e-6 of the absmax, bitwise
    equal on every rank;
  * elastic restore: a single-process save restored with ``shardings=``
    on (data 2, model 2), every rank's block bitwise equal to the saved
    leaf's;
  * ``launch/train.py --compress`` inside the world, with ``--resume``.
The rest needs no world: the fault logic, ``quantize_with_feedback``
bitwise, and the sharding specs equal to the reference's on abstract
meshes.

The reference's own multi-device tests fail here (jax 0.9's
``shard_map`` refuses ``check_rep``), so its unsharded functions on the
whole batch are the oracles.
"""

import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_world as world
from repro import configs as jconfigs
from repro import optim as joptim
from repro.core import rebranch as jrebranch
from repro.data import synthetic as jsyn
from repro.distributed import fault as jfault
from repro.launch import steps as jsteps
from repro.optim import compress as jcompress
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import deploy as tdeploy
from repro_torch import engine as tengine
from repro_torch import optim as toptim
from repro_torch.checkpoint import manager as tckpt
from repro_torch.core import rebranch as trebranch
from repro_torch.data import synthetic as tsyn
from repro_torch.distributed import fault as tfault
from repro_torch.distributed import sharding as tshd
from repro_torch.kernels import halo_conv as thalo
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as tsteps
from repro_torch.optim import compress as tcompress

WORLD = 4
DEADLINE_S = 240
STE_REL = 1e-4
STEP_REL = 1e-5
COMPRESS_REL = 5e-2
LOSS_REL = 1e-3
COSINE = 0.95


def _close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


def _cosine(a, b) -> float:
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    if not a.any() and not b.any():
        return 1.0
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# ---------------------------------------------------------------------------
# the world and the references computed beside it
# ---------------------------------------------------------------------------

@functools.cache
def _lm_params():
    """gemma-2b smoke from the port's init (the JAX package's eager init
    takes seconds), seeded non-zero cores, as numpy for both packages."""
    tm = tdeploy.compile_model(tconfigs.get_smoke("gemma_2b"))
    return world.with_cores(bridge.to_numpy(tm.init(seed=0, device="cpu")),
                            np.random.default_rng(1))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(each rank's results, the saved checkpoint's leaves, the JAX first
    loss): the world runs in a thread while the JAX step compiles."""
    root = tmp_path_factory.mktemp("dist_train")
    params = _lm_params()
    tp = bridge.to_torch(params, "cpu")
    t, _ = trebranch.partition(tp)
    opt = toptim.init(t)
    gen = torch.Generator().manual_seed(5)
    opt = bridge.tree_map(opt, lambda v: torch.randn(
        v.shape, generator=gen) if v.dim() else v + 7)
    tckpt.save(str(root / "ck"), 7, t, opt, tp)
    torch.save(tp, root / "lm.pt")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(mesh_lib.spawn, world.train_world, WORLD,
                              backend="gloo", deadline_s=DEADLINE_S,
                              args=(str(root / "lm.pt"), str(root / "ck"),
                                    str(root / "cli")))
        jax_loss = _jax_first_loss(params)
        for case in world.STE_CASES:
            _jax_ste(*case)
        for case in world.TRAIN_CASES:
            _cnn_whole(*case)
        _lm_whole()
        ranks = spawned.result()
    return ranks, (bridge.flatten(t), bridge.flatten(opt)), jax_loss


def _lm_batch(package):
    cfg = jconfigs.get_smoke("gemma_2b")
    kw = dict(seed=0, vocab_size=cfg.vocab_size, seq_len=world.LM_SEQ,
              global_batch=world.LM_BATCH)
    if package == "jax":
        return jsyn.markov_batch(jsyn.DataConfig(**kw), 0)
    return tsyn.markov_batch(tsyn.DataConfig(**kw), 0, device="cpu")


def _jax_first_loss(params) -> float:
    cfg = jconfigs.get_smoke("gemma_2b")
    t, f = jrebranch.partition(jax.tree.map(jnp.asarray, params))
    step = jax.jit(jsteps.make_train_step(cfg, joptim.AdamWConfig(lr=1e-3),
                                          loss_chunks=2))
    _, _, metrics = step(t, f, joptim.init(t), _lm_batch("jax"))
    return float(metrics["loss"])


@functools.cache
def _lm_whole():
    """(loss, grads) of the port's single-process LM step on the whole
    batch."""
    cfg = tconfigs.get_smoke("gemma_2b")
    model = tdeploy.compile_model(cfg, engine="pallas")
    t, f = trebranch.partition(bridge.to_torch(_lm_params(), "cpu"))
    step = tsteps.make_train_step(cfg, toptim.AdamWConfig(lr=1e-3),
                                  loss_chunks=2, model=model)
    loss, grads = step.grads(t, f, _lm_batch("torch"))
    return float(loss), {k: v.numpy() for k, v in
                         bridge.flatten(grads).items()}


@functools.cache
def _cnn_whole(name, dense):
    """(loss, grads) of the port's unsharded 'pallas' step on the whole
    batch."""
    params, x, y = world.train_cnn_case(name, dense)
    model = tdeploy.compile_model(world._cnn_cfg(name, dense),
                                  engine="pallas")
    t, f = trebranch.partition(bridge.to_torch(params, "cpu"))
    loss, grads = tsteps.value_and_grad(
        lambda tt: world.regression_loss(model)(
            trebranch.combine(tt, f),
            {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}), t)
    return float(loss), {k: v.numpy() for k, v in
                         bridge.flatten(grads).items()}


# ---------------------------------------------------------------------------
# the fault logic (pure)
# ---------------------------------------------------------------------------

def _table(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 24))
    hosts = [dict(host_id=i, last_heartbeat_s=float(rng.uniform(0, 100)),
                  last_step_time_s=float(rng.choice(
                      [0.0, rng.uniform(0.5, 1.5), rng.uniform(2, 5)],
                      p=[0.1, 0.8, 0.1])),
                  is_spare=bool(rng.random() < 0.15)) for i in range(n)]
    cfg = dict(heartbeat_timeout_s=float(rng.uniform(20, 90)),
               straggler_factor=float(rng.uniform(1.5, 3)),
               min_data_parallel=int(rng.integers(1, 5)))
    return hosts, cfg, int(rng.integers(1, 4)), rng


def _fault_case(pkg, seed):
    hosts, cfg, per_row, rng = _table(seed)
    c = pkg.FaultConfig(**cfg)
    hs = [pkg.HostState(**h) for h in hosts]
    dead = pkg.dead_hosts(hs, 100.0, c)
    slow = pkg.stragglers(hs, c)
    failed = sorted(set(dead) | set(slow))
    plan = pkg.plan_remesh(hs, failed, 8, per_row, c)
    shards = pkg.reassign_data_shards(
        13, list(plan.surviving_hosts) or [0])
    return dead, slow, dataclasses.astuple(plan), shards


SEEDS = range(40)


@pytest.mark.parametrize("seed", SEEDS)
def test_fault_logic_equals_the_reference(seed):
    assert _fault_case(tfault, seed) == _fault_case(jfault, seed)


def test_fault_sweep_reaches_every_action():
    """'swap_spares', 'shrink' and 'abort' all occur (the reference's
    'none' is never returned by its ``plan_remesh`` either)."""
    actions = {_fault_case(tfault, s)[2][-1] for s in SEEDS}
    assert actions == {"swap_spares", "shrink", "abort"}
    assert [f.name for f in dataclasses.fields(tfault.RemeshPlan)] == \
        [f.name for f in dataclasses.fields(jfault.RemeshPlan)]


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,shape,scale", [
    (0, (8, 64), 1e-3), (1, (3, 5, 7), 10.0), (2, (129,), 1e-30),
    (3, (4, 4), 0.0)])
def test_quantize_with_feedback_bitwise(seed, shape, scale):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=shape) * scale).astype(np.float32)
    err = (rng.normal(size=shape) * scale * 0.01).astype(np.float32)
    want = jcompress.quantize_with_feedback(jnp.asarray(g), jnp.asarray(err))
    got = tcompress.quantize_with_feedback(torch.from_numpy(g),
                                           torch.from_numpy(err))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_all_reduce_int8_matches_the_reference_over_4_ranks(run):
    ranks, _, _ = run
    gs = np.stack(world.compress_grads())
    red, err = jax.vmap(lambda g, e: jcompress.all_reduce_int8(g, e, "d"),
                        axis_name="d")(jnp.asarray(gs),
                                       jnp.zeros_like(jnp.asarray(gs)))
    for r in ranks:
        np.testing.assert_array_equal(r["compress"][0], ranks[0]["compress"][0])
        _close(r["compress"][0], red[r["rank"]], 1e-6)
        _close(r["compress"][1], err[r["rank"]], 1e-6)
    _close(ranks[0]["compress"][0], gs.mean(0), COMPRESS_REL)


def test_init_error_state_mirrors_the_trainable_tree():
    t = {"a": {"sram": {"core": torch.ones(2, 3)}}, "b": None,
         "c": [torch.ones(4, dtype=torch.bfloat16)]}
    e = tcompress.init_error_state(t)
    assert e["b"] is None and e["c"][0].dtype == torch.float32
    assert torch.equal(e["a"]["sram"]["core"], torch.zeros(2, 3))


# ---------------------------------------------------------------------------
# the sharding half of launch/steps.py (pure)
# ---------------------------------------------------------------------------

ABSTRACT = [((4, 2), ("data", "model")), ((16, 16), ("data", "model")),
            ((2, 16, 16), ("pod", "data", "model")),
            ((1, 4), ("data", "model"))]


def _meshes(shape, names):
    return (jax.sharding.AbstractMesh(shape, names),
            mesh_lib.AbstractMesh(shape, names))


def _jax_named(specs) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    return {jax.tree_util.keystr(p): tuple(s) for p, s in leaves}


def _torch_named(specs) -> dict:
    out = {}

    def walk(node, prefix):
        if isinstance(node, tshd.PartitionSpec):
            out[prefix] = tuple(node)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}[{k!r}]")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}[{i}]")
    walk(specs, "")
    return out


@pytest.mark.parametrize("shape,names", ABSTRACT)
@pytest.mark.parametrize("arch", jconfigs.ALL_ARCHS)
def test_cell_batch_and_cache_specs_equal_the_reference(arch, shape, names):
    """Over every (arch x shape) cell of ``configs.cells``: the inputs'
    batch spec and, for the serving kinds, every cache leaf's spec."""
    jm, tm = _meshes(shape, names)
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    assert tconfigs.cells(arch) == jconfigs.cells(arch)
    for cell, seq, gb, kind in tconfigs.cells(arch):
        assert tconfigs.SHAPES[cell] == (seq, gb, kind)
        assert tsteps.batch_pspec(tcfg, tm, gb) == \
            jsteps.batch_pspec(jcfg, jm, gb)
        specs = tsteps.input_specs(tcfg, seq, gb, kind)
        b = jsteps.batch_pspec(jcfg, jm, gb)
        for k, sh in tsteps.batch_shardings(tcfg, tm, specs, gb).items():
            want = (b, *[None] * (specs[k].dim() - 1))
            assert sh.mesh is tm and tuple(sh.spec) == want, (cell, k)
        if kind == "train":
            continue
        want = _jax_named(jsteps.cache_pspecs(
            jcfg, jm, jsteps.cache_specs(jcfg, gb, seq)))
        tree = tsteps.cache_specs(tcfg, gb, seq)
        assert _torch_named(tsteps.cache_pspecs(tcfg, tm, tree)) == want
        assert {k: tuple(v.spec) for k, v in bridge.flatten(
            tsteps.cache_shardings(tcfg, tm, tree)).items()} == want


def test_model_state_shardings_equal_the_reference():
    shape, names = (2, 2), ("data", "model")
    jm, tm = _meshes(shape, names)
    jcfg, tcfg = jconfigs.get_smoke("gemma_2b"), tconfigs.get_smoke(
        "gemma_2b")
    jt, jf, jo, jshapes = jsteps.model_state_shardings(jcfg, jm)
    tt, tf, to, tshapes = tsteps.model_state_shardings(tcfg, tm)
    is_ns = lambda s: isinstance(s, jax.sharding.NamedSharding)

    def jnamed(tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_ns)
        return {jax.tree_util.keystr(p): tuple(s.spec) for p, s in leaves
                if s is not None}

    def tnamed(tree):
        return {k: tuple(v.spec) for k, v in bridge.flatten(tree).items()}

    for j, t in ((jt, tt), (jf, tf), (jo, to)):
        assert tnamed(t) == jnamed(j)
        assert all(v.mesh is tm for v in bridge.flatten(t).values())
    assert any(tnamed(tt).values()) and any(tnamed(tf).values())
    assert {k: tuple(v.shape) for k, v in bridge.flatten(tshapes).items()} \
        == {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
            jax.tree_util.tree_flatten_with_path(jshapes)[0]}


class Ranked(mesh_lib.AbstractMesh):
    """An abstract mesh that says one rank's coordinates."""

    def __init__(self, shape, names, coords):
        super().__init__(shape, names)
        self.coords = coords

    def coordinate(self, axis):
        return self.coords[axis]


def test_block_bounds_are_gspmds_uneven_blocks():
    m = Ranked((2, 3), ("data", "model"), {"data": 1, "model": 2})
    sh = tshd.NamedSharding(m, tshd.P(("data", "model"), None, "model"))
    # dim 0: 13 rows over 6 blocks of 3, block 1*3+2 = 5; dim 2: 7 over 3
    assert tshd.block_bounds((13, 4, 7), sh) == [(13, 13), (0, 4), (6, 7)]
    x = torch.arange(20 * 7).reshape(20, 7)
    sh = tshd.NamedSharding(m, tshd.P("data", "model"))
    assert torch.equal(tshd.local_block(x, sh), x[10:20, 6:7])


def test_param_shardings_pair_each_spec_with_its_mesh():
    tm = mesh_lib.AbstractMesh((2, 2))
    tree = bridge.abstract(lambda: tdeploy.compile_model(
        tconfigs.get_smoke("gemma_2b")).init(seed=0, device="cpu"))
    specs = _torch_named(tshd.param_specs(tree, tm))
    got = {k: (v.mesh, tuple(v.spec)) for k, v in
           bridge.flatten(tshd.param_shardings(tree, tm)).items()}
    assert got == {k: (tm, s) for k, s in specs.items()}
    assert any(specs.values())


def test_a_model_axis_over_1_and_the_lm_axes_still_raise():
    """Over a model axis the dense family trains (here one rank's step of
    a fake (2, 2) world on ``meta``, ``launch.dryrun``); the ssm family's
    train step still raises naming ROADMAP item 5(d) (the moe family
    trains over a mesh since ``test_torch_moe_tp_train.py``)."""
    step = tsteps.BranchStep(lambda p, b: p["w"].sum())
    t = {"w": torch.ones(2)}
    ssm = tdeploy.compile_model(tconfigs.get_smoke("falcon_mamba_7b"))
    st, sf = trebranch.partition(bridge.abstract(
        lambda: ssm.init(seed=0, device="cpu")))
    ssm_step = tsteps.make_train_step(ssm.cfg, model=ssm)
    with tshd.use_mesh(mesh_lib.AbstractMesh((2, 2))):
        with pytest.raises(NotImplementedError, match=r"item 5\(d\)"):
            ssm_step.grads(st, sf, {})
        with pytest.raises(NotImplementedError, match=r"item 5\(d\)"):
            tshd.shard(torch.zeros(2, 4, 4, 3), "ssm_inner")
    with dryrun.dry_world(4):
        mesh = mesh_lib.make_mesh((2, 2), backend=mesh_lib.FAKE)
        rec = dryrun.lower_cell("gemma_2b", "train_4k", mesh,
                                cfg=tconfigs.get_smoke("gemma_2b"),
                                ranks=[{"data": 1, "model": 1}], seq=16,
                                gbatch=8)
    assert rec["flops"] > 0 and rec["bytes_sent"]["reduce_adjoint"] > 0
    with tshd.use_mesh(mesh_lib.AbstractMesh((1, 1))):
        loss, g = step.grads(t, {"w": None}, {})    # one rank: no reduce
    assert float(loss) == 2.0 and torch.equal(g["w"], torch.ones(2))
    assert tengine.get("pallas_sharded").capabilities.grads


# ---------------------------------------------------------------------------
# the world: sharded STE
# ---------------------------------------------------------------------------

@functools.cache
def _jax_ste(k, s, h):
    from repro.core.rebranch import conv_nhwc
    x, w_q, w_scale, g = world.ste_case(k, s, h)
    w = jnp.asarray(w_q).astype(jnp.float32) * jnp.asarray(w_scale)
    _, vjp = jax.vjp(lambda xx, ww: conv_nhwc(xx, ww, s, "SAME"),
                     jnp.asarray(x), w)
    dx, dw = vjp(jnp.asarray(g))
    return np.asarray(dx), np.asarray(dw)


def test_ste_cases_fit_and_fall_back():
    """Each mesh's cases hold maps the halo fits and maps it does not."""
    for n in (2, 4):
        fits = {thalo.plan_halo(h, k, s, "SAME", n) is not None
                for k, s, h in world.STE_CASES}
        assert fits == {True, False}


@pytest.mark.parametrize("k,s,h", world.STE_CASES)
@pytest.mark.parametrize("shape", world.STE_MESHES)
def test_sharded_ste_dx_matches_jax_grad(run, shape, k, s, h):
    ranks, _, _ = run
    want_dx, want_dw = _jax_ste(k, s, h)
    for r in ranks:
        trunk_dx, plain_dx, dw = r["ste"][shape, k, s, h]
        _close(trunk_dx, want_dx, STE_REL, "trunk dx")
        _close(plain_dx, want_dx, STE_REL, "plain dx")
        _close(dw, want_dw, STE_REL, "plain dw summed over data")
        np.testing.assert_array_equal(
            trunk_dx, ranks[0]["ste"][shape, k, s, h][0])


# ---------------------------------------------------------------------------
# the world: the sharded CNN step and the data-parallel LM step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,dense", world.TRAIN_CASES)
def test_sharded_cnn_step_matches_the_unsharded_step(run, name, dense):
    """Dense: 1e-5 of each leaf's absmax.  With the branches the CPU holds
    ``test_torch_train.py``'s ResNet-18 branch-step tolerances (loss 1e-3
    relative, each gradient leaf a cosine of 0.95): the CPU's
    ``F.conv2d`` is neither batch- nor slab-invariant (VGG-8's forward
    moves 4.1e-3 of its absmax between a 3-image batch and its images one
    by one, 1.6e-3 under an H-only split), and an ulp moved before a
    per-row quantiser moves an int8 code.  Each trunk conv's STE is held
    tightly above; the card holds the ReBranch step at 1e-5
    (``chip_smoke.py`` phase 31)."""
    ranks, _, _ = run
    loss, grads = _cnn_whole(name, dense)
    got = ranks[0]["cnn"][name, dense]
    assert set(got["grads"]) == set(grads)
    if dense:
        assert abs(got["loss"] - loss) <= STEP_REL * abs(loss)
        for k, g in grads.items():
            _close(got["grads"][k], g, STEP_REL, k)
    else:
        assert abs(got["loss"] - loss) <= LOSS_REL * abs(loss)
        for k, g in grads.items():
            assert _cosine(got["grads"][k], g) >= COSINE, k
    assert any(np.abs(g).max() > 0 for g in grads.values())
    for r in ranks:
        assert r["cnn"][name, dense]["digests"] == got["digests"]
        # the engine counts its own gathered trunks (a dense model's
        # gathered convs are plain ones)
        assert r["cnn"][name, dense]["fallbacks"] == (
            5 if name == "darknet19" and not dense else 0)
        assert r["cnn"][name, dense]["loss"] == got["loss"]
    sent = {k for r in ranks for k, v in
            r["cnn"][name, dense]["traffic"].items() if v}
    assert {"halo", "halo_adjoint", "gather", "gather_adjoint"} <= sent


def test_data_parallel_lm_step_matches_the_single_process_step(run):
    ranks, _, jax_loss = run
    loss, grads = _lm_whole()
    plain = ranks[0]["lm"][False]
    assert abs(plain["loss"] - loss) <= STEP_REL * abs(loss)
    assert plain["step_loss"] == plain["loss"]
    for k, g in grads.items():
        _close(plain["grads"][k], g, STEP_REL, k)
    assert abs(loss - jax_loss) <= LOSS_REL * abs(jax_loss)
    tokens = _lm_batch("torch")["tokens"][:, 0].tolist()
    for r in ranks:
        assert r["lm"]["rows"] == tokens[2 * r["rank"]:2 * r["rank"] + 2]
        for compressed in (False, True):
            assert r["lm"][compressed]["digests"] == \
                ranks[0]["lm"][compressed]["digests"]


def test_compressed_lm_step_is_within_the_references_bound(run):
    ranks, _, _ = run
    plain, packed = ranks[0]["lm"][False], ranks[0]["lm"][True]
    for k, g in plain["grads"].items():
        _close(packed["grads"][k], g, COMPRESS_REL, k)
    assert packed["loss"] == plain["loss"]
    n_grad = sum(g.size for g in plain["grads"].values())
    leaves = len(plain["grads"])
    # the plain mean packs the loss with the gradients: one f32 each
    assert plain["wire"] == {"f32": 4 * (n_grad + 1)}
    assert packed["wire"] == {"int8": n_grad + 4 * leaves, "f32": 4}


# ---------------------------------------------------------------------------
# the world: elastic restore and the train CLI
# ---------------------------------------------------------------------------

def test_elastic_restore_gives_each_rank_its_block(run):
    ranks, (saved_t, saved_o), _ = run
    tcfg = tconfigs.get_smoke("gemma_2b")
    split = set()
    for r in ranks:
        res = r["restore"]
        assert res["step"] == 7
        mesh = Ranked(world.RESTORE_MESH, ("data", "model"), res["coord"])
        t_sh, _, _, _ = tsteps.model_state_shardings(tcfg, mesh)
        t_sh = bridge.flatten(t_sh)
        for k, leaf in saved_t.items():
            bounds = tshd.block_bounds(tuple(leaf.shape), t_sh[k])
            assert res["bounds"][k] == bounds
            cut = tuple(slice(a, b) for a, b in bounds)
            np.testing.assert_array_equal(res["t"][k], leaf.numpy()[cut])
            for part in ("m", "v"):
                name = f"[{part!r}]{k}"
                np.testing.assert_array_equal(res["o"][name],
                                              saved_o[name].numpy()[cut])
            if res["t"][k].shape != tuple(leaf.shape):
                split.add(k)
        np.testing.assert_array_equal(res["o"]["['step']"],
                                      saved_o["['step']"].numpy())
    assert split, "no leaf was split over the model axis"


def test_train_cli_in_the_world_compresses_and_resumes(run):
    ranks, _, _ = run
    first, more, steps = ranks[0]["cli"]
    assert len(first) == 2 and len(more) == 1 and steps == [1, 2, 3]
    assert np.isfinite(first + more).all()
    for r in ranks[1:]:
        assert r["cli"] == ranks[0]["cli"]
