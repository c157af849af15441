"""The moe family served over a ``(data, model)`` mesh of
``torch.distributed`` ranks against the JAX package and the port's own
unsharded steps, on the CPU.

One spawned world of 4 gloo ranks (``_torch_world.moe_tp_world``,
started once for the module; the JAX references and the port's
unsharded steps run in this process meanwhile, on one thread as a rank
does) serves the cases of ``_torch_world.MOE_TP_CASES`` under
``int8_native``, ``pallas`` and ``pallas_fused`` (the plain kernel
versions), one per expert layout of ``sharding.expert_layout``:
Granite-MoE's smoke config (E 8) on (1, 4) and (2, 2), whole experts a
rank; Qwen2-MoE's (E 6, ff 64) on (1, 4), each expert's ff columns, with
its shared experts' MLP (ff 128); the same with ff 66, every expert
whole on every rank.

Held:
  * the steps (8 rows, prompts of 8, ``max_len`` 32, a prefill and 4
    greedy serve steps) against the port's unsharded steps and, under
    ``int8_native``, against the JAX package's unsharded
    ``make_prefill_step`` / ``make_serve_step``: logits within
    ``test_torch_moe.py``'s whole-model 5e-2 of the absmax, tokens
    agreeing in >= 99% of (row, step) pairs; every rank bitwise equal;
  * the expert_mlp down trunk (``moe.row_parallel_trunk``: rows quantised
    at the whole row's absmax, int32 partials added in rank order)
    bitwise the unsharded ``int8_bmm`` at the smoke model's ff and at
    Qwen2-MoE's 1408 over 4 (row sums past 2**24);
  * every rank-order sum of the block (the expert layout's partial
    outputs, the expert_mlp trunk and branch) bitwise a plain rank-order
    sum of the ranks' parts;
  * the routing groups are the whole batch's: at capacity 4 with a router
    skewed onto expert 0, 6 rows over (2, 2) and 8 over (4, 1) (prefill
    groups and every decode group spanning data ranks) drop the
    one-process run's choices, call by call, and give its tokens; the
    data ranks' rows run alone (their own groups) give other logits;
  * the dry run (``launch.dryrun``: each rank's serve step on ``meta``
    over a fake world) sends each rank's bytes of the world's last serve
    step, kind by kind, under ``pallas_fused`` and ``pallas``;
  * the shared experts' MLP runs at its own width (not ``cfg.d_ff``).
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
from repro import deploy as jdeploy
from repro.launch import steps as jsteps
from repro_torch import bridge
from repro_torch import deploy as tdeploy
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as tmoe

from test_torch_tp import _At

WORLD = 4
DEADLINE_S = 240
LOGITS_REL = 5e-2     # whole models: test_torch_moe.py's tolerance
AGREE = 0.99          # tokens, the reference's sharded-decode threshold
JAX_CONFIGS = ("granite_moe_3b", "qwen2_moe_a2_7b", "qwen2_moe_ff66")
CASES = world.MOE_TP_CASES


def _close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


def _jax_cfg(name):
    t = world.moe_tp_config(name)
    return dataclasses.replace(
        jconfigs.get_smoke(t.name.removesuffix("_smoke")),
        moe_d_ff=t.moe_d_ff, moe_capacity_factor=t.moe_capacity_factor)


@functools.cache
def _tree(name):
    return world.moe_tp_tree(name)


def _jax_steps(name):
    """The JAX package's unsharded prefill and 4 greedy serve steps on the
    port's tree."""
    cfg = _jax_cfg(name)
    model = jdeploy.compile_model(cfg, engine="int8_native")
    params = jax.tree.map(jnp.asarray, _tree(name))
    prefill = jax.jit(jsteps.make_prefill_step(
        cfg, world.TP_BATCH, world.TP_MAX_LEN, model=model))
    serve = jax.jit(jsteps.make_serve_step(cfg, model=model))
    logits, cache = prefill(params, {"tokens": jnp.asarray(
        world.tp_prompts(cfg.vocab_size))})
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks = [tok]
    for _ in range(world.TP_STEPS):
        tok, cache = serve(params, {"tokens": tok}, cache)
        toks.append(tok)
    return np.asarray(logits), np.asarray(jnp.concatenate(toks, 1))


def _rows_alone(name, batch, rows):
    """A skew case's prefill logits of ``rows`` of its ``batch`` prompts
    run alone, unsharded (the routing groups of those rows only)."""
    cfg = world.moe_tp_config(name)
    model = tdeploy.compile_model(cfg, engine="pallas_fused")
    prompts = world.tp_prompts(cfg.vocab_size, batch)
    lo, hi = rows
    logits, _ = tsteps.make_prefill_step(
        cfg, hi - lo, world.TP_MAX_LEN, model=model, device="cpu")(
            bridge.to_torch(_tree(name), "cpu"),
            {"tokens": torch.from_numpy(prompts[lo:hi])})
    return logits.numpy()


@pytest.fixture(scope="module")
def run():
    """(each rank's results, the JAX references, the port's unsharded
    steps, the skew case's one-process run and rows run alone)."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(mesh_lib.spawn, world.moe_tp_world, WORLD,
                              backend="gloo", deadline_s=DEADLINE_S)
        refs = {name: _jax_steps(name) for name in JAX_CONFIGS}
        threads = torch.get_num_threads()
        torch.set_num_threads(1)      # as a rank runs: the same GEMM bits
        try:
            whole = {}
            for name in dict.fromkeys(n for n, _ in CASES):
                tree = bridge.to_torch(_tree(name), "cpu")
                for engine in world.TP_ENGINES:
                    whole[name, engine] = world.tp_steps(
                        world.moe_tp_config(name), tree, None, engine)[0]
            name, skew = world.MOE_SKEW, {}
            for shape, batch in world.MOE_SKEW_CASES:
                skew[shape] = world.moe_tp_run(
                    name, bridge.to_torch(_tree(name), "cpu"), None,
                    "pallas_fused", batch=batch)
                skew[shape]["alone"] = [
                    _rows_alone(name, batch, r)
                    for r in tshd.h_layout(batch, shape[0])]
        finally:
            torch.set_num_threads(threads)
        ranks = spawned.result()
    return ranks, refs, whole, skew


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,shape", CASES, ids=str)
def test_each_case_takes_its_expert_layout(run, name, shape):
    for r in run[0]:
        for engine in world.TP_ENGINES:
            assert r["runs"][name, shape, engine]["layout"] == \
                world.MOE_TP_LAYOUTS[name]


@pytest.mark.parametrize("name,shape", [(n, s) for n, s in CASES
                                        if n in JAX_CONFIGS], ids=str)
def test_sharded_moe_steps_match_the_reference_unsharded(run, name, shape):
    ranks, refs, _, _ = run
    want_logits, want_toks = refs[name]
    logits, toks = ranks[0]["runs"][name, shape, "int8_native"]["steps"]
    _close(logits, want_logits, LOGITS_REL, f"{name} {shape}")
    assert float(np.mean(toks == want_toks)) >= AGREE


@pytest.mark.parametrize("engine", world.TP_ENGINES)
@pytest.mark.parametrize("name,shape", CASES, ids=str)
def test_sharded_moe_steps_match_the_ports_unsharded(run, name, shape,
                                                     engine):
    ranks, _, whole, _ = run
    logits, toks = ranks[0]["runs"][name, shape, engine]["steps"]
    w_logits, w_toks = whole[name, engine]
    _close(logits, w_logits, LOGITS_REL, f"{name} {shape} {engine}")
    assert float(np.mean(toks == w_toks)) >= AGREE


@pytest.mark.parametrize("name,shape", CASES, ids=str)
def test_every_rank_returns_the_same_bits(run, name, shape):
    ranks = run[0]
    for engine in world.TP_ENGINES:
        first = ranks[0]["runs"][name, shape, engine]["steps"]
        for r in ranks[1:]:
            got = r["runs"][name, shape, engine]["steps"]
            np.testing.assert_array_equal(got[0], first[0])
            np.testing.assert_array_equal(got[1], first[1])


# ---------------------------------------------------------------------------
# the block's sums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["qwen2_moe_a2_7b", *world.MOE_TRUNK_FF],
                         ids=str)
def test_expert_mlp_down_trunk_is_the_unsharded_trunk(run, key):
    for r in run[0]:
        got = r["trunk"][key]
        assert got["equal"] and got["dtype"] == "torch.int32", key
        if key == 1408:
            assert got["past_f32"]        # an f32 exchange would round


@pytest.mark.parametrize("name,shape", CASES, ids=str)
def test_the_blocks_sums_are_rank_order_sums(run, name, shape):
    """A prefill (its sums onto the rank's sequence chunk under seq_sp)
    and a decode step of every case: each sum bitwise ``rank_sum`` of the
    ranks' parts; the whole layout sums nothing."""
    for r in run[0]:
        n, equal = r["runs"][name, shape, "pallas_fused"]["sums"]
        assert equal, (name, shape)
        assert (n > 0) == (world.MOE_TP_LAYOUTS[name] != "whole")


@pytest.mark.parametrize("shape,batch", world.MOE_SKEW_CASES, ids=str)
def test_routing_groups_are_the_whole_batchs(run, shape, batch):
    """The data ranks drop, call by call, the choices the one-process run
    drops (some in groups spanning ranks), and give its tokens; the
    logits within the whole-model tolerance (the expert layout's sums
    reassociate).  The data ranks' rows run alone, in groups of their
    own, would give other logits."""
    ranks, _, _, skew = run
    one = skew[shape]
    want_logits, want_toks = one["steps"]
    assert sum(one["drops"]) > 0
    data_ranks = [r["skew"][shape] for r in ranks[::shape[1]]]
    assert [sum(c) for c in zip(*(x["drops"] for x in data_ranks))] == \
        one["drops"]
    for r in ranks:
        logits, toks = r["skew"][shape]["steps"]
        np.testing.assert_array_equal(toks, want_toks)
        _close(logits, want_logits, LOGITS_REL)
    joined = np.concatenate(one["alone"])
    assert not np.allclose(joined, want_logits, rtol=0,
                           atol=1e-3 * np.abs(want_logits).max())


@pytest.mark.parametrize("engine", ["pallas_fused", "pallas"])
@pytest.mark.parametrize("name,shape", CASES, ids=str)
def test_the_dry_run_sends_each_ranks_bytes_of_a_serve_step(run, name,
                                                             shape, engine):
    """The moe cases of ``test_torch_tp.py``'s test of this name: the serve
    step run per rank on ``meta`` over a fake world sends, rank by rank
    and kind by kind, the bytes the gloo world's ranks sent (the routing
    counts' gather included)."""
    ranks = run[0]
    cfg = world.moe_tp_config(name)
    with dryrun.dry_world(WORLD):
        mesh = world.tp_mesh(shape, mesh_lib.FAKE)
        coords = [dict(zip(mesh.axis_names, np.unravel_index(r, shape)))
                  for r in range(WORLD)]
        rec = dryrun.lower_cell(
            cfg.name.removesuffix("_smoke"), "decode_32k", mesh, cfg=cfg,
            ranks=coords, engine=engine, seq=world.TP_MAX_LEN,
            gbatch=world.TP_BATCH)
    sent = [r["runs"][name, shape, engine]["bytes"] for r in ranks]
    assert [r["bytes_sent"] for r in rec["ranks"]] == sent
    if shape[0] > 1:                      # the decode group spans data ranks
        assert all(s.get("routing", 0) > 0 for s in sent)


# ---------------------------------------------------------------------------
# no world
# ---------------------------------------------------------------------------

def test_shared_experts_mlp_takes_its_own_width(monkeypatch):
    """Qwen2-MoE's shared MLP is ``num_shared_experts * moe_d_ff`` wide
    (128 in the smoke config, whose d_ff is 64): its layout over a model
    axis (``sharding.linear_tp``) is asked at that width, so a rank's
    columns match its parameter block."""
    cfg = world.moe_tp_config("qwen2_moe_a2_7b")
    tree = bridge.to_torch(_tree("qwen2_moe_a2_7b"), "cpu")
    params = bridge.tree_map(tree["layers"]["moe"], lambda t: t[0])
    asked = []
    real = tshd.linear_tp

    def linear_tp(site, d_in, d_out, *a, **kw):
        asked.append((site, d_in, d_out))
        return real(site, d_in, d_out, *a, **kw)
    monkeypatch.setattr(tshd, "linear_tp", linear_tp)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 5, cfg.d_model)).astype(np.float32))
    tmoe.apply_moe_block(params, x, cfg)
    width = cfg.num_shared_experts * cfg.moe_d_ff
    assert width != cfg.d_ff
    assert asked == [("up", cfg.d_model, width), ("down", width, cfg.d_model)]


@pytest.mark.parametrize("name,shape", CASES, ids=str)
def test_expert_blocks_follow_the_layout(name, shape):
    """The model ranks' blocks of every expert leaf (``param_bounds``
    with ``experts=``) tile it along one dimension or are all whole: E
    under ``expert`` (C and U whole on every rank), ff (and down's core
    on d_c) under ``expert_mlp``, nothing under ``whole``."""
    cfg = world.moe_tp_config(name)
    experts = (cfg.num_experts, cfg.moe_d_ff)
    tree = bridge.abstract(lambda: tdeploy.compile_model(cfg).init(
        seed=0, device="cpu"))
    layout = world.MOE_TP_LAYOUTS[name]
    for path, leaf in bridge.flatten(tree).items():
        if "['experts']" not in path:
            continue
        got = []
        for m in range(shape[1]):
            mesh = _At(shape, (0, m))
            sh = bridge.flatten(tshd.param_shardings(tree, mesh))[path]
            got.append(tshd.param_bounds(path, leaf.shape, sh,
                                         experts=experts))
        split = [i for i in range(leaf.dim()) if len({b[i] for b in got}) > 1]
        if split:
            (i,) = split
            assert [b[i] for b in got] == tshd.h_layout(leaf.shape[i],
                                                        shape[1]), path
        leaf_name = path.rsplit("[", 1)[1]
        if layout == "expert":          # dim 1 of the stacked [L, E, ...]
            assert split == ([] if leaf_name in ("'C']", "'U']") else [1]), \
                path
        elif layout == "whole":
            assert split == [], path
        else:                           # gate/up on ff, down on its ff rows
            cut = ("'w_q']", "'w_scale']", "'U']") if "['down']" not in path \
                else ("'w_q']", "'C']", "'core']")
            assert bool(split) == (leaf_name in cut), path
