"""The moe family trained over a ``(data, model)`` mesh of
``torch.distributed`` ranks, and a data rank that holds no rows, against
the port's own one-process steps and the JAX package, on the CPU.

One spawned world of 4 gloo ranks (``_torch_world.moe_train_world``,
started once for the module; the one-process steps, the JAX first
losses and the dry runs run in this process meanwhile) runs
``_torch_world.MOE_TRAIN_CASES``: 'pallas' train steps (the plain kernel
versions), f32 activations, ``remat`` on, each rank on its blocks of the
parameters and its rows of the batch, one case per expert layout of
``sharding.expert_layout``: Granite-MoE's smoke config (E 8, whole
experts a rank) on (1, 4) and on (2, 2), where routing group 1 spans both
data ranks; Qwen2-MoE's (E 6, ff 64: each expert's ff columns) with its
shared experts; the same with ff 66 (every expert whole on every rank);
each under seq_sp (16 and 12 tokens) and, for the first two layouts,
with the residual stream whole (15 tokens).  Held:
  * every rank's block of every first-step gradient within ``STEP_REL``
    of its leaf's absmax from the one-process step on the whole batch;
  * the losses, the norm, and the gradient and update of every leaf the
    model ranks hold whole, bitwise equal on every rank;
  * the first loss (one process's, every rank's) within ``LOSS_REL`` of
    the loss the JAX package's unsharded ``make_train_step`` takes the
    gradient of, on the same parameters and batch
    (``test_torch_tp_train.py``'s tolerance);
  * remat on and off give bitwise-equal losses and gradients on every
    rank (the recompute routes again, its counts' exchange included);
  * the dry run (``launch.dryrun``: each rank's train step on ``meta``
    over a fake world) sends each rank's bytes of the world's first step,
    kind by kind.
Then a data rank without rows, over (data 4, model 1): 6 rows go 2, 2, 2,
0 and 5 rows 2, 2, 1, 0 (GSPMD's uneven layout).  Gemma-2B's and
Granite-MoE's smoke configs serve 6 prompts (a prefill and 4 greedy
steps) with the one-process run's tokens and logits; Gemma-2B's train
step on 6 and on 5 rows gives the one-process global mean (``EMPTY_REL``)
and its gradients (``STEP_REL``), with no NaN.

The reference's own sharded train-step test fails here (jax 0.9's
``shard_map``), so the port's one-process step is the oracle of the
sharded one, as in ``test_torch_tp_train.py``.
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
from repro.data import synthetic as jsyn
from repro.launch import steps as jsteps
from repro_torch import bridge
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib

WORLD = 4
DEADLINE_S = 240
STEP_REL = 1e-5
LOSS_REL = 1e-3          # the JAX package's first loss
EMPTY_REL = 1e-6         # the global mean over an empty data rank
LOGITS_REL = 5e-2        # whole models: test_torch_moe_tp.py's tolerance
CASES = world.MOE_TRAIN_CASES
LAYOUTS = {"granite_moe_3b": "expert", "qwen2_moe_a2_7b": "expert_mlp",
           "qwen2_moe_ff66": "whole"}
# the JAX package's first loss: one case per layout, the routing group
# across data ranks among them; the dry run's bytes: the same but the
# expert layout's on (1, 4) (its kinds are (2, 2)'s but the routing
# counts), and one case with the residual stream whole
HELD = CASES[:4]
DRY = CASES[1:4] + CASES[5:]


@functools.cache
def _whole(name):
    return bridge.to_torch(world.moe_tp_tree(name), "cpu")


def _one_thread(fn, *args):
    """``fn(*args)`` on one thread, as a rank runs (the CPU GEMMs' bits
    follow their thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(threads)


def _jax_first_loss(name, seq) -> float:
    """The loss the JAX package's ``make_train_step`` takes the gradient
    of (its ``loss_fn``: features, then the chunked readout loss), jitted
    without the backward."""
    t = world.moe_tp_config(name)
    cfg = dataclasses.replace(
        jconfigs.get_smoke(t.name.removesuffix("_smoke")),
        moe_d_ff=t.moe_d_ff, moe_capacity_factor=t.moe_capacity_factor)
    model = jdeploy.compile_model(cfg)
    params = jax.tree.map(jnp.asarray, world.moe_tp_tree(name))
    batch = jsyn.markov_batch(jsyn.DataConfig(
        seed=0, vocab_size=cfg.vocab_size, seq_len=seq,
        global_batch=world.MOE_TRAIN_BATCH), 0)
    loss = jax.jit(lambda p, b: jsteps.chunked_readout_loss(
        p, model.features(p, b), b["labels"], cfg, model=model))
    return float(loss(params, batch))


def _dry_bytes(name, shape, seq) -> list:
    """Each rank's bytes sent by kind over one train step of the case,
    run per rank on ``meta`` over a fake world of its mesh."""
    cfg = world.moe_tp_config(name)
    with dryrun.dry_world(WORLD):
        mesh = world.tp_mesh(shape, mesh_lib.FAKE)
        coords = [dict(zip(mesh.axis_names, np.unravel_index(r, shape)))
                  for r in range(WORLD)]
        rec = dryrun.lower_cell(
            cfg.name.removesuffix("_smoke"), "train_4k", mesh, cfg=cfg,
            ranks=coords, engine="pallas", seq=seq,
            gbatch=world.MOE_TRAIN_BATCH)
    return [r["bytes_sent"] for r in rec["ranks"]]


@pytest.fixture(scope="module")
def run():
    """(each rank's results, the one-process runs, the JAX first losses,
    the dry runs' bytes)."""
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        spawned = pool.submit(mesh_lib.spawn, world.moe_train_world, WORLD,
                              backend="gloo", deadline_s=DEADLINE_S)
        # the JAX package compiles beside this process's host work
        jaxed = pool.submit(lambda: {(n, q): _jax_first_loss(n, q)
                                     for n, _, q in HELD})
        one = {c: _one_thread(world.moe_train_run,
                              world.moe_tp_config(c[0]), _whole(c[0]),
                              None, c[2], world.MOE_TRAIN_BATCH,
                              world.MOE_TRAIN_STEPS, False)
               for c in CASES}
        one["serve"] = {c: _one_thread(world.empty_serve_run, *c, None)
                        for c in world.EMPTY_SERVE}
        one["train"] = {rows: _one_thread(world.empty_train_run, rows, None)
                        for rows in world.EMPTY_TRAIN}
        dry = {c: _dry_bytes(*c) for c in DRY}
        return spawned.result(), one, jaxed.result(), dry


# ---------------------------------------------------------------------------
# the moe train step over a mesh
# ---------------------------------------------------------------------------

IDS = [f"{n}-{'x'.join(map(str, s))}-s{q}" for n, s, q in CASES]


@pytest.mark.parametrize("name,shape,seq", CASES, ids=IDS)
def test_each_case_takes_its_expert_layout(run, name, shape, seq):
    for r in run[0]:
        assert r["runs"][name, shape, seq]["layout"] == LAYOUTS[name]


@pytest.mark.parametrize("name,shape,seq", CASES, ids=IDS)
def test_every_gradient_block_matches_one_process(run, name, shape, seq):
    ranks, one = run[0], run[1]
    want = one[name, shape, seq]["grads"]
    for r in ranks:
        got = r["runs"][name, shape, seq]
        assert set(got["grads"]) == set(want)
        for leaf, g in got["grads"].items():
            block = want[leaf][tuple(slice(lo, hi)
                                     for lo, hi in got["bounds"][leaf])]
            np.testing.assert_allclose(
                g, block, rtol=0, atol=STEP_REL * np.abs(want[leaf]).max(),
                err_msg=f"rank {r['rank']} {leaf}")


@pytest.mark.parametrize("name,shape,seq", CASES, ids=IDS)
def test_loss_and_whole_leaves_are_bitwise_equal_on_every_rank(run, name,
                                                               shape, seq):
    ranks = run[0]
    first = ranks[0]["runs"][name, shape, seq]
    split = set(first["split"])
    whole = [k for k in first["grads"] if k not in split]
    assert any("router" in k for k in whole)
    assert all(np.isfinite(v) for v in first["loss"])
    for r in ranks[1:]:
        got = r["runs"][name, shape, seq]
        assert got["loss"] == first["loss"]
        assert got["grad_norm"] == first["grad_norm"]
        assert got["split"] == first["split"]
        for k in whole:
            np.testing.assert_array_equal(got["grads"][k],
                                          first["grads"][k], err_msg=k)
            np.testing.assert_array_equal(got["updated"][k],
                                          first["updated"][k], err_msg=k)


@pytest.mark.parametrize("name,shape,seq", HELD, ids=IDS[:len(HELD)])
def test_first_loss_matches_the_jax_package(run, name, shape, seq):
    ranks, one, jaxed, _ = run
    want = jaxed[name, seq]
    got = [one[name, shape, seq]["loss"][0]] + [
        r["runs"][name, shape, seq]["loss"][0] for r in ranks]
    for loss in got:
        assert abs(loss - want) <= LOSS_REL * abs(want)


@pytest.mark.parametrize("name,shape,seq", CASES, ids=IDS)
def test_remat_on_and_off_are_bitwise_equal(run, name, shape, seq):
    for r in run[0]:
        assert r["runs"][name, shape, seq]["remat_equal"], r["rank"]


@pytest.mark.parametrize("name,shape,seq", DRY,
                         ids=[IDS[CASES.index(c)] for c in DRY])
def test_the_dry_run_sends_each_ranks_bytes_of_a_train_step(run, name,
                                                            shape, seq):
    """Rank by rank and kind by kind, the bytes of the world's first step
    (its forward, remat recompute and backward exchanges, the gradients'
    reductions); over (2, 2) the routing counts' gather (a group spans
    both data ranks) and its recompute's."""
    ranks, _, _, dry = run
    sent = [r["runs"][name, shape, seq]["bytes"] for r in ranks]
    assert dry[name, shape, seq] == sent
    assert all(s.get("routing", 0) > 0 for s in sent) == (shape[0] > 1)
    # the partial outputs' sum (reduce-scattered onto the chunks under
    # seq_sp), the expert_mlp down's int32 sums; whole sums nothing
    kind = {"expert": "expert" if seq == 15 else "expert_scatter",
            "expert_mlp": "expert"}.get(LAYOUTS[name])
    assert kind is None or all(s.get(kind, 0) > 0 for s in sent)


# ---------------------------------------------------------------------------
# a data rank without rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,rows", world.EMPTY_SERVE, ids=str)
def test_a_data_rank_without_rows_serves(run, name, rows):
    ranks, one = run[0], run[1]
    want_logits, want_toks = one["serve"][name, rows]
    for r in ranks:
        logits, toks = r["serve"][name, rows]
        np.testing.assert_array_equal(toks, want_toks)
        np.testing.assert_allclose(
            logits, want_logits, rtol=0,
            atol=LOGITS_REL * np.abs(want_logits).max())


@pytest.mark.parametrize("rows", world.EMPTY_TRAIN)
def test_a_data_rank_without_rows_trains_on_the_global_mean(run, rows):
    ranks, one = run[0], run[1]
    want = one["train"][rows]
    assert [r["train"][rows]["rows"] for r in ranks] == [
        hi - lo for lo, hi in tshd.h_layout(rows, WORLD)]
    for r in ranks:
        got = r["train"][rows]
        assert abs(got["loss"] - want["loss"]) <= EMPTY_REL * abs(
            want["loss"])
        for leaf, g in got["grads"].items():
            assert np.isfinite(g).all(), leaf
            np.testing.assert_allclose(
                g, want["grads"][leaf], rtol=0,
                atol=STEP_REL * np.abs(want["grads"][leaf]).max(),
                err_msg=f"rank {r['rank']} {leaf}")
