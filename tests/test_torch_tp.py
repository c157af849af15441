"""LM tensor-parallel serving over a ``(data, model)`` mesh of
``torch.distributed`` ranks against the JAX package and the port's own
unsharded steps, on the CPU.

One spawned world of 4 gloo ranks (``_torch_world.tp_world``, started
once for the module; the JAX init and references run in this process
meanwhile, the ranks starting on the configs that need no JAX tree)
serves the cases of ``_torch_world.TP_CASES`` under ``int8_native``,
``pallas`` and ``pallas_fused`` (the plain kernel versions).  On meshes
(1, 4) and (2, 2): Yi-34B's smoke config (kv 2: head-split over model 2,
sequence-split over 4), Gemma-2B's (kv 1) and Yi's with d_ff 1536, whose
down projection deals its three k-blocks 1, 1, 1, 0 over model 4 (an
empty rank) and 2, 1 over model 2, and whose even split (384, 768 a
rank) cuts a k-block.  On (1, 4), uneven heads: Gemma's with 3 heads
(1, 1, 1, 0 a rank: a rank without heads), Yi's with 6 heads over 2 kv
heads (2, 2, 2, 0, rep 3: GQA groups split between ranks), the same at
``max_len`` 30 (a whole cache on every rank), and Qwen1.5's with 6 heads
and seeded q/k/v biases (the q bias cut on each rank's whole heads).  On
(pod 2, data 2, model 1), Yi's and Gemma's smoke configs: a batch over
pod x data.

Held:
  * row-parallel sites: the reduced trunk bitwise the rank-order sum of
    the plain version over ``k_layout``'s ranges, the output within 1e-5
    of the absmax of the unsharded site's (the branch epilogue
    reassociates), columns moved only where the even split cuts a block;
  * column-parallel sites: the trunk bitwise the unsharded site's
    columns (kernel 3's too), the output within 1e-5;
  * the vocab-parallel lookup bitwise, the distributed argmax's ties as
    ``torch.argmax`` breaks them; the attention combine within 1e-5;
  * the vocab-parallel readout's whole logits within 1e-5 of the
    unsharded head's, its vocab block bitwise their columns;
  * the steps (8 rows, prompts of 8, ``max_len`` 32, a prefill and 4
    greedy serve steps): against the port's unsharded steps, logits at
    the whole-model tolerance (an ulp before a per-row int8 quantiser can
    move a code) and tokens agreeing in >= 99%; every rank bitwise equal;
    a row decoded at batch 8 bitwise the same row decoded in a small
    batch; against the JAX package's
    unsharded ``make_prefill_step`` / ``make_serve_step``
    (``int8_native``), logits within ``test_torch_lm.py``'s 5e-2 of the
    absmax and tokens agreeing in >= 99% of (row, step) pairs;
  * every leaf's rank blocks tiling it whole; what still raises (the moe
    family serves over a mesh but does not train over one; ``expert`` and
    ``expert_mlp`` are cut, ``ssm_inner`` and ``kv_seq`` raise);
  * the dry run (``launch.dryrun``: each rank's serve step on ``meta``
    over a fake world) sends each rank's bytes of the world's last serve
    step, kind by kind, under ``pallas_fused`` and ``pallas``.

The reference's own sharded test fails here (jax 0.9's ``shard_map``
refuses ``check_rep``), so its unsharded steps are the oracle.
"""

import concurrent.futures
import copy
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
from repro_torch import configs as tconfigs
from repro_torch import deploy as tdeploy
from repro_torch.core import rebranch as trebranch
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers

WORLD = 4
DEADLINE_S = 240
REL = 1e-5
LOGITS_REL = 5e-2     # whole models vs JAX: test_torch_lm.py's tolerance
AGREE = 0.99          # tokens, the reference's sharded-decode threshold
JAX_INIT = ("yi_34b", "gemma_2b")       # the JAX init; the rest the port's
JAX_CONFIGS = JAX_INIT + world.TP_UNEVEN     # held to the JAX package


def _close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if not want.size:                 # a rank without columns
        return
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _jax_cfg(name):
    """The JAX package's config of ``name`` (``_torch_world.tp_config``'s
    fields)."""
    t = world.tp_config(name)
    base = jconfigs.get_smoke(t.name.removesuffix("_smoke"))
    return dataclasses.replace(base, num_heads=t.num_heads,
                               num_kv_heads=t.num_kv_heads,
                               head_dim=t.head_dim, d_ff=t.d_ff)


@functools.cache
def _params(name):
    """The JAX init (jitted) with seeded non-zero cores, as numpy; the
    other configs from the port's init (one tree on both sides)."""
    if name not in JAX_INIT:
        return world.tp_port_tree(name)
    jm = jdeploy.compile_model(_jax_cfg(name), engine="int8_native")
    tree = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    return world.with_cores(tree, np.random.default_rng(1))


def _jax_steps(name):
    """The JAX package's unsharded prefill and 4 greedy serve steps."""
    cfg = _jax_cfg(name)
    model = jdeploy.compile_model(cfg, engine="int8_native")
    params = jax.tree.map(jnp.asarray, _params(name))
    prefill = jax.jit(jsteps.make_prefill_step(
        cfg, world.TP_BATCH, world.tp_max_len(name), model=model))
    serve = jax.jit(jsteps.make_serve_step(cfg, model=model))
    logits, cache = prefill(params, {"tokens": jnp.asarray(
        world.tp_prompts(cfg.vocab_size))})
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks = [tok]
    for _ in range(world.TP_STEPS):
        tok, cache = serve(params, {"tokens": tok}, cache)
        toks.append(tok)
    return np.asarray(logits), np.asarray(jnp.concatenate(toks, 1))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(each rank's results, the JAX references, the port's unsharded
    steps): the world runs in a thread while this process runs the
    references."""
    root = tmp_path_factory.mktemp("tp")
    path = root / "trees.pt"
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(mesh_lib.spawn, world.tp_world, WORLD,
                              backend="gloo", deadline_s=DEADLINE_S,
                              args=(str(path),))
        trees = {name: bridge.to_torch(_params(name), "cpu")
                 for name in world.TP_CONFIGS}
        torch.save({k: trees[k] for k in JAX_INIT}, root / "part.pt")
        (root / "part.pt").rename(path)       # the ranks read it whole
        refs = {name: _jax_steps(name) for name in JAX_CONFIGS}
        threads = torch.get_num_threads()
        torch.set_num_threads(1)      # as a rank runs: the same GEMM bits
        try:
            whole = {(name, engine): world.tp_steps(
                world.tp_config(name), trees[name], None, engine,
                world.tp_max_len(name))[0]
                for name in world.TP_CONFIGS for engine in world.TP_ENGINES}
        finally:
            torch.set_num_threads(threads)
        ranks = spawned.result()
    return ranks, refs, whole


CASES = world.TP_CASES


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,shape", [(n, s) for n, s in CASES
                                        if n in JAX_CONFIGS], ids=str)
def test_sharded_steps_match_the_reference_unsharded(run, name, shape):
    ranks, refs, _ = run
    want_logits, want_toks = refs[name]
    logits, toks = ranks[0]["steps"][name, shape, "int8_native"]
    _close(logits, want_logits, LOGITS_REL, f"{name} {shape}")
    agree = float(np.mean(toks == want_toks))
    assert agree >= AGREE, (name, shape, agree)


@pytest.mark.parametrize("engine", world.TP_ENGINES)
@pytest.mark.parametrize("name,shape", CASES, ids=str)
def test_sharded_steps_match_the_ports_unsharded(run, name, shape, engine):
    """Whole models at the whole-model tolerance: the row-parallel sums
    and the attention combine reassociate (1e-5 at every site, below),
    and an ulp before a per-row int8 quantiser can move a code (measured
    here: Gemma's smoke model on (1, 4) moved a logit by 3.1e-2)."""
    ranks, _, whole = run
    logits, toks = ranks[0]["steps"][name, shape, engine]
    w_logits, w_toks = whole[name, engine]
    _close(logits, w_logits, LOGITS_REL, f"{name} {shape} {engine}")
    assert float(np.mean(toks == w_toks)) >= AGREE


@pytest.mark.parametrize("name,shape", CASES, ids=str)
def test_vocab_parallel_readout_gives_whole_logits(run, name, shape):
    for r in run[0]:
        x = r["head"][name, shape]
        assert x["block_equal"]
        _close(x["logits"], x["want"], REL)
        np.testing.assert_array_equal(x["logits"],
                                      run[0][0]["head"][name, shape]["logits"])


@pytest.mark.parametrize("name,shape", CASES, ids=str)
def test_every_rank_returns_the_same_bits(run, name, shape):
    ranks = run[0]
    for engine in world.TP_ENGINES:
        first = ranks[0]["steps"][name, shape, engine]
        for r in ranks[1:]:
            got = r["steps"][name, shape, engine]
            np.testing.assert_array_equal(got[0], first[0])
            np.testing.assert_array_equal(got[1], first[1])


@pytest.mark.parametrize("name,shape", CASES, ids=str)
def test_a_row_decodes_the_same_bits_in_any_batch(run, name, shape):
    ranks = run[0]
    for r in ranks:
        for big, small in r["batch"][name, shape]["pairs"]:
            np.testing.assert_array_equal(big, small)


# ---------------------------------------------------------------------------
# the sites
# ---------------------------------------------------------------------------

ROW = [(n, s, m, e) for n, s in world.TP_ROW_SITES
       for m in world.tp_shapes(n) if m[-1] > 1 for e in world.TP_ENGINES]


@pytest.mark.parametrize("name,site,shape,engine", ROW, ids=str)
def test_row_parallel_site_sums_whole_k_blocks_in_rank_order(
        run, name, site, shape, engine):
    ranks = run[0]
    res = [r["row"][name, site, shape, engine] for r in ranks]
    for x in res:
        assert x["equal"], (name, site, shape, engine)
        _close(x["y"], x["y_whole"], REL)
        np.testing.assert_array_equal(x["y"], res[0]["y"])
    k_ranges, even = res[0]["k_ranges"], res[0]["even"]
    cuts = any(lo % 512 for lo, _ in even[1:] if lo < even[-1][1])
    moved = sum(x["relayout"] for x in res)
    assert (moved > 0) == (list(k_ranges) != list(even)), (k_ranges, even)
    if (name, site) == ("yi_34b_ff1536", "down"):
        assert cuts                         # the even split cuts a block
        n = shape[1]
        assert [hi - lo for lo, hi in k_ranges] == (
            [512, 512, 512, 0] if n == 4 else [1024, 512])
        assert [x["empty"] for x in res] == (
            [False, False, False, True] if n == 4 else [False] * 4)


COL = [(n, s, m, e) for n, s in world.TP_COL_SITES
       for m in world.tp_shapes(n) if m[-1] > 1 for e in world.TP_ENGINES]


@pytest.mark.parametrize("name,site,shape,engine", COL, ids=str)
def test_column_parallel_site_keeps_the_unsharded_columns(
        run, name, site, shape, engine):
    ranks = run[0]
    for r in ranks:
        x = r["col"][name, site, shape, engine]
        assert x["trunk_equal"], (name, site, shape, engine)
        _close(x["y"], x["y_whole"], REL)


@pytest.mark.parametrize("name,shape", CASES, ids=str)
def test_vocab_parallel_lookup_and_argmax(run, name, shape):
    ranks = run[0]
    for r in ranks:
        assert r["vocab"][name, shape] == {"embed_equal": True,
                                           "argmax_equal": True}


@pytest.mark.parametrize("n", [2, 4])
def test_attention_partials_combine_to_the_softmax(n):
    """The (max, sum of exp, weighted v) partials of a sequence split n
    ways, combined in rank order, against one masked softmax; a rank
    whose positions are all masked weighs nothing."""
    rng = np.random.default_rng(n)
    b, h, kvh, dh, s = 3, 4, 1, 16, 16
    q = torch.from_numpy(rng.normal(size=(b, 1, h, dh)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, s, kvh, dh)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(b, s, kvh, dh)).astype(np.float32))
    valid = torch.tensor([1, 5, 16])
    want = tlayers._decode_attention_rows(q, k, v, valid)[:, 0]
    c = s // n
    parts = [tlayers._decode_partial_rows(q, k[:, r * c:(r + 1) * c],
                                          v[:, r * c:(r + 1) * c], valid,
                                          p0=r * c) for r in range(n)]
    _close(tlayers._combine_partials(parts), want, REL)


# ---------------------------------------------------------------------------
# layouts and what still raises (no world)
# ---------------------------------------------------------------------------

def test_k_layout_deals_whole_blocks_in_order():
    assert tshd.k_layout(7168, 4) == [(0, 2048), (2048, 4096), (4096, 5632),
                                      (5632, 7168)]      # 4, 4, 3, 3 blocks
    assert tshd.k_layout(192, 4) == [(0, 192)] + [(192, 192)] * 3
    assert tshd.k_layout(1536, 4) == [(0, 512), (512, 1024), (1024, 1536),
                                      (1536, 1536)]
    assert tshd.k_layout(1536, 2) == [(0, 1024), (1024, 1536)]
    assert tshd.k_layout(2048, 4) == tshd.h_layout(2048, 4)   # Gemma's o
    assert tshd.k_layout(16384, 4) == tshd.h_layout(16384, 4)  # its down
    assert tshd.k_layout(1000, 3) == [(0, 512), (512, 1000), (1000, 1000)]


class _At(mesh_lib.AbstractMesh):
    """An abstract mesh at one coordinate (``block_bounds`` reads it)."""

    def __init__(self, shape, coord):
        super().__init__(shape)
        self.coord = dict(zip(self.axis_names, coord))

    def coordinate(self, axis):
        return self.coord[axis]


@pytest.mark.parametrize("name", world.TP_CONFIGS)
@pytest.mark.parametrize("shape", world.TP_MESHES, ids=str)
def test_rank_blocks_tile_every_leaf(name, shape):
    """Every leaf's blocks over the ranks (``k_layout`` for row-parallel
    contracting rows, whole heads for q's columns, GSPMD's even layout
    elsewhere) concatenate back to the whole leaf, each rank's once per
    data coordinate."""
    cfg = world.tp_config(name)
    tree = bridge.abstract(lambda: tdeploy.compile_model(cfg).init(
        seed=0, device="cpu"))
    flat = bridge.flatten(tree)
    coords = [(d, m) for d in range(shape[0]) for m in range(shape[1])]
    for path, leaf in flat.items():
        blocks = {}
        for coord in coords:
            mesh = _At(shape, coord)
            sh = bridge.flatten(tshd.param_shardings(tree, mesh))[path]
            blocks[coord] = tuple(tshd.param_bounds(
                path, leaf.shape, sh, head_dim=cfg.head_dim))
        for d in range(shape[0]):
            got = [blocks[d, m] for m in range(shape[1])]
            split = [i for i in range(leaf.dim())
                     if len({b[i] for b in got}) > 1]
            assert len(split) <= 1, path
            if not split:
                assert all(b == tuple((0, s) for s in leaf.shape)
                           for b in got), path
                continue
            i = split[0]
            spans = [b[i] for b in got]
            assert spans[0][0] == 0 and spans[-1][1] == leaf.shape[i], path
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:])), path
            if tshd.is_row_contraction(path):
                assert spans == tshd.k_layout(leaf.shape[i], shape[1]), path
            if tshd.head_site(path) == "q":
                assert spans == tshd.head_layout(
                    leaf.shape[i], cfg.head_dim, shape[1]), path


@pytest.mark.parametrize("engine", ["pallas_fused", "pallas"])
@pytest.mark.parametrize("name,shape", CASES)
def test_the_dry_run_sends_each_ranks_bytes_of_a_serve_step(run, name,
                                                             shape, engine):
    """The same serve step run per rank on ``meta`` over a fake world
    (``launch.dryrun``) sends, rank by rank and kind by kind, the bytes
    the gloo world's ranks sent, under the two kernel engines
    (``int8_native`` sends ``pallas``'s bytes)."""
    ranks, _, _ = run
    with dryrun.dry_world(WORLD):
        mesh = world.tp_mesh(shape, mesh_lib.FAKE)
        coords = [dict(zip(mesh.axis_names, np.unravel_index(r, shape)))
                  for r in range(WORLD)]
        cfg = world.tp_config(name)
        rec = dryrun.lower_cell(
            cfg.name.removesuffix("_smoke"), "decode_32k", mesh, cfg=cfg,
            ranks=coords, engine=engine, seq=world.tp_max_len(name),
            gbatch=world.TP_BATCH)
    assert [r["bytes_sent"] for r in rec["ranks"]] == [
        r["traffic"][name, shape, engine] for r in ranks]


class _Grouped(_At):
    """An abstract mesh at one coordinate that ``shard`` may cut on."""

    def group(self, axis):
        return None


def test_what_still_raises():
    mesh = mesh_lib.AbstractMesh((2, 2))
    for name in ("falcon_mamba_7b", "hymba_1_5b", "qwen2_vl_2b",
                 "musicgen_large"):
        with pytest.raises(NotImplementedError, match=r"item 5\(d\)"):
            tdeploy.compile_model(tconfigs.get_smoke(name), mesh=mesh)
    # the moe family serves over a mesh (test_torch_moe_tp.py) and trains
    # over one (test_torch_moe_tp_train.py): its train step passes the
    # family check and asks for the batch's whole size over batch axes
    moe = tdeploy.compile_model(tconfigs.get_smoke("granite_moe_3b"),
                                mesh=mesh)
    assert moe.mesh is mesh
    moe = tdeploy.compile_model(tconfigs.get_smoke("granite_moe_3b"))
    t, f = trebranch.partition(bridge.abstract(
        lambda: moe.init(seed=0, device="cpu")))
    step = tsteps.make_train_step(moe.cfg, model=moe)
    labels = {"labels": torch.zeros((2, 4), dtype=torch.int32)}
    with tshd.use_mesh(mesh):
        with pytest.raises(ValueError, match="global_batch"):
            step.grads(t, f, labels)
        for axis in ("ssm_inner", "kv_seq"):
            with pytest.raises(NotImplementedError, match=r"item 5\(d\)"):
                tshd.shard(torch.zeros(4, 4), None, axis)
    # expert and expert_mlp cut by the reference's rules (the size rule:
    # 3 does not divide the model axis)
    x = torch.arange(24.0).reshape(4, 6)
    with tshd.use_mesh(_Grouped((2, 2), (0, 1))):
        for axis in ("expert", "expert_mlp"):
            assert torch.equal(tshd.shard(x, axis, None), x[2:])
            assert torch.equal(tshd.shard(x, None, axis), x[:, 3:])
            assert torch.equal(tshd.shard(x[:3], axis, None), x[:3])
    cfg = tconfigs.get_smoke("gemma_2b")
    model = tdeploy.compile_model(cfg, mesh=mesh)
    with pytest.raises(NotImplementedError, match=r"item 5\(d\)"):
        model.init_cache(1, 32, device="cpu")       # kv_seq at batch 1
    # kv 1 and 31 do not divide model 2: no longer refused, a whole cache
    # (the rank's batch row, every position and kv head) on every rank;
    # at 62 the sequence splits, 31 positions a rank: the same block
    # shape, told apart by the cache's "seq_split" mark, which a copy and
    # a clone of every leaf keep
    model = tdeploy.compile_model(cfg, mesh=_At((2, 2), (1, 1)))
    whole = tdeploy.compile_model(cfg).init_cache(1, 31, device="cpu")
    for max_len, split in ((31, False), (62, True)):
        cache = model.init_cache(2, max_len, device="cpu")
        for leaf in ("k", "v"):
            assert cache["layers"][leaf].shape == whole["layers"][leaf].shape
        assert cache["layers"]["length"].shape == (cfg.num_layers, 2)
        assert ("seq_split" in cache["layers"]) == split
        with tshd.use_mesh(model.mesh):
            for c in (cache, copy.deepcopy(cache),
                      bridge.tree_map(cache, torch.clone)):
                assert tapi.cache_geometry(cfg, c) == (1, max_len)
