"""The port's sharding rules, meshes, 'pallas_sharded' engine and
``compile_model(mesh=)`` against the JAX package, on the CPU.

The rules and ``param_specs`` are pure metadata and must come out EQUAL
to the reference's on abstract meshes (16x16, 2x2 and the 2x16x16
multi-pod shape), over every arch of ``configs.ALL_ARCHS`` at full width
and the four paper CNNs: both functions run on the same shape tree (the
reference's ``jax.eval_shape`` init; the port's own ``bridge.abstract``
tree for Gemma-2B, which is key for key the same).

Sharded CNN forwards run in one spawned world of 4 gloo ranks
(``_torch_world.sharding_world``) on meshes 4x1, 2x2 and 1x4.  Each is
held to the JAX package's unsharded 'pallas' forward (jitted) at 5e-2 of
its absmax, ``test_torch_cnn.py``'s tolerance for whole quantised
forwards (they are chaotic at the ulp level; each layer is held tightly
in ``test_torch_halo_conv.py``).  DarkNet-19 at 32 px has sites of H <= 2
whose halo does not fit a 2- or 4-way split: there the engine gathers
the layer, warns once per geometry and counts it.  Each rank's bytes
sent in a DarkNet-19 forward are held, kind by kind, to the dry run's
(``launch.dryrun``: the same forward per rank on ``meta``), and the dry
run repeated in this process gives equal records.
"""

import concurrent.futures
import dataclasses
import functools
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

import _torch_world as world
from repro import configs as jconfigs
from repro import deploy as jdeploy
from repro.distributed import sharding as jshd
from repro.models import api as japi
from repro.models import cnn as jcnn
from repro_torch import bridge, configs as tconfigs
from repro_torch import deploy as tdeploy
from repro_torch import engine as tengine
from repro_torch.core import cim as tcim
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import api as tapi
from repro_torch.models import cnn as tcnn

ABSTRACT = [((16, 16), ("data", "model")), ((2, 2), ("data", "model")),
            ((2, 16, 16), ("pod", "data", "model")),
            ((1, 4), ("data", "model"))]
LOGICAL = [None, *jshd.DEFAULT_RULES]


def _meshes(shape, names):
    return (jax.sharding.AbstractMesh(shape, names),
            mesh_lib.AbstractMesh(shape, names))


# ---------------------------------------------------------------------------
# rules (pure)
# ---------------------------------------------------------------------------

def test_default_rules_equal_the_reference():
    assert tshd.DEFAULT_RULES == jshd.DEFAULT_RULES


@pytest.mark.parametrize("shape,names", ABSTRACT)
def test_logical_to_spec_and_mesh_axis_for_equal_the_reference(shape, names):
    jm, tm = _meshes(shape, names)
    for a in LOGICAL:
        for b in LOGICAL:
            axes = (a, b)
            assert tuple(tshd.logical_to_spec(axes, tm)) == \
                tuple(jshd.logical_to_spec(axes, jm)), axes
        if a is not None:
            assert tshd.mesh_axis_for(a, tm) == jshd.mesh_axis_for(a, jm)
    with tshd.use_mesh(tm), jshd.use_mesh(jm):
        assert tuple(tshd.logical_to_spec(("batch", "heads"))) == \
            tuple(jshd.logical_to_spec(("batch", "heads")))


@functools.cache
def _shape_tree(name):
    """The reference's parameter tree of ``name`` as ShapeDtypeStructs:
    an LM arch at full width, or a paper CNN at 32 px."""
    key = jax.random.PRNGKey(0)
    if name in jcnn.MODEL_REGISTRY:
        init, _ = jcnn.MODEL_REGISTRY[name]
        cfg = jcnn.CNNConfig(name=name, input_size=32)
        return jax.eval_shape(lambda k: init(k, cfg), key)
    return jax.eval_shape(lambda k: japi.init(k, jconfigs.get(name)), key)


def _jax_named(specs) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    return {jax.tree_util.keystr(p): tuple(s) for p, s in leaves}


def _torch_named(specs, prefix="") -> dict:
    if isinstance(specs, tshd.PartitionSpec):
        return {prefix: tuple(specs)}
    if isinstance(specs, dict):
        items = ((f"[{k!r}]", specs[k]) for k in sorted(specs))
    else:
        items = ((f"[{i}]", v) for i, v in enumerate(specs))
    out = {}
    for key, v in items:
        if v is not None:
            out.update(_torch_named(v, prefix + key))
    return out


@pytest.mark.parametrize("shape", [(16, 16), (2, 2)])
@pytest.mark.parametrize("name", [*jconfigs.ALL_ARCHS, *jcnn.MODEL_REGISTRY])
def test_param_specs_equal_the_reference(name, shape):
    jm, tm = _meshes(shape, ("data", "model"))
    tree = _shape_tree(name)
    want = _jax_named(jshd.param_specs(tree, jm))
    got = _torch_named(tshd.param_specs(tree, tm))
    assert got == want
    if name in jconfigs.ALL_ARCHS:       # CNN convs are 4-D: replicated
        assert any(s for s in want.values()), "nothing sharded"


def test_param_specs_over_the_ports_own_tree():
    """The port's fake-tensor init of full-width Gemma-2B gives the same
    specs as the reference's shape tree."""
    tm = mesh_lib.AbstractMesh((16, 16))
    tree = bridge.abstract(tapi.init, torch.Generator(),
                           tconfigs.get("gemma_2b"))
    want = _jax_named(jshd.param_specs(_shape_tree("gemma_2b"),
                                       jax.sharding.AbstractMesh(
                                           (16, 16), ("data", "model"))))
    assert _torch_named(tshd.param_specs(tree, tm)) == want
    assert _torch_named(tshd.param_specs(tree)) == {k: () for k in want}


def test_use_mesh_is_scoped_and_merges_rules():
    tm = mesh_lib.AbstractMesh((2, 2))
    assert tshd.current_mesh() is None
    with tshd.use_mesh(tm, rules={"cnn_h": ("model",)}):
        assert tshd.current_mesh() is tm
        assert tshd.current_rules()["cnn_h"] == ("model",)
        assert tshd.current_rules()["batch"] == ("pod", "data")
        with tshd.use_mesh(None):
            assert tshd.current_mesh() is None
        assert tshd.current_mesh() is tm
    assert tshd.current_mesh() is None
    assert tshd.current_rules() is tshd.DEFAULT_RULES


def test_h_layout_is_gspmds_uneven_split():
    assert tshd.h_layout(13, 2) == [(0, 7), (7, 13)]
    assert tshd.h_layout(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    assert tshd.h_layout(416, 4) == [(0, 104), (104, 208), (208, 312),
                                     (312, 416)]


def test_what_this_slice_does_not_execute_raises():
    x = torch.zeros(2, 8, 8, 3)
    assert tshd.shard(x, "cnn_batch", "cnn_h") is x          # no mesh
    with tshd.use_mesh(mesh_lib.AbstractMesh((1, 4))):
        assert tshd.shard(x, "cnn_batch", "cnn_h") is x      # size-1 axis
    with tshd.use_mesh(mesh_lib.AbstractMesh((2, 2))):
        with pytest.raises(NotImplementedError, match=r"item 5\(d\)"):
            tshd.shard(x, "ssm_inner")
        # executed since the moe family serves over a mesh: a cut needs
        # a mesh of ranks
        with pytest.raises(TypeError, match="no process groups"):
            tshd.shard(x, "expert")
        with pytest.raises(TypeError, match="no process groups"):
            tshd.shard(x, "cnn_batch", "cnn_h")
    # an image batch over pod is executed now: it needs a mesh of ranks
    # (test_torch_dist_train.py), and param_shardings pairs specs with
    # their mesh
    pod = mesh_lib.AbstractMesh((2, 1, 1), ("pod", "data", "model"))
    with tshd.use_mesh(pod):
        assert tshd.h_axis() is None
        with pytest.raises(TypeError, match="no process groups"):
            tshd.shard(x, "cnn_batch", "cnn_h")
    mesh = mesh_lib.AbstractMesh((2, 2))
    sh = tshd.param_shardings({"w": {"sram": {"core": torch.zeros(3, 3)}}},
                              mesh)
    assert sh["w"]["sram"]["core"] == tshd.NamedSharding(mesh, tshd.P())


# ---------------------------------------------------------------------------
# the engine and compile_model(mesh=) in this process
# ---------------------------------------------------------------------------

def test_engine_registered_with_its_capabilities():
    eng = tengine.get("pallas_sharded")
    caps = eng.capabilities
    assert caps.sharded_ops == ("conv",) and caps.epilogue and caps.tune
    assert caps.grads and caps.devices == ("cpu", "cuda")
    assert caps.fused_ops == ()
    assert caps.fidelity_modes == tengine.get("pallas").capabilities \
        .fidelity_modes


@pytest.mark.parametrize("mode", ["ideal", "per_subarray"])
def test_without_a_mesh_the_engine_is_pallas_and_silent(mode):
    cfg = tcim.CiMConfig(mode=mode)
    x, w_q, w_scale = [torch.from_numpy(a) for a in
                       world.conv_case(1, 3, 20, 12, 8)[:3]]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = tengine.get("pallas_sharded").conv(cfg, x, w_q, w_scale)
        with tshd.use_mesh(mesh_lib.AbstractMesh((1, 4))):
            one = tengine.get("pallas_sharded").conv(cfg, x, w_q, w_scale)
    want = tengine.get("pallas").conv(cfg, x, w_q, w_scale)
    assert torch.equal(got, want) and torch.equal(one, want)
    y = tengine.get("pallas_sharded").matmul(cfg, x[:, 0, 0], w_q[0, 0],
                                             w_scale.reshape(1, -1))
    assert torch.equal(y, tengine.get("pallas").matmul(
        cfg, x[:, 0, 0], w_q[0, 0], w_scale.reshape(1, -1)))


def test_compile_model_mesh_checks_and_repr():
    mesh = mesh_lib.AbstractMesh((4, 1))
    cfg = tcnn.CNNConfig(name="darknet19", input_size=32)
    model = tdeploy.compile_model(cfg, engine="pallas_sharded", mesh=mesh)
    assert model.mesh is mesh and repr(model).endswith(" mesh=4x1>")
    assert tdeploy.compile_model(cfg, engine="pallas_sharded").mesh is None
    with pytest.raises(ValueError, match="pallas_fused"):
        tdeploy.compile_model(cfg, engine="pallas_fused", mesh=mesh)
    with pytest.raises(NotImplementedError, match=r"item 5\(d\)"):
        tdeploy.compile_model(tconfigs.get_smoke("falcon_mamba_7b"),
                              mesh=mesh)
    # the moe family serves over a mesh (test_torch_moe_tp.py)
    assert tdeploy.compile_model(tconfigs.get_smoke("granite_moe_3b"),
                                 mesh=mesh).mesh is mesh


# ---------------------------------------------------------------------------
# 4 gloo ranks: meshes and sharded forwards
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks():
    """Each rank's results of ``_torch_world.sharding_world``; the JAX
    references compile meanwhile."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(mesh_lib.spawn, world.sharding_world, 4,
                              backend="gloo", deadline_s=240)
        for name in world.CNNS:
            _jax_forward(name)
        return spawned.result()


@functools.cache
def _jax_forward(name):
    params, x = world.cnn_case(name)
    model = jdeploy.compile_model(
        jcnn.CNNConfig(name=name, input_size=world.cnn_size(name),
                       fuse_bn_act=True), engine="pallas")
    return np.asarray(jax.jit(model.forward)(params, x))


def test_meshes_over_the_world(ranks):
    assert "256 ranks; the world has 4" in ranks[0]["production"]
    assert "8 ranks; the world has 4" in ranks[0]["serve8"]
    for r in ranks:
        for name, (shape, size, coord, timeouts) in r["meshes"].items():
            assert size == 4 and set(timeouts.values()) == {60.0}, name
        shape, _, coord, _ = r["meshes"]["local"]
        assert shape == {"data": 4, "model": 1}
        assert coord == {"data": r["rank"], "model": 0}
        assert r["meshes"]["serve4"][0] == shape
        assert r["meshes"][2, 2][2] == {"data": r["rank"] // 2,
                                        "model": r["rank"] % 2}


@pytest.mark.parametrize("shape", world.MESH_SHAPES)
@pytest.mark.parametrize("name", world.CNNS)
def test_sharded_forward_matches_jax(ranks, name, shape):
    y, _, _, rep = ranks[0]["forward"][name, shape, 0]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["forward"][name, shape, 0][0], y)
    want = _jax_forward(name)
    assert y.shape == want.shape and np.isfinite(y).all()
    np.testing.assert_allclose(y, want, rtol=0,
                               atol=5e-2 * np.abs(want).max())
    assert rep.endswith(f" mesh={shape[0]}x{shape[1]}>")


@pytest.mark.parametrize("shape,fallbacks,warned", [
    ((4, 1), 8, ["H=2 kh=3", "H=1 kh=3"]), ((2, 2), 5, ["H=1 kh=3"]),
    ((1, 4), 0, [])])
def test_darknet19_at_32_falls_back_where_the_halo_does_not_fit(
        ranks, shape, fallbacks, warned):
    for r in ranks:
        _, count, msgs, _ = r["forward"]["darknet19", shape, 0]
        assert count == fallbacks
        assert len(msgs) == len(warned)
        for msg, geometry in zip(msgs, warned):
            assert f"halo for {geometry} " in msg and "falling back" in msg
        y, again, msgs, _ = r["forward"]["darknet19", shape, 1]
        assert again == fallbacks and msgs == []           # warned once
        np.testing.assert_array_equal(
            y, r["forward"]["darknet19", shape, 0][0])


@pytest.mark.parametrize("shape", world.MESH_SHAPES)
def test_the_dry_run_sends_each_ranks_bytes_of_a_forward(ranks, shape):
    """DarkNet-19's sharded forward run per rank on ``meta`` over a fake
    world (``launch.dryrun``, the ranks side by side, H from each other's
    slab heights) sends, rank by rank and kind by kind, the bytes the
    gloo world's ranks sent."""
    coords = {"data": shape[0], "model": shape[1]}
    with dryrun.dry_world(4):
        mesh = mesh_lib.make_mesh(shape, backend=mesh_lib.FAKE)
        rec = dryrun.lower_cnn_cell("darknet19", mesh,
                                    size=world.cnn_size("darknet19"),
                                    gbatch=2)
    got = {r["rank"]: r["bytes_sent"] for r in rec["ranks"]}
    assert len(got) == coords["data"] * coords["model"]
    assert [got[r["rank"]] for r in ranks] == [
        r["traffic"]["darknet19", shape, 0] for r in ranks]


def test_the_dry_run_gives_equal_records_call_after_call(ranks):
    """DarkNet-19's dry run repeated in this process, after the world was
    spawned: every record equal (the ranks' threads take turns, so no two
    ranks' ops interleave), the gathered layers counted per record, as
    many as each gloo rank ran."""
    shape = (4, 1)                        # the most gathered layers (8)
    recs = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)           # threads switch as often as can be
    try:
        for _ in range(3):
            with dryrun.dry_world(4):
                mesh = mesh_lib.make_mesh(shape, backend=mesh_lib.FAKE)
                rec = dryrun.lower_cnn_cell(
                    "darknet19", mesh, size=world.cnn_size("darknet19"),
                    gbatch=2)
            recs.append({k: v for k, v in rec.items() if k != "run_s"})
    finally:
        sys.setswitchinterval(interval)
    assert recs[1] == recs[0] and recs[2] == recs[0]
    assert rec["fallbacks"] == ranks[0]["forward"]["darknet19", shape, 0][1]


def test_dataclass_fields_of_the_plan_are_the_references():
    from repro.kernels.halo_conv import HaloPlan as JPlan
    from repro_torch.kernels.halo_conv import HaloPlan as TPlan
    assert [f.name for f in dataclasses.fields(TPlan)] == \
        [f.name for f in dataclasses.fields(JPlan)]
