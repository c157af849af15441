"""The port's checkpoint manager against the JAX package's, on the CPU.

Both packages write the same files (``step_<n>/{state.npz, meta.json}``,
``branch_<name>/{state.npz, manifest.json}``, npz keys ``t/``, ``o/``,
``b/`` + keystr names), so each reads the other's: every leaf must come
back bit for bit (tolerance 0), bfloat16 leaves included (numpy stores
them as raw 2-byte ``V2`` bits).  The ROM fingerprint of one converted
tree is the same hex in both packages; a different ROM is refused.

Parameters come from the JAX init and are converted with
``bridge.to_torch`` (the LM init draws on the device's own generator, so
one seed gives other parameters in the port: one tree is converted, not
reseeded).
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro import plan as jplan
from repro import scenario as jscenario
from repro.checkpoint import manager as jckpt
from repro.core import rebranch as jrebranch
from repro.core import rom as jrom
from repro.models import api as japi
from repro.models import cnn as jcnn
from repro import deploy as jdeploy
from repro_torch import bridge
from repro_torch import deploy as tdeploy
from repro_torch import plan as tplan
from repro_torch import scenario as tscenario
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import rebranch, rom
from repro_torch.models import cnn as tcnn


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(a):
    """Array bits for an exact comparison (bfloat16 as uint16)."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 and \
        a.dtype.kind in "Vfi" else a


def _assert_tree_equal(got, want):
    """``got`` (torch) equals ``want`` (numpy) leaf for leaf, bit for bit."""
    g, w = bridge.flatten(got), bridge.flatten(want)
    assert list(g) == list(w)
    for name, leaf in w.items():
        t = g[name]
        host = rom.host_bytes(t)
        assert tuple(t.shape) == tuple(leaf.shape), name
        np.testing.assert_array_equal(_bits(host), _bits(leaf), err_msg=name)


@pytest.fixture(scope="module")
def lm_state():
    """Gemma-2B smoke: JAX params, their trainable half and AdamW state,
    as numpy (seeded non-zero cores, so the branch is not all zeros)."""
    cfg = jconfigs.get_smoke("gemma_2b")
    params = _np(japi.init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(4)

    def cores(tree):
        if isinstance(tree, dict):
            out = {k: cores(v) for k, v in tree.items()}
            if "core" in out.get("sram", {}):
                out["sram"]["core"] = rng.normal(
                    size=out["sram"]["core"].shape).astype(np.float32)
            return out
        return tree

    params = cores(params)
    t, _ = jrebranch.partition(params)
    opt = _np(joptim.init(t))
    return params, t, opt


def _bf16_tree():
    """A ReBranch linear with bfloat16 branch and scale leaves."""
    spec = jrebranch.ReBranchSpec(param_dtype=jnp.bfloat16)
    p = _np(jrebranch.init_linear(jax.random.PRNGKey(5), 48, 24, spec,
                                  use_bias=True))
    p["sram"]["core"] = np.random.default_rng(6).normal(
        size=p["sram"]["core"].shape).astype(ml_dtypes.bfloat16)
    assert p["sram"]["core"].dtype == ml_dtypes.bfloat16
    return {"layer": p}


# ---------------------------------------------------------------------------
# the ROM fingerprint
# ---------------------------------------------------------------------------

def test_rom_fingerprint_same_hex_across_packages(lm_state):
    params = lm_state[0]
    tparams = bridge.to_torch(params, "cpu")
    assert rom.rom_fingerprint(tparams) == jrom.rom_fingerprint(params)
    bf = _bf16_tree()
    assert rom.rom_fingerprint(bridge.to_torch(bf, "cpu")) == \
        jrom.rom_fingerprint(bf)
    # the fingerprint sees the ROM, not the SRAM
    moved = bridge.to_torch(params, "cpu")
    moved["ln_f"]["sram"]["scale"] += 1.0
    assert rom.rom_fingerprint(moved) == rom.rom_fingerprint(tparams)
    moved["embed"]["rom"]["table_q"][0, 0] += 1
    assert rom.rom_fingerprint(moved) != rom.rom_fingerprint(tparams)


# ---------------------------------------------------------------------------
# step checkpoints, both directions
# ---------------------------------------------------------------------------

def test_step_written_by_jax_read_by_port(lm_state, tmp_path):
    params, t, opt = lm_state
    jckpt.save(str(tmp_path), 5, t, opt, params, extra={"lr": 0.5})
    step, t2, opt2, extra = ckpt.restore(
        str(tmp_path), bridge.to_torch(t, "cpu"),
        bridge.to_torch(opt, "cpu"), bridge.to_torch(params, "cpu"),
        device="cpu")
    assert step == 5 and extra == {"lr": 0.5}
    _assert_tree_equal(t2, t)
    _assert_tree_equal(opt2, opt)


def test_step_written_by_port_read_by_jax(lm_state, tmp_path):
    params, t, opt = lm_state
    ckpt.save(str(tmp_path), 9, bridge.to_torch(t, "cpu"),
              bridge.to_torch(opt, "cpu"), bridge.to_torch(params, "cpu"),
              extra={"note": "x"})
    step, t2, opt2, extra = jckpt.restore(str(tmp_path), t, opt, params)
    assert step == 9 and extra == {"note": "x"}
    for want, got in ((t, t2), (opt, opt2)):
        w, g = jckpt._flatten(want), jckpt._flatten(got)
        assert list(w) == list(g)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), w[k], err_msg=k)


def test_bf16_leaves_cross_both_ways(tmp_path):
    """bfloat16 leaves: numpy writes ml_dtypes arrays as raw ``V2``; each
    package reads the other's bits back unchanged."""
    bf = _bf16_tree()
    t, _ = jrebranch.partition(bf)
    opt = {"step": np.zeros((), np.int32)}
    jckpt.save(str(tmp_path / "j"), 1, t, opt, bf)
    tt = bridge.to_torch(t, "cpu")
    _, got, _, _ = ckpt.restore(str(tmp_path / "j"), tt,
                                bridge.to_torch(opt, "cpu"),
                                bridge.to_torch(bf, "cpu"), device="cpu")
    assert got["layer"]["sram"]["core"].dtype == torch.bfloat16
    _assert_tree_equal(got, t)
    ckpt.save(str(tmp_path / "t"), 2, tt, bridge.to_torch(opt, "cpu"),
              bridge.to_torch(bf, "cpu"))
    _, back, _, _ = jckpt.restore(str(tmp_path / "t"), t, opt, bf)
    w, g = jckpt._flatten(t), jckpt._flatten(back)
    for k in w:
        np.testing.assert_array_equal(_bits(g[k]), _bits(w[k]), err_msg=k)


def test_rom_fingerprint_mismatch_refused(lm_state, tmp_path):
    params, t, opt = lm_state
    ckpt.save(str(tmp_path), 1, bridge.to_torch(t, "cpu"),
              bridge.to_torch(opt, "cpu"), bridge.to_torch(params, "cpu"))
    other = bridge.to_torch(params, "cpu")
    other["layers"]["attn"]["q"]["rom"]["w_q"][0, 0, 0] += 1   # another ROM
    with pytest.raises(ValueError, match="fingerprint"):
        ckpt.restore(str(tmp_path), bridge.to_torch(t, "cpu"),
                     bridge.to_torch(opt, "cpu"), other, device="cpu")
    # and the JAX package refuses the port's file against its other ROM
    with pytest.raises(ValueError, match="fingerprint"):
        jckpt.restore(str(tmp_path), t, opt,
                      _np(japi.init(jax.random.PRNGKey(99),
                                    jconfigs.get_smoke("gemma_2b"))))


def test_geometry_mismatch_and_shardings(lm_state, tmp_path):
    params, t, opt = lm_state
    tp = bridge.to_torch(params, "cpu")
    tt, to = bridge.to_torch(t, "cpu"), bridge.to_torch(opt, "cpu")
    ckpt.save(str(tmp_path), 1, tt, to, tp)
    wide = bridge.tree_map(tt, lambda x: x)
    wide["ln_f"]["sram"]["scale"] = torch.ones(7)
    with pytest.raises(ValueError, match="geometry changed"):
        ckpt.restore(str(tmp_path), wide, to, tp, device="cpu")
    extra = dict(tt, extra_leaf={"sram": torch.zeros(2)})
    with pytest.raises(ValueError, match="does not match the template"):
        ckpt.restore(str(tmp_path), extra, to, tp, device="cpu")
    # shardings= is elastic restore now: without a sharding per leaf every
    # leaf comes back whole (test_torch_dist_train.py cuts blocks on a
    # mesh of ranks)
    step, rt, ro, _ = ckpt.restore(str(tmp_path), tt, to, tp,
                                   shardings=(None, None), device="cpu")
    assert step == 1
    for a, b in ((rt, tt), (ro, to)):
        for k, v in bridge.flatten(b).items():
            assert torch.equal(bridge.flatten(a)[k], v), k


# ---------------------------------------------------------------------------
# keep-k garbage collection and stray directories
# ---------------------------------------------------------------------------

def _small():
    p = bridge.to_torch(_bf16_tree(), "cpu")
    t, _ = rebranch.partition(p)
    return p, t, {"step": torch.zeros((), dtype=torch.int32)}


def test_keep_k_and_keep_zero(tmp_path):
    p, t, opt = _small()
    for s in [1, 2, 3, 4, 5]:
        ckpt.save(str(tmp_path), s, t, opt, p, keep=2)
    assert ckpt.latest_steps(str(tmp_path)) == [4, 5]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    ckpt._gc(str(tmp_path), keep=0)              # keep=0 keeps NOTHING
    assert ckpt.latest_steps(str(tmp_path)) == []
    ckpt.save(str(tmp_path), 6, t, opt, p, keep=0)
    assert ckpt.latest_steps(str(tmp_path)) == []
    th = ckpt.save(str(tmp_path), 7, t, opt, p, async_=True)
    th.join()
    assert ckpt.latest_steps(str(tmp_path)) == [7]


def test_latest_steps_skips_stray_dirs(tmp_path):
    p, t, opt = _small()
    ckpt.save(str(tmp_path), 7, t, opt, p)
    os.makedirs(tmp_path / "step_broken")
    os.makedirs(tmp_path / "step_00000007_backup")
    os.makedirs(tmp_path / "step_00000008.tmp")
    assert ckpt.latest_steps(str(tmp_path)) == [7]
    assert ckpt.restore(str(tmp_path), t, opt, p, device="cpu")[0] == 7
    assert jckpt.latest_steps(str(tmp_path)) == [7]


# ---------------------------------------------------------------------------
# branch checkpoints, both directions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vgg():
    """vgg8 at 16 px in both packages under the same solved plan; the
    JAX-drawn branch, as numpy, with a seeded shift."""
    jcfg = jcnn.CNNConfig(name="vgg8", input_size=16)
    tcfg = tcnn.CNNConfig(name="vgg8", input_size=16)
    jp, tp = jplan.solve(jcfg), tplan.solve(tcfg)
    jmodel = jdeploy.compile_model(jcfg, plan=jp)
    tmodel = tdeploy.compile_model(tcfg, plan=tp)
    params = _np(jmodel.init(jax.random.PRNGKey(0)))
    branch = jax.tree.map(lambda x: x + np.float32(0.01),
                          jrebranch.partition(params)[0])
    return jmodel, jp, tmodel, tp, branch


def test_branch_written_by_jax_read_by_port(vgg, tmp_path):
    jmodel, jp, tmodel, tp, branch = vgg
    jckpt.save_branch(str(tmp_path), "night", branch,
                      model_name="vgg8", plan=jp, extra={"acc": 0.5})
    assert ckpt.branch_scenarios(str(tmp_path)) == ["night"]
    got = ckpt.restore_branch(str(tmp_path), "night",
                              tscenario.branch_template(tmodel), plan=tp,
                              model_name="vgg8", device="cpu")
    _assert_tree_equal(got, branch)


def test_branch_written_by_port_read_by_jax(vgg, tmp_path):
    jmodel, jp, tmodel, tp, branch = vgg
    ckpt.save_branch(str(tmp_path), "day", bridge.to_torch(branch, "cpu"),
                     model_name="vgg8", plan=tp)
    assert jckpt.branch_scenarios(str(tmp_path)) == ["day"]
    got = jckpt.restore_branch(str(tmp_path), "day",
                               jscenario.branch_template(jmodel), plan=jp,
                               model_name="vgg8")
    w, g = jckpt._flatten(branch), jckpt._flatten(got)
    assert list(w) == list(g)
    for k in w:
        np.testing.assert_array_equal(np.asarray(g[k]), w[k], err_msg=k)


def test_branch_mismatches_refused(vgg, tmp_path):
    jmodel, jp, tmodel, tp, branch = vgg
    tb = bridge.to_torch(branch, "cpu")
    ckpt.save_branch(str(tmp_path), "day", tb, model_name="vgg8", plan=tp)
    template = tscenario.branch_template(tmodel)
    with pytest.raises(ValueError, match="mismatched placement"):
        ckpt.restore_branch(str(tmp_path), "day", template, plan=None,
                            device="cpu")
    with pytest.raises(ValueError, match="resnet18"):
        ckpt.restore_branch(str(tmp_path), "day", template, plan=tp,
                            model_name="resnet18", device="cpu")
    with pytest.raises(FileNotFoundError, match="day"):
        ckpt.restore_branch(str(tmp_path), "night", template, plan=tp,
                            device="cpu")
    bare = tdeploy.compile_model(tcnn.CNNConfig(
        name="vgg8", input_size=16,
        rebranch=rebranch.ReBranchSpec(branch_enabled=False)))
    with pytest.raises(ValueError, match="does not match the template"):
        ckpt.restore_branch(str(tmp_path), "day",
                            tscenario.branch_template(bare), plan=tp,
                            device="cpu")
    wide = tdeploy.compile_model(tcnn.CNNConfig(
        name="vgg8", input_size=16, num_classes=21))
    with pytest.raises(ValueError, match="geometry changed"):
        ckpt.restore_branch(str(tmp_path), "day",
                            tscenario.branch_template(wide), plan=tp,
                            device="cpu")


@pytest.mark.parametrize("name", ["../escape", "a/b", ".hidden", "", "x y"])
def test_unsafe_scenario_names_rejected(vgg, tmp_path, name):
    _, _, tmodel, tp, branch = vgg
    with pytest.raises(ValueError, match="filesystem-safe"):
        ckpt.save_branch(str(tmp_path), name, bridge.to_torch(branch, "cpu"),
                         model_name="vgg8", plan=tp)
    with pytest.raises(ValueError, match="filesystem-safe"):
        ckpt.restore_branch(str(tmp_path), name,
                            tscenario.branch_template(tmodel), plan=tp,
                            device="cpu")
    assert os.listdir(tmp_path) == []
