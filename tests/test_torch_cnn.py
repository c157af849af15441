"""The port's four CNNs, placement plans and ``compile_model`` against the
JAX package, on the CPU, batch 2, at 32 px (Tiny-YOLO at 64 px: its six
pools leave no pixel of a 32 px image).

Parameters are drawn by the port's own init (a torch.Generator), their
zero-initialised ReBranch cores replaced by seeded non-zero ones so every
branch contributes, and handed to both packages as numpy; their tree is
checked against the JAX init's shapes (``jax.eval_shape``).  The JAX side
runs eagerly, as the package's own tests run it on the CPU.

Tolerances.  One conv layer on identical inputs: 1e-5 of the output's
absmax — the trunk is exact, and only float rounding differs (BN's rsqrt
may differ by an ulp; branch GEMMs, plain convs and matmuls sum in
another order).  A whole forward: 5e-2 of the absmax.  The quantised
networks are chaotic at the ulp level: an ulp moved before a later
layer's activation quantiser flips an int8 code, and the JAX package's
OWN forward moves by up to 2.3e-2 of its absmax when its input is
perturbed by 1e-7 relative (DarkNet-19 at 32 px under 'dequant' and
'pallas'; 7e-3 for VGG-8 and ResNet-18).  Plans are pure arithmetic and
must come out EQUAL.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import deploy as jdeploy
from repro import plan as jplan
from repro.models import cnn as jcnn
from repro_torch import bridge
from repro_torch import deploy as tdeploy
from repro_torch import plan as tplan
from repro_torch.models import cnn as tcnn

MODELS = ("vgg8", "resnet18", "darknet19", "tiny_yolo")
ENGINES = ("int8_native", "dequant", "pallas", "pallas_fused")


def _with_cores(params, rng):
    """Replace every zero ReBranch core by seeded N(0, 0.05) values."""
    if isinstance(params, dict):
        out = {k: _with_cores(v, rng) for k, v in params.items()}
        if "core" in out.get("sram", {}):
            core = out["sram"]["core"]
            out["sram"] = dict(out["sram"], core=(
                rng.normal(size=core.shape) * 0.05).astype(np.float32))
        return out
    if isinstance(params, list):
        return [_with_cores(v, rng) for v in params]
    return params


_PARAMS = {}


def _size(name):
    return 64 if name == "tiny_yolo" else 32


def _params(name):
    """(numpy params, NHWC images) for a model, built once per process."""
    if name not in _PARAMS:
        size = _size(name)
        tcfg = tcnn.CNNConfig(name=name, input_size=size)
        params = bridge.to_numpy(
            tdeploy.compile_model(tcfg).init(3, device="cpu"))
        init, _ = jcnn.MODEL_REGISTRY[name]
        shapes = jax.eval_shape(
            lambda k: init(k, jcnn.CNNConfig(name=name, input_size=size)),
            jax.random.PRNGKey(0))
        assert jax.tree.structure(params) == jax.tree.structure(shapes)
        assert [(a.shape, a.dtype) for a in jax.tree.leaves(params)] == \
            [(a.shape, a.dtype) for a in jax.tree.leaves(shapes)]
        rng = np.random.default_rng(len(name))
        x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
        _PARAMS[name] = (_with_cores(params, rng), x)
    return _PARAMS[name]


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_jax(name, engine, fuse):
    params, x = _params(name)
    jm = jdeploy.compile_model(
        jcnn.CNNConfig(name=name, input_size=_size(name), fuse_bn_act=fuse),
        engine=engine)
    want = np.asarray(jm.forward(params, x))
    tm = tdeploy.compile_model(
        tcnn.CNNConfig(name=name, input_size=_size(name), fuse_bn_act=fuse),
        engine=engine)
    with torch.no_grad():
        got = tm.forward(bridge.to_torch(params, "cpu"),
                         torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.size > 0
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-2 * np.abs(want).max())


# (kernel, C_in, stride, with branch)
LAYERS = [(3, 20, 1, True), (3, 33, 2, True), (1, 40, 1, True),
          (3, 20, 1, False)]


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("k,c_in,stride,branch", LAYERS)
def test_conv_layer_matches_jax(k, c_in, stride, branch, engine, fuse):
    """apply_conv with a BN + leaky-ReLU epilogue, one layer, same input."""
    rng = np.random.default_rng(k * 100 + c_in + stride)
    jspec = jdeploy.ReBranchSpec(trunk_impl=engine, branch_enabled=branch)
    tspec = tcnn.ReBranchSpec(trunk_impl=engine, branch_enabled=branch)
    p = bridge.to_numpy(tcnn.init_conv(torch.Generator().manual_seed(c_in),
                                       k, c_in, 12, tspec))
    p = _with_cores(p, rng)
    bn = {"sram": {"scale": rng.uniform(0.5, 1.5, 12).astype(np.float32),
                   "bias": rng.normal(size=12).astype(np.float32),
                   "mean": rng.normal(size=12).astype(np.float32),
                   "var": rng.uniform(0.5, 2.0, 12).astype(np.float32)}}
    x = rng.normal(size=(2, 9, 9, c_in)).astype(np.float32)

    def run(cnn_lib, spec, pp, bnp, xx):
        if fuse:
            return cnn_lib.apply_conv(pp, xx, spec, stride,
                                      cnn_lib.bn_epilogue(bnp, "leaky_relu"))
        y = cnn_lib.apply_conv(pp, xx, spec, stride)
        return cnn_lib.engine_base.finish(
            y, cnn_lib.bn_epilogue(bnp, "leaky_relu"))

    want = np.asarray(run(jcnn, jspec, p, bn, x))
    with torch.no_grad():
        got = run(tcnn, tspec, bridge.to_torch(p, "cpu"),
                  bridge.to_torch(bn, "cpu"), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _spec_fields(spec):
    return (spec.enabled, spec.trunk_impl, spec.branch_enabled, spec.d_ratio,
            spec.u_ratio, spec.trunk_skip, dataclasses.astuple(spec.cim))


@pytest.mark.parametrize("name", MODELS)
def test_solve_equal_across_packages(name):
    jcfg = jcnn.CNNConfig(name=name, input_size=32)
    tcfg = tcnn.CNNConfig(name=name, input_size=32)
    points = tplan.sweep(tcfg, 5)
    assert [p["budget_mm2"] for p in points] == \
        [p["budget_mm2"] for p in jplan.sweep(jcfg, 5)]
    budgets = [None] + [p["budget_mm2"] for p in points]
    for budget in budgets:
        jp = jplan.solve(jcfg, budget, engine="pallas_fused")
        tp = tplan.solve(tcfg, budget, engine="pallas_fused")
        assert [(a, _spec_fields(s)) for a, s in tp.entries] == \
            [(a, _spec_fields(s)) for a, s in jp.entries]
        assert _spec_fields(tp.default) == _spec_fields(jp.default)
        assert dataclasses.astuple(tp.stats(tcfg)) == \
            dataclasses.astuple(jp.stats(jcfg))


@pytest.mark.parametrize("name", MODELS)
def test_site_shapes_equal_across_packages(name):
    for size in (32, 416):
        assert tcnn.conv_site_shapes(tcnn.CNNConfig(name=name,
                                                    input_size=size)) == \
            jcnn.conv_site_shapes(jcnn.CNNConfig(name=name, input_size=size))


def test_layer_overrides_raise_on_unknown_sites():
    cfg = tcnn.CNNConfig(name="darknet19", input_size=32)
    with pytest.raises(ValueError, match="not wired"):
        tdeploy.compile_model(cfg, layer_overrides={"convs.99": {
            "memory": "sram"}})
    with pytest.raises(ValueError, match="unknown keys"):
        tdeploy.compile_model(cfg, layer_overrides={"convs.0": {"mem": 1}})
    with pytest.raises(ValueError, match="unknown trunk engine"):
        tdeploy.compile_model(cfg, engine="no_such_engine")
    assert "head" in tdeploy.valid_sites(cfg)


def test_plan_equals_equivalent_overrides():
    """Deploying under a plan is bit-identical to the same mapping given
    as layer_overrides (the first conv SRAM-resident, the rest fused)."""
    cfg = tcnn.CNNConfig(name="tiny_yolo", input_size=32)
    overrides = {"convs.0": {"memory": "sram"}}
    plan = tplan.PlacementPlan.build(cfg, overrides, default=dataclasses.replace(
        cfg.rebranch, trunk_impl="pallas_fused"))
    by_plan = tdeploy.compile_model(cfg, plan=plan)
    by_overrides = tdeploy.compile_model(cfg, engine="pallas_fused",
                                         layer_overrides=overrides)
    assert by_plan.layer_spec("convs.0").enabled is False
    params = by_plan.init(1, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(by_plan.forward(params, x),
                           by_overrides.forward(params, x))
