"""The port's CNN serving front door on the CPU: pad rows never change a
real row (bitwise), ``load`` of a builtin id deploys the same plan as the
JAX package and serves what ``compile_model`` computes, and the registry
is strict."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.serve import registry as jregistry
from repro_torch.serve import registry, server


def _spec_fields(spec):
    return (spec.enabled, spec.trunk_impl, spec.branch_enabled, spec.d_ratio,
            spec.u_ratio, dataclasses.astuple(spec.cim))


def _with_cores(tree, gen):
    if isinstance(tree, dict):
        out = {k: _with_cores(v, gen) for k, v in tree.items()}
        if "core" in out.get("sram", {}):
            core = out["sram"]["core"]
            out["sram"]["core"] = torch.randn(core.shape, generator=gen) * 0.05
        return out
    if isinstance(tree, list):
        return [_with_cores(v, gen) for v in tree]
    return tree


@pytest.fixture(scope="module")
def darknet():
    srv = server.load("darknet19-32", seed=0, n_slots=4, device="cpu")
    srv.params = _with_cores(srv.params, torch.Generator().manual_seed(1))
    images = np.random.default_rng(2).normal(
        size=(7, 32, 32, 3)).astype(np.float32)
    return srv, images


def test_pad_rows_are_invisible_bitwise(darknet):
    srv, images = darknet
    short = srv.submit(images[:3])            # one chunk, one pad row
    full = srv.submit(images[:4])             # the same rows, no padding
    assert short.shape == (3, 1, 1, 5, 25) and np.isfinite(short).all()
    np.testing.assert_array_equal(short, full[:3])
    # 7 images = one full chunk + a padded one, row for row the same again
    both = srv.submit(images)
    np.testing.assert_array_equal(both[:4], full)
    np.testing.assert_array_equal(both[4:], srv.submit(images[4:]))
    with torch.no_grad():
        direct = srv.model.forward(srv.params, torch.from_numpy(images[:4]))
    np.testing.assert_array_equal(full, direct.numpy())


def test_load_deploys_the_jax_packages_plan():
    srv = server.load("darknet19-32", device="cpu")
    assert srv.n_slots == 8 and srv.device == torch.device("cpu")
    jmodel, _ = jregistry.compile_entry("darknet19-32")
    tcfg, jcfg = srv.model.cfg, jmodel.cfg
    assert (tcfg.name, tcfg.input_size) == (jcfg.name, jcfg.input_size)
    assert [(a, _spec_fields(s)) for a, s in tcfg.rebranch_overrides] == \
        [(a, _spec_fields(s)) for a, s in jcfg.rebranch_overrides]
    assert _spec_fields(tcfg.rebranch) == _spec_fields(jcfg.rebranch)
    # the cell is resident: a second compile returns the same objects
    assert registry.compile_entry("darknet19-32")[0] is srv.model
    with pytest.raises(ValueError, match="no ScenarioStore"):
        srv.swap_scenario("night")


def test_registry_is_strict():
    cnn_ids = {i for i in jregistry.registered_ids() if i.endswith("-32")}
    assert set(registry.registered_ids()) >= cnn_ids
    with pytest.raises(KeyError, match="unknown model id 'darknet19-33'"):
        registry.resolve("darknet19-33")
    with pytest.raises(KeyError, match="registered"):
        server.load("no-such-model", device="cpu")
    entry = registry.resolve("vgg8-32")
    with pytest.raises(ValueError, match="already registered"):
        registry.register(entry)
    first = registry.compile_entry("vgg8-32")
    registry.register(entry, override=True)     # drops the resident cell
    assert registry.compile_entry("vgg8-32") is not first
    with pytest.raises(ValueError, match="at least one slot"):
        server.CNNServer(first[0], {"w": torch.zeros(1)}, n_slots=0)
