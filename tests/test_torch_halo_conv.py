"""The port's halo-exchange sharded conv (``kernels/halo_conv.py``, the
'pallas_sharded' engine) against the JAX package, on the CPU.

The halo plan is pure arithmetic and must come out EQUAL to the
reference's, over its own cases and every DarkNet-19 / ResNet-18 conv
geometry.  Sharded runs go through one spawned world of 4 gloo ranks
(``_torch_world.halo_world``, started once for the module) on meshes 4x1,
2x2 and 1x4, so the data axis shards H 4, 2 and 1 ways; every rank
returns the whole output, and every rank must agree.

Contracts (the reference's, ``src/repro/kernels/halo_conv.py``):
  * the sharded trunk equals the unsharded one bit for bit in every CiM
    mode.  In ``ideal`` it is held to the JAX ``trunk_conv_pallas``
    itself (one k-block: the port's trunk is the reference's bits).  In
    the ADC modes the JAX entry point is jitted and XLA fuses its ADC
    chain, so the port's unsharded trunk is 1e-6 of the absmax from it
    (``test_torch_adc.py``): the sharded trunk is held bitwise to the
    port's unsharded trunk, and both to JAX at 1e-6;
  * the fused route and the plain sharded conv add float GEMMs and convs
    on local shapes: within 1e-5 of the absmax of JAX's
    ``rebranch_conv_pallas`` (``test_torch_conv_nhwc.py``'s tolerance)
    and of the unsharded port;
  * the sharded trunk's STE backward and a plain sharded conv's give the
    unsharded dx (the exchange's adjoint returns the halo rows' gradient).

The reference's own sharded tests cannot run here (jax 0.9's
``shard_map`` refuses their ``check_rep=False``), so the oracle is the
reference's unsharded kernel.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

import _torch_world as world
from repro.core import cim as jcim
from repro.kernels import halo_conv as jhalo
from repro.kernels.rebranch_conv import rebranch_conv_pallas, trunk_conv_pallas
from repro.models import cnn as jcnn
from repro_torch.kernels import halo_conv as thalo
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import cnn as tcnn

WORLD = 4
DEADLINE_S = 240


@pytest.fixture(scope="module")
def ranks():
    """Each rank's results of ``_torch_world.halo_world``."""
    return mesh_lib.spawn(world.halo_world, WORLD, backend="gloo",
                          deadline_s=DEADLINE_S)


def _agreed(ranks, section, key):
    """``ranks[0][section][key]`` (an array or a tuple of arrays), after
    checking that every rank returned the same bits."""
    first = ranks[0][section][key]
    as_tuple = lambda v: v if isinstance(v, tuple) else (v,)
    for r in ranks[1:]:
        for a, b in zip(as_tuple(r[section][key]), as_tuple(first)):
            np.testing.assert_array_equal(a, b)
    return first


def _close(got, want, rel):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


# ---------------------------------------------------------------------------
# the halo plan (pure)
# ---------------------------------------------------------------------------

# the reference's own cases (tests/test_sharded_conv.py::TestHaloPlan)
PLAN_CASES = [(16, 3, 1, "SAME", 4), (16, 3, 2, "SAME", 4),
              (16, 1, 1, "SAME", 4), (9, 3, 2, "SAME", 4),
              (4, 5, 1, "SAME", 4), (8, 5, 1, "SAME", 8),
              (13, 3, 1, "SAME", 2), (9, 3, 2, "VALID", 2)]


def _model_geometries():
    """(h, kh, stride) of every conv of DarkNet-19 and ResNet-18 at 32 and
    416 px."""
    out = set()
    for name in ("darknet19", "resnet18"):
        for size in (32, 416):
            for _, k, _, _, in_hw, _, st in tcnn._conv_sites(
                    tcnn.CNNConfig(name=name, input_size=size)):
                out.add((in_hw, k, st))
    return sorted(out)


@pytest.mark.parametrize("h,kh,stride,padding,n", PLAN_CASES + [
    (h, k, s, "SAME", n) for h, k, s in _model_geometries()
    for n in (1, 2, 4, 8)])
def test_plan_halo_and_halo_bytes_equal_the_reference(h, kh, stride,
                                                      padding, n):
    want = jhalo.plan_halo(h, kh, stride, padding, n)
    got = thalo.plan_halo(h, kh, stride, padding, n)
    if want is None:
        assert got is None
    else:
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    shape = (2, h, 11, 20)
    assert thalo.halo_bytes(shape, kh, stride, padding, n) == \
        jhalo.halo_bytes(shape, kh, stride, padding, n)


def test_plan_fits_every_darknet19_conv_at_416_and_not_at_32():
    """plan_halo is None at 0 DarkNet-19 sites at 416 for n = 2 and 4; at
    32 at 5 (n = 2) and 8 (n = 4), the sites of H <= 2."""
    def misses(size, n):
        return sum(thalo.plan_halo(hw, k, 1, "SAME", n) is None
                   for _, k, _, _, hw, _ in jcnn.conv_site_shapes(
                       jcnn.CNNConfig(name="darknet19", input_size=size)))
    assert [misses(416, 2), misses(416, 4)] == [0, 0]
    assert [misses(32, 2), misses(32, 4)] == [5, 8]


# ---------------------------------------------------------------------------
# sharded runs over 4 gloo ranks
# ---------------------------------------------------------------------------

@functools.cache
def _jax_trunk(k, stride, h):
    x, w_q, w_scale = world.conv_case(k * 10 + h, k, 20, 12, h)[:3]
    return np.asarray(trunk_conv_pallas(
        x, w_q, w_scale, jcim.CiMConfig(mode="ideal"), stride=stride))


@pytest.mark.parametrize("shape", world.MESH_SHAPES)
@pytest.mark.parametrize("k,stride,h", world.SWEEP)
def test_sharded_trunk_bitwise_vs_jax(ranks, shape, k, stride, h):
    """The reference's sweep: n in {4, 2, 1}, k in {1, 3}, stride in
    {1, 2}, even (aligned) and odd (general path) H."""
    got = _agreed(ranks, "sweep", (shape, k, stride, h))
    want = _jax_trunk(k, stride, h)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@functools.cache
def _jax_adc_trunk(mode, h):
    x, w_q, w_scale = world.conv_case(h, 3, world.ADC_C_IN, 12, h, n=1)[:3]
    return np.asarray(jax.jit(lambda x: trunk_conv_pallas(
        x, w_q, w_scale, jcim.CiMConfig(mode=mode)))(x))


@pytest.mark.parametrize("shape", world.MESH_SHAPES)
@pytest.mark.parametrize("mode,h", world.ADC_CASES)
def test_sharded_trunk_in_adc_modes(ranks, shape, mode, h):
    got, unsharded = _agreed(ranks, "adc", (shape, mode, h))
    np.testing.assert_array_equal(got, unsharded)
    _close(got, _jax_adc_trunk(mode, h), 1e-6)


@functools.cache
def _jax_fused(h, stride):
    return np.asarray(rebranch_conv_pallas(
        *world.conv_case(h + stride, 3, 20, 12, h),
        jcim.CiMConfig(mode="ideal"), stride=stride))


@pytest.mark.parametrize("shape", world.MESH_SHAPES)
@pytest.mark.parametrize("h,stride", world.FUSED_CASES)
def test_sharded_rebranch_conv(ranks, shape, h, stride):
    got, unsharded = _agreed(ranks, "fused", (shape, h, stride))
    _close(got, unsharded, 1e-5)
    _close(got, _jax_fused(h, stride), 1e-5)


@pytest.mark.parametrize("shape", world.MESH_SHAPES)
@pytest.mark.parametrize("k,stride,h", world.SWEEP)
def test_sharded_conv_nhwc(ranks, shape, k, stride, h):
    """The plain conv a branch core (or an SRAM site) runs under a mesh."""
    got, unsharded = _agreed(ranks, "plain", (shape, k, stride, h))
    _close(got, unsharded, 1e-6)


def test_every_darknet19_and_resnet18_geometry_bitwise(ranks):
    """Every trunk-conv geometry of both models (32 px, channels capped at
    64) sharded 4 ways equals the unsharded 'pallas' engine bit for bit."""
    for r in ranks:
        assert r["geoms"] and all(r["geoms"].values()), r["geoms"]
    assert len(ranks[0]["geoms"]) == len(world.geometry_cases())


def test_sharded_trunk_backward_raises_naming_the_next_slice(ranks):
    """The slice it named has come: the sharded trunk's STE backward and a
    plain sharded conv's backward (through the exchange's adjoint) give
    the unsharded dx on 4 ranks, to 1e-5 of its absmax (summed in another
    order: the halo rows' gradient arrives from the neighbour)."""
    for r in ranks:
        for got, want in (r["backward"], r["exchange_grad"]):
            _close(got, want, 1e-5)
    assert all(r["traffic"]["halo_adjoint"] > 0 for r in ranks)


def test_halo_rows_crossed_between_ranks(ranks):
    for r in ranks:
        assert r["traffic"]["halo"] > 0 and r["traffic"]["gather"] > 0
