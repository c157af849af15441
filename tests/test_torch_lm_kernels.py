"""Parity of the port's LM kernel paths with the JAX package, on the CPU.

The kernel wrappers take their plain PyTorch versions here.

Kernel 4 (``cim_matmul``, the port of ``_cim_kernel``) is held BITWISE to
``cim_matmul_pallas`` (direct lowering and interpret grid): the block dots
are exact and the blocks are added in f32 in ascending order on both
sides, also where a row sum passes 2**24 and one int32 sum over all K
would round differently.

Kernel 3 (``rebranch_trunk_sketch``, the port of ``_rebranch_kernel``)
keeps the ROADMAP Queue 2 bit contract of the trunk kernels: ``part *
scale`` and ``acc + part`` round once each.  Its trunk is bitwise equal to
JAX's own contract-keeping trunk, the direct lowering of a 1x1
``trunk_conv_pallas`` on the same rows, and to ``_direct_rebranch`` and
the interpret grid wherever K is one k-block.  With more than one k-block
XLA:CPU contracts ``trunk + part * scale`` inside ``_direct_rebranch``'s
scan body (and in the grid's ``trunk_ref +=``) into an FMA, one rounding
fewer: the tests show the JAX trunk equals the port's own block parts
accumulated with that single rounding, bit for bit.  The f32 sketch t1
and the full output are held to 1e-5 of their absmax (float GEMMs summed
in another order).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import cim as jcim
from repro.core import rebranch as jrebranch
from repro.kernels import ops as jops
from repro.kernels.cim_matmul import cim_matmul_pallas
from repro.kernels.rebranch_conv import trunk_conv_pallas
from repro.kernels.rebranch_matmul import (_direct_rebranch,
                                           rebranch_matmul_pallas)
from repro_torch.core import cim as tcim
from repro_torch.core import quant as tquant
from repro_torch.core import rebranch as trebranch
from repro_torch.core.rebranch import ReBranchSpec as TSpec
from repro_torch.kernels import cim_matmul as tcm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rebranch_matmul as trm
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tiling

IDEAL_J, IDEAL_T = jcim.CiMConfig(mode="ideal"), tcim.CiMConfig(mode="ideal")


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _int8(rng, *shape):
    return rng.integers(-127, 128, size=shape).astype(np.int8)


# ---------------------------------------------------------------------------
# kernel 4: cim_matmul
# ---------------------------------------------------------------------------

# (M, K, N): one ragged block, whole blocks, ragged tails, up to 4 blocks
CIM_CASES = [(1, 64, 16), (3, 300, 48), (8, 512, 64), (37, 640, 100),
             (5, 1280, 48), (8, 2048, 64)]


@pytest.mark.parametrize("m,k,n", CIM_CASES)
def test_cim_matmul_bitwise_vs_pallas_direct(m, k, n):
    rng = np.random.default_rng(m * k + n)
    x, w = _int8(rng, m, k), _int8(rng, k, n)
    x[0] = 127                         # row 0 x column 0 sums past 2**24
    w[:, 0] = np.random.default_rng(6).integers(100, 128, size=k)
    want = np.asarray(cim_matmul_pallas(x, w, IDEAL_J, direct=True))
    got = tcm.cim_matmul(*_t(x, w)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tops.cim_matmul(*_t(x, w), IDEAL_T).numpy(), want)
    exact = x.astype(np.int64) @ w.astype(np.int64)
    assert (abs(exact[0, 0]) > 2 ** 24) == (k >= 1280)
    if k == 2048:
        # one int32 sum over all K (cim_matmul_model) rounds differently
        assert np.float32(exact[0, 0]) != want[0, 0]


def test_cim_matmul_bitwise_vs_interpret_grid():
    rng = np.random.default_rng(3)
    x, w = _int8(rng, 10, 1100), _int8(rng, 1100, 40)
    x[0], w[:, 0] = 127, 127
    want = np.asarray(cim_matmul_pallas(x, w, IDEAL_J, interpret=True))
    np.testing.assert_array_equal(tcm.cim_matmul(*_t(x, w)).numpy(), want)


@pytest.mark.parametrize("mode", ["per_subarray", "bitserial"])
def test_cim_matmul_modes_vs_pallas(mode):
    """Non-ideal modes run the plain version on the CPU; ADC codes sum in
    another order, so 1e-6 of the absmax."""
    rng = np.random.default_rng(4)
    k = 640 if mode == "per_subarray" else 256    # bitserial traces slowly
    x = np.clip(np.round(rng.normal(size=(6, k)) * 40), -127, 127)
    w = np.clip(np.round(rng.normal(size=(k, 12)) * 30), -127, 127)
    x, w = x.astype(np.int8), w.astype(np.int8)
    want = np.asarray(cim_matmul_pallas(x, w, jcim.CiMConfig(mode=mode),
                                        direct=True))
    got = tcm.cim_matmul(*_t(x, w), tcim.CiMConfig(mode=mode)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------------------------
# kernel 3: the fused ReBranch matmul
# ---------------------------------------------------------------------------

def _rebranch_inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    x[0, : min(k, 40)] *= 1e3            # one row's first block dominates
    w = _int8(rng, k, n)
    w_scale = (rng.random((1, n)) * 1e-2 + 1e-3).astype(np.float32)
    c = (rng.normal(size=(k, k // 4)) / np.sqrt(k)).astype(np.float32)
    core = (rng.normal(size=(k // 4, n // 4)) * 0.1).astype(np.float32)
    u = (rng.normal(size=(n // 4, n)) / np.sqrt(n // 4)).astype(np.float32)
    return x, w, w_scale, c, core, u


def _fma_trunk(x, w):
    """The port's block parts, accumulated with ONE rounding per block
    (``fl(acc + part * scale)``, as an FMA does)."""
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for k0, k1 in tiling.k_partition(x.shape[1], 128):
        q, s = tquant.quant_rows_f32(torch.from_numpy(x[:, k0:k1]))
        dot = tcim.int_dot(q, torch.from_numpy(w[k0:k1])).numpy()
        acc = (acc.astype(np.float64) + dot.astype(np.float64)
               * s.numpy().astype(np.float64)).astype(np.float32)
    return acc


def _jax_contract_trunk(x, w):
    """JAX's contract-keeping trunk: a 1x1 ``trunk_conv_pallas`` over the
    rows of x (direct lowering), with w_scale 1."""
    ones = np.ones((w.shape[1],), np.float32)
    out = trunk_conv_pallas(x[:, None, None, :], w[None, None], ones,
                            IDEAL_J)
    return np.asarray(out)[:, 0, 0]


@pytest.mark.parametrize("n", [48, 256])
@pytest.mark.parametrize("k", [64, 300, 512, 1280])
@pytest.mark.parametrize("m", [1, 8, 37])
def test_rebranch_trunk_and_sketch_vs_direct(m, k, n):
    x, w, w_scale, c, core, u = _rebranch_inputs(m, k, n, seed=m + k + n)
    bk = tiling.block_k(k, 128)
    jt, jt1 = _direct_rebranch(x, w, c, cfg=IDEAL_J, bk=bk)
    jt, jt1 = np.asarray(jt), np.asarray(jt1)
    trunk, t1 = trm.rebranch_trunk_sketch(*_t(x, w, c))
    trunk, t1 = trunk.numpy(), t1.numpy()
    np.testing.assert_array_equal(trunk, _jax_contract_trunk(x, w))
    if k <= bk:
        np.testing.assert_array_equal(trunk, jt)
    else:     # XLA:CPU's FMA-contracted accumulate, see the docstring
        np.testing.assert_array_equal(_fma_trunk(x, w), jt)
    np.testing.assert_allclose(t1, jt1, rtol=0,
                               atol=1e-5 * np.abs(jt1).max())
    want = np.asarray(rebranch_matmul_pallas(x, w, w_scale, c, core, u,
                                             IDEAL_J, direct=True))
    got = trm.rebranch_matmul(*_t(x, w, w_scale, c, core, u)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("m,k,n", [(8, 300, 48), (37, 1280, 256)])
def test_rebranch_matmul_vs_interpret_grid(m, k, n):
    x, w, w_scale, c, core, u = _rebranch_inputs(m, k, n, seed=5)
    # w_scale 1 and a zero core: the grid's output IS its trunk
    ones, zc = np.ones((1, n), np.float32), np.zeros_like(core)
    grid_trunk = np.asarray(rebranch_matmul_pallas(x, w, ones, c, zc, u,
                                                   IDEAL_J, interpret=True))
    trunk, _ = trm.rebranch_trunk_sketch(*_t(x, w, c))
    if k <= 512:
        np.testing.assert_array_equal(trunk.numpy(), grid_trunk)
    else:
        np.testing.assert_array_equal(_fma_trunk(x, w), grid_trunk)
    want = np.asarray(rebranch_matmul_pallas(x, w, w_scale, c, core, u,
                                             IDEAL_J, interpret=True))
    got = tops.rebranch_matmul(*_t(x, w, w_scale, c, core, u)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # and the unblocked-branch oracle agrees with the fused path
    np.testing.assert_allclose(
        tref.rebranch_matmul_ref(*_t(x, w, w_scale, c, core, u)).numpy(),
        want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_rebranch_rows_are_independent_of_the_batch():
    x, w, _, c, _, _ = _rebranch_inputs(9, 1280, 48, seed=6)
    trunk, t1 = trm.rebranch_trunk_sketch(*_t(x, w, c))
    one_trunk, one_t1 = trm.rebranch_trunk_sketch(*_t(x[4:5], w, c))
    assert torch.equal(one_trunk, trunk[4:5])
    # the CPU's f32 GEMM blocks the sketch by M; the card's kernel does not
    np.testing.assert_allclose(one_t1.numpy(), t1[4:5].numpy(), rtol=0,
                               atol=1e-5 * t1.abs().max().item())


# ---------------------------------------------------------------------------
# ops.trunk_matmul_pallas and apply_linear under the four engines
# ---------------------------------------------------------------------------

def test_trunk_matmul_pallas_forward_and_ste_vs_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 700)).astype(np.float32)
    w, w_scale = _int8(rng, 700, 48), (rng.random((48,)) * 1e-2
                                       ).astype(np.float32)
    g = rng.normal(size=(2, 5, 48)).astype(np.float32)
    want = np.asarray(jops.trunk_matmul_pallas(IDEAL_J, x, w, w_scale))
    got = tops.trunk_matmul_pallas(IDEAL_T, *_t(x, w, w_scale)).numpy()
    np.testing.assert_array_equal(got, want)

    def jloss(xx):
        return jnp.sum(jops.trunk_matmul_pallas(IDEAL_J, xx, w, w_scale) * g)

    want_dx = np.asarray(jax.grad(jloss)(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tops.trunk_matmul_pallas(IDEAL_T, xt, *_t(w, w_scale))
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=1e-5,
                               atol=1e-6)


def _linear_params(d_in, d_out, seed, bias=False, enabled=True):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    if not enabled:
        return {"sram": {"w": w}}
    scale = np.maximum(np.abs(w).max(axis=0, keepdims=True), 1e-8) / 127.0
    w_q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    d_c, d_u = d_in // 4, d_out // 4
    p = {"rom": {"w_q": w_q, "w_scale": scale.astype(np.float32),
                 "C": (rng.normal(size=(d_in, d_c)) / np.sqrt(d_in)
                       ).astype(np.float32),
                 "U": (rng.normal(size=(d_u, d_out)) / np.sqrt(d_u)
                       ).astype(np.float32)},
         "sram": {"core": (rng.normal(size=(d_c, d_u)) * 0.05
                           ).astype(np.float32)}}
    if bias:
        p["sram"]["b"] = (rng.normal(size=(d_out,)) * 0.1).astype(np.float32)
    return p


def _to_t(tree):
    if isinstance(tree, dict):
        return {k: _to_t(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


@pytest.mark.parametrize("engine", ["int8_native", "dequant", "pallas",
                                    "pallas_fused"])
@pytest.mark.parametrize("d_in,bias", [(192, True), (1280, False)])
def test_apply_linear_vs_jax(engine, d_in, bias):
    p = _linear_params(d_in, 96, seed=d_in, bias=bias)
    x = np.random.default_rng(8).normal(size=(2, 3, d_in)).astype(np.float32)
    jspec = jrebranch.ReBranchSpec(trunk_impl=engine)
    want = np.asarray(jrebranch.apply_linear(p, x, jspec))
    got = trebranch.apply_linear(_to_t(p), torch.from_numpy(x),
                                 TSpec(trunk_impl=engine)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("variant", ["sram", "trunk_only", "trunk_skip"])
def test_apply_linear_routes_vs_jax(variant):
    enabled = variant != "sram"
    p = _linear_params(256, 64, seed=9, bias=True, enabled=enabled)
    x = np.random.default_rng(10).normal(size=(4, 256)).astype(np.float32)
    kw = {"sram": dict(enabled=False),
          "trunk_only": dict(branch_enabled=False),
          "trunk_skip": dict(trunk_skip=True)}[variant]
    want = np.asarray(jrebranch.apply_linear(
        p, x, jrebranch.ReBranchSpec(trunk_impl="pallas_fused", **kw)))
    got = trebranch.apply_linear(_to_t(p), torch.from_numpy(x),
                                 TSpec(trunk_impl="pallas_fused", **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
