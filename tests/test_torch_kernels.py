"""Parity of the port's trunk-conv kernel path with the JAX package.

On the CPU the kernel wrapper takes its plain PyTorch version, which is
held BITWISE to ``repro.kernels.rebranch_conv.trunk_conv_pallas`` in its
default direct lowering: the k-block integer dots are exact, and scale /
accumulate round once each in ascending k-block order on both sides.  The
interpret-mode ``pallas_call`` grid is held to 1e-6 of the absmax
instead: XLA:CPU contracts its ``o_ref += dot * scale`` into an FMA, one
rounding fewer than the bit contract the direct lowering keeps.  The fused ReBranch conv
adds float branch GEMMs, summed in another order by XLA and PyTorch, so
it is held to rtol = atol = 1e-5 of the output's absmax.  The CUDA kernel
itself is compared with the plain version by ``test_torch_gpu.py``, which
imports no JAX so that it runs on the card, and skips without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cim as jcim
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import tiling as jtiling
from repro.kernels.cim_matmul import cim_block_dot as j_cim_block_dot
from repro.kernels.rebranch_conv import (rebranch_conv_pallas,
                                         trunk_conv_pallas)
from repro_torch.core import cim as tcim
from repro_torch.kernels import cim_matmul as tcm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rebranch_conv as trc
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tiling as ttiling

IDEAL_J, IDEAL_T = jcim.CiMConfig(mode="ideal"), tcim.CiMConfig(mode="ideal")

# (kernel, C_in, stride, H): R = k*k*C_in and its k-blocks of 512
CASES = {
    "R27_below_one_subarray": (3, 3, 1, 9),     # R = 27, one block of 128
    "gk1": (3, 20, 1, 8),                       # R = 180
    "gk1_1x1_R512": (1, 512, 1, 5),             # R = 512, one full block
    "gk2_ragged_tail": (3, 64, 1, 6),           # R = 576: 512 + 64
    "gk3_ragged_cin_stride2": (3, 130, 2, 9),   # R = 1170: 512+512+146
}


def _conv_inputs(seed, k, c_in, h, c_out=9, branch=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, h + 1, c_in)).astype(np.float32)
    x[0, 0, 0] = 0.0                            # an all-zero patch row
    w = rng.normal(size=(k, k, c_in, c_out)) / np.sqrt(k * k * c_in)
    scale = np.maximum(np.abs(w).max(axis=(0, 1, 2), keepdims=True),
                       1e-8) / 127.0
    w_q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    w_scale = scale.astype(np.float32)
    if not branch:
        return x, w_q, w_scale
    c_c, c_u = max(1, c_in // 4), max(1, c_out // 4)
    c = (rng.normal(size=(1, 1, c_in, c_c)) / np.sqrt(c_in)).astype(np.float32)
    core = (rng.normal(size=(k, k, c_c, c_u)) * 0.1).astype(np.float32)
    u = (rng.normal(size=(1, 1, c_u, c_out)) / np.sqrt(c_u)).astype(np.float32)
    return x, w_q, w_scale, c, core, u


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", sorted(CASES))
def test_trunk_conv_bitwise_vs_pallas(case):
    k, c_in, stride, h = CASES[case]
    x, w_q, w_scale = _conv_inputs(len(case), k, c_in, h, branch=False)
    want = np.asarray(trunk_conv_pallas(x, w_q, w_scale, IDEAL_J,
                                        stride=stride))
    got = trc.trunk_conv(*_t(x, w_q, w_scale), IDEAL_T, stride=stride)
    np.testing.assert_array_equal(got.numpy(), want)
    # the oracle and the STE wrapper the engines call agree bitwise too
    np.testing.assert_array_equal(
        tref.trunk_conv_ref(*_t(x, w_q, w_scale), IDEAL_T, stride).numpy(),
        want)
    np.testing.assert_array_equal(
        tops.trunk_conv(IDEAL_T, stride, "SAME", *_t(x, w_q, w_scale)).numpy(),
        want)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_trunk_conv_bitwise_vs_interpret_grid(padding):
    """Against the pallas_call grid (interpret mode), gk = 2; the grid's
    accumulate is FMA-contracted on the CPU (see the module docstring)."""
    x, w_q, w_scale = _conv_inputs(7, 3, 64, 6, branch=False)
    want = np.asarray(trunk_conv_pallas(x, w_q, w_scale, IDEAL_J,
                                        padding=padding, interpret=True))
    got = trc.trunk_conv(*_t(x, w_q, w_scale), IDEAL_T, padding=padding)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("case", ["gk1", "gk2_ragged_tail",
                                  "gk3_ragged_cin_stride2"])
def test_rebranch_conv_vs_pallas(case):
    k, c_in, stride, h = CASES[case]
    args = _conv_inputs(len(case), k, c_in, h)
    want = np.asarray(rebranch_conv_pallas(*args, IDEAL_J, stride=stride))
    got = trc.rebranch_conv(*_t(*args), IDEAL_T, stride=stride).numpy()
    assert got.shape == want.shape
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol)
    # the fused patch-matrix branch equals the unfused three-conv branch
    np.testing.assert_allclose(
        tref.rebranch_conv_ref(*_t(*args), IDEAL_T, stride).numpy(), want,
        rtol=1e-5, atol=tol)


@pytest.mark.parametrize("mode", ["ideal", "per_subarray"])
def test_trunk_conv_modes_vs_pallas(mode):
    """Non-ideal modes run through the plain version on the CPU."""
    x, w_q, w_scale = _conv_inputs(3, 3, 64, 6, branch=False)
    want = np.asarray(trunk_conv_pallas(
        x, w_q, w_scale, jcim.CiMConfig(mode=mode)))
    got = trc.trunk_conv(*_t(x, w_q, w_scale), tcim.CiMConfig(mode=mode))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["ideal", "per_subarray", "bitserial"])
def test_cim_block_dot_modes(mode):
    rng = np.random.default_rng(11)
    x = np.clip(np.round(rng.normal(size=(16, 256)) * 40), -127, 127)
    w = np.clip(np.round(rng.normal(size=(256, 12)) * 30), -127, 127)
    x, w = x.astype(np.int8), w.astype(np.int8)
    want = np.asarray(j_cim_block_dot(jcim.CiMConfig(mode=mode), x, w))
    got = tcm.cim_block_dot(tcim.CiMConfig(mode=mode), *_t(x, w)).numpy()
    if mode == "ideal":
        np.testing.assert_array_equal(got, want)
    else:   # ADC codes summed in another order: 1e-6 of the absmax
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_trunk_conv_ste_backward_matches_jax():
    x, w_q, w_scale = _conv_inputs(5, 3, 20, 8, branch=False)
    g = np.random.default_rng(6).normal(size=(2, 4, 5, 9)).astype(np.float32)

    def jloss(xx):
        return jnp.sum(jops.trunk_conv(IDEAL_J, 2, "SAME", xx, w_q, w_scale)
                       * g)

    want = np.asarray(jax.grad(jloss)(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tops.trunk_conv(IDEAL_T, 2, "SAME", xt, *_t(w_q, w_scale))
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-5)


def test_blocked_oracle_matches_jax_oracle():
    x, w_q, w_scale = _conv_inputs(9, 3, 64, 6, branch=False)
    want = np.asarray(jref.trunk_conv_ref(x, w_q, w_scale, IDEAL_J))
    got = tref.trunk_conv_ref(*_t(x, w_q, w_scale), IDEAL_T).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 27, 128, 180, 512, 576, 1170, 9216])
def test_k_partition_matches_jax_default(k):
    """The port's fixed k-partition is the JAX package's default one
    (block_k 512, 128-row subarrays): it fixes the quantisation groups."""
    assert ttiling.k_partition(k, 128) == jtiling.k_partition(k, 512, 128)
    k0, k1 = ttiling.k_partition(k, 128)[0]
    assert k1 - k0 == min(k, ttiling.block_k(k, 128))
