"""Parity of the port's quantisation and CiM macro model with the JAX
package (``repro_torch.core`` vs ``repro.core``), on the CPU.

Inputs come from a numpy seed and pass between the packages as numpy.
Integer results and the quantisers are held bitwise; the non-ideal macro
modes sum ADC codes (multiples of a non-integer lsb) in another order
than XLA, so they get a tolerance of 1e-6 of the output's absmax.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import cim as jcim
from repro.core import quant as jquant
from repro.core import rebranch as jrebranch
from repro_torch.core import cim as tcim
from repro_torch.core import quant as tquant
from repro_torch.core import rebranch as trebranch


def _rows(seed, m=48, k=300):
    """Rows of mixed magnitude, plus an all-zero row and a tiny one."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)) * rng.uniform(1e-3, 30, size=(m, 1))
    x[0] = 0.0
    x[1] *= 1e-9
    return x.astype(np.float32)


def _int8(rng, shape, scale=40):
    return np.clip(np.round(rng.normal(size=shape) * scale),
                   -127, 127).astype(np.int8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quant_rows_bitwise_vs_jitted(seed):
    x = _rows(seed)
    q, s = jax.jit(jquant.quant_rows)(x)
    tq, ts = tquant.quant_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    qf, sf = jax.jit(jquant.quant_rows_f32)(x)
    tqf, tsf = tquant.quant_rows_f32(torch.from_numpy(x))
    np.testing.assert_array_equal(tqf.numpy(), np.asarray(qf))
    np.testing.assert_array_equal(tsf.numpy(), np.asarray(sf))


@pytest.mark.parametrize("seed", [0, 1])
def test_division_form_quantisers(seed):
    x = _rows(seed)
    q, s = jquant.quantize_activations(x)
    tq, ts = tquant.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    w = np.random.default_rng(seed).normal(size=(3, 3, 8, 5)).astype(np.float32)
    wq, ws = jquant.quantize_weights(w, axis=(0, 1, 2))
    twq, tws = tquant.quantize_weights(torch.from_numpy(w), axis=(0, 1, 2))
    np.testing.assert_array_equal(twq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(tws.numpy(), np.asarray(ws))


@pytest.mark.parametrize("mode", ["ideal", "per_subarray", "bitserial"])
@pytest.mark.parametrize("k", [100, 300])
def test_cim_matmul_model_modes(mode, k):
    rng = np.random.default_rng(k)
    a, w = _int8(rng, (2, 5, k)), _int8(rng, (k, 7), scale=30)
    cfg_j, cfg_t = jcim.CiMConfig(mode=mode), tcim.CiMConfig(mode=mode)
    want = np.asarray(jcim.cim_matmul_model(a, w, cfg_j))
    got = tcim.cim_matmul_model(torch.from_numpy(a), torch.from_numpy(w),
                                cfg_t).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if mode == "ideal":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


# k 1/3, stride 1/2, SAME/VALID, odd and even spatial sizes
GEOMS = [(k, s, pad, h) for k in (1, 3) for s in (1, 2)
         for pad in ("SAME", "VALID") for h in (7, 8)]


@pytest.mark.parametrize("k,stride,padding,h", GEOMS)
def test_conv_pads_and_im2col(k, stride, padding, h):
    assert tcim.conv_pads(h, k, stride, padding) == \
        jcim.conv_pads(h, k, stride, padding)
    x = np.random.default_rng(h * 10 + k).normal(
        size=(2, h, h + 2, 5)).astype(np.float32)
    want, hw = jcim.im2col(x, k, k, stride, padding)
    got, thw = tcim.im2col(torch.from_numpy(x), k, k, stride, padding)
    assert thw == hw
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"),
                                            (2, "VALID")])
def test_cim_conv_model_and_conv_nhwc(stride, padding):
    rng = np.random.default_rng(stride)
    xq, wq = _int8(rng, (2, 9, 9, 6)), _int8(rng, (3, 3, 6, 4))
    cfg_j, cfg_t = jcim.CiMConfig(mode="ideal"), tcim.CiMConfig(mode="ideal")
    want = np.asarray(jcim.cim_conv_model(xq, wq, cfg_j, stride, padding))
    got = tcim.cim_conv_model(torch.from_numpy(xq), torch.from_numpy(wq),
                              cfg_t, stride, padding).numpy()
    np.testing.assert_array_equal(got, want)
    # the float conv wrapper: XLA and PyTorch sum in other orders (f32)
    x = rng.normal(size=(2, 9, 9, 6)).astype(np.float32)
    w = rng.normal(size=(3, 3, 6, 4)).astype(np.float32)
    want = np.asarray(jrebranch.conv_nhwc(x, w, stride, padding))
    got = trebranch.conv_nhwc(torch.from_numpy(x), torch.from_numpy(w),
                              stride, padding).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
