"""The implicit im2col map of the NHWC trunk-conv kernel, held to the JAX
package on the CPU.

``csrc/trunk_conv.cu`` never builds the patch matrix P: it reads the NHWC
input x through the geometry that ``kernels/rebranch_conv.py::conv_launch``
hands it (``ConvGeom``) and the index map of ``csrc/conv_geom.cuh``.  These
tests write that index map out in numpy, from the geometry the wrapper
makes, and hold what it gathers to JAX's own P
(``repro.kernels.rebranch_conv._stacked_patches``):

* the gathered rows equal P exactly, at DarkNet-19's 20 sites and
  ResNet-18's sites (cut to a small input), a 7x7 stride-2 stem, stride-2
  SAME and VALID convs;
* the per-(row, k-block) absmaxes of the gathered rows equal
  ``_block_absmaxes`` on its three routes (one k-block, whole taps per
  block, half-tap blocks at C_in = 1024), over ``tiling.k_partition``;
* the split plan of every DarkNet-19 launch at 416x416 covers its shape and
  falls on k-partition boundaries;
* ``rebranch_conv``'s branch, the patch matrix of ``x @ C`` gathered at C_c
  channels, is within 1e-5 of ``rebranch_conv_pallas`` (float sums in
  another order, as in ``test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch

from repro.core import cim as jcim
from repro.kernels.rebranch_conv import (_block_absmaxes, _stacked_patches,
                                         rebranch_conv_pallas)
from repro_torch.core import cim as tcim
from repro_torch.kernels import rebranch_conv as rc
from repro_torch.kernels import tiling
from repro_torch.models import cnn

IDEAL_J, IDEAL_T = jcim.CiMConfig(mode="ideal"), tcim.CiMConfig(mode="ideal")


def _sites(name, size, batch=2):
    """(case id, x shape, (k, k, C_in, C_out), stride) of every conv site of
    a CNN at a small input: the site's input is its output times its
    stride (SAME)."""
    return [(f"{name}.{site}", (batch, hw * stride, hw * stride + 1, c_in),
             (k, k, c_in, c_out), stride, "SAME")
            for site, k, c_in, c_out, hw, stride in cnn.conv_site_shapes(
                cnn.CNNConfig(name=name, input_size=size))]


# (id, x shape, w shape, stride, padding)
GEOMETRIES = (_sites("darknet19", 64) + _sites("resnet18", 32) + [
    ("stem7x7_s2", (1, 23, 20, 3), (7, 7, 3, 64), 2, "SAME"),
    ("s2_same_c64", (2, 9, 8, 64), (3, 3, 64, 16), 2, "SAME"),
    ("valid_c20", (2, 9, 11, 20), (3, 3, 20, 8), 1, "VALID"),
    ("valid_s2_c130", (1, 10, 9, 130), (3, 3, 130, 8), 2, "VALID"),
    ("valid_1x1_s2", (1, 7, 6, 40), (1, 1, 40, 8), 2, "VALID"),
])


def _gather(x: np.ndarray, g) -> np.ndarray:
    """The patch matrix as the kernel reads it, from ``g`` alone:
    ``conv_geom.cuh``'s row_pixel, col_tap and tap_offset in numpy."""
    m = g.n * g.oh * g.ow
    r = g.kh * g.kw * g.c
    row = np.arange(m)
    img, rem = row // (g.oh * g.ow), row % (g.oh * g.ow)
    pix0 = img * g.h * g.w                       # row_pixel: (img, 0, 0)
    ih0 = (rem // g.ow) * g.stride - g.ph0       # the window's top row
    iw0 = (rem % g.ow) * g.stride - g.pw0        # ... and left column
    kk = np.arange(r)
    t, c = kk // g.c, kk % g.c                   # col_tap: tap, channel
    dh, dw = t // g.kw, t % g.kw
    ih = ih0[:, None] + dh[None, :]
    iw = iw0[:, None] + dw[None, :]
    inside = (ih >= 0) & (ih < g.h) & (iw >= 0) & (iw < g.w)
    off = (pix0[:, None] + ih * g.w + iw) * g.c + c[None, :]   # tap_offset
    flat = x.reshape(-1)
    return np.where(inside, flat[np.where(inside, off, 0)], 0.0)


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x[0, 0, :2] = 0.0                            # zero pixels
    x[-1, -1, -1] *= 1e3                         # one pixel dominates
    return x


@pytest.mark.parametrize("case,x_shape,w_shape,stride,padding", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_gather_equals_jax_patch_matrix(case, x_shape, w_shape, stride,
                                        padding):
    kh, kw, c_in, _ = w_shape
    x = _x(x_shape, len(case))
    g = rc.conv_geometry(x_shape, kh, kw, stride, padding)
    # the pads and output size are the JAX package's
    (ph0, _), oh = jcim.conv_pads(x_shape[1], kh, stride, padding)
    (pw0, _), ow = jcim.conv_pads(x_shape[2], kw, stride, padding)
    assert (g.n, g.h, g.w, g.c) == x_shape
    assert (g.oh, g.ow, g.ph0, g.pw0) == (oh, ow, ph0, pw0)
    assert (g.kh, g.kw, g.stride) == (kh, kw, stride)
    p, (n, joh, jow), _ = _stacked_patches(x, kh, kw, stride, padding)
    assert (joh, jow) == (g.oh, g.ow)
    np.testing.assert_array_equal(_gather(x, g), np.asarray(p))


# (id, x shape, w shape): one k-block (R <= 512), whole taps per block
# (512 % C_in == 0, R > 512), half-tap blocks (C_in = 1024)
ABSMAX_CASES = [("gk1_c64_1x1", (2, 6, 7, 64), (1, 1, 64, 8)),
                ("gk1_c3_3x3", (2, 9, 8, 3), (3, 3, 3, 8)),
                ("whole_taps_c64", (2, 6, 7, 64), (3, 3, 64, 8)),
                ("whole_taps_c256", (1, 5, 6, 256), (3, 3, 256, 8)),
                ("half_taps_c1024", (1, 4, 5, 1024), (3, 3, 1024, 8)),
                ("half_taps_c1024_1x1", (2, 3, 3, 1024), (1, 1, 1024, 8))]


@pytest.mark.parametrize("case,x_shape,w_shape", ABSMAX_CASES,
                         ids=[c[0] for c in ABSMAX_CASES])
@pytest.mark.parametrize("stride", [1, 2])
def test_gathered_block_absmaxes_equal_jax(case, x_shape, w_shape, stride):
    kh, kw, c_in, _ = w_shape
    x = _x(x_shape, len(case) + stride)
    g = rc.conv_geometry(x_shape, kh, kw, stride, "SAME")
    r = kh * kw * c_in
    bk = tiling.block_k(r, 128)
    p, _, pads = _stacked_patches(x, kh, kw, stride, "SAME")
    bounds, absmaxes = _block_absmaxes(x, p, kh, kw, c_in, stride, pads, bk)
    assert tuple(bounds) == tiling.k_partition(r, 128)
    gathered = _gather(x, g)
    for (k0, k1), want in zip(bounds, absmaxes):
        got = np.abs(gathered[:, k0:k1]).max(axis=1, keepdims=True)
        np.testing.assert_array_equal(got, np.asarray(want))


DARKNET_416 = [(site, (8, hw, hw, c_in), (k, k, c_in, c_out))
               for site, k, c_in, c_out, hw, _ in cnn.conv_site_shapes(
                   cnn.CNNConfig(name="darknet19", input_size=416))]


@pytest.mark.parametrize("site,x_shape,w_shape", DARKNET_416,
                         ids=[d[0] for d in DARKNET_416])
def test_conv_plan_covers_the_launch_on_k_blocks(site, x_shape, w_shape):
    kh, kw, c_in, c_out = w_shape
    launch, floats = rc.conv_launch(x_shape, w_shape, 1, "SAME", IDEAL_T)
    g, plan = launch.geom, launch.plan
    m, r = g.n * g.oh * g.ow, kh * kw * c_in
    assert (m, launch.r, launch.n) == (x_shape[0] * x_shape[1] * x_shape[2],
                                       r, c_out)
    assert launch.bk == tiling.block_k(r, 128)
    blocks = tiling.k_partition(r, 128)
    # the grid covers the shape: every (row tile, column tile) once
    assert plan.tiles_n == -(-c_out // tiling.TILE_N)
    assert plan.tiles == -(-m // plan.tile_m) * plan.tiles_n
    assert plan.nkb == len(blocks) and plan.kb_per >= 1
    assert plan.n_splits == -(-plan.nkb // plan.kb_per)
    # each split is a run of whole k-blocks; together they cover [0, R)
    splits = [(blocks[s][0], blocks[min(s + plan.kb_per, plan.nkb) - 1][1])
              for s in range(0, plan.nkb, plan.kb_per)]
    assert splits[0][0] == 0 and splits[-1][1] == r
    assert all(a[1] == b[0] for a, b in zip(splits, splits[1:]))
    assert floats == (plan.nkb * m * c_out if plan.n_splits > 1 else 0)
    # a grid under two blocks per SM is split, a larger one is not
    if plan.tiles >= tiling.SPLIT_BELOW:
        assert plan.n_splits == 1


def _branch_inputs(seed, k, c_in, h, c_out=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, h + 1, c_in)).astype(np.float32)
    x[0, 0, 0] = 0.0
    w = rng.normal(size=(k, k, c_in, c_out)) / np.sqrt(k * k * c_in)
    scale = np.maximum(np.abs(w).max(axis=(0, 1, 2), keepdims=True),
                       1e-8) / 127.0
    w_q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    c_c, c_u = max(1, c_in // 4), max(1, c_out // 4)
    c = (rng.normal(size=(1, 1, c_in, c_c)) / np.sqrt(c_in)).astype(np.float32)
    core = (rng.normal(size=(k, k, c_c, c_u)) * 0.1).astype(np.float32)
    u = (rng.normal(size=(1, 1, c_u, c_out)) / np.sqrt(c_u)).astype(np.float32)
    return x, w_q, scale.astype(np.float32), c, core, u


@pytest.mark.parametrize("c_in,stride,padding", [
    (3, 1, "SAME"), (64, 1, "SAME"), (1024, 1, "SAME"), (3, 2, "SAME"),
    (64, 2, "SAME"), (64, 2, "VALID")])
def test_rebranch_conv_branch_route_vs_pallas(c_in, stride, padding):
    args = _branch_inputs(c_in + stride, 3, c_in, 7)
    want = np.asarray(rebranch_conv_pallas(*args, IDEAL_J, stride=stride,
                                           padding=padding))
    got = rc.rebranch_conv(*[torch.from_numpy(a) for a in args], IDEAL_T,
                           stride=stride, padding=padding).numpy()
    assert got.shape == want.shape
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol)
