"""The bitserial CiM macro as the CUDA tile computes it, on the CPU.

``csrc/bitserial_tile.cuh`` takes its counts from binary tensor-core MMAs
over bit planes and its ADC from a table of (popcount, count); neither
runs here.  These tests hold, exactly (``torch.equal`` / array equality):

  * the ADC table that the wrappers hand the kernels to the plain
    version's ``adc_transfer`` (and the JAX package's) at every
    (popcount, count) pair, at two CiMConfigs;
  * the sign-plane derivation (|q| planes and a sign plane, AND / AND-NOT)
    to ``max(+-q, 0)``, -128 included;
  * a numpy model of the tile's data flow (planes in the tile's k order,
    AND + popcount counts, lookups in the table bytes the kernels get, the
    f32 adds in the plain version's order) to the plain ``cim_block_dot``
    and ``cim_matmul_plain``;
  * the bitserial split plan to whole k-blocks at Gemma-2B's geometries.

The kernel itself is held to the plain version on the card by
``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import adc as jadc
from repro.core import cim as jcim
from repro_torch.core import adc
from repro_torch.core import cim
from repro_torch.kernels import cim_matmul as cm
from repro_torch.kernels import tiling

CONFIGS = [cim.CiMConfig(mode="bitserial"),
           cim.CiMConfig(mode="bitserial", adc_bits=4, adc_range_frac=0.37)]
GEMMA_GEOMS = [(2048, 2048), (2048, 256), (2048, 16384), (16384, 2048)]


@pytest.mark.parametrize("cfg", CONFIGS, ids=["default", "4bit-0.37"])
def test_adc_table_is_the_plain_adc_at_every_popcount_and_count(cfg):
    code, lsb = cm.adc_table(cfg)
    assert code.dtype == torch.uint8 and code.shape == (129, 385)
    assert lsb.dtype == torch.float32 and lsb.shape == (129,)
    # the plain version's call: counts [bm, bn] against per-column ranges
    counts = torch.arange(385, dtype=torch.float32)[:, None].expand(385, 129)
    full_range = (torch.arange(129, dtype=torch.float32)[None, :]
                  * cfg.group_max).clamp_min(1.0)
    want = adc.adc_transfer(counts, full_range, cfg)
    got = code.T.float() * lsb[None, :]
    assert torch.equal(got, want)
    assert int(code.max()) <= cfg.adc_levels
    jcfg = jcim.CiMConfig(mode="bitserial", adc_bits=cfg.adc_bits,
                          adc_range_frac=cfg.adc_range_frac)
    jwant = jadc.adc_transfer(jnp.asarray(counts.numpy()),
                              jnp.asarray(full_range.numpy()), jcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))


def test_adc_table_bytes_are_the_kernels_layout():
    cfg = CONFIGS[0]
    code, lsb = cm.adc_table(cfg)
    raw = cm._device_table(cfg, torch.device("cpu"))
    assert raw.dtype == torch.uint8 and raw.numel() == cm.ADC_TABLE_BYTES
    assert cm.ADC_TABLE_BYTES % 16 == 0
    assert torch.equal(raw[:516].view(torch.float32), lsb)
    # row p at csrc/cim_block_dot.cuh's adc_row(p): the counts 0 .. 3 p
    for p in range(129):
        row = 516 + p + 3 * p * (p - 1) // 2
        assert torch.equal(raw[row:row + 3 * p + 1], code[p, :3 * p + 1])
    assert not raw[516 + 128 + 3 * 128 * 127 // 2 + 385:].any()
    assert cm.adc_pointer(cim.CiMConfig(mode="per_subarray"), "cpu") == 0


@pytest.mark.parametrize("cfg", CONFIGS, ids=["default", "4bit-0.37"])
def test_fused_sensed_value_is_the_plain_product(cfg):
    """cim_block_dot.cuh's adc_sensed: fma(2**23 + code, lsbc, -2**23
    lsbc), one rounding of the exact code * lsbc, equals the plain
    version's coef * (code * lsb) for every table entry and every
    coefficient +-2**(2g + j) (the fma written out exactly in float64)."""
    code, lsb = cm.adc_table(cfg)
    code = code.numpy().astype(np.float64)
    lsb = lsb.numpy()
    for g in range(4):
        for j in range(7):
            for sign in (1.0, -1.0):
                coef = np.float32(sign * 2.0 ** (2 * g + j))
                lsbc = (lsb * coef).astype(np.float32)[:, None]
                big = (lsbc * np.float32(-2.0 ** 23)).astype(np.float32)
                fused = ((2.0 ** 23 + code) * lsbc.astype(np.float64)
                         + big.astype(np.float64)).astype(np.float32)
                plain = (coef * (code.astype(np.float32)
                                 * lsb[:, None]).astype(np.float32)
                         ).astype(np.float32)
                np.testing.assert_array_equal(fused, plain)


def test_kernels_refuse_codes_wider_than_a_byte():
    with pytest.raises(ValueError, match="adc_bits"):
        cm.kernel_args(cim.CiMConfig(mode="bitserial", adc_bits=9))
    cm.kernel_args(cim.CiMConfig(mode="per_subarray", adc_bits=9))


def _mags(v: np.ndarray) -> np.ndarray:
    """__vabs4: each byte's absolute value, -128 giving 0x80 (128)."""
    return np.where(v < 0, -v.astype(np.int16), v).astype(np.uint8)


def test_sign_planes_give_the_sign_split_parts():
    q = np.arange(-128, 128).astype(np.int8)
    mags, neg = _mags(q), q < 0
    planes = [((mags >> b) & 1).astype(bool) for b in range(8)]
    a_pos = sum((p & ~neg).astype(np.int32) << b for b, p in enumerate(planes))
    a_neg = sum((p & neg).astype(np.int32) << b for b, p in enumerate(planes))
    np.testing.assert_array_equal(a_pos, np.maximum(q.astype(np.int32), 0))
    np.testing.assert_array_equal(a_neg, np.maximum(-q.astype(np.int32), 0))
    assert a_neg[0] == 128 and (a_neg[0] >> 6) & 3 == 2   # group 3, bit 7
    # weights: 7 planes, -128 (magnitude 128) in none of them, as the plain
    # version's (w_part >> j) & 1 for j < 7
    w_pos = sum((p & ~neg).astype(np.int32) << b
                for b, p in enumerate(planes[:7]))
    w_neg = sum((p & neg).astype(np.int32) << b
                for b, p in enumerate(planes[:7]))
    w = q.astype(np.int32)
    np.testing.assert_array_equal(w_pos, np.maximum(w, 0) & 127)
    np.testing.assert_array_equal(w_neg, np.maximum(-w, 0) & 127)


def _transpose32(x: np.ndarray) -> np.ndarray:
    """bitserial_tile.cuh's transpose32 over the 32 lanes of a warp: lane
    r's word in ``x[r]``, __shfl_xor_sync as an index permutation."""
    lanes = np.arange(32)
    for s, m in zip((16, 8, 4, 2, 1), (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F,
                                      0x33333333, 0x55555555)):
        m = np.uint32(m)
        y = x[lanes ^ s]
        x = np.where((lanes & s) != 0, (x & ~m) | ((y & ~m) >> np.uint32(s)),
                     (x & m) | ((y & m) << np.uint32(s)))
    return x


def test_warp_bit_transpose_is_a_transpose():
    rng = np.random.default_rng(0)
    for rows in (rng.integers(0, 2**32, 32, dtype=np.uint64).astype(np.uint32),
                 np.uint32(1) << np.arange(32, dtype=np.uint32),
                 np.full(32, 0x80808080, dtype=np.uint32)):
        bits = (rows[:, None] >> np.arange(32, dtype=np.uint32)) & 1  # [r, c]
        want = (bits.T.astype(np.uint64) << np.arange(32, dtype=np.uint64)
                ).sum(1).astype(np.uint32)
        np.testing.assert_array_equal(_transpose32(rows), want)


def _plane_words(v: np.ndarray, nbits: int, nch: int) -> np.ndarray:
    """int8 codes [rows, 128 nch] as the tile's plane words
    [rows, plane (nbits magnitude bits, then the sign), chunk, e]: bit l
    of word (c, e) is k = 128 c + 4 l + e."""
    mags, neg = _mags(v), v < 0
    bits = [(mags >> b) & 1 for b in range(nbits)] + [neg.astype(np.uint8)]
    out = np.zeros((v.shape[0], nbits + 1, nch, 4), dtype=np.uint32)
    for p, plane in enumerate(bits):
        lanes = plane.reshape(v.shape[0], nch, 32, 4).astype(np.uint32)
        out[:, p] = (lanes << np.arange(32, dtype=np.uint32)[None, None, :,
                                                              None]).sum(2)
    return out


def _tile_block(q: np.ndarray, w: np.ndarray, cfg) -> np.ndarray:
    """bitserial_tile.cuh's part of one k-block, in numpy: q int8 [m, kb],
    w int8 [kb, n] -> f32 [m, n]."""
    nch = -(-q.shape[1] // 128)
    pad = nch * 128 - q.shape[1]
    q = np.pad(q, ((0, 0), (0, pad)))
    w = np.pad(w, ((0, pad), (0, 0)))
    ap = _plane_words(q, 8, nch)                   # [m, 9, nch, 4]
    wp = _plane_words(w.T, 7, nch)                 # [n, 8, nch, 4]
    table = cm._device_table(cfg, torch.device("cpu")).numpy()
    lsb = table[:516].view(np.float32)
    popc = np.bitwise_count
    part = np.zeros((q.shape[0], w.shape[1]), dtype=np.float32)
    for sa, sw in ((0, 0), (0, 1), (1, 0), (1, 1)):
        sign = 1.0 if sa == sw else -1.0
        for c in range(nch):
            am = ap[:, 8, c] if sa else ~ap[:, 8, c]   # [m, 4]
            bm = wp[:, 7, c] if sw else ~wp[:, 7, c]   # [n, 4]
            for g in range(4):
                lo = ap[:, 2 * g, c] & am
                hi = ap[:, 2 * g + 1, c] & am
                for j in range(7):
                    b = wp[:, j, c] & bm
                    p = popc(b).sum(-1).astype(np.int64)           # [n]
                    count = (popc(lo[:, None] & b[None]).sum(-1)
                             + 2 * popc(hi[:, None] & b[None]).sum(-1)
                             ).astype(np.int64)
                    assert (count <= 3 * p[None]).all()
                    coef = np.float32(sign * 2.0 ** (2 * g + j))
                    lsbc = (lsb[p] * coef).astype(np.float32)
                    row = 516 + p + 3 * p * (p - 1) // 2   # adc_row(p)
                    sensed = (table[row[None] + count].astype(np.float32)
                              * lsbc[None]).astype(np.float32)
                    part = (part + sensed).astype(np.float32)
    return part


@pytest.mark.parametrize("cfg", CONFIGS, ids=["default", "4bit-0.37"])
@pytest.mark.parametrize("m,k,n", [(5, 300, 7), (3, 512, 9), (4, 1100, 6)])
def test_tile_model_equals_the_plain_version(m, k, n, cfg):
    rng = np.random.default_rng(m * k + n)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    x[0, ::3] = -128                                # a magnitude of 128
    w[::5, 0] = -128                                # no magnitude plane
    x[-1] = 0                                       # a zero row
    acc = None
    for k0, k1 in tiling.k_partition(k, 128):
        part = _tile_block(x[:, k0:k1], w[k0:k1], cfg)
        if k1 - k0 == k:
            pad = -k % 128
            want = cm.cim_block_dot(
                cfg, F.pad(torch.from_numpy(x), (0, pad)),
                F.pad(torch.from_numpy(w), (0, 0, 0, pad)))
            assert torch.equal(torch.from_numpy(part), want)
        acc = part if acc is None else (acc + part).astype(np.float32)
    want = cm.cim_matmul_plain(torch.from_numpy(x), torch.from_numpy(w), cfg)
    assert torch.equal(torch.from_numpy(acc), want)


@pytest.mark.parametrize("m", (1, 8, 16, 128))
@pytest.mark.parametrize("k,n", GEMMA_GEOMS)
def test_bitserial_plan_cuts_only_on_k_block_boundaries(k, n, m):
    sp = tiling.split_plan(m, n, k, "bitserial")
    assert sp == tiling.split_bitserial(m, n, k)
    nkb = len(tiling.k_partition(k, 128))
    assert sp.n_kblocks == nkb and sp.tile_m == (16 if m <= 16 else 32)
    # every split takes whole k-blocks, the splits cover each k-block once
    taken = [kb for s in range(sp.n_splits)
             for kb in range(s * sp.kb_per_split,
                             min((s + 1) * sp.kb_per_split, nkb))]
    assert taken == list(range(nkb))
    assert sp.scratch_floats(m, n) == (nkb * m * n if sp.n_splits > 1 else 0)
    if m <= 16:   # decode: a bitserial k-block per block
        assert sp.kb_per_split == 1
    assert tiling.split_plan(m, n, k, "ideal") == tiling.split_k(m, n, k)
