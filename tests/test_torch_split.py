"""The split-K plans of the LM kernels' tensor-core tiles, on the CPU.

``kernels/tiling.py::split_k`` (the trunk of kernels 3 and 4) and
``split_sketch`` (kernel 3's sketch) decide from the shapes alone how a
launch's k range is cut over the grid; the wrappers hand the plans to the
kernels as they are (``csrc/mma_tile.cuh``'s SplitPlan and SketchPlan,
mirrored field for field by ``kernels/cim_matmul.py``).  These tests hold:

* the rules to k-partition boundaries at every Gemma-2B and DarkNet-19
  geometry, and to the shapes alone;
* the ctypes mirrors to the C structs, name for name;
* the split launch's data flow, written out in PyTorch: each split writes
  its k-blocks' parts (the plain versions' block parts) into a NaN-filled
  scratch of the plan's size, in any order, and the ordered reduction
  (the first part as it is, then ``+`` in ascending k-block order) reads
  them back; this equals ``cim_matmul_plain`` and
  ``trunk_patch_dot_plain`` bit for bit, including row sums past 2**24
  and a -0.0 first part;
* the sketch's summation order (one FMA chain per 128-row sub-block, the
  sub-blocks joined in order into k-block parts, the k-block parts joined
  in order, through sub-block or k-block scratch slots as the plan says):
  the same bits under every plan, and within 1e-5 of the absmax of JAX's
  ``_direct_rebranch`` t1 (the direct lowering of
  ``rebranch_matmul_pallas``).
"""

import ctypes
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import cim as jcim
from repro.kernels.rebranch_matmul import _direct_rebranch
from repro_torch.core import cim
from repro_torch.kernels import cim_matmul as cm
from repro_torch.kernels import rebranch_conv as rc
from repro_torch.kernels import rebranch_matmul as rm
from repro_torch.kernels import tiling
from repro_torch.models import cnn

CSRC = Path(rm.__file__).resolve().parent / "csrc"

# Gemma-2B's linears (K, N) at decode, both tile heights and prefill
GEMMA = [(k, n, m) for k, n in ((2048, 2048), (2048, 256), (2048, 16384),
                                (16384, 2048))
         for m in (1, 8, 16, 17, 128)]
# DarkNet-19 at 416x416, batch 8, as ops.cim_conv hands it to kernel 4
DARKNET = [(8 * hw * hw, k * k * c_in, c_out)
           for _, k, c_in, c_out, hw, _ in cnn.conv_site_shapes(
               cnn.CNNConfig(name="darknet19", input_size=416))]


def _split_ranges(sp: tiling.Split, k: int):
    """The (start, end) k-range of each split of ``sp``, in order."""
    blocks = tiling.k_partition(k, 128)
    return [(blocks[s][0], blocks[min(s + sp.kb_per_split,
                                      sp.n_kblocks) - 1][1])
            for s in range(0, sp.n_kblocks, sp.kb_per_split)]


def _sketch_ranges(sp: tiling.SketchSplit, k: int):
    """The (start, end) k-range of each split of ``sp``."""
    return [(s * 128, min((s + sp.sub_per_split) * 128, k))
            for s in range(0, sp.n_sub, sp.sub_per_split)]


def _blocks_cover(ranges, k):
    """The ranges are unions of consecutive k_partition blocks covering
    [0, k) in ascending order."""
    bounds = {0} | {b for blk in tiling.k_partition(k, 128) for b in blk}
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    return all(a in bounds and b in bounds and a < b for a, b in ranges)


@pytest.mark.parametrize("m,k,n", [(m, k, n) for k, n, m in GEMMA] + DARKNET)
def test_split_falls_on_k_partition_boundaries(m, k, n):
    sp = tiling.split_k(m, n, k)
    ranges = _split_ranges(sp, k)
    assert len(ranges) == sp.n_splits
    assert _blocks_cover(ranges, k)
    assert sp.tile_m == (16 if m <= 16 else 64)
    assert sp.tiles == math.ceil(m / sp.tile_m) * sp.tiles_n
    assert sp.tiles_n == math.ceil(n / tiling.TILE_N)
    # a grid of two blocks per SM or more is not split
    if sp.tiles >= tiling.SPLIT_BELOW:
        assert sp.n_splits == 1
    assert sp.scratch_floats(m, n) == (
        0 if sp.n_splits == 1 else len(tiling.k_partition(k, 128)) * m * n)
    # the rule reads the shapes only: no cache, no card, no data
    tiling.split_k.cache_clear()
    assert tiling.split_k(m, n, k) == sp


@pytest.mark.parametrize("k,n,m", GEMMA)
def test_sketch_split_falls_on_sub_block_boundaries(k, n, m):
    cdim = k // 4
    sp = tiling.split_sketch(m, cdim, k)
    ranges = _sketch_ranges(sp, k)
    assert len(ranges) == sp.n_splits
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a % 128 == 0 and a < b for a, b in ranges)
    bk = tiling.block_k(k, 128)
    # one sub-block per split, or whole k-blocks
    assert sp.sub_per_split == 1 or all(
        a % bk == 0 for a, _ in ranges)
    assert sp.sub_slots == (sp.sub_per_split % sp.sub_per_kblock != 0)
    assert sp.tile_m == (8 if m <= 8 else 16 if m <= 16 else 64)
    tiling.split_sketch.cache_clear()
    assert tiling.split_sketch(m, cdim, k) == sp


def test_split_rule_at_gemma_decode():
    """The numbers the kernels' sources quote: a `down` launch at M = 8
    splits its 32 k-blocks over 16 splits (512 trunk blocks, 2 MB of
    parts); the sketch over 1024 blocks; a full grid is not split."""
    sp = tiling.split_k(8, 2048, 16384)
    assert (sp.tile_m, sp.tiles, sp.n_splits) == (16, 32, 16)
    assert 4 * sp.scratch_floats(8, 2048) == 2 << 20
    ss = tiling.split_sketch(8, 4096, 16384)
    assert ss.tiles * ss.n_splits == 1024
    assert tiling.split_k(128, 16384, 2048).n_splits == 1


# ---------------------------------------------------------------------------
# the C structs the plans travel in
# ---------------------------------------------------------------------------

def _c_fields(header: str, struct: str) -> list[str]:
    """The field names of ``struct`` in ``csrc/<header>``, in order."""
    text = (CSRC / header).read_text()
    body = re.search(r"struct %s \{(.*?)\};" % struct, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return [re.findall(r"(\w+)\s*$", decl.strip())[0]
            for decl in body.split(";") if decl.strip()]


@pytest.mark.parametrize("header,mirror", [
    ("cim_block_dot.cuh", cm.AdcParams), ("mma_tile.cuh", cm.SplitPlan),
    ("mma_tile.cuh", cm.SketchPlan), ("cim_matmul.cu", cm.CimLaunch),
    ("rebranch_matmul.cu", rm.FusedLaunch), ("conv_geom.cuh", rc.ConvGeom),
    ("trunk_conv.cu", rc.ConvLaunch)])
def test_ctypes_mirrors_the_kernel_structs(header, mirror):
    names = [f for f, _ in mirror._fields_]
    assert _c_fields(header, mirror.__name__) == names
    # every field is 4 bytes (int, float or a struct of them): no padding
    assert ctypes.sizeof(mirror) % 4 == 0


def test_plans_travel_field_for_field():
    sp = tiling.split_k(8, 2048, 16384)
    ss = tiling.split_sketch(8, 4096, 16384)
    c_sp, c_ss = cm.c_split(sp), cm.c_sketch(ss)
    assert [getattr(c_sp, f) for f, _ in c_sp._fields_] == [
        sp.tile_m, sp.tiles_n, sp.tiles, sp.n_kblocks, sp.kb_per_split,
        sp.n_splits]
    assert [getattr(c_ss, f) for f, _ in c_ss._fields_] == [
        ss.tile_m, ss.tiles_n, ss.tiles, ss.n_sub, ss.sub_per_kblock,
        ss.sub_per_split, ss.n_splits, ss.n_kblocks, int(ss.sub_slots)]
    launch, ft, fs = rm._launch(8, 16384, 2048, 4096, rm.IDEAL, True)
    assert (launch.m, launch.k, launch.n, launch.cdim, launch.bk,
            launch.x_bf16) == (8, 16384, 2048, 4096, 512, 1)
    assert (ft, fs) == (sp.scratch_floats(8, 2048),
                        ss.scratch_floats(8, 4096))
    # bitserial takes split_bitserial's plan, and its scratch
    bs = cim.CiMConfig(mode="bitserial")
    sb = tiling.split_bitserial(8, 2048, 16384)
    launch, ft, fs = rm._launch(8, 16384, 2048, 4096, bs, True)
    assert [getattr(launch.trunk, f) for f, _ in launch.trunk._fields_] == [
        sb.tile_m, sb.tiles_n, sb.tiles, sb.n_kblocks, sb.kb_per_split,
        sb.n_splits]
    assert (ft, fs) == (sb.scratch_floats(8, 2048),
                        ss.scratch_floats(8, 4096))
    launch, floats = cm._launch(8, 16384, 2048, bs)
    assert launch.plan.n_splits == sb.n_splits > 1
    assert floats == sb.scratch_floats(8, 2048)


# ---------------------------------------------------------------------------
# the split trunk's ordered reduction
# ---------------------------------------------------------------------------

def _ordered_sum(parts):
    """split_reduce's ``ordered_sum``: the first part as it is, then ``+``
    in order."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _split_launch(block_part, sp: tiling.Split, k: int, m: int, n: int):
    """The data flow of a split trunk launch: every split writes its
    k-blocks' parts (``block_part(k0, k1)``) into the plan's scratch, last
    split first, and the reduction adds each element's parts in ascending
    k-block order.  Unsplit, the one block adds its own parts in order."""
    blocks = tiling.k_partition(k, 128)
    if sp.n_splits == 1:
        return _ordered_sum([block_part(a, b) for a, b in blocks])
    scratch = torch.full((sp.scratch_floats(m, n),), float("nan"))
    slots = scratch.view(sp.n_kblocks, m, n)
    for s in reversed(range(sp.n_splits)):
        for kb in range(s * sp.kb_per_split,
                        min((s + 1) * sp.kb_per_split, sp.n_kblocks)):
            assert bool(slots[kb].isnan().all()), "a slot written twice"
            slots[kb] = block_part(*blocks[kb])
    assert not bool(scratch.isnan().any()), "a slot left unwritten"
    return _ordered_sum(list(slots))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _plans(m, n, k):
    """The rule's plan, one k-block per split, and no split."""
    tm = tiling.tile_m(m)
    return {"rule": tiling.split_k(m, n, k),
            "one": tiling.make_split(m, n, k, 128, tm, 1),
            "none": tiling.make_split(m, n, k, 128, tm, 10 ** 6)}


@pytest.mark.parametrize("mode", ["ideal", "per_subarray"])
@pytest.mark.parametrize("m,k,n", [(8, 2048, 64), (17, 1280, 48),
                                   (3, 16384, 16), (5, 300, 20)])
def test_ordered_reduction_equals_cim_matmul_plain(m, k, n, mode):
    cfg = cim.CiMConfig(mode=mode)
    rng = np.random.default_rng(m * k + n)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    x[0] = 127                        # row 0 x column 0 sums past 2**24
    w[:, 0] = 127
    want = _bits(cm.cim_matmul_plain(x, w, cfg))
    for name, sp in _plans(m, n, k).items():
        got = _split_launch(
            lambda a, b: cm.cim_matmul_plain(x[:, a:b], w[a:b], cfg),
            sp, k, m, n)
        assert torch.equal(_bits(got), want), name
    if k >= 1280 and mode == "ideal":
        assert got[0, 0].item() > 2 ** 24


@pytest.mark.parametrize("mode", ["ideal", "per_subarray"])
@pytest.mark.parametrize("m,k,n", [(8, 2048, 64), (17, 1280, 48),
                                   (5, 300, 20)])
def test_ordered_reduction_equals_trunk_patch_dot_plain(m, k, n, mode):
    cfg = cim.CiMConfig(mode=mode)
    gen = torch.Generator().manual_seed(m + k + n)
    p = torch.randn((m, k), generator=gen)
    p[1, :600] *= 1e3
    w = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    want = _bits(rc.trunk_patch_dot_plain(p, w, cfg))
    for name, sp in _plans(m, n, k).items():
        got = _split_launch(
            lambda a, b: rc.trunk_patch_dot_plain(p[:, a:b], w[a:b], cfg),
            sp, k, m, n)
        assert torch.equal(_bits(got), want), name


def test_ordered_reduction_keeps_a_negative_zero_first_part():
    """The first part is taken as it is (acc = p0), as the plain versions'
    ``acc = part`` does; a reduction from 0.0 would turn -0.0 into 0.0."""
    parts = {(0, 512): torch.tensor([[-0.0, -0.0, 1.0]]),
             (512, 1024): torch.tensor([[-0.0, 2.0 ** 25, 1.0]])}
    for sp in _plans(1, 3, 1024).values():
        got = _split_launch(lambda a, b: parts[a, b], sp, 1024, 1, 3)
        want = parts[0, 512] + parts[512, 1024]
        assert torch.equal(_bits(got), _bits(want))
        assert not torch.equal(_bits(got), _bits(0.0 + want))
        assert got[0, 1].item() == 2.0 ** 25   # 2**25 + 1 rounds to even


# ---------------------------------------------------------------------------
# the sketch's summation order
# ---------------------------------------------------------------------------

def _fma_chain(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """sketch_tile's chain over one sub-block, per (row, column): acc = 0,
    then acc = fma(x[k], c[k], acc) for k ascending.  The product is exact
    in f64 and the sum is rounded to f64 and then to f32, which is the
    single rounding of an FMA but in rare halfway cases: the order is the
    kernel's, the bits may differ by an ulp."""
    acc = torch.zeros((x.shape[0], c.shape[1]), dtype=torch.float64)
    xd, cd = x.double(), c.double()
    for kk in range(x.shape[1]):
        acc = (acc + xd[:, kk:kk + 1] * cd[kk:kk + 1]).float().double()
    return acc.float()


def _sketch_launch(x, c, sp: tiling.SketchSplit) -> torch.Tensor:
    """The sketch of a fused launch under plan ``sp``: each split (last
    first) takes its sub-blocks' chains; a k-block's part is its
    sub-blocks' chains joined in order; without a split the block joins
    the k-block parts itself, with one it writes sub-block slots
    (sub_slots) or k-block slots, and the reduction (sketch_sum) joins
    them in order."""
    m, k = x.shape
    cdim = c.shape[1]
    spk, nsub = sp.sub_per_kblock, sp.n_sub
    chains = {}
    for s in reversed(range(sp.n_splits)):
        for sub in range(s * sp.sub_per_split,
                         min((s + 1) * sp.sub_per_split, nsub)):
            k0, k1 = sub * 128, min((sub + 1) * 128, k)
            chains[sub] = _fma_chain(x[:, k0:k1], c[k0:k1])

    def kblock(kb, part):
        return _ordered_sum([part(s) for s in
                             range(kb * spk, min((kb + 1) * spk, nsub))])

    if sp.n_splits == 1:
        return _ordered_sum([kblock(kb, chains.get)
                             for kb in range(sp.n_kblocks)])
    scratch = torch.full((sp.scratch_floats(m, cdim),), float("nan"))
    slots = scratch.view(-1, m, cdim)
    if sp.sub_slots:
        for sub, chain in chains.items():
            slots[sub] = chain
    else:
        for kb in range(sp.n_kblocks):
            slots[kb] = kblock(kb, chains.get)
    assert not bool(scratch.isnan().any()), "a slot left unwritten"
    if sp.sub_slots:
        return _ordered_sum([kblock(kb, lambda s: slots[s])
                             for kb in range(sp.n_kblocks)])
    return _ordered_sum(list(slots))


# (M, K, Cd): decode, a ragged last k-block, one ragged k-block
SKETCH_CASES = [(8, 2048, 64), (3, 1280, 48), (17, 300, 20)]


@pytest.mark.parametrize("plan", ["rule", "one", "kblock", "none"])
@pytest.mark.parametrize("m,k,cdim", SKETCH_CASES)
def test_sketch_order_is_the_same_under_every_plan_and_near_jax(
        m, k, cdim, plan):
    rng = np.random.default_rng(m + k + cdim)
    x = rng.standard_normal((m, k)).astype(np.float32)
    c = (rng.standard_normal((k, cdim)) / np.sqrt(k)).astype(np.float32)
    w = rng.integers(-127, 128, (k, 16)).astype(np.int8)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    rule = tiling.split_sketch(m, cdim, k)
    per = {"rule": rule.sub_per_split, "one": 1,
           "kblock": rule.sub_per_kblock, "none": rule.n_sub}[plan]
    sp = tiling.make_sketch_split(m, cdim, k, 128, rule.tile_m, per)
    assert (sp.n_splits > 1) == (plan != "none" and rule.n_sub > per)
    got = _sketch_launch(xt, ct, sp)
    # the plan moves no bit: the rule's unsplit order is the reference
    ref = _sketch_launch(xt, ct, tiling.make_sketch_split(
        m, cdim, k, 128, rule.tile_m, rule.n_sub))
    assert torch.equal(_bits(got), _bits(ref))
    _, jt1 = _direct_rebranch(x, w, c, cfg=jcim.CiMConfig(mode="ideal"),
                              bk=tiling.block_k(k, 128))
    jt1 = np.asarray(jt1)
    np.testing.assert_allclose(got.numpy(), jt1, rtol=0,
                               atol=1e-5 * np.abs(jt1).max())
    # and the port's plain version, which the card is held to
    plain = rm.rebranch_matmul_plain(xt, torch.from_numpy(w), ct)[1]
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=1e-5 * plain.abs().max().item())
