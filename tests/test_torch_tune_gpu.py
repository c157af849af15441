"""Launch plans on the card: every legal plan of a geometry gives the shape
rule's plan's bits, and the checked-in table is bit-neutral.

Imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_tune_gpu.py

A plan fixes only the tile heights and how the k-blocks are split
(``kernels/tiling.py``); every k-block's part is computed whole and the
parts are added in ascending order, so a candidate whose output differs
from the rule's, bit for bit, is a kernel fault.  Each launch's plan is
read back from the struct the wrapper handed the kernel.
"""

import pytest
import torch

from repro_torch.core import cim
from repro_torch.kernels import cim_matmul as cm
from repro_torch.kernels import rebranch_conv as rc
from repro_torch.kernels import rebranch_matmul as rm
from repro_torch.tune import autotune, table

MODES = ("ideal", "per_subarray", "bitserial")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels take plans only on the card")
    return torch.device("cuda")


def _tiny_yolo(mode):
    """A few Tiny-YOLO geometries at 32x32: the stem (K = 27), a split
    conv (K = 2304) and the head (K = 4608), solo and batched."""
    geoms = autotune.conv_geometries(("tiny_yolo",), (32,), (mode,),
                                     ("trunk_conv", "cim_matmul",
                                      "rebranch_matmul"), (1, 8))
    return [g for g in geoms if g.k in (27, 2304, 4608)]


def _gemma(mode):
    """Gemma-2B's linears at decode (8 rows, bf16 x) and prefill (64)."""
    out = []
    for m in (8, 64):
        for k, n in ((2048, 256), (16384, 2048)):
            out.append(autotune.Geometry("rebranch_matmul", mode, "bfloat16",
                                         m, k, n))
            out.append(autotune.Geometry("cim_matmul", mode, "int8", m, k, n))
    return out


def _outputs_equal(a, b):
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("which", ("tiny_yolo", "gemma_2b"))
def test_every_candidate_equals_the_rule(which, mode):
    dev = _card()
    geoms = _tiny_yolo(mode) if which == "tiny_yolo" else _gemma(mode)
    assert geoms
    for g in geoms:
        fn, args, used = autotune._runner(g, dev)
        with table.disabled():
            ref = fn(*args[0])
            assert used() == g.rule()
        for cand in autotune.candidates(g.kernel, g.mode, g.m, g.k, g.n,
                                        dtype=g.dtype, cdim=g.cdim,
                                        fast=False):
            with table.overrides({g.key: cand}):
                out = fn(*args[0])
                assert used() == cand, g.key
            assert _outputs_equal(ref, out), (g.key, cand)
        del fn, args, ref
        torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ("trunk_conv", "cim_matmul",
                                    "rebranch_matmul"))
def test_checked_in_table_is_bit_neutral(kernel):
    dev = _card()
    entries = table.load_table()
    geoms = [g for g in autotune.conv_geometries(
        ("darknet19", "resnet18", "tiny_yolo"), (32,), MODES, (kernel,),
        (1, 8)) if g.key in entries]
    assert geoms, "no table entry to check"
    changed = 0
    for g in geoms:
        fn, args, used = autotune._runner(g, dev)
        with table.disabled():
            ref = fn(*args[0])
        out = fn(*args[0])
        assert used() == entries[g.key]
        changed += entries[g.key] != g.rule()
        assert _outputs_equal(ref, out), g.key
    print(f"{kernel}: {len(geoms)} entries bit-neutral, {changed} of them "
          f"another plan than the rule's")


@pytest.mark.gpu
def test_wrappers_take_an_explicit_plan():
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    xq = torch.randint(-127, 128, (40, 4608), generator=gen, device=dev,
                       dtype=torch.int8)
    w = torch.randint(-127, 128, (4608, 96), generator=gen, device=dev,
                      dtype=torch.int8)
    want = cm.cim_matmul_plain(xq, w)
    plan = table.Plan(16, 2)
    assert torch.equal(cm.cim_matmul(xq, w, plan=plan), want)
    assert cm.launched_plan(cm.last_launch) == plan
    x = torch.randn((2, 6, 6, 512), generator=gen, device=dev)
    wc = torch.randint(-127, 128, (3, 3, 512, 70), generator=gen,
                       device=dev, dtype=torch.int8)
    got = rc.trunk_conv_dot(x, wc, plan=table.Plan(16, 3))
    assert cm.launched_plan(rc.last_launch) == table.Plan(16, 3)
    assert torch.equal(got, rc.trunk_conv_dot(x, wc))
    c = torch.randn((4608, 1152), generator=gen, device=dev)
    xf = torch.randn((40, 4608), generator=gen, device=dev)
    a = rm.rebranch_trunk_sketch(xf, w, c, plan=table.Plan(16, 9, 8, 1))
    assert rm.launched_plan(rm.last_launch) == table.Plan(16, 9, 8, 1)
    b = rm.rebranch_trunk_sketch(xf, w, c)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="not a legal plan"):
        cm.cim_matmul(xq, w, cim.CiMConfig(mode="bitserial"),
                      plan=table.Plan(64, 1))
