"""The CUDA trunk-conv kernel against its plain PyTorch version, on the card.

Imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each test decides inside itself whether there is a card and skips without
one.  The unscaled trunk is held with ``torch.equal``: the k-block integer
dots are exact and ``part * scale`` and ``acc + part`` round once each, in
ascending k-block order, on both sides.
"""

import pytest
import torch

from repro_torch.core import cim
from repro_torch.kernels import rebranch_conv as rc

# (M, R, N): R < 128, one ragged block, whole blocks, a ragged tail after
# two full blocks, and M / N off the kernel's 64-wide tiles
SHAPES = [(1000, 27, 32), (777, 180, 9), (300, 512, 64), (130, 576, 100),
          (65, 1170, 17), (5000, 288, 64), (64, 4608, 1024)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the trunk kernel runs only on the card")
    return torch.device("cuda")


def _inputs(m, r, n, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    p = torch.randn((m, r), generator=gen)
    p[0] = 0.0                                   # an all-zero patch row
    p[1, : min(r, 600)] *= 1e3                   # one row's scale dominates
    w = torch.randint(-127, 128, (r, n), generator=gen, dtype=torch.int8)
    return p.to(dev), w.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("m,r,n", SHAPES)
def test_kernel_equals_plain_version(m, r, n):
    dev = _card()
    p, w = _inputs(m, r, n, dev, seed=m + r + n)
    before = rc.launches
    got = rc.trunk_patch_dot(p, w)
    torch.cuda.synchronize()
    assert rc.launches == before + 1
    assert torch.equal(got, rc.trunk_patch_dot_plain(p, w))
    # and the CPU's plain version gives the same bits
    assert torch.equal(got.cpu(), rc.trunk_patch_dot_plain(p.cpu(), w.cpu()))


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_does_not_take():
    dev = _card()
    p, w = _inputs(70, 200, 10, dev, seed=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rc.trunk_patch_dot(p, w, cim.CiMConfig(mode="per_subarray"))
    with pytest.raises(ValueError):
        rc.trunk_patch_dot(p.double(), w)
    with pytest.raises(ValueError):
        rc.trunk_patch_dot(p[:, ::2], w[::2])
    with pytest.raises(ValueError):
        rc.trunk_patch_dot(p, w.cpu())
