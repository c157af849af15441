"""Branch training's kernels on the card (``chip_smoke.py`` phase 15 at
small sizes), against the plain versions and the CPU.

Imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_gpu.py

Each test decides inside itself whether there is a card and skips without
one.  Kernel 4 under autograd (``ops.trunk_matmul_pallas``) launches once
in the forward and never in the straight-through backward; its output is
``torch.equal`` to the plain version's and its dx to ``g @ (w_q*s).T`` on
the card.  Kernel 1's scaled trunk (``ops.trunk_conv``) is ``torch.equal``
to the CPU's plain version, and its STE dx (a cuDNN transposed conv on
the card) within 1e-5 of the CPU's absmax.  A whole train step, card vs
CPU, is held as ``tests/test_torch_train.py`` holds the packages: the
loss to 1e-3 relative, AdamW's ``m`` to 5e-2 of each leaf's absmax.
"""

import pytest
import torch

from repro_torch import bridge, configs, deploy, optim
from repro_torch import device as device_lib
from repro_torch.core import quant, rebranch
from repro_torch.data import synthetic
from repro_torch.kernels import cim_matmul as cm
from repro_torch.kernels import ops as kops
from repro_torch.kernels import rebranch_conv as rc
from repro_torch.launch import steps
from repro_torch.models import cnn, moe


def _card():
    """The card, through the port's resolver (which turns TF32 off: the
    STE dx is a cuDNN conv, and TF32 would move it by ~3e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    return device_lib.resolve()


def _rel(got, want) -> float:
    return ((got.float().cpu() - want.float().cpu()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


# (M, K, N): one k-block, a ragged third block, a split-K shape, M off 64
MATMULS = [(64, 512, 96), (48, 1152, 40), (128, 2048, 256), (37, 256, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", MATMULS)
def test_kernel4_under_autograd(m, k, n, dtype):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    w_q = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                        dtype=torch.int8)
    w_scale = torch.rand((n,), generator=gen, device=dev) * 1e-2 + 1e-3
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    x.requires_grad_(True)
    before = cm.launches
    y = kops.trunk_matmul_pallas(cm.IDEAL, x, w_q, w_scale)
    assert cm.launches == before + 1
    x_q, sx = quant.quantize_activations(x.detach())
    want = (cm.cim_matmul_plain(x_q, w_q) * sx).to(dtype) \
        * w_scale.to(dtype)
    assert torch.equal(y.detach(), want)
    g = torch.randn(y.shape, generator=gen, device=dev).to(dtype)
    (dx,) = torch.autograd.grad(y, x, g)
    assert cm.launches == before + 1          # none in the backward
    assert torch.equal(dx, g @ (w_q.to(dtype) * w_scale.to(dtype)).T)


# (N, H, C_in, C_out, k, stride): ResNet-18's kinds of conv
CONVS = [(4, 16, 3, 64, 3, 1), (4, 16, 64, 128, 3, 2),
         (4, 8, 64, 128, 1, 2), (2, 4, 256, 512, 3, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,c_in,c_out,k,stride", CONVS)
def test_kernel1_trunk_and_ste_dx_vs_cpu(n, h, c_in, c_out, k, stride):
    dev = _card()
    gen = torch.Generator().manual_seed(n * h + c_in + k)
    x = torch.randn((n, h, h, c_in), generator=gen)
    w_q = torch.randint(-127, 128, (k, k, c_in, c_out), generator=gen,
                        dtype=torch.int8)
    w_scale = torch.rand((1, 1, 1, c_out), generator=gen) * 1e-2 + 1e-3
    outs = {}
    for d in (dev, torch.device("cpu")):
        xd = x.to(d).requires_grad_(True)
        before = rc.launches
        y = kops.trunk_conv(rc.IDEAL, stride, "SAME", xd, w_q.to(d),
                            w_scale.to(d))
        assert rc.launches - before == (d.type == "cuda")
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(5))
        (dx,) = torch.autograd.grad(y, xd, g.to(d))
        outs[d.type] = (y.detach().cpu(), dx.cpu())
    assert torch.equal(outs["cuda"][0], outs["cpu"][0])
    assert _rel(outs["cuda"][1], outs["cpu"][1]) <= 1e-5


def _smoke_train_cell():
    cfg = configs.get_smoke("gemma_2b")
    model = deploy.compile_model(cfg, engine="pallas")
    params = model.init(seed=0, device="cpu")
    return cfg, model, params


@pytest.mark.gpu
def test_train_step_card_matches_cpu():
    dev = _card()
    cfg, model, params = _smoke_train_cell()
    step_fn = steps.make_train_step(cfg, optim.AdamWConfig(lr=3e-3),
                                    loss_chunks=2, model=model)
    dcfg = synthetic.DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                global_batch=4)
    outs = {}
    for d in (dev, torch.device("cpu")):
        p = bridge.tree_map(params, lambda t: t.to(d))
        t, f = rebranch.partition(p)
        before = cm.launches
        outs[d.type] = step_fn(t, f, optim.init(t),
                               synthetic.markov_batch(dcfg, 0, device=d))
        # 7 ROM linears a layer, run again in each block's remat recompute
        assert cm.launches - before == (7 * cfg.num_layers
                                        * (2 if cfg.remat else 1)
                                        if d.type == "cuda" else 0)
    (_, o_card, m_card), (_, o_cpu, m_cpu) = outs["cuda"], outs["cpu"]
    assert float(m_card["loss"]) == pytest.approx(float(m_cpu["loss"]),
                                                  rel=1e-3)
    want = bridge.flatten(o_cpu["m"])
    for name, a in bridge.flatten(o_card["m"]).items():
        assert a.device.type == "cuda"
        assert _rel(a, want[name]) <= 5e-2, name


@pytest.mark.gpu
def test_resnet18_branch_step_launches_kernel1_per_conv():
    dev = _card()
    cfg = cnn.CNNConfig(name="resnet18", input_size=16, num_classes=10)
    model = deploy.compile_model(cfg, engine="pallas")
    params = model.init(seed=1, device=dev)
    t, f = rebranch.partition(params)
    x, y = synthetic.image_batch(3, 0, 4, 16, 10, device=dev)

    def loss_fn(tt):
        logits = model.forward(rebranch.combine(tt, f), x)
        return -torch.log_softmax(logits, -1).gather(
            -1, y.long()[:, None]).mean()

    before = rc.launches
    loss, grads = steps.value_and_grad(loss_fn, t)
    assert rc.launches - before == len(cnn.conv_site_shapes(cfg))
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in bridge.flatten(grads).values())


@pytest.mark.gpu
@pytest.mark.parametrize("e,c,d_in,d_out", [(40, 64, 1536, 512),
                                            (3, 5, 100, 48)])
def test_stacked_expert_trunk_ste_card_matches_cpu(e, c, d_in, d_out):
    """``moe.stacked_trunk_matmul`` (plain PyTorch in both packages, not
    kernel 4) on the card: the forward ``torch.equal`` to the CPU's (exact
    int sums), the straight-through dx ``g @ (w_q*s).T`` within 1e-5 of
    the CPU's absmax, and no gradient for the int8 W or its scale."""
    dev = _card()
    gen = torch.Generator().manual_seed(e + d_in)
    x = torch.randn((e, c, d_in), generator=gen)
    w_q = torch.randint(-127, 128, (e, d_in, d_out), generator=gen,
                        dtype=torch.int8)
    w_s = torch.rand((e, 1, d_out), generator=gen) * 1e-2 + 1e-3
    g = torch.randn((e, c, d_out), generator=gen)
    outs = []
    for where in ("cpu", dev):
        xx = x.to(where).requires_grad_(True)
        y = moe.stacked_trunk_matmul(xx, w_q.to(where), w_s.to(where))
        (dx,) = torch.autograd.grad(y, xx, g.to(where))
        outs.append((y.detach().cpu(), dx.cpu()))
    assert torch.equal(outs[1][0], outs[0][0])
    assert _rel(outs[1][1], outs[0][1]) <= 1e-5
