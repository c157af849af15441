"""The port's branch training against the JAX package, on the CPU.

Parameters come from the JAX init (gemma-2b smoke, seeded non-zero
ReBranch cores) and are converted with ``bridge.to_torch``; batches are
the packages' own ``markov_batch`` (equal arrays).  The JAX step runs
under ``jax.jit``, the port's eagerly, each on its own state.

Tolerances and why:
  * ``token_cross_entropy`` / ``chunked_readout_loss`` on the same logits
    or features: 1e-6 / 1e-5 relative (logsumexp and the rmsnorm mean
    sum in another order; the picked logit is exact).
  * one train step: the loss to 1e-3 relative and each leaf of AdamW's
    ``m`` after the step (0.1 x the clipped gradient) to 5e-2 of its
    absmax — the LM forward's own tolerance (``test_torch_lm.py``): an
    ulp moved before a per-row int8 quantiser can move a code (measured
    here: loss 2e-7, ``m`` 1.1e-6 on the first step).
  * a checkpoint crossing packages: the continued step's loss to 1e-3.
  * the ResNet-18 branch step: the loss to 1e-3 relative and every
    gradient leaf to a cosine of 0.95 with JAX's (measured: 6e-4 and
    0.982 at 16 px), the head's gradient to 5e-2 of its absmax.  The
    quantised CNN is chaotic at the ulp level (``test_torch_cnn.py``), so
    the backward is held tightly per conv instead: every ResNet-18 conv's
    vector-Jacobian product on identical inputs to 1e-5 of its absmax
    (measured ~4e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro import deploy as jdeploy
from repro import optim as joptim
from repro.checkpoint import manager as jckpt
from repro.core import rebranch as jrebranch
from repro.core.rebranch import ReBranchSpec as JSpec
from repro.data import synthetic as jsyn
from repro.launch import steps as jsteps
from repro.models import cnn as jcnn
from repro.optim import schedule as jschedule
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import deploy as tdeploy
from repro_torch import optim as toptim
from repro_torch.checkpoint import manager as tckpt
from repro_torch.core import rebranch as trebranch
from repro_torch.core.rebranch import ReBranchSpec as TSpec
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import cnn as tcnn
from repro_torch.optim import schedule as tschedule

LOSS_REL = 1e-3
M_REL = 5e-2
SEQ, BATCH = 32, 4
SCHED = dict(peak_lr=3e-3, warmup_steps=2, total_steps=12)


def with_cores(tree, rng):
    """Seeded N(0, 0.05) ReBranch cores, so every branch contributes."""
    if isinstance(tree, dict):
        out = {k: with_cores(v, rng) for k, v in tree.items()}
        sram = out.get("sram")
        if isinstance(sram, dict) and "core" in sram:
            out["sram"] = dict(sram, core=(
                rng.normal(size=sram["core"].shape) * 0.05
            ).astype(np.float32))
        return out
    if isinstance(tree, list):
        return [with_cores(v, rng) for v in tree]
    return tree


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


class LM:
    """One gemma-2b smoke cell in both packages."""

    def __init__(self, engine):
        self.jcfg = jconfigs.get_smoke("gemma_2b")
        self.tcfg = tconfigs.get_smoke("gemma_2b")
        self.jm = jdeploy.compile_model(self.jcfg, engine=engine)
        self.tm = tdeploy.compile_model(self.tcfg, engine=engine)
        self.params = with_cores(
            jax.tree.map(np.asarray, self.jm.init(jax.random.PRNGKey(0))),
            np.random.default_rng(1))
        kw = dict(seed=0, vocab_size=self.jcfg.vocab_size, seq_len=SEQ,
                  global_batch=BATCH)
        self.jd, self.td = jsyn.DataConfig(**kw), tsyn.DataConfig(**kw)

    def jax_state(self):
        t, f = jrebranch.partition(jax.tree.map(jnp.asarray, self.params))
        return t, f, joptim.init(t)

    def torch_state(self):
        p = bridge.to_torch(self.params, "cpu")
        t, f = trebranch.partition(p)
        return p, t, f, toptim.init(t)

    def jax_step(self):
        return jax.jit(jsteps.make_train_step(
            self.jcfg, joptim.AdamWConfig(lr=3e-3),
            lr_fn=lambda s: jschedule.cosine_with_warmup(s, **SCHED),
            loss_chunks=2, model=self.jm))

    def torch_step(self):
        return tsteps.make_train_step(
            self.tcfg, toptim.AdamWConfig(lr=3e-3),
            lr_fn=lambda s: tschedule.cosine_with_warmup(s, **SCHED),
            loss_chunks=2, model=self.tm)

    def batches(self, step):
        return (jsyn.markov_batch(self.jd, step),
                tsyn.markov_batch(self.td, step, device="cpu"))


_LM = {}


def lm(engine="int8_native"):
    if engine not in _LM:
        _LM[engine] = LM(engine)
    return _LM[engine]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 5, 37), (3, 4, 2, 11)])
def test_token_cross_entropy_matches(shape):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=shape) * 3).astype(np.float32)
    labels = rng.integers(0, shape[-1], size=shape[:-1]).astype(np.int32)
    want = float(jsteps.token_cross_entropy(jnp.asarray(logits),
                                            jnp.asarray(labels)))
    got = tsteps.token_cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("seq,chunks", [(32, 4), (30, 4), (7, 8)])
def test_chunked_readout_loss_matches(seq, chunks):
    """Also the chunk rule: S = 30 with 4 chunks falls to 3, S = 7 to 7."""
    c = lm()
    rng = np.random.default_rng(seq)
    feats = rng.normal(size=(2, seq, c.jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, c.jcfg.vocab_size, size=(2, seq)
                          ).astype(np.int32)
    want = float(jsteps.chunked_readout_loss(
        jax.tree.map(jnp.asarray, c.params), jnp.asarray(feats),
        jnp.asarray(labels), c.jcfg, chunks, model=c.jm))
    tp = bridge.to_torch(c.params, "cpu")
    got = tsteps.chunked_readout_loss(tp, torch.from_numpy(feats),
                                      torch.from_numpy(labels), c.tcfg,
                                      chunks, model=c.tm)
    assert float(got) == pytest.approx(want, rel=1e-5)
    whole = tsteps.token_cross_entropy(
        c.tm.apply_head(tp, torch.from_numpy(feats)),
        torch.from_numpy(labels))
    assert float(got) == pytest.approx(float(whole), rel=1e-5)


def test_readout_chunks_are_recomputed_in_the_backward(monkeypatch):
    """Each chunk's logits are made once in the forward and once more in
    the backward (non-reentrant checkpoint), and the loss's gradient
    matches the unchunked loss's."""
    c = lm()
    tp = bridge.to_torch(c.params, "cpu")
    feats = torch.randn((2, 16, c.tcfg.d_model), generator=torch.Generator(
        ).manual_seed(0), requires_grad=True)
    labels = torch.randint(0, c.tcfg.vocab_size, (2, 16), dtype=torch.int32)
    calls = []
    head = c.tm.apply_head

    def counted(params, x):
        calls.append(tuple(x.shape))
        return head(params, x)

    monkeypatch.setattr(c.tm, "apply_head", counted)
    loss = tsteps.chunked_readout_loss(tp, feats, labels, c.tcfg, 4,
                                       model=c.tm)
    assert calls == [(2, 4, c.tcfg.d_model)] * 4
    (g,) = torch.autograd.grad(loss, feats)
    assert len(calls) == 8
    monkeypatch.setattr(c.tm, "apply_head", head)
    (g_whole,) = torch.autograd.grad(
        tsteps.token_cross_entropy(head(tp, feats), labels), feats)
    np.testing.assert_allclose(g.numpy(), g_whole.numpy(), rtol=0,
                               atol=1e-5 * g_whole.abs().max().item())


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["int8_native", "pallas"])
def test_train_step_matches_reference(engine):
    c = lm(engine)
    jt, jf, jo = c.jax_state()
    _, tt, tf, to = c.torch_state()
    jb, tb = c.batches(0)
    jt2, jo2, jm = c.jax_step()(jt, jf, jo, jb)
    tt2, to2, tm = c.torch_step()(tt, tf, to, tb)
    assert set(tm) == {"loss", "grad_norm", "lr"}
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                              rel=LOSS_REL)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=LOSS_REL)
    assert float(tm["lr"]) == float(jm["lr"])
    want = bridge.flatten(jax.tree.map(np.asarray, jo2["m"]))
    got = bridge.flatten(to2["m"])
    assert list(got) == list(want)
    for name in want:
        assert _rel(got[name].numpy(), want[name]) <= M_REL, name
    assert int(to2["step"]) == 1
    assert list(bridge.flatten(tt2)) == list(bridge.flatten(tt))


def test_unreached_leaf_gets_zero_grad_and_still_decays():
    """A trainable leaf the loss never reads gets a zero gradient (as
    ``jax.grad`` gives), so AdamW still applies its weight decay."""
    c = lm()
    _, tt, tf, to = c.torch_state()
    tt = dict(tt, unused={"sram": {"w": torch.ones(3)}})
    tf = dict(tf, unused={"sram": {"w": None}})
    to = toptim.init(tt)
    _, tb = c.batches(0)
    tt2, to2, _ = c.torch_step()(tt, tf, to, tb)
    assert torch.equal(to2["m"]["unused"]["sram"]["w"], torch.zeros(3))
    lr = float(tschedule.cosine_with_warmup(torch.tensor(0), **SCHED))
    decayed = torch.ones(3) - lr * 0.01 * torch.ones(3)
    assert torch.equal(tt2["unused"]["sram"]["w"], decayed)


def test_rom_gets_no_gradient_and_is_not_written():
    c = lm("pallas")
    p, tt, tf, to = c.torch_state()
    frozen = bridge.flatten(tf)
    before = {k: v.clone() for k, v in frozen.items()}
    _, tb = c.batches(0)
    c.torch_step()(tt, tf, to, tb)
    for k, v in bridge.flatten(tf).items():
        assert v is frozen[k] and not v.requires_grad
        assert torch.equal(v, before[k]), k


def test_train_loss_decreases_and_resumes(tmp_path):
    """Port of ``TestEndToEnd``: 12 steps, the loss falls, and a save /
    restore mid-run continues bit for bit."""
    c = lm()
    p, t, f, opt = c.torch_state()
    step_fn = tsteps.make_train_step(c.tcfg, toptim.AdamWConfig(lr=5e-3),
                                     loss_chunks=2, model=c.tm)
    losses = []
    for s in range(12):
        t, opt, m = step_fn(t, f, opt, c.batches(s)[1])
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    tckpt.save(str(tmp_path), 12, t, opt, p)
    _, t2, opt2, _ = tckpt.restore(str(tmp_path), t, opt, p, device="cpu")
    b = c.batches(12)[1]
    t_a, _, ma = step_fn(t, f, opt, b)
    t_b, _, mb = step_fn(t2, f, opt2, b)
    assert float(ma["loss"]) == float(mb["loss"])
    for k, v in bridge.flatten(t_a).items():
        assert torch.equal(v, bridge.flatten(t_b)[k]), k


def test_checkpoint_resumes_across_packages(tmp_path):
    """JAX trains 4 steps and saves, the port restores and continues one
    step; then the port trains 4 steps and saves, JAX restores and
    continues.  Each continued loss within 1e-3 of the writer's own."""
    c = lm()
    jstep, tstep = c.jax_step(), c.torch_step()
    jt, jf, jo = c.jax_state()
    p, tt, tf, to = c.torch_state()
    jparams = jax.tree.map(jnp.asarray, c.params)
    for s in range(4):
        jt, jo, _ = jstep(jt, jf, jo, c.batches(s)[0])
    jckpt.save(str(tmp_path / "j"), 4, jt, jo, jparams)
    _, jm = jstep(jt, jf, jo, c.batches(4)[0])[1:]
    step, rt, ro, _ = tckpt.restore(str(tmp_path / "j"), tt, to, p,
                                    device="cpu")
    assert step == 4 and int(ro["step"]) == 4
    _, _, tm = tstep(rt, tf, ro, c.batches(4)[1])
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                              rel=LOSS_REL)

    for s in range(4):
        tt, to, _ = tstep(tt, tf, to, c.batches(s)[1])
    tckpt.save(str(tmp_path / "t"), 4, tt, to, p)
    _, _, tm = tstep(tt, tf, to, c.batches(4)[1])
    jt0, _, jo0 = c.jax_state()
    step, rt, ro, _ = jckpt.restore(str(tmp_path / "t"), jt0, jo0, jparams)
    assert step == 4 and int(ro["step"]) == 4
    _, _, jm = jstep(rt, jf, ro, c.batches(4)[0])
    assert float(jm["loss"]) == pytest.approx(float(tm["loss"]),
                                              rel=LOSS_REL)


def test_prefill_and_serve_steps():
    """``make_prefill_step`` / ``make_serve_step``: a prompt into a fresh
    cache, then one greedy token, as the model's own surface gives."""
    c = lm()
    tp = bridge.to_torch(c.params, "cpu")
    _, tb = c.batches(0)
    prompt = {"tokens": tb["tokens"][:, :8]}
    logits, cache = tsteps.make_prefill_step(c.tcfg, BATCH, 16, c.tm,
                                             device="cpu")(tp, prompt)
    want_cache = c.tm.init_cache(BATCH, 16, device="cpu")
    with torch.no_grad():
        want, _ = c.tm.prefill(tp, prompt, want_cache)
    assert torch.equal(logits, want)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    nxt, cache = tsteps.make_serve_step(c.tcfg, c.tm)(
        tp, {"tokens": tok}, cache)
    with torch.no_grad():
        want, _ = c.tm.decode_step(tp, tok, want_cache)
    assert nxt.dtype == torch.int32 and nxt.shape == (BATCH, 1)
    assert torch.equal(nxt, torch.argmax(want, dim=-1).to(torch.int32))


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------

def test_train_main_smoke_with_resume(tmp_path, capsys):
    args = ["--arch", "gemma_2b", "--smoke", "--steps", "6", "--batch", "2",
            "--seq", "16", "--warmup", "2", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "3", "--log-every", "3"]
    losses = ttrain.main(args, device="cpu")
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert tckpt.latest_steps(str(tmp_path)) == [3, 6]
    out = capsys.readouterr().out
    assert "ROM" in out and "step     6" in out and "entropy floor" in out
    more = ttrain.main(args[:4] + ["8"] + args[5:] + ["--resume"],
                       device="cpu")
    assert "resumed from step 6" in capsys.readouterr().out
    assert len(more) == 2 and tckpt.latest_steps(str(tmp_path)) == [3, 6, 8]


def test_train_main_compress_raises(capsys):
    """``--compress`` no longer raises: in one process there is no
    gradient all-reduce to compress, so the losses are those of a run
    without it (test_torch_dist_train.py runs it in a world of ranks)."""
    args = ["--arch", "gemma_2b", "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "16", "--warmup", "1"]
    plain = ttrain.main(args, device="cpu")
    capsys.readouterr()
    assert ttrain.main(args + ["--compress"], device="cpu") == plain
    assert "no gradient all-reduce to compress" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the paper's CNN fine-tune: a ResNet-18 branch step
# ---------------------------------------------------------------------------

CNN_SIZE, CNN_CLASSES, CNN_BATCH = 16, 10, 4


def _cnn_params():
    cfg = tcnn.CNNConfig(name="resnet18", input_size=CNN_SIZE,
                         num_classes=CNN_CLASSES)
    params = bridge.to_numpy(tdeploy.compile_model(cfg).init(3,
                                                             device="cpu"))
    return with_cores(params, np.random.default_rng(0))


@pytest.mark.parametrize("engine", ["int8_native", "pallas"])
def test_resnet18_branch_step_matches_value_and_grad(engine):
    params = _cnn_params()
    x, y = tsyn._image_arrays(5, 0, CNN_BATCH, CNN_SIZE, CNN_CLASSES)
    jm = jdeploy.compile_model(jcnn.CNNConfig(
        name="resnet18", input_size=CNN_SIZE, num_classes=CNN_CLASSES),
        engine=engine)
    tm = tdeploy.compile_model(tcnn.CNNConfig(
        name="resnet18", input_size=CNN_SIZE, num_classes=CNN_CLASSES),
        engine=engine)
    jt, jf = jrebranch.partition(jax.tree.map(jnp.asarray, params))

    def jloss(t):
        logp = jax.nn.log_softmax(jm.forward(jrebranch.combine(t, jf), x))
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=-1))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jt)
    tt, tf = trebranch.partition(bridge.to_torch(params, "cpu"))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)

    def tloss(t):
        logp = F.log_softmax(tm.forward(trebranch.combine(t, tf), tx), -1)
        return -logp.gather(-1, ty.long()[:, None]).mean()

    tl, tg = tsteps.value_and_grad(tloss, tt)
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_REL)
    want = bridge.flatten(jax.tree.map(np.asarray, jg))
    got = bridge.flatten(tg)
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name].numpy().ravel()
        cos = g @ w.ravel() / (np.linalg.norm(g) * np.linalg.norm(w))
        assert cos >= 0.95, (name, cos)
    for name in ("['fc']['sram']['w']", "['fc']['sram']['b']"):
        assert _rel(got[name].numpy(), want[name]) <= M_REL, name
    # one AdamW step on those gradients moves only the SRAM tree
    opt = toptim.init(tt)
    t2, _, m = toptim.update(tg, opt, tt, toptim.AdamWConfig(
        lr=2e-3, weight_decay=0.0))
    assert np.isfinite(float(m["grad_norm"]))
    assert all(not torch.equal(a, bridge.flatten(tt)[k])
               for k, a in bridge.flatten(t2).items() if "core" in k)


def _resnet18_convs():
    """(k, c_in, c_out, stride) of every ROM conv of ResNet-18."""
    out = [(3, 3, 64, 1)]
    c_in = 64
    for c_out, blocks, stride in tcnn.RESNET18_STAGES:
        for b in range(blocks):
            st = stride if b == 0 else 1
            out += [(3, c_in, c_out, st), (3, c_out, c_out, 1)]
            if st != 1 or c_in != c_out:
                out.append((1, c_in, c_out, st))
            c_in = c_out
    return sorted(set(out))


@pytest.mark.parametrize("engine", ["int8_native", "pallas"])
def test_resnet18_conv_vjps_match(engine):
    """Each ResNet-18 conv geometry (at 8x8): the branch-core and input
    gradients of one ReBranch conv on identical inputs."""
    rng = np.random.default_rng(2)
    for k, c_in, c_out, stride in _resnet18_convs():
        p = bridge.to_numpy(tcnn.init_conv(torch.Generator().manual_seed(1),
                                           k, c_in, c_out, TSpec()))
        p["sram"]["core"] = (rng.normal(size=p["sram"]["core"].shape)
                             * 0.05).astype(np.float32)
        x = rng.normal(size=(2, 8, 8, c_in)).astype(np.float32)
        jspec = JSpec(trunk_impl=engine)
        y, vjp = jax.vjp(lambda core, xx: jcnn.apply_conv(
            {"rom": p["rom"], "sram": {"core": core}}, xx, jspec, stride),
            jnp.asarray(p["sram"]["core"]), jnp.asarray(x))
        g = rng.normal(size=y.shape).astype(np.float32)
        jcore, jx = vjp(jnp.asarray(g))
        tp = bridge.to_torch(p, "cpu")
        core = tp["sram"]["core"].requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        yt = tcnn.apply_conv({"rom": tp["rom"], "sram": {"core": core}}, xt,
                             TSpec(trunk_impl=engine), stride)
        tcore, tx = torch.autograd.grad(yt, (core, xt), torch.from_numpy(g))
        geom = (k, c_in, c_out, stride)
        assert _rel(yt.detach().numpy(), y) <= 1e-5, geom
        assert _rel(tcore.numpy(), jcore) <= 1e-5, geom
        assert _rel(tx.numpy(), jx) <= 1e-5, geom
