"""Branch training, branch checkpoints and hot-swap over the LM families
that serve through the port since its moe/ssm/hybrid and vlm/audio slices,
held to the JAX package on the CPU.

Parameters are the port's init of each SMOKE config on the CPU with
seeded non-zero ReBranch cores, handed to both packages as numpy (the
JAX init of these trees takes 3-10 s each); batches are the packages' own
``markov_batch`` (equal arrays; [B, S, 4] codebook tokens for MusicGen).
Both run under ``pallas`` (kernel 4 behind every ROM linear; its plain
version here).  Each JAX step is jitted once and its result shared by the
tests through a module-level cache.

Tolerances and why (``tests/test_torch_train.py``'s):
  * one train step: the loss and the global gradient norm to 1e-3
    relative, each leaf of AdamW's ``m`` after the step to 5e-2 of its
    absmax (the SMOKE configs run f32 activations) — the LM forward's own
    tolerance: an ulp moved before a per-row int8 quantiser can move a
    code.  The learning rate exactly.
  * checkpoints and branch files crossing packages: bitwise.
  * a hot-swapped cell against a fresh one: bitwise (tokens and logits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import deploy as jdeploy
from repro import optim as joptim
from repro import plan as jplan
from repro import scenario as jscenario
from repro.checkpoint import manager as jckpt
from repro.core import rebranch as jrebranch
from repro.data import synthetic as jsyn
from repro.launch import steps as jsteps
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import deploy as tdeploy
from repro_torch import optim as toptim
from repro_torch import plan as tplan
from repro_torch import scenario as tscenario
from repro_torch.checkpoint import manager as tckpt
from repro_torch.core import rebranch as trebranch
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe
from repro_torch.serve import pool as tpool
from repro_torch.serve.scheduler import ContinuousBatcher

from test_torch_train import with_cores

LOSS_REL = 1e-3
M_REL = 5e-2
SEQ, BATCH = 16, 2
FAMILIES = ("qwen2_vl_2b", "musicgen_large", "granite_moe_3b",
            "hymba_1_5b", "falcon_mamba_7b")
TREES = ("granite_moe_3b", "hymba_1_5b", "falcon_mamba_7b")
ENGINE = "pallas"


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


class Family:
    """One SMOKE config in both packages, its parameters and batches, and
    one jitted JAX train step from the initial state."""

    def __init__(self, arch):
        self.arch = arch
        self.jcfg, self.tcfg = jconfigs.get_smoke(arch), \
            tconfigs.get_smoke(arch)
        self.jplan = jplan.solve(self.jcfg, None, engine=ENGINE)
        self.tplan = tplan.solve(self.tcfg, None, engine=ENGINE)
        self.jm = jdeploy.compile_model(self.jcfg, plan=self.jplan)
        self.tm = tdeploy.compile_model(self.tcfg, plan=self.tplan)
        self.params = with_cores(
            bridge.to_numpy(self.tm.init(seed=0, device="cpu")),
            np.random.default_rng(1))
        kw = dict(seed=0, vocab_size=self.jcfg.vocab_size, seq_len=SEQ,
                  global_batch=BATCH, num_codebooks=self.jcfg.num_codebooks)
        self.jd, self.td = jsyn.DataConfig(**kw), tsyn.DataConfig(**kw)
        self._jax_step = None

    def torch_state(self):
        p = bridge.to_torch(self.params, "cpu")
        t, f = trebranch.partition(p)
        return p, t, f, toptim.init(t)

    def torch_step(self, lr=3e-3):
        return tsteps.make_train_step(self.tcfg, toptim.AdamWConfig(lr=lr),
                                      loss_chunks=2, model=self.tm)

    def jax_step(self):
        """(trainable, opt state, metrics) after one jitted JAX step."""
        if self._jax_step is None:
            jt, jf = jrebranch.partition(
                jax.tree.map(jnp.asarray, self.params))
            step = jax.jit(jsteps.make_train_step(
                self.jcfg, joptim.AdamWConfig(lr=3e-3), loss_chunks=2,
                model=self.jm))
            self._jax_step = jax.tree.map(
                np.asarray, step(jt, jf, joptim.init(jt), self.batch(0)[0]))
        return self._jax_step

    def batch(self, step):
        return (jsyn.markov_batch(self.jd, step),
                tsyn.markov_batch(self.td, step, device="cpu"))


_FAM = {}


def fam(arch):
    if arch not in _FAM:
        _FAM[arch] = Family(arch)
    return _FAM[arch]


# ---------------------------------------------------------------------------
# the train step over every new family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(arch):
    f = fam(arch)
    jt2, jo2, jm = f.jax_step()
    _, tt, tf, to = f.torch_state()
    tb = f.batch(0)[1]
    if f.tcfg.num_codebooks:
        assert tuple(tb["tokens"].shape) == (BATCH, SEQ, 4)
    tt2, to2, tm = f.torch_step()(tt, tf, to, tb)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                              rel=LOSS_REL)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=LOSS_REL)
    assert float(tm["lr"]) == float(jm["lr"])
    want, got = bridge.flatten(jo2["m"]), bridge.flatten(to2["m"])
    assert list(got) == list(want)
    for name in want:
        assert _rel(got[name].numpy(), want[name]) <= M_REL, name
    assert int(to2["step"]) == 1
    assert list(bridge.flatten(tt2)) == list(bridge.flatten(jt2))


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_falls_and_the_rom_is_never_written(arch):
    f = fam(arch)
    _, t, fr, opt = f.torch_state()
    frozen = bridge.flatten(fr)
    before = {k: v.clone() for k, v in frozen.items()}
    step = f.torch_step(lr=5e-3)
    losses = []
    for s in range(8):
        t, opt, m = step(t, fr, opt, f.batch(s % 2)[1])
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    for k, v in bridge.flatten(fr).items():
        assert v is frozen[k] and not v.requires_grad
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_cli_over_every_new_family(arch, tmp_path):
    """``launch/train.py --arch`` on each new family's SMOKE config, with
    checkpoints and ``--resume``."""
    argv = ["--arch", arch, "--smoke", "--steps", "4", "--batch", "2",
            "--seq", "8", "--warmup", "1", "--log-every", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    losses = ttrain.main(argv[:4] + ["2"] + argv[5:], device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert tckpt.latest_steps(str(tmp_path))[-1] == 2
    rest = ttrain.main(argv + ["--resume"], device="cpu")
    assert len(rest) == 2 and all(np.isfinite(rest))
    assert tckpt.latest_steps(str(tmp_path))[-1] == 4


def test_stacked_trunk_ste_backward_through_a_moe_step():
    """The stacked expert trunk's straight-through backward runs in the
    train step (one call per expert stack and layer), and gives no
    gradient to its int8 W."""
    f = fam("granite_moe_3b")
    _, t, fr, opt = f.torch_state()
    calls = []
    real = tmoe._StackedTrunkMatmul.backward

    def counted(ctx, g):
        out = real(ctx, g)
        calls.append(out)
        return out

    tmoe._StackedTrunkMatmul.backward = staticmethod(counted)
    try:
        f.torch_step()(t, fr, opt, f.batch(0)[1])
    finally:
        tmoe._StackedTrunkMatmul.backward = staticmethod(real)
    assert len(calls) == 3 * f.tcfg.num_layers
    assert all(dx is not None and dw is None and ds is None
               for dx, dw, ds in calls)


# ---------------------------------------------------------------------------
# checkpoints and branch files across packages, over the new trees
# ---------------------------------------------------------------------------

def _assert_same(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        g = got[k]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("arch", TREES)
def test_train_checkpoint_crosses_packages(arch, tmp_path):
    """The state after one JAX step, saved by JAX, restored by the port;
    and saved by the port, restored by JAX: every leaf bitwise."""
    f = fam(arch)
    jt2, jo2, _ = f.jax_step()
    jparams = jax.tree.map(jnp.asarray, f.params)
    jckpt.save(str(tmp_path / "j"), 1, jax.tree.map(jnp.asarray, jt2),
               jax.tree.map(jnp.asarray, jo2), jparams)
    p, tt, _, to = f.torch_state()
    step, rt, ro, _ = tckpt.restore(str(tmp_path / "j"), tt, to, p,
                                    device="cpu")
    assert step == 1 and int(ro["step"]) == 1
    _assert_same(bridge.flatten(rt), bridge.flatten(jt2))
    _assert_same(bridge.flatten(ro["m"]), bridge.flatten(jo2["m"]))
    _assert_same(bridge.flatten(ro["v"]), bridge.flatten(jo2["v"]))

    tckpt.save(str(tmp_path / "t"), 1, rt, ro, p)
    jt0, _ = jrebranch.partition(jparams)
    step, jrt, jro, _ = jckpt.restore(str(tmp_path / "t"), jt0,
                                      joptim.init(jt0), jparams)
    assert step == 1
    _assert_same(bridge.flatten(jax.tree.map(np.asarray, jrt)),
                 bridge.flatten(jt2))
    _assert_same(bridge.flatten(jax.tree.map(np.asarray, jro["m"])),
                 bridge.flatten(jo2["m"]))


@pytest.mark.parametrize("arch", TREES)
def test_branch_files_and_plan_fingerprint_cross_packages(arch, tmp_path):
    f = fam(arch)
    assert tscenario.plan_fingerprint(f.tplan) == \
        jscenario.plan_fingerprint(f.jplan)
    ttemp = tscenario.branch_template(f.tm)
    jtemp = jscenario.branch_template(f.jm)
    assert {k: tuple(v.shape) for k, v in bridge.flatten(ttemp).items()} \
        == {k: tuple(v.shape) for k, v in bridge.flatten(jtemp).items()}
    if arch == "hymba_1_5b":                       # a per-layer list
        assert isinstance(ttemp["layers"], list)
    if arch == "granite_moe_3b":
        # the stacked experts: one C/U per stack (ROM), a core per expert
        ex = f.params["layers"]["moe"]["experts"]["gate"]
        e = f.tcfg.num_experts
        assert ex["sram"]["core"].shape[:2] == (f.tcfg.num_layers, e)
        assert ex["rom"]["C"].shape[:1] == (f.tcfg.num_layers,)
        assert "C" not in ttemp["layers"]["moe"]["experts"]["gate"].get(
            "sram", {})
    branch = bridge.map_named(
        trebranch.partition(f.params)[0],
        lambda k, a: a + np.float32(0.01))
    name = f.tcfg.name
    jckpt.save_branch(str(tmp_path / "j"), "night", branch,
                      model_name=name, plan=f.jplan)
    got = tckpt.restore_branch(str(tmp_path / "j"), "night", ttemp,
                               plan=f.tplan, model_name=name, device="cpu")
    _assert_same(bridge.flatten(got), bridge.flatten(branch))
    tckpt.save_branch(str(tmp_path / "t"), "day",
                      bridge.to_torch(branch, "cpu"), model_name=name,
                      plan=f.tplan)
    got = jckpt.restore_branch(str(tmp_path / "t"), "day", jtemp,
                               plan=f.jplan, model_name=name)
    _assert_same(bridge.flatten(jax.tree.map(np.asarray, got)),
                 bridge.flatten(branch))


# ---------------------------------------------------------------------------
# hot-swap over the new trees
# ---------------------------------------------------------------------------

def _serve(model, params, prompts, n_new, swap=None, paged=False):
    """Requests through a 2-row batcher; with ``swap=(branch, i)`` the swap
    is queued behind the first ``i`` requests, the rest submitted after."""
    pool = (tpool.PagedPool(model, 2, 12, 8, 48, device="cpu") if paged
            else tpool.SlotPool(model, 2, 48, device="cpu"))
    b = ContinuousBatcher(model, params, pool, prefill_chunk=0,
                          scenario="a")
    cut = swap[1] if swap else len(prompts)
    reqs = [b.submit(p, n_new) for p in prompts[:cut]]
    if swap:
        b.step()                              # mid-stream
        b.swap("b", swap[0])
        reqs += [b.submit(p, n_new, scenario="b") for p in prompts[cut:]]
    b.drain(max_steps=200)
    return b, reqs


@pytest.mark.parametrize("arch", TREES)
def test_swap_under_the_batcher_equals_a_fresh_cell(arch):
    """A mid-stream swap from branch A to a trained branch B: the trunk
    tensors stay the same objects, and the requests served after the swap
    give the tokens of a fresh cell built on B's tree."""
    f = fam(arch)
    pA, t, fr, opt = f.torch_state()
    for s in range(2):                               # branch B: trained
        t, opt, _ = f.torch_step(lr=5e-2)(t, fr, opt, f.batch(s)[1])
    swapped = tscenario.swap_params(pA, t, donate=False)
    trunk = bridge.flatten(trebranch.partition(pA)[1])
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, f.tcfg.vocab_size, size=n)
               for n in (5, 9, 4, 7)]
    paged = arch == "granite_moe_3b"
    b, reqs = _serve(f.tm, pA, prompts, 5, swap=(t, 2), paged=paged)
    assert b.swap_count == 1 and b.scenario == "b"
    now = bridge.flatten(trebranch.partition(b.params)[1])
    assert all(now[k] is v for k, v in trunk.items())
    _, fresh = _serve(f.tm, swapped, prompts[2:], 5, paged=paged)
    assert [r.tokens for r in reqs[2:]] == [r.tokens for r in fresh]
    _, before = _serve(f.tm, pA, prompts[:2], 5, paged=paged)
    assert [r.tokens for r in reqs[:2]] == [r.tokens for r in before]
    # the swapped tree's decode logits equal the fresh tree's bit for bit
    donated = tscenario.swap_params(pA, t)
    cache_a = f.tm.init_cache(1, 16, dtype=torch.float32, device="cpu")
    cache_b = f.tm.init_cache(1, 16, dtype=torch.float32, device="cpu")
    tok = torch.as_tensor(prompts[0][None])
    with torch.no_grad():
        la, _ = f.tm.prefill(donated, {"tokens": tok}, cache_a)
        lb, _ = f.tm.prefill(swapped, {"tokens": tok}, cache_b)
    assert torch.equal(la, lb)
