"""The port's AdamW and schedules against the JAX package, on the CPU.

The same numpy params, grads and state go into ``repro.optim.update`` and
``repro_torch.optim.update``, step after step, each package carrying its
own state.  Both apply the same correctly rounded f32 operations in the
same order (the port takes its square roots and cosines in f64 rounded
to f32, as XLA's are correctly rounded and PyTorch's f32 ones on the CPU
are not), so the results agree to 1 f32 ulp (in fact bit for bit), with
one exception: the global norm sums each leaf in the framework's own
reduction order.  Where the clip is engaged the gradients are therefore
drawn on a 1/8 grid, whose squares sum exactly in any order; with normal
draws the clip factor may move by an ulp, and the test of that case holds
the norm to 1e-6 and the params to 1e-6 of their absmax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.optim import schedule as jschedule
from repro_torch import bridge
from repro_torch import optim as toptim
from repro_torch.optim import schedule as tschedule

STEPS = 5


def _tree(rng):
    """A trainable tree with None leaves where the ROM sits."""
    return {"layer": {"rom": None,
                      "sram": {"w": rng.normal(size=(33, 17)),
                               "b": rng.normal(size=(17,))}},
            "norms": [rng.normal(size=(1000,)), None],
            "head": {"w": rng.normal(size=(8, 4, 3))}}


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _grads(like, step, scale, grid):
    rng = np.random.default_rng(100 + step)

    def leaf(a):
        g = rng.normal(size=a.shape) * scale
        return np.round(g * 8) / 8 if grid else g
    return _f32(jax.tree.map(leaf, like))


def _assert_ulp(got, want, ulps=1):
    """``got`` (torch tree) within ``ulps`` f32 ulps of ``want`` (numpy
    tree), leaf for leaf, with the same None positions."""
    g = bridge.flatten(got)
    w = bridge.flatten(jax.tree.map(np.asarray, want))
    assert list(g) == list(w)
    for name, a in w.items():
        b = g[name].numpy()
        assert b.dtype == a.dtype and b.shape == a.shape, name
        tol = ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)))
        assert (np.abs(b - a) <= tol).all(), name


def _run(scale, grid, lr_kind, cfg_kw=None):
    """Both packages over STEPS steps; yields each step's outputs."""
    p0 = _f32(_tree(np.random.default_rng(0)))
    jcfg = joptim.AdamWConfig(**(cfg_kw or {}))
    tcfg = toptim.AdamWConfig(**(cfg_kw or {}))
    jp, tp = jax.tree.map(jnp.asarray, p0), bridge.to_torch(p0, "cpu")
    js, ts = joptim.init(jp), toptim.init(tp)
    for s in range(STEPS):
        g = _grads(p0, s, scale, grid)
        if lr_kind == "schedule":
            kw = dict(peak_lr=3e-3, warmup_steps=2, total_steps=STEPS + 3)
            jlr = jschedule.cosine_with_warmup(js["step"], **kw)
            tlr = tschedule.cosine_with_warmup(ts["step"], **kw)
        else:
            jlr = tlr = 3e-3 if lr_kind == "float" else None
        jp, js, jm = joptim.update(jax.tree.map(jnp.asarray, g), js, jp,
                                   jcfg, lr=jlr)
        tp, ts, tm = toptim.update(bridge.to_torch(g, "cpu"), ts, tp, tcfg,
                                   lr=tlr)
        yield (jp, js, jm), (tp, ts, tm)


@pytest.mark.parametrize("lr_kind", ["schedule", "float", "config"])
@pytest.mark.parametrize("scale", [1e-3, 10.0])     # clip off / engaged
def test_update_matches_reference(scale, lr_kind):
    for (jp, js, jm), (tp, ts, tm) in _run(scale, True, lr_kind):
        assert int(ts["step"]) == int(js["step"])
        assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
        _assert_ulp(tp, jp)
        _assert_ulp(ts["m"], js["m"])
        _assert_ulp(ts["v"], js["v"])
        assert float(tm["grad_norm"]) == float(jm["grad_norm"])
        assert (scale > 1) == (float(jm["grad_norm"]) > 1.0)


def test_update_normal_grads_clip_engaged():
    """Normal draws: the norm's reduction order may move the clip factor
    by an ulp (see the module docstring)."""
    for (jp, js, jm), (tp, ts, tm) in _run(10.0, False, "schedule"):
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        want = bridge.flatten(jax.tree.map(np.asarray, jp))
        for name, t in bridge.flatten(tp).items():
            np.testing.assert_allclose(
                t.numpy(), want[name], rtol=0,
                atol=1e-6 * np.abs(want[name]).max())


def test_update_weight_decay_and_betas():
    kw = dict(b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.1, grad_clip=0.5)
    for (jp, js, _), (tp, ts, _) in _run(10.0, True, "float", kw):
        _assert_ulp(tp, jp)
        _assert_ulp(ts["v"], js["v"])


def test_bf16_leaf_with_schedule_lr_rounds_once():
    """A 0-d f32 lr times a bf16 leaf promotes to f32 in JAX (one rounding
    to bf16 at the end); a float lr keeps bf16.  The port matches both."""
    rng = np.random.default_rng(3)
    p = {"w": rng.normal(size=(64,)).astype(jnp.bfloat16)}
    g = {"w": (rng.normal(size=(64,)) * 1e-3).astype(np.float32)}
    for lr in (jnp.asarray(3e-3, jnp.float32), 3e-3):
        jp = {"w": jnp.asarray(p["w"])}
        jout, _, _ = joptim.update(jax.tree.map(jnp.asarray, g),
                                   joptim.init(jp), jp, joptim.AdamWConfig(),
                                   lr=lr)
        tp = bridge.to_torch(p, "cpu")
        tlr = torch.tensor(float(lr)) if not isinstance(lr, float) else lr
        tout, _, _ = toptim.update(bridge.to_torch(g, "cpu"),
                                   toptim.init(tp), tp, toptim.AdamWConfig(),
                                   lr=tlr)
        assert tout["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tout["w"].float().numpy(),
            np.asarray(jout["w"]).astype(np.float32))


def test_opt_state_tree_lines_up_with_reference():
    p0 = _f32(_tree(np.random.default_rng(0)))
    js = joptim.init(jax.tree.map(jnp.asarray, p0))
    ts = toptim.init(bridge.to_torch(p0, "cpu"))
    assert list(bridge.flatten(ts)) == list(
        bridge.flatten(jax.tree.map(np.asarray, js)))
    assert ts["m"]["layer"]["rom"] is None and ts["v"]["norms"][1] is None


def test_update_writes_nothing_in_place():
    p0 = _f32(_tree(np.random.default_rng(0)))
    tp = bridge.to_torch(p0, "cpu")
    ts = toptim.init(tp)
    g = bridge.to_torch(_grads(p0, 0, 1.0, False), "cpu")
    before = [t.clone() for t in bridge.flatten((tp, ts, g)).values()]
    toptim.update(g, ts, tp, toptim.AdamWConfig())
    for a, b in zip(bridge.flatten((tp, ts, g)).values(), before):
        assert torch.equal(a, b)


def test_schedule_matches_reference_steps_0_to_120():
    for kw in (dict(peak_lr=3e-3, warmup_steps=20, total_steps=100),
               dict(peak_lr=1.0, warmup_steps=10, total_steps=100,
                    min_frac=0.2),
               dict(peak_lr=2e-3, warmup_steps=0, total_steps=50)):
        for step in range(121):
            want = np.float32(jschedule.cosine_with_warmup(
                jnp.asarray(step, jnp.int32), **kw))
            got = tschedule.cosine_with_warmup(
                torch.tensor(step, dtype=torch.int32), **kw)
            assert got.dtype == torch.float32 and got.dim() == 0
            assert abs(float(got) - float(want)) <= np.spacing(want), \
                (kw, step)
    assert tschedule.constant(torch.tensor(5), lr=0.25) == \
        jschedule.constant(jnp.asarray(5), lr=0.25)


# ---------------------------------------------------------------------------
# ports of tests/test_training.py::TestOptim
# ---------------------------------------------------------------------------

def test_adamw_reduces_quadratic():
    p = {"sram": {"w": torch.tensor([3.0, -2.0])}}
    st = toptim.init(p)
    cfg = toptim.AdamWConfig(lr=0.2, weight_decay=0.0)
    for _ in range(100):
        g = bridge.tree_map(p, lambda x: 2 * x)
        p, st, _ = toptim.update(g, st, p, cfg)
    assert float(p["sram"]["w"].abs().max()) < 0.1


def test_none_leaves_passthrough():
    p = {"rom": {"w": None}, "sram": {"w": torch.ones(3)}}
    st = toptim.init(p)
    g = {"rom": {"w": None}, "sram": {"w": torch.ones(3)}}
    p2, st2, _ = toptim.update(g, st, p, toptim.AdamWConfig())
    assert p2["rom"]["w"] is None
    assert p2["sram"]["w"].shape == (3,)
    assert st2["m"]["rom"]["w"] is None


def test_grad_clip():
    p = {"w": torch.zeros(4)}
    st = toptim.init(p)
    g = {"w": torch.full((4,), 1e6)}
    _, _, m = toptim.update(g, st, p, toptim.AdamWConfig(grad_clip=1.0))
    assert float(m["grad_norm"]) > 1e5   # reported pre-clip


def test_cosine_schedule():
    kw = dict(peak_lr=1.0, warmup_steps=10, total_steps=100)
    assert float(tschedule.cosine_with_warmup(torch.tensor(0), **kw)) == 0.0
    assert float(tschedule.cosine_with_warmup(torch.tensor(10), **kw)) == \
        pytest.approx(1.0)
    assert float(tschedule.cosine_with_warmup(torch.tensor(100), **kw)) == \
        pytest.approx(0.1, abs=1e-3)
