"""Parity of the port's selective SSM (``repro_torch.models.ssm``) and the
ssm family (falcon-mamba) with the JAX package, on the CPU at SMOKE size.

The same numpy inputs and the same JAX-initialised parameters (converted by
``bridge``, the ReBranch cores replaced by seeded non-zero values) go
through ``repro`` and ``repro_torch`` (``device="cpu"``).

Tolerances and why:
  * the chunked scan: the port's log-step (Hillis-Steele) scan within a
    chunk multiplies and adds the (decay, input) pairs in another order
    than ``jax.lax.associative_scan``, and ``exp`` rounds differently in
    the two libraries: 1e-5 of the absmax for y and for the final state.
  * one SSM block's four projections, fed the same inputs: the trunk
    bitwise, the output 1e-5 of the absmax; the block's prefill and decode
    outputs and states: 1e-5 of the absmax (norms, softplus and the conv
    sum in another order).
  * whole-model logits: 5e-2 of the absmax, as ``test_torch_lm.py`` states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import deploy as jdeploy
from repro import plan as jplan
from repro.core import rebranch as jrebranch
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import deploy as tdeploy
from repro_torch import plan as tplan
from repro_torch.core import rebranch as trebranch
from repro_torch.models import ssm as tssm

from test_torch_lm import LOGITS_REL, _close, _trunks, with_cores


@pytest.mark.parametrize("s,chunk,with_h0", [(13, 4, False), (13, 4, True),
                                             (16, 16, True), (7, 8, False)])
def test_ssm_scan_chunked_vs_jax(s, chunk, with_h0):
    # across chunk boundaries (13 = 4 + 4 + 4 + 1), one whole chunk, and
    # a chunk longer than the sequence
    rng = np.random.default_rng(s + chunk)
    b, di, n = 2, 12, 5
    u = rng.normal(size=(b, s, di)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, s, di))) * 0.3).astype(np.float32)
    a = -np.exp(rng.normal(size=(di, n))).astype(np.float32)
    bb = rng.normal(size=(b, s, n)).astype(np.float32)
    cc = rng.normal(size=(b, s, n)).astype(np.float32)
    d_skip = rng.normal(size=(di,)).astype(np.float32)
    h0 = rng.normal(size=(b, di, n)).astype(np.float32) if with_h0 else None
    wy, wh = jssm._ssm_scan_chunked(u, dt, a, bb, cc, d_skip, chunk, h0=h0)
    t = [torch.from_numpy(v) for v in (u, dt, a, bb, cc, d_skip)]
    gy, gh = tssm._ssm_scan_chunked(
        *t, chunk, h0=None if h0 is None else torch.from_numpy(h0))
    _close(gy, wy)
    _close(gh, wh)


@pytest.fixture(scope="module")
def block():
    jcfg = jconfigs.get_smoke("falcon_mamba_7b")
    tcfg = tconfigs.get_smoke("falcon_mamba_7b")
    p = jax.tree.map(np.asarray, jssm.init_ssm_block(jax.random.PRNGKey(4),
                                                     jcfg))
    return jcfg, tcfg, with_cores(p, np.random.default_rng(5))


def test_ssm_block_init_is_the_references_tree(block):
    jcfg, tcfg, p = block
    mine = tssm.init_ssm_block(torch.Generator().manual_seed(0), tcfg)
    assert {k: tuple(v.shape) for k, v in bridge.flatten(mine).items()} == \
        {k: v.shape for k, v in bridge.flatten(p).items()}
    # log rounds in the last bit differently in the two libraries
    _close(mine["A_log"]["sram"]["w"], p["A_log"]["sram"]["w"])
    sp = tssm.softplus(mine["dt_proj"]["sram"]["b"])
    assert bool(((sp >= 1e-3 * 0.999) & (sp <= 0.1 * 1.001)).all())


@pytest.mark.parametrize("name,d_in", [("in_proj", 64), ("x_proj", 128),
                                       ("dt_proj", 4), ("out_proj", 128)])
def test_ssm_projections_vs_jax(block, name, d_in):
    jcfg, tcfg, p = block
    x = np.random.default_rng(6).normal(size=(2, 5, d_in)).astype(np.float32)
    tp = bridge.to_torch(p[name], "cpu")
    for engine in ("int8_native", "pallas_fused"):
        jspec = dataclasses.replace(jcfg.rebranch, trunk_impl=engine)
        tspec = dataclasses.replace(tcfg.rebranch, trunk_impl=engine)
        _close(trebranch.apply_linear(tp, torch.from_numpy(x), tspec),
               jrebranch.apply_linear(p[name], x, jspec))
    # the fused kernel's trunk (its plain version here) is the
    # reference's, bitwise, at this site's geometry
    got, want = _trunks("pallas_fused", p[name]["rom"], x)
    np.testing.assert_array_equal(got, want)


def test_ssm_block_prefill_then_decode_vs_jax(block):
    jcfg, tcfg, p = block
    tp = bridge.to_torch(p, "cpu")
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    jc = jssm.init_ssm_cache(jcfg, 2, jnp.float32)
    tc = tssm.init_ssm_cache(tcfg, 2, torch.float32, "cpu")
    wy, jc = jssm.apply_ssm_block(p, x, jcfg, cache=jc)
    gy, tc = tssm.apply_ssm_block(tp, torch.from_numpy(x), tcfg, cache=tc)
    _close(gy, wy)
    for key in ("conv", "h"):
        _close(tc[key], jc[key])
    for i in range(3):
        xt = rng.normal(size=(2, 1, 64)).astype(np.float32)
        wy, jc = jssm.apply_ssm_block(p, xt, jcfg, cache=jc, decode=True)
        gy, tc = tssm.apply_ssm_block(tp, torch.from_numpy(xt), tcfg,
                                      cache=tc, decode=True)
        _close(gy, wy)
        for key in ("conv", "h"):
            _close(tc[key], jc[key])
    # no cache: the whole-sequence path equals the cached prefill's output
    y0, _ = tssm.apply_ssm_block(tp, torch.from_numpy(x), tcfg)
    y1, _ = tssm.apply_ssm_block(
        tp, torch.from_numpy(x), tcfg,
        cache=tssm.init_ssm_cache(tcfg, 2, torch.float32, "cpu"))
    assert torch.equal(y0, y1)


def test_ssm_decode_rows_are_batch_invariant(block):
    # a decode step gives a row the same bits alone as in a batch
    _, tcfg, p = block
    tp = bridge.to_torch(p, "cpu")
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(5, 1, 64)).astype(np.float32))
    cache = tssm.init_ssm_cache(tcfg, 5, torch.float32, "cpu")
    cache["h"].normal_(generator=torch.Generator().manual_seed(1))
    cache["conv"].normal_(generator=torch.Generator().manual_seed(2))
    solo = bridge.tree_map(cache, lambda t: t[2:3].clone())
    y, _ = tssm.apply_ssm_block(tp, x, tcfg, cache=cache, decode=True)
    y1, _ = tssm.apply_ssm_block(tp, x[2:3], tcfg, cache=solo, decode=True)
    assert torch.equal(y1, y[2:3])
    assert torch.equal(solo["h"], cache["h"][2:3])


@pytest.fixture(scope="module")
def cells():
    jcfg = jconfigs.get_smoke("falcon_mamba_7b")
    tcfg = tconfigs.get_smoke("falcon_mamba_7b")
    jm = jdeploy.compile_model(jcfg, plan=jplan.solve(jcfg, None,
                                                      engine="pallas_fused"))
    tm = tdeploy.compile_model(tcfg, plan=tplan.solve(tcfg, None,
                                                      engine="pallas_fused"))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return jm, tm, with_cores(params, np.random.default_rng(1))


def test_falcon_mamba_forward_prefill_decode_vs_jax(cells):
    jm, tm, params = cells
    tp = bridge.to_torch(params, "cpu")
    mine = tm.init(seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in bridge.flatten(mine).items()} == \
        {k: v.shape for k, v in bridge.flatten(params).items()}
    tok = np.random.default_rng(3).integers(0, 128, size=(2, 11)
                                            ).astype(np.int32)
    _close(tm.forward(tp, {"tokens": torch.from_numpy(tok)}),
           jm.forward(params, {"tokens": tok}), LOGITS_REL)
    jc = jm.init_cache(2, 16, dtype=jnp.float32)
    tc = tm.init_cache(2, 16, dtype=torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in bridge.flatten(tc).items()} == \
        {k: v.shape for k, v in bridge.flatten(jc).items()}
    jl, jc = jm.prefill(params, {"tokens": tok}, jc)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok)}, tc)
    assert tl.dtype == torch.float32
    _close(tl, jl, LOGITS_REL)
    nt = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(3):
        jl, jc = jm.decode_step(params, nt, jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nt), tc)
        _close(tl, jl, LOGITS_REL)
        np.testing.assert_array_equal(tl.numpy()[:, -1].argmax(-1),
                                      np.asarray(jl)[:, -1].argmax(-1))
        nt = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
