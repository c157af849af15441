"""Chunked prefill and the async front doors in the port on the CPU, held
to their own invariants and to the JAX package on the same parameters
(``gemma-2b-smoke``, ``max_len`` 48, JAX-drawn parameters with seeded
non-zero cores).

Invariants (``docs/ARCHITECTURE.md``, "Serving invariants"): a prompt
prefilled in chunks adopts a row bitwise equal to a whole-prompt solo
prefill (the prefill attention runs its queries on fixed 16-query slices,
``layers._prefill_attention``, so a query's bits do not depend on how many
others share the call); in-flight decodes advance on every tick in which
a chunk runs; a swap barrier waits for an in-flight chunked prefill.
Logits are held to the JAX package's within 5e-2 of their absmax, tokens
exactly.

The JAX package is imported inside the fixtures, so the ``gpu`` test at
the end runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_chunked_prefill.py
"""

import asyncio
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.core import rebranch
from repro_torch.models import api
from repro_torch.serve import pool as tpool
from repro_torch.serve import registry, server
from repro_torch.serve.scheduler import ContinuousBatcher

MODEL_ID = "gemma-2b-smoke"
MAX_LEN = 48
LOGIT_RTOL = 5e-2            # of the reference logits' absmax


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules (imported here, not at module level)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.serve import pool as jpool
    from repro.serve import registry as jregistry
    from repro.serve import scheduler as jscheduler
    return types.SimpleNamespace(jax=jax, jnp=jnp, pool=jpool,
                                 registry=jregistry, scheduler=jscheduler)


@pytest.fixture(scope="module")
def cell(J):
    """(JAX model, port model, numpy params): the JAX init with seeded
    non-zero cores."""
    jmodel, _ = J.registry.compile_entry(MODEL_ID)
    params = J.jax.tree.map(np.asarray, jmodel.init(J.jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)

    def cores(tree):
        if isinstance(tree, dict):
            out = {k: cores(v) for k, v in tree.items()}
            if "core" in out.get("sram", {}):
                out["sram"]["core"] = (rng.normal(
                    size=out["sram"]["core"].shape) * 0.3).astype(np.float32)
            return out
        return tree

    return jmodel, registry.compile_entry(MODEL_ID)[0], cores(params)


def _prompts(n, seed=0, lo=9, hi=30):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=int(s))
            for s in rng.integers(lo, hi, size=n)]


def _prefill(model, params, prompt, chunk):
    """A solo cache prefilled in chunks of ``chunk`` (0: whole)."""
    cache = model.init_cache(1, MAX_LEN, dtype=torch.float32, device="cpu")
    step = chunk or prompt.size
    with torch.no_grad():
        for lo in range(0, prompt.size, step):
            logits, cache = model.prefill(
                params, {"tokens": torch.as_tensor(prompt[None,
                                                          lo:lo + step])},
                cache)
    return logits, cache


def _solo(model, params, prompt, n_new):
    logits, cache = _prefill(model, params, prompt, 0)
    out = [int(logits[0, -1].argmax())]
    with torch.no_grad():
        for _ in range(n_new - 1):
            logits, cache = model.decode_step(
                params, torch.tensor([[out[-1]]]), cache)
            out.append(int(logits[0, -1].argmax()))
    return out


@pytest.mark.parametrize("chunk", [1, 4, 5, 16, 32])
def test_chunked_rows_equal_whole_prompt_rows(cell, chunk):
    """Every cache leaf and the last logits of a chunked solo prefill equal
    the whole-prompt prefill's, bit for bit, at chunk widths below, at and
    above the 16-query slice."""
    _, model, params = cell
    tp = bridge.to_torch(params, "cpu")
    for prompt in _prompts(3, seed=chunk, lo=17, hi=47):
        want_logits, want = _prefill(model, tp, prompt, 0)
        got_logits, got = _prefill(model, tp, prompt, chunk)
        assert torch.equal(got_logits, want_logits)
        for key in ("k", "v", "length"):
            assert torch.equal(got["layers"][key], want["layers"][key]), key


def test_chunk_logits_match_jax(J, cell):
    """A prompt prefilled in chunks of 4 in both packages: the last
    logits within 5e-2 of the reference's absmax."""
    jmodel, model, params = cell
    prompt = _prompts(1, seed=3)[0]
    got, _ = _prefill(model, bridge.to_torch(params, "cpu"), prompt, 4)
    jp = J.jax.tree.map(J.jnp.asarray, params)
    cache = jmodel.init_cache(1, MAX_LEN, dtype=J.jnp.float32)
    for lo in range(0, prompt.size, 4):
        want, cache = jmodel.prefill(jp, {"tokens": prompt[None, lo:lo + 4]},
                                     cache)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())


@pytest.mark.parametrize("paged", [False, True])
def test_chunked_tokens_equal_solo_and_jax(J, cell, paged):
    """``prefill_chunk=4``: every request's tokens equal its whole-prompt
    solo decode and the JAX batcher's; each adopted row equals the
    whole-prompt prefill's row, bit for bit."""
    jmodel, model, params = cell
    tp = bridge.to_torch(params, "cpu")
    prompts = _prompts(5, seed=4)
    pool = (tpool.PagedPool(model, 3, 18, 8, MAX_LEN, device="cpu")
            if paged else tpool.SlotPool(model, 3, MAX_LEN, device="cpu"))
    b = ContinuousBatcher(model, tp, pool, prefill_chunk=4)
    adopted, adopt = {}, pool.adopt

    def recording(slot, solo):
        adopted[len(adopted)] = bridge.tree_map(solo, torch.clone)
        adopt(slot, solo)

    pool.adopt = recording
    reqs = [b.submit(p, 6) for p in prompts]
    b.drain(max_steps=200)
    for i, (req, prompt) in enumerate(zip(reqs, prompts)):
        assert req.tokens == _solo(model, tp, prompt, 6)
        _, want = _prefill(model, tp, prompt, 0)
        for key in ("k", "v", "length"):
            assert torch.equal(adopted[i]["layers"][key],
                               want["layers"][key]), (i, key)
    jp = J.jax.tree.map(J.jnp.asarray, params)
    jpl = (J.pool.PagedPool(jmodel, 3, 18, 8, MAX_LEN, dtype=J.jnp.float32)
           if paged else J.pool.SlotPool(jmodel, 3, MAX_LEN,
                                         dtype=J.jnp.float32))
    jb = J.scheduler.ContinuousBatcher(jmodel, jp, jpl, prefill_chunk=4)
    jreqs = [jb.submit(p, 6) for p in prompts]
    jb.drain(max_steps=200)
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    if paged:
        assert pool.blocks_in_use == 0 == pool.blocks_reserved


def test_chunks_interleave_with_decode(cell):
    """Admitting a long prompt never stalls in-flight decodes: with chunk
    2, an active request gains a token on every tick the new prompt's
    chunks run (the reference's test)."""
    _, model, params = cell
    tp = bridge.to_torch(params, "cpu")
    prompts = _prompts(2, seed=9, lo=7, hi=8)
    b = ContinuousBatcher(model, tp,
                          tpool.SlotPool(model, 2, MAX_LEN, device="cpu"),
                          prefill_chunk=2)
    r1 = b.submit(prompts[0], 12)
    ticks = 0
    while r1.admit_step < 0:                  # r1's own chunks run
        b.step()
        ticks += 1
        assert ticks < 20
    assert ticks == 4                         # 7 tokens in chunks of 2
    r2 = b.submit(prompts[1], 4)
    grew = []
    while b.prefilling or r2.admit_step < 0:
        before = len(r1.tokens)
        b.step()
        grew.append(len(r1.tokens) > before)
        ticks += 1
        assert ticks < 100
    assert len(grew) == 4 and all(grew), "decode stalled during a chunk"
    b.drain(max_steps=100)
    assert r1.tokens == _solo(model, tp, prompts[0], 12)
    assert r2.tokens == _solo(model, tp, prompts[1], 4)


def test_swap_barrier_waits_for_an_inflight_chunk(cell):
    """A swap queued behind a chunk-prefilling request applies only after
    that request's prefill and decode finished under the old branch."""
    _, model, params = cell
    pA = bridge.to_torch(params, "cpu")
    brB = bridge.tree_map(rebranch.partition(pA)[0],
                          lambda t: t + 0.02 if t.is_floating_point() else t)
    b = ContinuousBatcher(model, pA,
                          tpool.SlotPool(model, 2, MAX_LEN, device="cpu"),
                          scenario="a", prefill_chunk=2)
    prompt = _prompts(1, seed=13)[0]
    r1 = b.submit(prompt, 4, scenario="a")
    b.step()                                  # the first chunk only
    assert b.prefilling and not b.idle and b.active == 0
    b.swap("b", brB)
    b.step()
    assert b.scenario == "a"                  # barrier held
    b.drain(max_steps=100)
    assert b.scenario == "b" and b.swap_count == 1
    assert r1.tokens == _solo(model, pA, prompt, 4)


def test_prefill_chunk_defaults_and_refusals(cell):
    """``None`` -> 32 where the family can chunk; a family whose prefill
    rebuilds recurrent state cannot, and says so (the reference's text)."""
    _, model, params = cell
    pool = tpool.SlotPool(model, 1, MAX_LEN, device="cpu")
    assert api.supports_chunked_prefill(model.cfg)
    assert ContinuousBatcher(model, {}, pool).prefill_chunk == 32
    assert ContinuousBatcher(model, {}, pool, prefill_chunk=0
                             ).prefill_chunk == 0
    srv = server.load(MODEL_ID, params=bridge.to_torch(params, "cpu"),
                      n_slots=2, max_len=MAX_LEN, prefill_chunk=8)
    assert srv.batcher.prefill_chunk == 8
    ssm = types.SimpleNamespace(cfg=dataclasses.replace(model.cfg,
                                                        family="ssm"))
    assert not api.supports_chunked_prefill(ssm.cfg)
    assert ContinuousBatcher(ssm, {}, pool).prefill_chunk == 0
    with pytest.raises(ValueError, match="cannot chunk"):
        ContinuousBatcher(ssm, {}, pool, prefill_chunk=8)


# ---------------------------------------------------------------------------
# the async front doors
# ---------------------------------------------------------------------------

def test_lm_generate_batches_concurrent_callers(cell):
    """Concurrent ``generate`` calls share one batch: the decode steps are
    those of one batched run, not one per caller, and each caller gets its
    solo tokens."""
    _, model, params = cell
    tp = bridge.to_torch(params, "cpu")
    srv = server.load(MODEL_ID, params=tp, n_slots=3, max_len=MAX_LEN,
                      spec_k=2)
    prompts = _prompts(3, seed=21)
    rows = []
    decode = srv.model.verify_step

    def recording(p, tok, cache):
        rows.append(len(srv.batcher._active))
        return decode(p, tok, cache)

    srv.model.verify_step = recording

    async def main():
        return await asyncio.gather(*(srv.generate(p, 5) for p in prompts))

    try:
        outs = asyncio.run(main())
    finally:
        del srv.model.verify_step
    assert outs == [_solo(model, tp, p, 5) for p in prompts]
    assert max(rows) == 3 and srv.batcher.idle


def test_cnn_generate_is_submit(cell):
    srv = server.load("darknet19-32", device="cpu", n_slots=2)
    img = np.random.default_rng(0).normal(size=(32, 32, 3)).astype(np.float32)
    got = asyncio.run(srv.generate(img))
    np.testing.assert_array_equal(got, srv.submit(img[None])[0])
    np.testing.assert_array_equal(asyncio.run(srv.generate(img[None])), got)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_chunked_prefill_equals_whole_prompt_on_the_card():
    """Gemma-2B smoke under ``pallas_fused`` (kernel 3 behind every ROM
    linear) on the card: a solo prefill in chunks of 32, 16 and 5 equals
    the whole-prompt prefill in every cache leaf and the last logits, bit
    for bit, at bf16 and f32 activations; served with ``prefill_chunk=32``
    the tokens equal the whole-prompt solo decode; one kernel-3 launch
    per linear per chunk."""
    from repro_torch import configs
    from repro_torch.kernels import rebranch_matmul as rm
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: kernel 3 runs only on the card")
    dev = torch.device("cuda")
    for dtype in ("float32", "bfloat16"):
        model_id = f"gemma-2b-smoke-chunk-{dtype}-test"
        registry.register(registry.ModelEntry(
            model_id=model_id, config=lambda d=dtype: dataclasses.replace(
                configs.get_smoke("gemma_2b"), dtype=d),
            engine="pallas_fused"), override=True)
        model, _ = registry.compile_entry(model_id)
        params = model.init(seed=0, device=dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        for key, t in bridge.flatten(params).items():
            if key.endswith("['core']"):
                t.copy_(torch.randn(t.shape, generator=gen, device=dev)
                        * 0.05)
        max_len = 128
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, 512, size=n) for n in (40, 77, 100)]
        per_pass = 7 * model.cfg.num_layers

        def prefill(prompt, chunk):
            cache = model.init_cache(1, max_len, dtype=torch.float32,
                                     device=dev)
            step = chunk or prompt.size
            with torch.no_grad():
                for lo in range(0, prompt.size, step):
                    rm.launches = 0
                    logits, cache = model.prefill(params, {
                        "tokens": torch.as_tensor(prompt[None, lo:lo + step],
                                                  device=dev)}, cache)
                    assert rm.launches == per_pass
            return logits, cache

        solo = []
        for prompt in prompts:
            want_logits, want = prefill(prompt, 0)
            for chunk in (32, 16, 5):
                got_logits, got = prefill(prompt, chunk)
                assert torch.equal(got_logits, want_logits), (dtype, chunk)
                for key in ("k", "v", "length"):
                    assert torch.equal(got["layers"][key],
                                       want["layers"][key]), (dtype, key)
            toks, cache = [int(want_logits[0, -1].argmax())], want
            with torch.no_grad():
                for _ in range(5):
                    logits, cache = model.decode_step(
                        params, torch.tensor([[toks[-1]]], device=dev), cache)
                    toks.append(int(logits[0, -1].argmax()))
            solo.append(toks)
        srv = server.load(model_id, params=params, n_slots=2,
                          max_len=max_len, prefill_chunk=32)
        reqs = [srv.submit(p, 6) for p in prompts]
        srv.drain()
        assert [r.tokens for r in reqs] == solo
