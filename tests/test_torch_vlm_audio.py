"""The vlm (Qwen2-VL: M-RoPE, frontend embeddings) and audio (MusicGen:
multi-codebook tokens) branches of the port's transformer, held to the
JAX package on the CPU.

The same numpy inputs and parameters (drawn once by the port on the CPU,
the ReBranch cores replaced by seeded non-zero values, and handed to both
packages as numpy) go through both packages; the parameters and the JAX
batcher's reference tokens are shared through module-level caches and a
module-scoped fixture.

Tolerances and why:
  * M-RoPE is float code (cos/sin evaluated by each framework): 1e-5 of
    the absmax.  On [B, S] positions M-RoPE is ``torch.equal`` to RoPE:
    the three streams are one stream, so each angle is the same product.
  * the codebook embedding sum is bitwise: the same lookups added in the
    reference's order (codebook 0, then 1..Q-1 one at a time), in f32 and
    in bf16, where another order moves bits.
  * one ReBranch linear (the q projection with its bias, the codebook
    head) fed the same input: 1e-5 of the absmax (its trunk is exact; the
    float branch GEMMs sum in another order).
  * whole forwards, prefills and decode steps: 5e-2 of the logits' absmax
    (``tests/test_torch_lm.py``: an ulp moved upstream of a per-row int8
    quantiser can move a code); greedy tokens exactly.
  * served tokens (dense, paged, chunked, speculative) exactly.
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
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.serve import pool as jpool
from repro.serve import registry as jregistry
from repro.serve import scheduler as jscheduler
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import deploy as tdeploy
from repro_torch import plan as tplan
from repro_torch.core import rebranch as trebranch
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.serve import pool as tpool
from repro_torch.serve import registry, server
from repro_torch.serve.scheduler import ContinuousBatcher

from test_torch_lm_serve import with_cores

REL = 1e-5          # float code and one linear: of the absmax
LOGITS_REL = 5e-2   # whole forwards: of the absmax
NEW_ARCHS = ("qwen2_vl_2b", "musicgen_large")
MAX_LEN = 48


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


class Cell:
    """One smoke config in both packages under ``engine``, on JAX-drawn
    parameters with seeded non-zero cores."""

    def __init__(self, arch, engine):
        self.jcfg, self.tcfg = jconfigs.get_smoke(arch), \
            tconfigs.get_smoke(arch)
        self.jm = jdeploy.compile_model(
            self.jcfg, plan=jplan.solve(self.jcfg, None, engine=engine))
        self.tm = tdeploy.compile_model(
            self.tcfg, plan=tplan.solve(self.tcfg, None, engine=engine))
        self.params = _params(arch)
        self.jp = jax.tree.map(jnp.asarray, self.params)
        self.tp = bridge.to_torch(self.params, "cpu")

    def tokens(self, b, s, seed):
        q = self.tcfg.num_codebooks
        rng = np.random.default_rng(seed)
        return rng.integers(0, self.tcfg.vocab_size,
                            size=(b, s, q) if q else (b, s)).astype(np.int32)


_CELLS, _PARAMS = {}, {}


def _params(arch):
    """The port's init of the smoke config on the CPU with seeded non-zero
    cores, as numpy, drawn once per arch (the all-ROM trees do not depend
    on the engine; the JAX init of MusicGen's smoke tree alone takes ~8
    s)."""
    if arch not in _PARAMS:
        model = tdeploy.compile_model(tconfigs.get_smoke(arch))
        _PARAMS[arch] = with_cores(
            bridge.to_numpy(model.init(seed=0, device="cpu")),
            np.random.default_rng(1))
    return _PARAMS[arch]


def cell(arch, engine="pallas_fused"):
    if (arch, engine) not in _CELLS:
        _CELLS[arch, engine] = Cell(arch, engine)
    return _CELLS[arch, engine]


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dh", [128, 16, 24])
@pytest.mark.parametrize("streams", [2, 3])
def test_mrope_matches_jax(dh, streams):
    rng = np.random.default_rng(dh + streams)
    x = rng.normal(size=(2, 7, 3, dh)).astype(np.float32)
    shape = (2, 7, 3) if streams == 3 else (2, 7)
    pos = rng.integers(0, 4000, size=shape).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, True)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             1e6, True)
    _close(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrope_on_text_positions_is_rope_exactly(dtype):
    """[B, S] positions broadcast to the three streams: ``torch.equal`` to
    plain RoPE, so text prompts serve as on a dense model."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 9, 2, 128), generator=g).to(dtype)
    pos = torch.randint(0, 30000, (3, 9), generator=g)
    assert torch.equal(tlayers.apply_rope(x, pos, 1e6, True),
                       tlayers.apply_rope(x, pos, 1e6, False))
    three = pos[..., None].expand(3, 9, 3)
    assert torch.equal(tlayers.apply_rope(x, three, 1e6, True),
                       tlayers.apply_rope(x, pos, 1e6, False))
    # distinct streams do move the height/width sections
    grid = three.clone()
    grid[..., 1] += 1
    out = tlayers.apply_rope(x, grid, 1e6, True)
    n = 64
    t = n - 2 * (n // 4)
    assert torch.equal(out[..., :t], tlayers.apply_rope(x, pos, 1e6)[..., :t])
    assert not torch.equal(out, tlayers.apply_rope(x, pos, 1e6))


# ---------------------------------------------------------------------------
# codebooks, frontend embeddings, one linear
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codebook_embedding_sum_is_bitwise(dtype):
    c = cell("musicgen_large")
    jcfg = dataclasses.replace(c.jcfg, dtype=dtype)
    tcfg = dataclasses.replace(c.tcfg, dtype=dtype)
    toks = c.tokens(3, 5, seed=2)
    want = jtransformer._token_embed(c.jp, jnp.asarray(toks), jcfg)
    got = ttransformer._token_embed(c.tp, torch.from_numpy(toks), tcfg)
    assert got.dtype == tlayers.torch_dtype(dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    if dtype == "bfloat16":
        # the order is the contract: summing the codebooks the other way
        # round moves bits here
        rev = sum(tlayers.apply_embedding(c.tp["embed"],
                                          torch.from_numpy(toks)[..., q],
                                          tcfg) for q in (3, 2, 1, 0))
        assert not torch.equal(rev, got)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_apply_head_and_readout_linear_match_jax(arch):
    """``apply_head``: [.., Q, V] through the codebook head (MusicGen), the
    tied table (Qwen2-VL); and the q projection with its bias."""
    c = cell(arch)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, c.tcfg.d_model)).astype(np.float32)
    want = c.jm.apply_head(c.jp, jnp.asarray(x))
    got = c.tm.apply_head(c.tp, torch.from_numpy(x))
    q = c.tcfg.num_codebooks
    assert tuple(got.shape) == ((2, 5, q, c.tcfg.vocab_size) if q
                                else (2, 5, c.tcfg.vocab_size))
    _close(got.numpy(), want)
    layer0 = jax.tree.map(lambda a: a[0], c.params["layers"])
    qp = layer0["attn"]["q"]
    assert ("b" in qp["sram"]) == (arch == "qwen2_vl_2b")
    from repro.core import rebranch as jrebranch
    spec_j = c.jm.layer_spec("blocks.attn")
    spec_t = c.tm.layer_spec("blocks.attn")
    want = jrebranch.apply_linear(jax.tree.map(jnp.asarray, qp),
                                  jnp.asarray(x), spec_j)
    got = trebranch.apply_linear(bridge.to_torch(qp, "cpu"),
                                 torch.from_numpy(x), spec_t)
    _close(got.numpy(), want)


def test_embeds_prefill_with_grid_positions_matches_jax():
    """Frontend embeddings [B, S, d] plus tokens, three distinct position
    streams (an image grid's temporal / height / width), into a cache; then
    decode steps from text positions."""
    c = cell("qwen2_vl_2b")
    rng = np.random.default_rng(4)
    b, s = 2, 12
    embeds = rng.normal(size=(b, s, c.tcfg.d_model)).astype(np.float32)
    toks = c.tokens(b, s, seed=5)
    hw = np.stack(np.meshgrid(np.arange(3), np.arange(4), indexing="ij"),
                  -1).reshape(s, 2)
    pos = np.concatenate([np.zeros((s, 1)), hw], -1).astype(np.int32)
    pos = np.broadcast_to(pos, (b, s, 3)).copy()
    for batch in ({"embeds": embeds, "positions": pos},
                  {"embeds": embeds, "tokens": toks, "positions": pos}):
        jc = c.jm.init_cache(b, 16, dtype=jnp.float32)
        tc = c.tm.init_cache(b, 16, dtype=torch.float32, device="cpu")
        jl, jc = c.jm.prefill(c.jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, jc)
        tl, tc = c.tm.prefill(c.tp, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, tc)
        _close(tl.numpy(), jl, LOGITS_REL)
        nt = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
        for _ in range(2):
            jl, jc = c.jm.decode_step(c.jp, jnp.asarray(nt), jc)
            tl, tc = c.tm.decode_step(c.tp, torch.from_numpy(nt), tc)
            _close(tl.numpy(), jl, LOGITS_REL)
            nt = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
    # embeds are cast to the activation dtype before the sum
    bcfg = dataclasses.replace(c.tcfg, dtype="bfloat16")
    x = ttransformer._embed_inputs(c.tp, {"embeds": torch.from_numpy(
        embeds)}, bcfg)
    assert x.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# forward, prefill and decode on both smoke configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["int8_native", "pallas_fused"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_prefill_decode_match_jax(arch, engine):
    c = cell(arch, engine)
    toks = c.tokens(2, 10, seed=6)
    want = c.jm.forward(c.jp, {"tokens": jnp.asarray(toks)})
    got = c.tm.forward(c.tp, {"tokens": torch.from_numpy(toks)})
    _close(got.numpy(), want, LOGITS_REL)
    jc = c.jm.init_cache(2, 16, dtype=jnp.float32)
    tc = c.tm.init_cache(2, 16, dtype=torch.float32, device="cpu")
    jl, jc = c.jm.prefill(c.jp, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = c.tm.prefill(c.tp, {"tokens": torch.from_numpy(toks)}, tc)
    _close(tl.numpy(), jl, LOGITS_REL)
    _close(tl.numpy(), got.numpy()[:, -1:], LOGITS_REL)
    for _ in range(3):
        nt = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(tl.numpy()[:, -1].argmax(-1),
                                      nt[:, 0])
        jl, jc = c.jm.decode_step(c.jp, jnp.asarray(nt), jc)
        tl, tc = c.tm.decode_step(c.tp, torch.from_numpy(nt), tc)
        _close(tl.numpy(), jl, LOGITS_REL)
    for a, b in zip(bridge.flatten(tc).values(),
                    bridge.flatten(jax.tree.map(np.asarray, jc)).values()):
        _close(a, b, LOGITS_REL)


def test_musicgen_prefill_and_serve_steps_match_jax():
    """The model-level serve path of a multi-codebook config:
    ``make_prefill_step`` then greedy ``make_serve_step`` tokens [B, 1, Q],
    equal to the JAX package's steps."""
    c = cell("musicgen_large")
    toks = c.tokens(3, 8, seed=7)
    jl, jc = jsteps.make_prefill_step(c.jcfg, 3, 16, c.jm)(
        c.jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tsteps.make_prefill_step(c.tcfg, 3, 16, c.tm, device="cpu")(
        c.tp, {"tokens": torch.from_numpy(toks)})
    assert tuple(tl.shape) == (3, 1, 4, c.tcfg.vocab_size)
    _close(tl.float().numpy(), np.asarray(jl, np.float32), LOGITS_REL)
    nt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)      # [B, 1, Q]
    jstep, tstep = jsteps.make_serve_step(c.jcfg, c.jm), \
        tsteps.make_serve_step(c.tcfg, c.tm)
    for _ in range(4):
        jt, jc = jstep(c.jp, {"tokens": jnp.asarray(nt)}, jc)
        tt, tc = tstep(c.tp, {"tokens": torch.from_numpy(nt)}, tc)
        assert tt.dtype == torch.int32 and tuple(tt.shape) == (3, 1, 4)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        nt = np.asarray(jt)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cache_geometry_errors_read_the_first_two_dims(arch):
    """A [B, S, Q] or [B, S, d] input meets the same geometry errors as
    [B, S]; the texts are the reference's."""
    c = cell(arch)
    q, d = c.tcfg.num_codebooks, c.tcfg.d_model

    def inputs(b, s):
        return [("tokens", np.zeros((b, s, q) if q else (b, s), np.int32)),
                ("embeds", np.zeros((b, s, d), np.float32))]

    def both(call_j, call_t):
        with pytest.raises(ValueError) as ej:
            call_j()
        with pytest.raises(ValueError) as et:
            call_t()
        assert str(et.value) == str(ej.value)

    jc = c.jm.init_cache(2, 8, dtype=jnp.float32)
    tc = c.tm.init_cache(2, 8, dtype=torch.float32, device="cpu")
    for key, a in inputs(3, 4) + inputs(2, 9):
        both(lambda: c.jm.prefill(c.jp, {key: jnp.asarray(a)}, jc),
             lambda: c.tm.prefill(c.tp, {key: torch.from_numpy(a)}, tc))
    tok = inputs(2, 2)[0][1]
    both(lambda: c.jm.decode_step(c.jp, jnp.asarray(tok), jc),
         lambda: c.tm.decode_step(c.tp, torch.from_numpy(tok), tc))
    tok = inputs(3, 1)[0][1]
    both(lambda: c.jm.decode_step(c.jp, jnp.asarray(tok), jc),
         lambda: c.tm.decode_step(c.tp, torch.from_numpy(tok), tc))


# ---------------------------------------------------------------------------
# configs, cells, input specs, site trees, plans, sweeps
# ---------------------------------------------------------------------------

def _config_dict(cfg):
    """``dataclasses.asdict`` with the spec's param dtype by name (a
    ``torch.dtype`` in the port, a numpy scalar type in the reference)."""
    out = dataclasses.asdict(cfg)
    pd = out["rebranch"]["param_dtype"]
    out["rebranch"]["param_dtype"] = str(getattr(pd, "__name__", pd)
                                         ).replace("torch.", "")
    return out


def test_configs_cells_and_arch_lists_equal_the_references():
    assert tconfigs.ALL_ARCHS == jconfigs.ALL_ARCHS
    assert tconfigs.PORTED_ARCHS == jconfigs.ALL_ARCHS
    assert tconfigs.SHAPES == jconfigs.SHAPES
    assert tconfigs.VLM_ARCHS == ["qwen2_vl_2b"]
    assert tconfigs.AUDIO_ARCHS == ["musicgen_large"]
    families = (tconfigs.DENSE_ARCHS + tconfigs.VLM_ARCHS
                + tconfigs.AUDIO_ARCHS + tconfigs.MOE_ARCHS
                + tconfigs.SSM_ARCHS + tconfigs.HYBRID_ARCHS)
    assert sorted(families) == sorted(jconfigs.ALL_ARCHS)
    for arch in jconfigs.ALL_ARCHS:
        assert tconfigs.cells(arch) == jconfigs.cells(arch), arch
        for get in ("get", "get_smoke"):
            t = getattr(tconfigs, get)(arch)
            j = getattr(jconfigs, get)(arch)
            assert _config_dict(t) == _config_dict(j), (arch, get)


def test_input_specs_equal_the_references():
    for arch in jconfigs.ALL_ARCHS:
        for shape, (seq, gb, kind) in jconfigs.SHAPES.items():
            want = jsteps.input_specs(jconfigs.get(arch), seq, gb, kind)
            got = tsteps.input_specs(tconfigs.get(arch), seq, gb, kind)
            assert list(got) == list(want), (arch, shape)
            for k, v in got.items():
                assert v.device.type == "meta"
                assert tuple(v.shape) == want[k].shape, (arch, shape, k)
                assert str(v.dtype).replace("torch.", "") == \
                    str(want[k].dtype), (arch, shape, k)
    with pytest.raises(ValueError):
        tsteps.input_specs(tconfigs.get("gemma_2b"), 8, 2, "verify")


def _strip(rec):
    out = {k: v for k, v in rec.items() if k != "plan"}
    out["entries"] = [(a, s.enabled, s.trunk_impl)
                      for a, s in rec["plan"].entries]
    return out


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_site_trees_plans_and_sweeps_equal_the_references(arch, full):
    jcfg = (jconfigs.get if full else jconfigs.get_smoke)(arch)
    tcfg = (tconfigs.get if full else tconfigs.get_smoke)(arch)

    def sites(tree):
        return [(s.name, s.kind, s.weights, s.macs, s.count, s.shape,
                 s.members, s.branch_members) for s in tree]

    got = sites(tplan.site_tree(tcfg))
    assert got == sites(jplan.site_tree(jcfg))
    assert ("codebook_head" in [s[0] for s in got]) == \
        (arch == "musicgen_large")
    jp_, tp_ = jplan.solve(jcfg, None), tplan.solve(tcfg, None)
    assert [(a, s.enabled) for a, s in tp_.entries] == \
        [(a, s.enabled) for a, s in jp_.entries]
    assert dataclasses.asdict(tp_.stats(tcfg)) == \
        dataclasses.asdict(jp_.stats(jcfg))
    for kw in ({}, {"engine": "pallas_fused", "reload_factor": 3.0}):
        assert [_strip(r) for r in tplan.sweep(tcfg, 5, **kw)] == \
            [_strip(r) for r in jplan.sweep(jcfg, 5, **kw)]

    def shapes(tree):
        return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in bridge.flatten(tree).items()}

    gen = torch.Generator()
    assert shapes(bridge.abstract(tapi.init, gen, tcfg)) == shapes(
        jax.eval_shape(lambda: japi.init(jax.random.PRNGKey(0), jcfg)))


# ---------------------------------------------------------------------------
# serving: Qwen2-VL's text prompts as a dense model; MusicGen refused
# ---------------------------------------------------------------------------

QWEN_ID = "qwen2-vl-2b-smoke"
GENS = [5, 7, 3, 6, 4]


@pytest.fixture(scope="module")
def qwen():
    """(port model, numpy params, prompts, plain greedy tokens from the
    JAX batcher over a dense pool)."""
    jmodel, _ = jregistry.compile_entry(QWEN_ID)
    model, _ = registry.compile_entry(QWEN_ID)
    params = _params("qwen2_vl_2b")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 128, size=n) for n in (3, 40, 9, 17, 35)]
    jp = jax.tree.map(jnp.asarray, params)
    b = jscheduler.ContinuousBatcher(
        jmodel, jp, jpool.SlotPool(jmodel, 3, MAX_LEN, dtype=jnp.float32),
        prefill_chunk=0)
    reqs = [b.submit(p, g) for p, g in zip(prompts, GENS)]
    b.drain(max_steps=500)
    return model, params, prompts, [r.tokens for r in reqs]


def test_registry_has_both_smoke_ids():
    for arch in NEW_ARCHS:
        mid = arch.replace("_", "-") + "-smoke"
        assert mid in registry.registered_ids()
        assert mid in jregistry.registered_ids()
        assert registry.compile_entry(mid)[0].cfg.name == arch + "_smoke"


@pytest.mark.parametrize("mode", ["dense", "paged", "chunked", "spec",
                                  "spec-paged"])
def test_qwen2_vl_serves_text_prompts_as_the_jax_batcher(qwen, mode):
    """Dense and paged pools, 8-token prefill chunks, and ``spec_k=3``
    (the branch drafter) over both pools: every request's tokens equal the
    JAX batcher's plain greedy tokens, and no row or block is left."""
    model, params, prompts, want = qwen
    paged = mode in ("paged", "chunked", "spec-paged")
    kw = {"chunked": dict(prefill_chunk=8)}.get(
        mode, dict(prefill_chunk=0))
    if mode.startswith("spec"):
        kw["spec_k"] = 3
    pool = (tpool.PagedPool(model, 3, 18, 8, MAX_LEN, device="cpu")
            if paged else tpool.SlotPool(model, 3, MAX_LEN, device="cpu"))
    b = ContinuousBatcher(model, bridge.to_torch(params, "cpu"), pool, **kw)
    reqs = [b.submit(p, g) for p, g in zip(prompts, GENS)]
    b.drain(max_steps=500)
    assert [r.tokens for r in reqs] == want
    assert pool.occupancy == 0
    if paged:
        assert pool.blocks_in_use == 0 == pool.blocks_reserved
    if mode.startswith("spec"):
        assert b.spec_rounds == b.step_count > 0


def test_qwen2_vl_server_load_serves():
    srv = server.load(QWEN_ID, device="cpu", n_slots=2, max_len=32)
    assert type(srv.pool) is tpool.PagedPool
    req = srv.submit([3, 1, 4, 1, 5], 4)
    srv.drain(max_steps=20)
    assert len(req.tokens) == 4 and all(0 <= t < 128 for t in req.tokens)


def test_lmserver_refuses_multi_codebook_configs():
    """The reference builds the server and fails at the first decode step
    (a TypeError); the port refuses at build time and names the
    model-level route."""
    model, _ = registry.compile_entry("musicgen-large-smoke")
    params = model.init(seed=0, device="cpu")
    with pytest.raises(ValueError, match="make_serve_step"):
        server.LMServer(model, params, n_slots=2, max_len=32)
    with pytest.raises(ValueError, match="4 codebooks"):
        server.load("musicgen-large-smoke", params=params, n_slots=2,
                    max_len=32)
