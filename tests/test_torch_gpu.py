"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each test decides inside itself whether there is a card and skips without
one.  The unscaled trunk is held with ``torch.equal`` in every CiM mode:
the k-block's macro math is computed as the plain version computes it
(exact integer dots; in the ADC modes the same IEEE division, bias, round
and clamp per subarray, or per binary count the table of the same formula,
added in the same order), and
``part * scale`` and ``acc + part`` round once each, in ascending k-block
order, on both sides.  The trunk-conv kernel reads the conv's NHWC input
itself and is held against the plain version on the patch matrix, which
the card path never builds.  The CiM matmul kernel is held with ``torch.equal``
as well (one f32 add per block), and the fused ReBranch matmul's trunk
too; its f32 sketch t1 sums within a k-block in another order than
cuBLAS, so it is held to 1e-5 of its absmax.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import cim
from repro_torch.kernels import cim_matmul as cm
from repro_torch.kernels import rebranch_conv as rc
from repro_torch.kernels import rebranch_matmul as rm

# (N, H, W, C_in, k, stride, padding, C_out): C_in = 3 (scalar loads, R =
# 27), ResNet's 7x7x3 stem at stride 2, a stride-2 conv whose R = 576 is a
# full block and a ragged one, a VALID conv, C_in = 130 (not a multiple of
# 4, R = 1170 in three blocks), half-tap blocks at C_in = 1024 (R = 9216),
# a 1x1 conv whose grid is split over k-blocks, M <= 16 (16-row tiles),
# a 1x1 stride-2 VALID conv of 24 channels (R <= 32: four rows per warp
# pass), and C_out of 4 column tiles with and without a split (64-row
# tiles in pairs, each block staging half the rows for both; 2 column tiles
# above pair too); M and C_out off the kernel's 64-wide tiles
CONV_SHAPES = [(2, 23, 25, 3, 3, 1, "SAME", 32),
               (1, 32, 30, 3, 7, 2, "SAME", 64),
               (1, 17, 19, 64, 3, 2, "SAME", 100),
               (2, 11, 13, 20, 3, 1, "VALID", 17),
               (3, 9, 9, 130, 3, 2, "VALID", 9),
               (1, 7, 9, 1024, 3, 1, "SAME", 70),
               (8, 13, 13, 512, 1, 1, "SAME", 512),
               (1, 4, 3, 16, 3, 1, "SAME", 8),
               (2, 9, 10, 24, 1, 2, "VALID", 40),
               (1, 9, 11, 64, 3, 1, "SAME", 256),
               (4, 40, 40, 16, 3, 1, "SAME", 200)]
MODES = ("ideal", "per_subarray", "bitserial")


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


def _conv_inputs(n, h, w, c_in, k, c_out, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, h, w, c_in), generator=gen)
    x[0, : h // 2, : w // 2] = 0.0               # all-zero patch rows
    x[-1, -1, -1] *= 1e3                         # one pixel dominates its rows
    w_q = torch.randint(-127, 128, (k, k, c_in, c_out), generator=gen,
                        dtype=torch.int8)
    return x.to(dev), w_q.to(dev)


def _plain_trunk(x, w_q, stride, padding, cfg):
    kh, kw, _, c_out = w_q.shape
    p, _ = rc.patch_matrix(x, kh, kw, stride, padding)
    return rc.trunk_patch_dot_plain(p, w_q.reshape(-1, c_out), cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,h,w,c_in,k,stride,padding,c_out", CONV_SHAPES)
def test_kernel_equals_plain_version(n, h, w, c_in, k, stride, padding,
                                     c_out, mode):
    """The NHWC kernel is torch.equal to the plain version on the patch
    matrix, on the card and on the CPU."""
    dev = _card()
    cfg = cim.CiMConfig(mode=mode)
    x, w_q = _conv_inputs(n, h, w, c_in, k, c_out, dev, seed=h * w + c_in)
    before = rc.launches
    got = rc.trunk_conv_dot(x, w_q, stride, padding, cfg)
    torch.cuda.synchronize()
    assert rc.launches == before + 1
    assert torch.equal(got, _plain_trunk(x, w_q, stride, padding, cfg))
    assert torch.equal(got.cpu(), _plain_trunk(x.cpu(), w_q.cpu(), stride,
                                               padding, cfg))


@pytest.mark.gpu
def test_conv_builds_no_patch_matrix(monkeypatch):
    """On a CUDA tensor trunk_conv and rebranch_conv run with patch_matrix
    made to raise, and allocate less than the patch matrix's bytes."""
    dev = _card()
    x, w_q = _conv_inputs(2, 40, 40, 256, 3, 64, dev, seed=7)
    gen = torch.Generator().manual_seed(8)
    w_scale = (torch.rand((1, 1, 1, 64), generator=gen) * 1e-2).to(dev)
    c = (torch.randn((1, 1, 256, 64), generator=gen) / 16).to(dev)
    core = (torch.randn((3, 3, 64, 16), generator=gen) * 0.05).to(dev)
    u = (torch.randn((1, 1, 16, 64), generator=gen) / 4).to(dev)
    want_t = rc.trunk_conv(x, w_q, w_scale)
    want_f = rc.rebranch_conv(x, w_q, w_scale, c, core, u)
    p_bytes = 4 * 2 * 40 * 40 * 9 * 256

    def refuse(*args, **kwargs):
        raise AssertionError("the card path built the patch matrix")

    monkeypatch.setattr(rc, "patch_matrix", refuse)
    for fn, want in ((lambda: rc.trunk_conv(x, w_q, w_scale), want_t),
                     (lambda: rc.rebranch_conv(x, w_q, w_scale, c, core, u),
                      want_f)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = fn()
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - base < p_bytes
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_does_not_take():
    dev = _card()
    x, w_q = _conv_inputs(1, 9, 9, 20, 3, 10, dev, seed=0)
    with pytest.raises(ValueError, match="rows_per_subarray"):
        rc.trunk_conv_dot(x, w_q, cfg=cim.CiMConfig(mode="per_subarray",
                                                    rows_per_subarray=64))
    with pytest.raises(ValueError):
        rc.trunk_conv_dot(x.double(), w_q)
    with pytest.raises(ValueError):
        rc.trunk_conv_dot(x.bfloat16(), w_q)
    with pytest.raises(ValueError):
        rc.trunk_conv_dot(x[:, :, ::2], w_q)               # not contiguous
    with pytest.raises(ValueError):
        rc.trunk_conv_dot(x, w_q[:, :, :10])               # C_in 10 != 20
    with pytest.raises(ValueError):
        rc.trunk_conv_dot(x, w_q.float())
    with pytest.raises(ValueError):
        rc.trunk_conv_dot(x, w_q.cpu())


# (M, K, N): one ragged block, whole blocks, ragged tails, the four
# Gemma-2B geometries at decode width, `down` at both tile heights (M = 16
# and 17) and at prefill width (split and unsplit grids), and cim_conv's
# unaligned patch widths K = 27 and 45
LM_SHAPES = [(2, 64, 48), (8, 300, 256), (37, 1280, 48), (8, 2048, 2048),
             (8, 2048, 256), (8, 2048, 16384), (8, 16384, 2048),
             (130, 1024, 100), (16, 16384, 2048), (17, 16384, 2048),
             (128, 16384, 2048), (1000, 27, 32), (77, 45, 20)]


def _int8_inputs(m, k, n, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    return x.to(dev), w.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,k,n", LM_SHAPES)
def test_cim_matmul_kernel_equals_plain_version(m, k, n, mode):
    dev = _card()
    cfg = cim.CiMConfig(mode=mode)
    x, w = _int8_inputs(m, k, n, dev, seed=m + k + n)
    x[0] = 127                                   # row sums far above 2**24
    w[:, 0] = 127
    x[-1, ::3] = -128                            # -128: a magnitude of 128
    w[::5, -1] = -128                            # -128: no magnitude plane
    before = cm.launches
    got = cm.cim_matmul(x, w, cfg)
    torch.cuda.synchronize()
    assert cm.launches == before + 1
    assert torch.equal(got, cm.cim_matmul_plain(x, w, cfg))
    assert torch.equal(got.cpu(), cm.cim_matmul_plain(x.cpu(), w.cpu(), cfg))
    # rows are independent of the batch around them
    assert torch.equal(cm.cim_matmul(x[:1].contiguous(), w, cfg), got[:1])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,k,n", LM_SHAPES)
def test_rebranch_matmul_kernel_equals_plain_version(m, k, n, mode):
    dev = _card()
    cfg = cim.CiMConfig(mode=mode)
    p, w = _inputs(m, k, n, dev, seed=m + k + n)
    gen = torch.Generator().manual_seed(k)
    c = (torch.randn((k, max(1, k // 4)), generator=gen) / k ** .5).to(dev)
    before = rm.launches
    trunk, t1 = rm.rebranch_trunk_sketch(p.bfloat16(), w, c, cfg)
    torch.cuda.synchronize()
    assert rm.launches == before + 1
    want_trunk, want_t1 = rm.rebranch_matmul_plain(p.bfloat16(), w, c, cfg)
    assert torch.equal(trunk, want_trunk)
    tol = 1e-5 * want_t1.abs().max().item()
    assert (t1 - want_t1).abs().max().item() <= tol
    # the trunk equals the trunk-conv kernel's on the same (widened) input,
    # as a 1x1 conv
    assert torch.equal(trunk, rc.trunk_conv_dot(
        p.bfloat16().float().reshape(m, 1, 1, k), w.reshape(1, 1, k, n),
        cfg=cfg))
    one_trunk, one_t1 = rm.rebranch_trunk_sketch(p[:1].bfloat16(), w, c, cfg)
    assert torch.equal(one_trunk, trunk[:1]) and torch.equal(one_t1, t1[:1])


@pytest.mark.gpu
def test_cim_conv_runs_the_cim_matmul_kernel():
    """ops.cim_conv (the port of cim_conv_pallas) is im2col + kernel 4."""
    from repro_torch.kernels import ops
    dev = _card()
    gen = torch.Generator().manual_seed(3)
    x = torch.randint(-128, 128, (2, 9, 8, 20), generator=gen,
                      dtype=torch.int8).to(dev)
    w = torch.randint(-127, 128, (3, 3, 20, 40), generator=gen,
                      dtype=torch.int8).to(dev)
    for mode in MODES:
        cfg = cim.CiMConfig(mode=mode)
        before = cm.launches
        got = ops.cim_conv(x, w, cfg)
        assert cm.launches == before + 1
        p, _ = rc.patch_matrix(x.cpu(), 3, 3, 1, "SAME")
        want = cm.cim_matmul_plain(p, w.cpu().reshape(-1, 40), cfg)
        assert torch.equal(got.cpu().reshape(-1, 40), want)
    # the default config is per_subarray, and runs on the card
    assert ops.cim_matmul(x.reshape(-1, 20), w[1, 1]).is_cuda


@pytest.mark.gpu
def test_lm_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _card()
    x, w = _int8_inputs(8, 256, 64, dev, seed=0)
    for field, value in (("weight_bits", 6), ("act_bits", 4),
                         ("act_group_bits", 1), ("rows_per_subarray", 256)):
        bad = cim.CiMConfig(mode="bitserial", **{field: value})
        with pytest.raises(ValueError, match=field):
            cm.cim_matmul(x, w, bad)
        # the CPU plain version takes it
        assert cm.cim_matmul(x.cpu(), w.cpu(), bad).shape == (8, 64)
    with pytest.raises(ValueError):
        cm.cim_matmul(x.float(), w)
    with pytest.raises(ValueError):
        cm.cim_matmul(x, w.cpu())
    c = torch.zeros((256, 64), device=dev)
    with pytest.raises(ValueError, match="act_group_bits"):
        rm.rebranch_trunk_sketch(x.float(), w, c,
                                 cim.CiMConfig(mode="per_subarray",
                                               act_group_bits=4))
    with pytest.raises(ValueError):
        rm.rebranch_trunk_sketch(x.float(), w, c[:100])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k,n", [(2048, 2048), (16384, 2048), (300, 256)])
def test_rows_do_not_depend_on_the_tile_or_the_split(k, n, mode):
    """An M = 1 launch (16-row tile, split K) gives row 0 the bits of the
    M = 8, 16 (16-row tile) and M = 128 (64-row tile, another split)
    launches, for kernel 4's output, kernel 3's trunk and its sketch."""
    from repro_torch.kernels import tiling
    dev = _card()
    cfg = cim.CiMConfig(mode=mode)
    x, w = _int8_inputs(128, k, n, dev, seed=k + n)
    p = _inputs(129, k, n, dev, seed=k - n)[0][1:]   # row 0: not all zero
    gen = torch.Generator().manual_seed(n)
    c = (torch.randn((k, k // 4), generator=gen) / k ** .5).to(dev)
    one4 = cm.cim_matmul(x[:1].contiguous(), w, cfg)
    one3 = rm.rebranch_trunk_sketch(p[:1].contiguous(), w, c, cfg)
    assert bool(one3[0].abs().max() > 0) and bool(one4.abs().max() > 0)
    assert len({tiling.split_plan(m, n, k, mode).tile_m
                for m in (1, 16, 128)}) == 2
    for m in (8, 16, 128):
        assert torch.equal(cm.cim_matmul(x[:m].contiguous(), w, cfg)[:1],
                           one4)
        trunk, t1 = rm.rebranch_trunk_sketch(p[:m].contiguous(), w, c, cfg)
        assert torch.equal(trunk[:1], one3[0])
        assert torch.equal(t1[:1], one3[1])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,k,n", [(8, 2048, 256), (16, 1280, 48),
                                   (128, 300, 100)])
def test_bf16_x_gives_the_bits_of_its_widened_copy(m, k, n, mode):
    """Kernel 3 reads a bf16 x as it is (M <= 16, K even, 4-byte aligned)
    and any other x widened first; widening is exact, so both routes give
    the same trunk and t1 bits, also for a bf16 x that is not 4-byte
    aligned."""
    dev = _card()
    cfg = cim.CiMConfig(mode=mode)
    p, w = _inputs(m, k, n, dev, seed=m * k + n)
    gen = torch.Generator().manual_seed(n)
    c = (torch.randn((k, k // 4), generator=gen) / k ** .5).to(dev)
    xb = p.bfloat16()
    want = rm.rebranch_trunk_sketch(xb.float(), w, c, cfg)
    got = rm.rebranch_trunk_sketch(xb, w, c, cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    flat = torch.empty(m * k + 1, dtype=torch.bfloat16, device=dev)
    odd = flat[1:].view(m, k)                  # 2 bytes off: widened first
    odd.copy_(xb)
    assert odd.data_ptr() % 4 == 2
    got = rm.rebranch_trunk_sketch(odd, w, c, cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_bitserial_tile_with_a_split_a_ragged_chunk_and_minus_128():
    """The bitserial tile of kernels 4, 3 and 1 is torch.equal to the plain
    versions where the plan splits K over the grid, the last k-block ends
    in a ragged subarray, and activations and weights hold -128."""
    from repro_torch.kernels import tiling
    dev = _card()
    bs = cim.CiMConfig(mode="bitserial")
    m, k, n = 8, 2000, 300                    # 2000 = 3 x 512 + 3 x 128 + 80
    assert tiling.split_plan(m, n, k, "bitserial").n_splits > 1
    x, w = _int8_inputs(m, k, n, dev, seed=11)
    x[0, ::3] = -128
    x[-1, 1::2] = -128
    w[::7, 0] = -128
    w[1::5, -1] = -128
    got = cm.cim_matmul(x, w, bs)
    assert torch.equal(got, cm.cim_matmul_plain(x, w, bs))
    p = _inputs(m, k, n, dev, seed=12)[0]
    gen = torch.Generator().manual_seed(13)
    c = (torch.randn((k, 64), generator=gen) / k ** .5).to(dev)
    trunk, _ = rm.rebranch_trunk_sketch(p, w, c, bs)
    assert torch.equal(trunk, rm.rebranch_matmul_plain(p, w, c, bs)[0])
    # kernel 1: R = 3 x 3 x 300 = 2700 (ragged), M = 98 in 2 row tiles
    xc, wc = _conv_inputs(2, 7, 7, 300, 3, 70, dev, seed=14)
    wc[0, 0, :5] = -128
    launch, _ = rc.conv_launch(tuple(xc.shape), tuple(wc.shape), 1, "SAME",
                               bs)
    assert launch.plan.n_splits > 1 and launch.plan.tile_m == 32
    got = rc.trunk_conv_dot(xc, wc, cfg=bs)
    assert torch.equal(got, _plain_trunk(xc, wc, 1, "SAME", bs))


@pytest.mark.gpu
@pytest.mark.parametrize("n_slots", (24, 64))
def test_pools_past_the_row_bucket_decode_as_solo(n_slots):
    """A pool of more rows than core/rows.py's bucket (16) decodes every
    request as its solo run does: tokens and first decode step logits,
    bit for bit, for requests in the first, a middle and the last 16-row
    slice (Gemma-2B smoke config, pallas_fused, seeded weights with
    non-zero cores)."""
    from repro_torch import configs
    from repro_torch.serve import registry, server
    dev = _card()
    model_id = "gemma-2b-smoke-fused"
    registry.register(registry.ModelEntry(
        model_id=model_id, config=lambda: configs.get_smoke("gemma_2b"),
        engine="pallas_fused"), override=True)
    model, _ = registry.compile_entry(model_id)
    params = model.init(seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def with_cores(tree):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for key, value in items:
            if key == "core":
                value.copy_(torch.randn(value.shape, generator=gen,
                                        device=dev) * 0.05)
            elif isinstance(value, (dict, list)):
                with_cores(value)

    with_cores(params)
    max_len, n_new = 48, 4
    srv = server.load(model_id, params=params, n_slots=n_slots,
                      max_len=max_len)
    rng = np.random.default_rng(n_slots)
    vocab = model.cfg.vocab_size
    prompts = [rng.integers(0, vocab, size=int(s))
               for s in rng.integers(3, 20, size=n_slots)]
    first, decode = {}, model.decode_step

    def recording(p, tok, cache):
        logits, cache = decode(p, tok, cache)
        assert tok.shape[0] == n_slots
        for slot, req in srv.batcher._active.items():
            if len(req.tokens) == 1:
                first[req.rid] = logits[slot, -1].float().cpu()
        return logits, cache

    model.decode_step = recording
    try:
        reqs = [srv.submit(p, n_new) for p in prompts]
        srv.drain()
    finally:
        del model.decode_step
    for i in (0, 17, n_slots - 1):
        cache = model.init_cache(1, max_len, dtype=torch.float32, device=dev)
        with torch.no_grad():
            logits, cache = model.prefill(
                params, {"tokens": torch.as_tensor(prompts[i][None],
                                                   device=dev)}, cache)
            toks, solo_first = [int(logits[0, -1].argmax())], None
            for _ in range(n_new - 1):
                logits, cache = model.decode_step(
                    params, torch.tensor([[toks[-1]]], device=dev), cache)
                if solo_first is None:
                    solo_first = logits[0, -1].float().cpu()
                toks.append(int(logits[0, -1].argmax()))
        assert toks == reqs[i].tokens
        assert torch.equal(solo_first, first[reqs[i].rid])


# ---------------------------------------------------------------------------
# kernels 3 and 4 at the new geometries, on the card
# ---------------------------------------------------------------------------

# (M, K, N): hymba's dt_proj (K = 100, Cd = 25), its x_proj (N = 132), its
# lm_head (N = 32001), its MLP down (K = 5504, a ragged last k-block) and
# falcon-mamba's x_proj (N = 288); the decode rows take the 16-row tiles,
# and each geometry runs again at a ragged prefill near the longest served
# prompt (M = 100) and at a whole 128-row one, which take the taller tiles
NEW_GEOMS = [(1, 100, 3200), (8, 100, 3200), (8, 3200, 132),
             (1, 1600, 32001), (16, 5504, 1600), (8, 8192, 288)] + [
    (m, k, n) for k, n in ((100, 3200), (3200, 132), (1600, 32001),
                           (5504, 1600), (8192, 288))
    for m in (100, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ("ideal", "per_subarray", "bitserial"))
@pytest.mark.parametrize("m,k,n", NEW_GEOMS)
def test_kernels_3_and_4_at_the_new_geometries(m, k, n, mode):
    dev = _card()
    cfg = cim.CiMConfig(mode=mode)
    gen = torch.Generator().manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen).to(dev)
    xq = torch.randint(-127, 128, (m, k), generator=gen,
                       dtype=torch.int8).to(dev)
    w = torch.randint(-127, 128, (k, n), generator=gen,
                      dtype=torch.int8).to(dev)
    c = (torch.randn((k, k // 4), generator=gen) / k ** .5).to(dev)
    for xx in (x, x.bfloat16()):
        trunk, t1 = rm.rebranch_trunk_sketch(xx, w, c, cfg)
        want_trunk, want_t1 = rm.rebranch_matmul_plain(xx, w, c, cfg)
        torch.cuda.synchronize()
        assert torch.equal(trunk, want_trunk)
        assert (t1 - want_t1).abs().max().item() <= \
            1e-5 * want_t1.abs().max().item()
        one = rm.rebranch_trunk_sketch(xx[:1].contiguous(), w, c, cfg)
        assert torch.equal(one[0], trunk[:1])
    got = cm.cim_matmul(xq, w, cfg)
    assert torch.equal(got, cm.cim_matmul_plain(xq, w, cfg))
    assert torch.equal(cm.cim_matmul(xq[:1].contiguous(), w, cfg), got[:1])


# the vlm and audio geometries (K, N): Qwen2-VL-2B's q/o, k/v, gate/up and
# down (K = 8960: a 256-wide last k-block), MusicGen-large's up and
# codebook head, and its down; at a decode step's 8 rows and a verify
# round's or prefill chunk's 32
VLM_AUDIO_GEOMS = [(m, k, n) for k, n in ((1536, 1536), (1536, 256),
                                          (1536, 8960), (8960, 1536),
                                          (2048, 8192), (8192, 2048))
                   for m in (8, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ("ideal", "per_subarray", "bitserial"))
@pytest.mark.parametrize("m,k,n", VLM_AUDIO_GEOMS)
def test_kernels_3_and_4_at_the_vlm_and_audio_geometries(m, k, n, mode):
    test_kernels_3_and_4_at_the_new_geometries(m, k, n, mode)
