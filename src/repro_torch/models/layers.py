"""Shared LM components (port of ``repro.models.layers``).

Every large linear map goes through ``core.rebranch.apply_linear`` (frozen
int8 ROM trunk + trainable branch, on the engine its spec names); norms
and biases are small and stay trainable ("SRAM").  The embedding table is
ROM (int8 + per-token scale); lookups and the tied readout dequantise it.

Attention and the branch GEMMs were plain jnp in the reference, so they
stay plain PyTorch here; attention keeps the reference's own softmax
geometry (online softmax over ``attn_chunk`` chunks at prefill, one masked
softmax over the whole cache horizon at decode), which the batched-equals-
solo serving invariant rests on.  Masks use -1e30, as the reference.
Prefill against a cache runs its queries on fixed ``rows.ROW_BUCKET``-query
slices, so a prompt prefilled in chunks gives the bits of a whole-prompt
prefill; a speculative verify block runs one decode attention per query.

KV caches are updated IN PLACE: ``apply_attention`` writes the new entries
into the cache tensors it is given and returns them (the JAX scheduler
donates its cache to the same effect).  A caller that needs the old cache
passes a copy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import quant, rebranch, rows
from repro_torch.distributed import sharding as shd
from repro_torch.models.config import ArchConfig, torch_dtype


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, device=None):
    return {"sram": {"scale": torch.ones((d,), dtype=torch.float32,
                                         device=device)}}


def apply_rmsnorm(params, x, eps: float = 1e-6):
    """RMS norm over the last dim; the mean reduces bucketed rows (its
    kernel, and so its order, would otherwise follow the batch)."""
    def norm(a):
        var = (a * a).mean(dim=-1, keepdim=True)
        return a * torch.rsqrt(var + eps)

    y = rows.rowwise(norm, x.float().reshape(-1, x.shape[-1]))
    return (y.reshape(x.shape) * params["sram"]["scale"]).to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings (ROM: int8 table + per-token scale)
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d: int):
    table = torch.randn((vocab, d), generator=gen, device=gen.device,
                        dtype=torch.float32)
    t_q, t_scale = quant.quantize_weights(table, axis=1)   # per-token scale
    return {"rom": {"table_q": t_q, "table_scale": t_scale}}


def apply_embedding(params, ids, cfg: ArchConfig):
    """The lookup; from a vocab-parallel table (its rows split over the
    model axis) each rank looks up the ids it holds, zeros elsewhere, and
    the ranks' lookups are added in rank order: exact, since one rank
    holds each row."""
    dt = torch_dtype(cfg.dtype)
    t_q = params["rom"]["table_q"]
    t_s = params["rom"]["table_scale"]
    if t_q.shape[0] == cfg.vocab_size:
        return t_q[ids].to(dt) * t_s[ids].to(dt)
    mesh, axis = shd.model_axis()
    lo, hi = shd.h_layout(cfg.vocab_size,
                          mesh.shape[axis])[mesh.coordinate(axis)]
    local = ids - lo
    own = (local >= 0) & (local < hi - lo)
    idx = local.clamp(0, hi - lo - 1)
    e = t_q[idx].to(dt) * t_s[idx].to(dt)
    e = torch.where(own[..., None], e, torch.zeros((), dtype=dt,
                                                   device=e.device))
    return shd.reduce_model(e, "embed")


def embedding_as_logits(params, x, cfg: ArchConfig):
    """Tied-embedding readout: x @ dequant(table)^T (the reference
    dequantises the whole table each call, and so does the port).  A
    vocab-parallel table gives this rank's vocab columns."""
    t_q = params["rom"]["table_q"]
    t_s = params["rom"]["table_scale"]
    w = t_q.to(x.dtype) * t_s.to(x.dtype)                  # [V, d]
    logits = rows.rowwise(lambda a: a @ w.T, x.reshape(-1, x.shape[-1]))
    return logits.reshape(*x.shape[:-1], w.shape[0])


def linear(params, x, spec, tp=None, sp=None):
    """``rebranch.apply_linear``, passed the tensor-parallel arguments only
    when there are any (an unsharded call keeps its three arguments)."""
    if tp is None and sp is None:
        return rebranch.apply_linear(params, x, spec)
    return rebranch.apply_linear(params, x, spec, tp=tp, sp=sp)


# ---------------------------------------------------------------------------
# rotary embeddings (RoPE and qwen2-vl M-RoPE)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float):
    """float64 numpy, as the reference; callers cast to f32."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _mrope_streams(head_dim: int, device: torch.device) -> torch.Tensor:
    """The position stream (0 temporal, 1 height, 2 width) of each of the
    head_dim/2 rotary frequencies: the rotary half split 2:1:1 as the
    reference splits it (for head_dim 128: [32, 16, 16]; Hugging Face's
    Qwen2-VL uses [16, 24, 24])."""
    n = head_dim // 2
    sec = [n - 2 * (n // 4), n // 4, n // 4]
    return torch.as_tensor(np.repeat(np.arange(3), sec), device=device)


def apply_rope(x, positions, theta: float = 10_000.0, mrope: bool = False):
    """x: [B, S, H, Dh]; positions: [B, S] (or [B, S, 3] for M-RoPE).

    M-RoPE (qwen2-vl) on [B, S, 3] positions: each rotary frequency takes
    its angle from the stream :func:`_mrope_streams` assigns it.  [B, S]
    positions stand for three equal streams, whose angles are RoPE's
    products exactly, so they take the RoPE line.
    """
    dh = x.shape[-1]
    freqs = torch.as_tensor(rope_frequencies(dh, theta).astype(np.float32),
                            device=x.device)
    if mrope and positions.dim() == 3:
        angles = (positions.float()[..., _mrope_streams(dh, x.device)]
                  * freqs)                               # [B, S, dh/2]
    else:
        angles = positions.float()[..., None] * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA + KV cache + chunked causal / sliding window)
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ArchConfig):
    spec = cfg.rebranch
    h, kv, dh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    return {
        "q": rebranch.init_linear(gen, d, h * dh, spec, use_bias=cfg.qkv_bias),
        "k": rebranch.init_linear(gen, d, kv * dh, spec,
                                  use_bias=cfg.qkv_bias),
        "v": rebranch.init_linear(gen, d, kv * dh, spec,
                                  use_bias=cfg.qkv_bias),
        "o": rebranch.init_linear(gen, h * dh, d, spec),
    }


def _chunked_causal_attention(q, k, v, chunk: int, window: int = 0,
                              kv_offset=0, qpos=None):
    """Causal attention by online softmax over KV chunks.

    q: [B, Sq, H, Dh], k/v: [B, Skv, KV, Dh].  ``kv_offset`` (an int or a
    0-d tensor) is the absolute position of the first query; ``qpos``
    ([Sq]), when given, the absolute position of each query instead.
    """
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = 1.0 / np.sqrt(dh)
    q = q.float() * scale
    dev = q.device
    if qpos is None:
        qpos = kv_offset + torch.arange(sq, device=dev)

    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    kc = k.reshape(b, n_chunks, chunk, kvh, dh).float()
    vc = v.reshape(b, n_chunks, chunk, kvh, dh).float()
    qg = q.reshape(b, sq, kvh, rep, dh)

    m = torch.full((b, h, sq), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        kpos = ci * chunk + torch.arange(chunk, device=dev)
        s = torch.einsum("bsgrd,bcgd->bgrsc", qg, kc[:, ci])
        s = s.reshape(b, kvh * rep, sq, chunk)
        mask = kpos[None, :] <= qpos[:, None]                  # causal
        mask = mask & (kpos[None, :] < skv)                    # padding
        if window:
            mask = mask & (kpos[None, :] > (qpos[:, None] - window))
        s = torch.where(mask[None, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bgrsc,bcgd->bgrsd",
                          p.reshape(b, kvh, rep, sq, chunk), vc[:, ci])
        acc = acc * corr[..., None] + pv.reshape(b, kvh * rep, sq, dh)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2)          # [B, Sq, H, Dh]


def _prefill_attention(q, k, v, chunk: int, window: int, kv_offset):
    """:func:`_chunked_causal_attention` of the queries of one prefill call
    against the cache view, computed on consecutive
    :data:`~repro_torch.core.rows.ROW_BUCKET`-query slices (the last one
    padded with position-0 queries): its GEMMs and reductions then see
    one shape whatever the call's query count, so a query gets the same
    bits in a chunk of a chunked prefill as in a whole-prompt prefill
    (cuBLAS and PyTorch's reductions pick their order from the shape)."""
    qpos = kv_offset + torch.arange(q.shape[1], device=q.device)

    def block(qs, ps):                     # qs: [16, B, H, Dh]
        out = _chunked_causal_attention(qs.transpose(0, 1), k, v, chunk,
                                        window, qpos=ps)
        return out.transpose(0, 1)

    return rows.rowwise(block, q.transpose(0, 1), qpos).transpose(0, 1)


def _gather_paged(leaf, table):
    """The logical [B, S, KV, Dh] view of a paged cache leaf.

    leaf: [P, bs, KV, Dh] physical blocks; table: [B, NB] block ids.  The
    view equals, at every valid position, the dense row the same request
    would hold, so the attention downstream is unchanged.
    """
    b, nb = table.shape
    bs = leaf.shape[1]
    return leaf[table].reshape(b, nb * bs, *leaf.shape[2:])


def _verify_attention(q, k_cache, v_cache, length, s_max: int):
    """Speculative-verify attention: S queries against one cache view
    that already holds this block's entries at ``length .. length+S-1``.
    Query j sees the positions ``< length + 1 + j`` (its own entry and
    everything before it; the drafted future entries are masked), through
    one :func:`_decode_attention` call per query, so each query runs at
    exactly the shapes of a plain decode step and an accepted token has
    the bits of sequential decode."""
    outs = [_decode_attention(q[:, j:j + 1], k_cache, v_cache,
                              torch.clamp(length + 1 + j, max=s_max))
            for j in range(q.shape[1])]
    return torch.cat(outs, dim=1)


def _decode_attention(q, k_cache, v_cache, valid_count):
    """Single-position attention against a (possibly ring-buffer) cache.
    q: [B, 1, H, Dh]; one masked softmax over the whole horizon, on
    bucketed rows (batch-invariant bits, see ``core.rows``)."""
    return rows.rowwise(_decode_attention_rows, q, k_cache, v_cache,
                        valid_count)


def _decode_attention_rows(q, k_cache, v_cache, valid_count):
    b, _, h, dh = q.shape
    s_max, kvh = k_cache.shape[1], k_cache.shape[2]
    rep = h // kvh
    scale = 1.0 / np.sqrt(dh)
    qq = (q.float() * scale)[:, 0].reshape(b, kvh, rep, dh)
    s = torch.einsum("bgrd,bcgd->bgrc", qq, k_cache.float())   # [B,KV,rep,S]
    pos = torch.arange(s_max, device=q.device)
    mask = pos[None, :] < valid_count[:, None]                 # [B, S]
    s = torch.where(mask[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrc,bcgd->bgrd", p, v_cache.float())
    return out.reshape(b, 1, h, dh)


def _write_decode(cache, k, v, length, rows):
    """Write each row's new K/V entries at its own ring slot, in place;
    returns the logical (k, v) views decode attention reads."""
    k_cache, v_cache = cache["k"], cache["v"]
    s = k.shape[1]
    if "table" in cache:
        # paged: the table indirects each row's logical slot to a physical
        # (block, offset); free rows point at the trash block
        table = cache["table"]
        bs = k_cache.shape[1]
        s_max = table.shape[1] * bs
        for j in range(s):
            slot = (length + j) % s_max
            pb = table[rows, slot // bs]
            off = slot % bs
            k_cache[pb, off] = k[:, j].to(k_cache.dtype)
            v_cache[pb, off] = v[:, j].to(v_cache.dtype)
        return _gather_paged(k_cache, table), _gather_paged(v_cache, table)
    s_max = k_cache.shape[1]
    for j in range(s):
        slot = (length + j) % s_max          # per-row ring slot
        k_cache[rows, slot] = k[:, j].to(k_cache.dtype)
        v_cache[rows, slot] = v[:, j].to(v_cache.dtype)
    return k_cache, v_cache


def apply_attention(params, x, cfg: ArchConfig, layer_idx: int,
                    positions=None, cache=None, decode: bool = False,
                    sp=None):
    """Returns (out, new_cache_entry); the cache is updated in place.
    Under a model axis the heads run tensor-parallel
    (:func:`_attention_tp`); ``sp`` is the seq_sp layout the output's
    sequence takes there."""
    at = shd.model_axis()
    if at is not None:
        return _attention_tp(params, x, cfg, layer_idx, positions, cache,
                             decode, sp, at)
    spec = cfg.rebranch
    b, s, _ = x.shape
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    q = rebranch.apply_linear(params["q"], x, spec).reshape(b, s, h, dh)
    k = rebranch.apply_linear(params["k"], x, spec).reshape(b, s, kv, dh)
    v = rebranch.apply_linear(params["v"], x, spec).reshape(b, s, kv, dh)
    out, new_cache = _attend(q, k, v, cfg, layer_idx, positions, cache,
                             decode)
    out = out.to(x.dtype).reshape(b, s, h * dh)
    return rebranch.apply_linear(params["o"], out, spec), new_cache


def _positions(b: int, s: int, cache, positions, device):
    """[B, S] positions: given, else the cache's length onward (decode, or
    a prefill continuing the cache), else 0..S-1."""
    if positions is not None:
        return positions
    steps = torch.arange(s, device=device)
    if cache is not None:
        return cache["length"][:, None] + steps[None]
    return steps[None].expand(b, s)


def _offset(length):
    """A prefill's first position: row 0's cache length; 0 for a block of
    no rows (a data rank that GSPMD's uneven layout leaves empty writes
    and attends nothing, but runs every op and exchange of the others)."""
    return length[0] if length.numel() else 0


def _attend(q, k, v, cfg: ArchConfig, layer_idx: int, positions, cache,
            decode: bool, group=None):
    """RoPE, the cache update and attention of projected q [B, S, H, Dh]
    and k, v [B, S, KV, Dh]; returns (out [B, S, H, Dh], new cache).
    ``group`` (:func:`_group_kv`) gives, from k or v with every kv head
    (and the cache with all of them), the kv heads q's heads read, for a
    rank that holds some of the heads (tensor parallelism)."""
    b, s = q.shape[:2]
    inner = _attention_of(group)
    window = 0 if cfg.uses_full_attention(layer_idx) else cfg.sliding_window
    paged = cache is not None and "table" in cache
    steps = torch.arange(s, device=q.device)
    positions = _positions(b, s, cache, positions, q.device)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope)
    if decode:
        # s == 1: plain decode.  s > 1: speculative VERIFY, a k-token
        # block per row, written entry by entry as k decode steps would
        # and attended with per-query validity (a full-horizon cache only:
        # ``api.supports_speculation``)
        if cache is None:
            raise ValueError("decode needs a KV cache")
        length = cache["length"]
        rows = torch.arange(b, device=q.device)
        k_view, v_view = _write_decode(cache, k, v, length, rows)
        s_max = k_view.shape[1]
        if s == 1:
            out = inner(_decode_attention, q, k_view, v_view,
                        torch.clamp(length + 1, max=s_max))
        else:
            out = inner(_verify_attention, q, k_view, v_view, length, s_max)
        new_cache = {**cache, "length": length + s}
    else:
        if paged:
            raise ValueError(
                "prefill cannot run against a paged cache (physical "
                "blocks have no per-row horizon to fill); prefill into "
                "a dense batch=1 cache and adopt the row into the "
                "paged pool (serve.pool.PagedPool.adopt)")
        if cache is not None and s < cache["k"].shape[1]:
            # attend over the updated cache view (cached prefix ++ this
            # chunk at its offset); offset is row 0's length, as the
            # reference (admission prefills are B=1)
            offset = _offset(cache["length"])
            idx = offset + steps
            k_att = cache["k"].to(k.dtype).index_copy(1, idx, k)
            v_att = cache["v"].to(v.dtype).index_copy(1, idx, v)
            out = inner(_prefill_attention, q, k_att, v_att,
                        cfg.attn_chunk, window, offset)
            cache["k"].index_copy_(1, idx, k.to(cache["k"].dtype))
            cache["v"].index_copy_(1, idx, v.to(cache["v"].dtype))
            new_cache = {"k": cache["k"], "v": cache["v"],
                         "length": cache["length"] + s}
        else:
            out = inner(_chunked_causal_attention, q, k, v, cfg.attn_chunk,
                        window)
            if cache is not None:    # prompt >= horizon: ring fill
                s_max = cache["k"].shape[1]
                cache["k"].copy_(torch.roll(k[:, -s_max:], s % s_max, 1))
                cache["v"].copy_(torch.roll(v[:, -s_max:], s % s_max, 1))
                new_cache = {"k": cache["k"], "v": cache["v"],
                             "length": cache["length"] + s}
            else:
                new_cache = None

    return out, new_cache


def _kv_heads(q0: int, q1: int, rep: int) -> tuple[int, int]:
    """The kv heads ``[k0, k1)`` that q heads ``[q0, q1)`` read (GQA: q
    head i reads kv head ``i // rep``); a GQA group may be split between
    ranks (Yi-34B's rep 7 over 19, 19, 18 heads)."""
    return q0 // rep, (q1 - 1) // rep + 1


def _group_kv(t, q0: int, q1: int, rep: int):
    """The kv heads of ``t`` [B, S, KV, Dh] (every kv head) that q heads
    ``[q0, q1)`` read, laid out for the attention functions (q head i of
    the block reads kv head ``i // (hq / kv_block)``): a slice where the
    block holds whole groups or reads one kv head, else one kv head per q
    head (a group split between ranks)."""
    k0, k1 = _kv_heads(q0, q1, rep)
    if k1 - k0 == 1 or (q0 % rep == 0 and q1 % rep == 0):
        return t[:, :, k0:k1]
    idx = torch.arange(q0, q1, device=t.device) // rep
    return t.index_select(2, idx)


def _attention_of(group=None):
    """``inner(fn, q, k, v, *args)``: the attention ``fn`` of q's heads
    against k and v, or with ``group`` the kv heads it picks from them; a
    rank with no q heads attends nothing (an empty result)."""
    def inner(fn, q, k, v, *args):
        if group is None:
            return fn(q, k, v, *args)
        if q.shape[2] == 0:       # zeros after q, k and v in the graph
            return rebranch.zeros_from(q, q.shape, k, v,
                                       dtype=torch.float32)
        return fn(q, group(k), group(v), *args)
    return inner


def _attention_tp(params, x, cfg: ArchConfig, layer_idx: int, positions,
                  cache, decode: bool, sp, at):
    """Attention over the model axis (port of what GSPMD makes of the
    reference under ``param_specs`` and ``launch.steps.cache_pspecs``).

    q is column-parallel on whole heads: the rank holds the heads of its
    ``sharding.linear_tp`` columns (``sharding.head_layout``, GSPMD's
    uneven layout: Yi-34B's 56 heads over 16 ranks go 4 to ranks 0-13,
    none to 14-15).  Where the kv heads divide the model axis, k and v
    are column-parallel too, the cache holds the rank's kv heads and
    attention is local (GQA groups stay inside a rank).  Where they do
    not, k and v are column-parallel over their columns and gathered
    after the projection (or kept whole, by the size rule), and each rank
    attends its q heads against the kv heads they read
    (:func:`_group_kv`).  The cache is then split over the sequence
    (``init_cache`` marks it ``"seq_split"``; :func:`_attend_seq_split`),
    or whole on every rank when ``max_len`` does not divide the model
    axis either (every rank writes every position).  The output
    projection is row-parallel, its input in the heads' layout.  A rank
    without heads launches no q kernel and attends nothing, but joins
    every exchange."""
    mesh, axis = at
    n = mesh.shape[axis]
    spec = cfg.rebranch
    rows_k = spec.cim.rows_per_subarray
    b, s, d = x.shape
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cache is not None and "table" in cache:
        raise NotImplementedError(
            f"a paged KV cache over a mesh comes with {shd.LM_SLICE}")
    if sp is None:                # whole x into the heads: Megatron's f
        x = shd.replicate(x)
    tp_q = shd.linear_tp("q", d, h * dh, rows_k, head_dim=dh)
    q0, q1 = (c // dh for c in tp_q.cols)
    window = 0 if cfg.uses_full_attention(layer_idx) else cfg.sliding_window
    q = linear(params["q"], x, spec, tp=tp_q)
    q = q.reshape(b, s, q1 - q0, dh)
    tp_k = shd.linear_tp("k", d, kv * dh, rows_k)
    if tp_k is None:              # k, v kept whole, read by the rank's heads
        shd.mark_partial(params["k"].get("sram"), params["v"].get("sram"))
    kv_t = torch.stack([linear(params[name], x, spec, tp=tp_k)
                        for name in ("k", "v")])
    if kv % n == 0:
        k, v = kv_t.reshape(2, b, s, kv // n, dh).unbind(0)
        out, new_cache = _attend(q, k, v, cfg, layer_idx, positions, cache,
                                 decode)
    else:
        if tp_k is not None:
            kv_t = shd.gather_cols(kv_t, kv * dh, mesh, axis)
        k, v = kv_t.reshape(2, b, s, kv, dh).unbind(0)
        group = functools.partial(_group_kv, q0=q0, q1=q1, rep=h // kv)
        if cache is None or "seq_split" not in cache:
            out, new_cache = _attend(q, k, v, cfg, layer_idx, positions,
                                     cache, decode, group)
        else:
            out, new_cache = _attend_seq_split(q, k, v, cfg, positions,
                                               cache, decode, window, mesh,
                                               axis, group, q0)
    out = out.to(x.dtype).reshape(b, s, (q1 - q0) * dh)
    return linear(
        params["o"], out, spec,
        tp=shd.linear_tp("o", h * dh, d, rows_k, head_dim=dh), sp=sp), \
        new_cache


def _attend_seq_split(q, k, v, cfg: ArchConfig, positions, cache,
                      decode: bool, window: int, mesh, axis, group,
                      q0: int):
    """:func:`_attend` of the rank's q heads [B, S, hq, Dh] (heads ``q0``
    on) and whole k, v [B, S, KV, Dh] against a cache split over its
    sequence: a decode step writes its position on the rank that owns it,
    every rank attends all q heads (gathered) over its positions, and the
    (max, sum of exp, weighted v) partials are combined in rank order,
    each rank keeping its heads; a prefill attends from the gathered
    cache and writes each rank's positions back."""
    n, r = mesh.shape[axis], mesh.coordinate(axis)
    b, s, hq, _ = q.shape
    h, kv = cfg.num_heads, cfg.num_kv_heads
    inner = _attention_of(group)
    positions = _positions(b, s, cache, positions, q.device)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope)
    if cache["k"].shape[2] != kv:
        raise ValueError(f"a cache of {cache['k'].shape[2]} kv heads for "
                         f"{kv}: not the sequence-split layout")
    s_loc = cache["k"].shape[1]
    s_max, p0 = s_loc * n, r * s_loc
    length = cache["length"]
    if decode:
        if s != 1:
            raise NotImplementedError(
                f"a speculative verify block over a sequence-split cache "
                f"comes with {shd.LM_SLICE}")
        slot = length % s_max
        own = ((slot >= p0) & (slot < p0 + s_loc))[:, None, None]
        at = (slot - p0).clamp(0, s_loc - 1)
        rows_i = torch.arange(b, device=q.device)
        for leaf, new in (("k", k), ("v", v)):
            c = cache[leaf]
            c[rows_i, at] = torch.where(own, new[:, 0].to(c.dtype),
                                        c[rows_i, at])
        qa = shd.gather_cols(q, h, mesh, axis, dim=2)
        part = rows.rowwise(
            functools.partial(_decode_partial_rows, p0=p0), qa, cache["k"],
            cache["v"], torch.clamp(length + 1, max=s_max))
        out = rows.rowwise(lambda *ps: _combine_partials(ps),
                           *shd.gather_parts(part, mesh, axis, "attention"))
        out = out[:, q0:q0 + hq][:, None]
        return out, {**cache, "length": length + 1}
    # prefill: the whole horizon's view, this call's k and v in it, the
    # rank's positions written back
    view = torch.stack([cache["k"], cache["v"]])
    view = shd.move_rows(view, shd.h_layout(s_max, n), [(0, s_max)] * n,
                         mesh, axis, "gather", dim=2)
    if s < s_max:
        offset = _offset(length)
        idx = offset + torch.arange(s, device=q.device)
        kv_new = torch.stack([k, v])
        att = view.to(k.dtype).index_copy(2, idx, kv_new)
        out = inner(_prefill_attention, q, att[0], att[1], cfg.attn_chunk,
                    window, offset)
        view = view.index_copy(2, idx, kv_new.to(view.dtype))
    else:                             # prompt >= horizon: ring fill
        out = inner(_chunked_causal_attention, q, k, v, cfg.attn_chunk,
                    window)
        view = torch.roll(torch.stack([k, v])[:, :, -s_max:], s % s_max,
                          2).to(view.dtype)
    cache["k"].copy_(view[0][:, p0:p0 + s_loc])
    cache["v"].copy_(view[1][:, p0:p0 + s_loc])
    return out, {"k": cache["k"], "v": cache["v"], "length": length + s}


def _decode_partial_rows(q, k_cache, v_cache, valid_count, p0: int):
    """One decode query of all heads against this rank's cache positions
    ``p0 ..``: per (row, head) the masked max, the sum of exp and the
    exp-weighted v, packed [B, H, Dh + 2] (f32)."""
    b, _, h, dh = q.shape
    s_loc, kvh = k_cache.shape[1], k_cache.shape[2]
    rep = h // kvh
    qq = (q.float() * (1.0 / np.sqrt(dh)))[:, 0].reshape(b, kvh, rep, dh)
    sc = torch.einsum("bgrd,bcgd->bgrc", qq, k_cache.float())
    pos = p0 + torch.arange(s_loc, device=q.device)
    mask = pos[None, :] < valid_count[:, None]
    sc = torch.where(mask[:, None, None, :], sc, -1e30)
    m = sc.amax(dim=-1)
    p = torch.exp(sc - m[..., None])
    acc = torch.einsum("bgrc,bcgd->bgrd", p, v_cache.float())
    packed = torch.cat([acc, m[..., None], p.sum(dim=-1)[..., None]], -1)
    return packed.reshape(b, h, dh + 2)


def _combine_partials(parts) -> torch.Tensor:
    """The ranks' (weighted v, max, sum of exp) partials [B, H, Dh + 2]
    combined in rank order: out [B, H, Dh] = sum_r acc_r e^(m_r - M) /
    sum_r l_r e^(m_r - M), M the max over the ranks (a rank whose
    positions are all masked weighs e^(-1e30 - M) = 0)."""
    big = parts[0][..., -2]
    for p in parts[1:]:
        big = torch.maximum(big, p[..., -2])
    acc = den = None
    for p in parts:
        w = torch.exp(p[..., -2] - big)
        a, l = p[..., :-2] * w[..., None], p[..., -1] * w
        acc, den = (a, l) if acc is None else (acc + a, den + l)
    return acc / den.clamp_min(1e-30)[..., None]


def init_attention_cache(cfg: ArchConfig, batch: int, max_len: int,
                         layer_idx: int, dtype=torch.bfloat16, device=None):
    """SWA layers get a ring buffer of window size; full-attention layers
    keep the whole horizon."""
    window = (0 if cfg.uses_full_attention(layer_idx)
              else cfg.sliding_window)
    s = max_len if window == 0 else min(max_len, window)
    shape = (batch, s, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def init_paged_attention_cache(cfg: ArchConfig, rows: int, n_blocks: int,
                               block_size: int, max_len: int,
                               dtype=torch.bfloat16, device=None):
    """One layer of a PAGED KV cache: ``n_blocks`` physical blocks of
    ``block_size`` positions shared by every row, and a [rows,
    max_len/block_size] block table owned by the pool.  ``block_size``
    must divide ``max_len`` so the gathered view has exactly the dense
    cache's shape (same softmax geometry = same bits).  Table entries start
    at the LAST block, the pool's trash block."""
    if max_len % block_size:
        raise ValueError(
            f"block_size {block_size} does not divide max_len {max_len}; "
            f"the gathered paged view must have exactly the dense cache "
            f"shape (same attention geometry = same bits)")
    if not cfg.uses_full_attention(layer_idx=0) or cfg.sliding_window:
        raise ValueError(
            f"paged KV requires a uniform full-attention horizon; "
            f"{cfg.name!r} has sliding_window={cfg.sliding_window} "
            f"(ring caches smaller than max_len cannot share one block "
            f"table) — serve this config over a dense SlotPool")
    nb = max_len // block_size
    shape = (n_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": torch.zeros((rows,), dtype=torch.int32, device=device),
        "table": torch.full((rows, nb), n_blocks - 1, dtype=torch.int32,
                            device=device),
    }


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / GELU)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ArchConfig, d_ff: int | None = None):
    spec = cfg.rebranch
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {
            "gate": rebranch.init_linear(gen, d, ff, spec),
            "up": rebranch.init_linear(gen, d, ff, spec),
            "down": rebranch.init_linear(gen, ff, d, spec),
        }
    return {
        "up": rebranch.init_linear(gen, d, ff, spec),
        "down": rebranch.init_linear(gen, ff, d, spec),
    }


def _gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _bucketed(fn, x):
    """Elementwise ``fn`` of ``x`` on bucketed rows (``core.rows``)."""
    return rows.rowwise(fn, x.reshape(-1, x.shape[-1])).reshape(x.shape)


def apply_mlp(params, x, cfg: ArchConfig, sp=None, d_ff: int | None = None):
    """Under a model axis column-parallel (gate, up: the rank's ``mlp``
    columns) into row-parallel (down, whole output or, with ``sp``, the
    rank's seq_sp chunk).  ``d_ff``: the hidden width where it is not
    ``cfg.d_ff`` (the moe block's shared experts), as :func:`init_mlp`
    takes it: the layout over the model axis follows it."""
    spec = cfg.rebranch
    rows_k = spec.cim.rows_per_subarray
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    tp_in = shd.linear_tp("up", d, ff, rows_k)
    act = F.silu if cfg.mlp_type == "swiglu" else _gelu
    if tp_in is not None:
        # the rank's columns are few enough that the CPU's vectorised
        # transcendental loops leave a row's tail to the scalar ones,
        # whose bits differ: bucketed rows keep one shape for any batch
        act = functools.partial(_bucketed, act)
        if sp is None:            # whole x into the columns: Megatron's f
            x = shd.replicate(x)
    elif sp is not None:          # kept whole, the output cut to sp rows
        shd.mark_partial(*(params[k].get("sram") for k in params))
    if cfg.mlp_type in ("swiglu", "geglu"):
        g = linear(params["gate"], x, spec, tp=tp_in)
        u = linear(params["up"], x, spec, tp=tp_in)
        h = act(g) * u
    else:
        h = act(linear(params["up"], x, spec, tp=tp_in))
    return linear(params["down"], h, spec,
                                 tp=shd.linear_tp("down", ff, d, rows_k),
                                 sp=sp)

