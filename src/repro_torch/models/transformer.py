"""Decoder-only LM: the dense, vlm, audio and moe families (port of
``repro.models.transformer``).

Covers musicgen-large (4-codebook audio tokens), qwen2-vl-2b (M-RoPE and
the frontend-embedding stub), yi-34b, qwen1.5-32b (QKV bias), gemma-2b
(GeGLU, head_dim 256, MQA), deepseek-67b, and the MoE models
granite-moe-3b and qwen2-moe-a2.7b (the MoE block, ``models.moe``, in
place of the MLP).

API:
  init(gen, cfg)                                   -> params
  forward(params, batch, cfg)                      -> logits
  prefill(params, batch, cfg, cache)               -> (logits, cache)
  decode_step(params, tokens, cfg, cache)          -> (logits, cache)
  verify_step(params, tokens, cfg, cache)          -> (logits, cache)
  init_cache(cfg, batch, max_len)                  -> cache

Parameters and caches keep the JAX package's STACKED layout: every leaf
under ``params["layers"]`` and ``cache["layers"]`` carries a leading L
dim (the reference builds them with ``jax.vmap`` and runs ``lax.scan``),
so trees match key for key and shape for shape; the port loops over L in
Python on views of the stacked tensors.  As under the reference's scan,
every layer runs with ``layer_idx`` 0.  Caches are updated in place (see
``models.layers``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import bridge
from repro_torch.core import rebranch
from repro_torch.models import layers, moe
from repro_torch.models.config import ArchConfig, spec_for, torch_dtype


def _check_family(cfg: ArchConfig):
    if cfg.family not in ("dense", "vlm", "audio", "moe"):
        raise ValueError(f"models.transformer serves the dense, vlm, audio "
                         f"and moe families, not {cfg.family!r}")


def site_cfg(cfg: ArchConfig, site: str) -> ArchConfig:
    """cfg with the resolved spec for ``site`` as its config-wide
    rebranch (honours ancestor-prefix overrides)."""
    spec = spec_for(cfg, site)
    if spec is cfg.rebranch:
        return cfg
    return dataclasses.replace(cfg, rebranch=spec)


def _block_init(gen, cfg: ArchConfig):
    block = {
        "ln1": layers.init_rmsnorm(cfg.d_model, gen.device),
        "attn": layers.init_attention(gen, site_cfg(cfg, "blocks.attn")),
        "ln2": layers.init_rmsnorm(cfg.d_model, gen.device),
    }
    if cfg.family == "moe":
        block["moe"] = moe.init_moe_block(gen, site_cfg(cfg, "blocks.moe"))
    else:
        block["mlp"] = layers.init_mlp(gen, site_cfg(cfg, "blocks.mlp"))
    return block


def _block_apply(params, x, cfg: ArchConfig, layer_idx: int,
                 positions=None, cache=None, decode=False):
    h, new_cache = layers.apply_attention(
        params["attn"], layers.apply_rmsnorm(params["ln1"], x, cfg.norm_eps),
        site_cfg(cfg, "blocks.attn"), layer_idx,
        positions=positions, cache=cache, decode=decode)
    x = x + h
    h2 = layers.apply_rmsnorm(params["ln2"], x, cfg.norm_eps)
    if cfg.family == "moe":
        h2 = moe.apply_moe_block(params["moe"], h2,
                                 site_cfg(cfg, "blocks.moe"))
    else:
        h2 = layers.apply_mlp(params["mlp"], h2, site_cfg(cfg, "blocks.mlp"))
    return x + h2, new_cache


def layer(tree, i: int):
    """Layer ``i``'s slice (views) of a stacked params or cache tree."""
    return bridge.tree_map(tree, lambda t: t[i])


def unstack(tree, n: int) -> list:
    """The ``n`` per-layer slices (views) of a stacked params tree, one
    ``unbind`` per leaf: under autograd a stacked leaf's gradient is then
    one stack of its slices' gradients, not ``n`` full-size scatters."""
    slices = {k: t.unbind(0) for k, t in bridge.flatten(tree).items()}
    return [bridge.map_named(tree, lambda k, _: slices[k][i])
            for i in range(n)]


def init_stacked(gen: torch.Generator, cfg: ArchConfig, block_init):
    """``cfg.num_layers`` blocks of ``block_init(gen, cfg)`` drawn in order
    into preallocated stacked [L, ...] tensors, one at a time, so the peak
    is one layer above the stacked tree."""
    first = block_init(gen, cfg)
    stacked = bridge.tree_map(
        first, lambda t: t.new_empty((cfg.num_layers, *t.shape)))
    for i in range(cfg.num_layers):
        block = first if i == 0 else block_init(gen, cfg)
        bridge.tree_map2(layer(stacked, i), block, lambda d, s: d.copy_(s))
        del block
    return stacked


def init(gen: torch.Generator, cfg: ArchConfig):
    """Parameters drawn from ``gen`` on its device: the embedding, then the
    layers in order (:func:`init_stacked`), then the readout."""
    _check_family(cfg)
    params = {"embed": layers.init_embedding(gen, cfg.vocab_size,
                                             cfg.d_model)}
    params["layers"] = init_stacked(gen, cfg, _block_init)
    params["ln_f"] = layers.init_rmsnorm(cfg.d_model, gen.device)
    if cfg.num_codebooks:      # musicgen: per-codebook readout heads
        params["codebook_head"] = rebranch.init_linear(
            gen, cfg.d_model, cfg.num_codebooks * cfg.vocab_size,
            spec_for(cfg, "codebook_head"))
    elif not cfg.tie_embeddings:
        params["lm_head"] = rebranch.init_linear(
            gen, cfg.d_model, cfg.vocab_size, spec_for(cfg, "lm_head"))
    return params


def _token_embed(params, tokens, cfg: ArchConfig):
    """tokens [B, S] (or [B, S, Q] codebooks: codebook 0's embedding, then
    codebooks 1..Q-1 added one at a time in the activation dtype, the
    reference's order)."""
    if cfg.num_codebooks and tokens.dim() == 3:
        embs = layers.apply_embedding(params["embed"], tokens[..., 0], cfg)
        for q in range(1, cfg.num_codebooks):
            embs = embs + layers.apply_embedding(params["embed"],
                                                 tokens[..., q], cfg)
        return embs
    return layers.apply_embedding(params["embed"], tokens, cfg)


def _embed_inputs(params, batch, cfg: ArchConfig):
    """tokens and/or precomputed frontend embeddings [B, S, d] (the vision
    / audio stub), cast to the activation dtype and summed."""
    if "embeds" in batch:
        x = batch["embeds"].to(torch_dtype(cfg.dtype))
        if "tokens" in batch:
            x = x + _token_embed(params, batch["tokens"], cfg)
        return x
    return _token_embed(params, batch["tokens"], cfg)


def apply_head(params, x, cfg: ArchConfig):
    """ln_f + readout projection on [..., d] -> [..., V] / [..., Q, V]."""
    x = layers.apply_rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if cfg.num_codebooks:
        logits = rebranch.apply_linear(params["codebook_head"], x,
                                       spec_for(cfg, "codebook_head"))
        return logits.reshape(*logits.shape[:-1], cfg.num_codebooks,
                              cfg.vocab_size)
    if cfg.tie_embeddings:
        return layers.embedding_as_logits(params["embed"], x, cfg)
    return rebranch.apply_linear(params["lm_head"], x,
                                 spec_for(cfg, "lm_head"))


def features(params, batch, cfg: ArchConfig):
    """Forward through the blocks only (pre-ln_f hidden states)."""
    _check_family(cfg)
    x = _embed_inputs(params, batch, cfg)
    positions = batch.get("positions")
    for block in unstack(params["layers"], cfg.num_layers):
        x = _block_apply(block, x, cfg, 0, positions=positions)[0]
    return x


def forward(params, batch, cfg: ArchConfig):
    """Full-sequence forward: logits [B, S, V] (or [B, S, Q, V])."""
    return apply_head(params, features(params, batch, cfg), cfg)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    one = layers.init_attention_cache(cfg, batch, max_len, 0, dtype, device)
    return {"layers": bridge.tree_map(
        one, lambda a: a.new_zeros((cfg.num_layers, *a.shape)))}


def init_paged_cache(cfg: ArchConfig, rows: int, n_blocks: int,
                     block_size: int, max_len: int, dtype=torch.bfloat16,
                     device=None):
    """Paged KV cache: per layer, ``n_blocks`` physical [block_size, KV,
    Dh] blocks plus a [rows, max_len/block_size] block table (owned by
    ``serve.pool.PagedPool``), stacked over L like :func:`init_cache`."""
    one = layers.init_paged_attention_cache(cfg, rows, n_blocks, block_size,
                                            max_len, dtype, device)
    return {"layers": bridge.tree_map(
        one, lambda a: a[None].repeat(cfg.num_layers,
                                      *([1] * a.dim())))}


def _run_layers(params, x, cfg: ArchConfig, cache, positions=None,
                decode=False):
    """Every layer against its cache slice; the caches' K/V are written in
    place and the stacked lengths advanced."""
    cl = cache["layers"]
    lengths = []
    for i in range(cfg.num_layers):
        x, nc = _block_apply(layer(params["layers"], i), x, cfg, 0,
                             positions=positions, cache=layer(cl, i),
                             decode=decode)
        lengths.append(nc["length"])
    cl["length"].copy_(torch.stack(lengths))
    return x, cache


def prefill(params, batch, cfg: ArchConfig, cache):
    """Prompt into ``cache`` (``tokens`` [B, S] or [B, S, Q] and/or
    ``embeds`` [B, S, d]; ``positions`` [B, S], or [B, S, 3] for
    M-RoPE); logits of the last position."""
    _check_family(cfg)
    x = _embed_inputs(params, batch, cfg)
    x, cache = _run_layers(params, x, cfg, cache,
                           positions=batch.get("positions"))
    return apply_head(params, x[:, -1:, :], cfg), cache


def decode_step(params, tokens, cfg: ArchConfig, cache):
    """One token per sequence against the KV cache; tokens [B, 1] (or
    [B, 1, Q] codebooks, or a [B, k] verify block, see
    :func:`verify_step`)."""
    _check_family(cfg)
    x = _token_embed(params, tokens, cfg)
    x, cache = _run_layers(params, x, cfg, cache, decode=True)
    return apply_head(params, x, cfg), cache


def verify_step(params, tokens, cfg: ArchConfig, cache):
    """Speculative VERIFY: a k-token block per sequence in one pass.

    tokens: [B, k], per row the last accepted token and the first k-1
    drafted ones.  Returns logits [B, k, V]: position i's argmax is the
    true next token after input i (each token's KV is written before it
    attends, with per-query validity), so the caller accepts the longest
    drafted prefix that matches plus the first mismatch's correction, bit
    for bit what k plain ``decode_step`` calls give on the accepted
    prefix.  The cache comes back advanced by k on every row; the serving
    pool rolls the rejected tail back (``rollback``).  The body IS
    ``decode_step``: every layer takes any block width.
    """
    return decode_step(params, tokens, cfg, cache)
