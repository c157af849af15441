"""Hymba-style hybrid: parallel attention + SSM heads in every layer (port
of ``repro.models.hybrid``).

Each block runs attention and a mamba-style SSM on the same normalised
input; the two outputs are RMS-normalised per path, scaled by learnable
betas and averaged (Hymba fusion), then an MLP follows.  Most layers use
sliding-window attention (a ring cache of the window); the layers in
``cfg.full_attn_layers`` attend globally.  Meta tokens are elided, as in
the reference.

Parameters and caches are per-layer LISTS (``cfg.scan_layers`` is False:
the window, and so the cache shape, differs by layer), each layer's cache
``{"attn": {k, v, length}, "ssm": {conv, h}}``, updated in place.
"""

from __future__ import annotations

import torch

from repro_torch.core import rebranch
from repro_torch.models import layers, ssm
from repro_torch.models.config import ArchConfig, spec_for
from repro_torch.models.transformer import site_cfg


def _block_init(gen, cfg: ArchConfig):
    dev = gen.device
    return {
        "ln1": layers.init_rmsnorm(cfg.d_model, dev),
        "attn": layers.init_attention(gen, site_cfg(cfg, "blocks.attn")),
        "ssm": ssm.init_ssm_block(gen, cfg, prefix="blocks.ssm"),
        "attn_norm": layers.init_rmsnorm(cfg.d_model, dev),
        "ssm_norm": layers.init_rmsnorm(cfg.d_model, dev),
        "beta": {"sram": {"w": torch.ones((2,), dtype=torch.float32,
                                          device=dev)}},
        "ln2": layers.init_rmsnorm(cfg.d_model, dev),
        "mlp": layers.init_mlp(gen, site_cfg(cfg, "blocks.mlp")),
    }


def _block_apply(params, x, cfg: ArchConfig, layer_idx: int, cache=None,
                 decode=False):
    h = layers.apply_rmsnorm(params["ln1"], x, cfg.norm_eps)
    a_out, new_attn = layers.apply_attention(
        params["attn"], h, site_cfg(cfg, "blocks.attn"), layer_idx,
        cache=None if cache is None else cache["attn"], decode=decode)
    s_out, _ = ssm.apply_ssm_block(
        params["ssm"], h, cfg, cache=None if cache is None else cache["ssm"],
        decode=decode, prefix="blocks.ssm")
    if cache is not None:
        cache["attn"]["length"].copy_(new_attn["length"])

    beta = params["beta"]["sram"]["w"]
    a_out = layers.apply_rmsnorm(params["attn_norm"], a_out, cfg.norm_eps)
    s_out = layers.apply_rmsnorm(params["ssm_norm"], s_out, cfg.norm_eps)
    fused = 0.5 * (beta[0] * a_out.float()
                   + beta[1] * s_out.float()).to(x.dtype)
    x = x + fused
    h2 = layers.apply_rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + layers.apply_mlp(params["mlp"], h2,
                                site_cfg(cfg, "blocks.mlp"))


def init(gen: torch.Generator, cfg: ArchConfig):
    """The embedding, the layers in order (a list), ``ln_f``, the
    readout."""
    return {
        "embed": layers.init_embedding(gen, cfg.vocab_size, cfg.d_model),
        "layers": [_block_init(gen, cfg) for _ in range(cfg.num_layers)],
        "ln_f": layers.init_rmsnorm(cfg.d_model, gen.device),
        "lm_head": rebranch.init_linear(gen, cfg.d_model, cfg.vocab_size,
                                        spec_for(cfg, "lm_head")),
    }


def _run(params, x, cfg: ArchConfig, cache=None, decode=False):
    for i, block in enumerate(params["layers"]):
        x = _block_apply(block, x, cfg, i,
                         cache=None if cache is None else cache["layers"][i],
                         decode=decode)
    return x


def features(params, batch, cfg: ArchConfig):
    x = layers.apply_embedding(params["embed"], batch["tokens"], cfg)
    return _run(params, x, cfg)


def apply_head(params, x, cfg: ArchConfig):
    x = layers.apply_rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return rebranch.apply_linear(params["lm_head"], x,
                                 spec_for(cfg, "lm_head"))


def forward(params, batch, cfg: ArchConfig):
    return apply_head(params, features(params, batch, cfg), cfg)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """SWA layers keep a window-sized ring, full-attention layers the whole
    horizon; the SSM state is O(1)."""
    return {"layers": [{
        "attn": layers.init_attention_cache(cfg, batch, max_len, i, dtype,
                                            device),
        "ssm": ssm.init_ssm_cache(cfg, batch, dtype, device),
    } for i in range(cfg.num_layers)]}


def prefill(params, batch, cfg: ArchConfig, cache):
    x = layers.apply_embedding(params["embed"], batch["tokens"], cfg)
    x = _run(params, x, cfg, cache)
    return apply_head(params, x[:, -1:], cfg).float(), cache


def decode_step(params, tokens, cfg: ArchConfig, cache):
    x = layers.apply_embedding(params["embed"], tokens, cfg)
    x = _run(params, x, cfg, cache, decode=True)
    return apply_head(params, x, cfg).float(), cache
