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

Under a mesh (the dense and moe families) each rank
runs its rows of the batch (the steps cut them,
``launch.steps.local_batch``) with its block of the parameters and cache
(``deploy.CompiledModel.shard_params``, ``api.init_cache``): the
embedding and readout vocab-parallel, attention and MLP tensor-parallel
(``models.layers``), the moe block by its expert layout (``models.moe``,
told the rank's rows of the batch), the residual stream of a prefill in
the reference's ``seq_sp`` layout (each rank its chunk of the sequence,
gathered before attention and MLP).  The reference's ``shard``
sites stand where a whole tensor takes a layout; the batch is never cut
here.  A train step runs the same forward under autograd, each block
checkpointed when ``cfg.remat`` (:func:`features`), the head's input
entering its vocab-parallel readout through ``sharding.replicate``.
"""

from __future__ import annotations

import contextvars
import dataclasses

import torch
import torch.utils.checkpoint

from repro_torch import bridge
from repro_torch.core import rebranch
from repro_torch.distributed import sharding as shd
from repro_torch.launch import cost
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
                 positions=None, cache=None, decode=False, sp=None,
                 rows=None):
    """One block.  ``sp``: the seq_sp layout of the residual ``x`` over
    the model axis (each rank holds its sequence chunk): the normed input
    of attention and MLP is gathered whole, their row-parallel outputs
    come back as the rank's chunk (the norm scales then meet only the
    rank's rows: ``sharding.mark_partial``).  ``rows``: ``(lo, hi, B)``,
    this rank's rows of the batch, for the moe block's routing groups."""
    if sp is not None:
        shd.mark_partial(params["ln1"], params["ln2"])
    h = _unchunk(layers.apply_rmsnorm(params["ln1"], x, cfg.norm_eps), sp)
    kw = {} if sp is None else {"sp": sp}    # unsharded: the 7 arguments
    h, new_cache = layers.apply_attention(
        params["attn"], h, site_cfg(cfg, "blocks.attn"), layer_idx,
        positions=positions, cache=cache, decode=decode, **kw)
    x = x + h
    h2 = _unchunk(layers.apply_rmsnorm(params["ln2"], x, cfg.norm_eps), sp)
    if cfg.family == "moe":
        if rows is not None:
            kw["rows"] = rows
        h2 = moe.apply_moe_block(params["moe"], h2,
                                 site_cfg(cfg, "blocks.moe"), **kw)
    else:
        h2 = layers.apply_mlp(params["mlp"], h2, site_cfg(cfg, "blocks.mlp"),
                              **kw)
    return x + h2, new_cache


def _seq_parallel(x):
    """The whole residual ``x`` [B, S, d] into the reference's
    ``shard(x, "batch", "seq_sp", "embed")`` layout (the batch is already
    the rank's rows), with that layout (None when S stays whole)."""
    at = shd.axis_layout("seq_sp", x.shape[1])
    return shd.shard(x, None, "seq_sp", "embed"), \
        None if at is None else at[2]


def _unchunk(x, sp, replicated: bool = False):
    """The whole sequence on every rank from seq_sp chunks.  Into a
    block's tensor-parallel work each rank's gradient is a part, which
    the gather's adjoint sums (Megatron's f); ``replicated``: into work
    done alike on every rank (the head), whose gradient is whole on each
    rank (``sharding.move_rows``)."""
    if sp is None:
        return x
    mesh, axis = shd.model_axis()
    return shd.move_rows(x, sp, [(0, sp[-1][1])] * len(sp), mesh, axis,
                         "gather", dim=1, replicated=replicated)


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
    is one layer above the stacked tree.  Under a fake-tensor mode
    (``bridge.abstract``: shapes only) the first block stands for all."""
    first = block_init(gen, cfg)
    stacked = bridge.tree_map(
        first, lambda t: t.new_empty((cfg.num_layers, *t.shape)))
    fake = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
    for i in range(1 if fake is not None else cfg.num_layers):
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


def apply_head(params, x, cfg: ArchConfig, whole_logits: bool = True):
    """ln_f + readout projection on [..., d] -> [..., V] / [..., Q, V].

    Under a model axis the readout is vocab-parallel (the tied table's
    rows, or a column-parallel ``lm_head``); the logits come back whole
    on every rank, or with ``whole_logits=False`` as this rank's vocab
    columns (``sharding.vocab_argmax`` reads them)."""
    x = layers.apply_rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if cfg.num_codebooks:
        logits = rebranch.apply_linear(params["codebook_head"], x,
                                       spec_for(cfg, "codebook_head"))
        return logits.reshape(*logits.shape[:-1], cfg.num_codebooks,
                              cfg.vocab_size)
    if cfg.tie_embeddings:
        if params["embed"]["rom"]["table_q"].shape[0] != cfg.vocab_size:
            x = shd.replicate(x)          # into the rank's vocab rows
        logits = layers.embedding_as_logits(params["embed"], x, cfg)
    else:
        spec = spec_for(cfg, "lm_head")
        tp = shd.linear_tp("lm_head", cfg.d_model, cfg.vocab_size,
                           spec.cim.rows_per_subarray)
        if tp is not None:
            x = shd.replicate(x)          # into the rank's vocab columns
        logits = layers.linear(params["lm_head"], x, spec, tp=tp)
    return shd.gather_vocab(logits, cfg.vocab_size) if whole_logits \
        else logits


def _readout(params, x, cfg: ArchConfig, whole_logits: bool):
    """:func:`apply_head`, passed ``whole_logits`` only when it is False
    (the whole-logits call keeps its three arguments)."""
    if whole_logits:
        return apply_head(params, x, cfg)
    return apply_head(params, x, cfg, whole_logits=False)


class _Recompute(torch.autograd.Function):
    """The identity on a checkpointed block's output whose backward reads
    a tensor the block saved: the block's recompute then runs first in
    its backward, before any of its exchanges' adjoints, on every rank
    alike (ranks without heads or k-blocks save other tensors, and would
    otherwise recompute at another point of the exchanges' order)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.saved_tensors
        return g


def checkpointed(fn, *args):
    """``fn(*args)`` under a non-reentrant ``torch.utils.checkpoint``: only
    its inputs are kept, and the backward recomputes it whole (no early
    stop: every exchange of ``fn`` runs again, in the same order on every
    rank) in this call's context (the bound mesh, the tuning policy and
    the cost record: the backward runs outside them)."""
    ctx = contextvars.copy_context()
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        return torch.utils.checkpoint.checkpoint(
            lambda *a: ctx.run(fn, *a), *args, use_reentrant=False,
            preserve_rng_state=False)


def _remat_block(block, x, cfg: ArchConfig, positions, sp, rows=None):
    """One block checkpointed (:func:`checkpointed`; the reference's
    ``jax.checkpoint``), recomputed first in its backward
    (:class:`_Recompute`): a moe block's recompute routes again, its
    counts' exchange included, in the same order on every rank."""
    def run(blk, xx):
        return _Recompute.apply(
            _block_apply(blk, xx, cfg, 0, positions=positions, sp=sp,
                         rows=rows)[0])
    return checkpointed(run, block, x)


def features(params, batch, cfg: ArchConfig, rows=None):
    """Forward through the blocks only (pre-ln_f hidden states).  When
    autograd records and ``cfg.remat``, each block runs checkpointed
    (:func:`_remat_block`), as the reference's training forward.
    ``rows``: ``(lo, hi, B)``, this rank's rows of a batch of B under a
    mesh (``launch.steps.make_train_step`` passes them), for the moe
    block's routing groups."""
    _check_family(cfg)
    x, sp = _seq_parallel(_embed_inputs(params, batch, cfg))
    positions = batch.get("positions")
    remat = cfg.remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in bridge.flatten(params["layers"]).values())
    blocks = unstack(params["layers"], cfg.num_layers)
    if remat and x.device.type == "meta":
        x = _meta_layers(blocks[0], x, cfg, positions, sp, rows)
    elif remat:
        for block in blocks:
            x = _remat_block(block, x, cfg, positions, sp, rows)
    else:
        for block in blocks:
            x = _block_apply(block, x, cfg, 0, positions=positions,
                             sp=sp, rows=rows)[0]
    return _unchunk(x, sp, replicated=True)


def _meta_layers(block, x, cfg: ArchConfig, positions, sp, rows=None):
    """The checkpointed layers on ``meta`` (shapes only; a dry run): every
    layer runs the same ops on the same shapes, so layer 0 runs for all,
    its forward, recompute and backward counted ``num_layers`` times
    (``cost.repeated``, ``cost.repeated_grad``), and stand-ins for the
    other layers' saved inputs hold their memory until its backward."""
    n = cfg.num_layers
    keep = [x.new_empty(x.shape) for _ in range(n - 1)]
    named = bridge.flatten(block)
    # the region's inputs: x, and the layer's parameters (the first
    # layer's x carries no gradient)
    marked, close = cost.repeated_grad(n, x, *named.values(), keep=keep)
    del keep
    leaves = dict(zip(named, marked[1:]))
    block = bridge.map_named(block, lambda k, _: leaves[k])
    with cost.repeated(n):
        return close(_remat_block(block, marked[0], cfg, positions, sp,
                                  rows))


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
                decode=False, sp=None, s=None):
    """Every layer against its cache slice; the caches' K/V are written in
    place and the stacked lengths advanced.  Under a mesh that splits the
    batch the cache holds the rank's rows and its lengths stay whole: the
    layers read the rank's rows of them, and every row advances by the
    ``s`` tokens of this call, as every row of a step does."""
    cl = cache["layers"]
    rows = moe_rows = None
    whole = cl["length"].shape[1]
    if whole != x.shape[0]:
        rows = shd.batch_block(whole)
    mesh = shd.current_mesh()
    if cfg.family == "moe" and mesh is not None and mesh.size > 1:
        moe_rows = (*shd.batch_block(whole), whole)
    lengths = []
    # on meta (shapes only) every layer runs the same ops on the same
    # shapes (the reference's scanned body): one runs for all of them
    n = 1 if x.device.type == "meta" else cfg.num_layers
    with cost.repeated(cfg.num_layers // n):
        for i in range(n):
            lc = layer(cl, i)
            if rows is not None:
                lc = {**lc, "length": lc["length"][rows[0]:rows[1]]}
            x, nc = _block_apply(layer(params["layers"], i), x, cfg, 0,
                                 positions=positions, cache=lc,
                                 decode=decode, sp=sp, rows=moe_rows)
            lengths.append(nc["length"])
    lengths *= cfg.num_layers // n
    if rows is None:
        cl["length"].copy_(torch.stack(lengths))
    else:
        cl["length"].add_(s)
    return x, cache


def prefill(params, batch, cfg: ArchConfig, cache,
            whole_logits: bool = True):
    """Prompt into ``cache`` (``tokens`` [B, S] or [B, S, Q] and/or
    ``embeds`` [B, S, d]; ``positions`` [B, S], or [B, S, 3] for
    M-RoPE); logits of the last position (``apply_head``'s
    ``whole_logits``)."""
    _check_family(cfg)
    x = _embed_inputs(params, batch, cfg)
    s = x.shape[1]
    x, sp = _seq_parallel(x)
    x, cache = _run_layers(params, x, cfg, cache,
                           positions=batch.get("positions"), sp=sp, s=s)
    if sp is not None:            # the last position, from its owner
        mesh, axis = shd.model_axis()
        x = shd.move_rows(x, sp, [(s - 1, s)] * len(sp), mesh, axis,
                          "gather", dim=1)
    else:
        x = x[:, -1:, :]
    return _readout(params, x, cfg, whole_logits), cache


def decode_step(params, tokens, cfg: ArchConfig, cache,
                whole_logits: bool = True):
    """One token per sequence against the KV cache; tokens [B, 1] (or
    [B, 1, Q] codebooks, or a [B, k] verify block, see
    :func:`verify_step`)."""
    _check_family(cfg)
    x = shd.shard(_token_embed(params, tokens, cfg), None, None, "embed")
    x, cache = _run_layers(params, x, cfg, cache, decode=True,
                           s=x.shape[1])
    return _readout(params, x, cfg, whole_logits), cache


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
