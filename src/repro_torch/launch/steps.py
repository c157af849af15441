"""Step builders for training and serving (port of
``repro.launch.steps``, single device):

  train_step   : fwd + bwd (branch-only grads) + AdamW + metrics
  prefill_step : full-sequence forward writing a fresh KV cache
  serve_step   : one decode token against the cache

``input_specs`` gives each step's inputs as meta-device tensors (shapes
and dtypes, no allocation).  The multi-device half of the reference
(batch and cache shardings, model-state shardings) waits for ROADMAP
Queue 1 item 5.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import bridge, deploy, optim
from repro_torch.core import rebranch
from repro_torch.models.config import ArchConfig


# ---------------------------------------------------------------------------
# input specs (meta-device stand-ins; no allocation)
# ---------------------------------------------------------------------------

def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, seq_len: int, global_batch: int,
                kind: str) -> dict:
    """Stand-ins for every model input of a step of the given kind:
    int32 tokens ([B, S], or [B, S, Q] codebooks; [B, 1(, Q)] to decode),
    labels to train, and the vlm's bf16 frontend embeddings [B, S, d]."""
    i32 = torch.int32
    tok_shape = ((global_batch, seq_len, cfg.num_codebooks)
                 if cfg.num_codebooks else (global_batch, seq_len))
    if kind in ("train", "prefill"):
        specs = {"tokens": _spec(tok_shape, i32)}
        if kind == "train":
            specs["labels"] = _spec(tok_shape, i32)
        if cfg.family == "vlm":
            specs["embeds"] = _spec((global_batch, seq_len, cfg.d_model),
                                    torch.bfloat16)
        return specs
    if kind == "decode":
        one = ((global_batch, 1, cfg.num_codebooks)
               if cfg.num_codebooks else (global_batch, 1))
        return {"tokens": _spec(one, i32)}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _ce_sum(logits, labels):
    """Sum over positions of logsumexp - the label's logit, in f32.  The
    label's logit is gathered: the reference contracts with a one-hot,
    which picks the same value exactly (every other product is 0)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = lf.gather(-1, labels.long()[..., None])[..., 0]
    return torch.sum(lse - picked)


def token_cross_entropy(logits, labels):
    """Mean CE over the last axis; [B, S, V] or [B, S, Q, V] logits."""
    return _ce_sum(logits, labels) / labels.numel()


def chunked_readout_loss(params, feats, labels, cfg: ArchConfig,
                         num_chunks: int = 8, model=None):
    """ln_f + readout + CE in sequence chunks, each under a non-reentrant
    ``torch.utils.checkpoint`` (the port of the reference's checkpointed
    scan): the full-vocab logits exist for one chunk at a time, and the
    backward recomputes each chunk's logits.  The chunk count falls to the
    largest divisor of S at or below ``num_chunks``, as the reference's.
    Labels are [B, S] or [B, S, Q] (multi-codebook logits [B, S, Q, V])."""
    model = model or deploy.compile_model(cfg)
    s = feats.shape[1]
    nc = num_chunks
    while s % nc:
        nc -= 1
    w = s // nc

    def chunk(xc, yc):
        return _ce_sum(model.apply_head(params, xc), yc)

    total = torch.zeros((), dtype=torch.float32, device=feats.device)
    for i in range(nc):
        total = total + torch.utils.checkpoint.checkpoint(
            chunk, feats[:, i * w:(i + 1) * w], labels[:, i * w:(i + 1) * w],
            use_reentrant=False)
    return total / labels.numel()


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def value_and_grad(loss_fn, trainable):
    """(loss, grads) of ``loss_fn(trainable)`` over every trainable leaf;
    a leaf the loss does not reach gets zeros (as ``jax.grad`` gives),
    not ``None``, so AdamW still decays it and its moments."""
    named = bridge.flatten(trainable)
    leaves = {k: v.detach().requires_grad_(True) for k, v in named.items()}
    with torch.enable_grad():
        loss = loss_fn(bridge.map_named(trainable, lambda k, _: leaves[k]))
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    grads = dict(zip(leaves, grads))
    return loss.detach(), bridge.map_named(
        trainable, lambda k, p: torch.zeros_like(p) if grads[k] is None
        else grads[k])


def make_train_step(cfg: ArchConfig, opt_cfg: optim.AdamWConfig | None = None,
                    lr_fn=None, loss_chunks: int = 8, model=None):
    """``train_step(trainable, frozen, opt_state, batch) -> (new_trainable,
    new_opt_state, {"loss", "grad_norm", "lr"})``: the gradient of the
    chunked readout loss over the trainable (SRAM) tree only, then one
    AdamW step at ``lr_fn(step)`` (or ``opt_cfg.lr``).  The frozen (ROM)
    tree is read, never written: the trunk ops' straight-through backward
    gives no gradient for it."""
    opt_cfg = opt_cfg or optim.AdamWConfig()
    model = model or deploy.compile_model(cfg)

    def train_step(trainable, frozen, opt_state, batch):
        def loss_fn(t):
            params = rebranch.combine(t, frozen)
            feats = model.features(params, batch)
            return chunked_readout_loss(params, feats, batch["labels"],
                                        cfg, loss_chunks, model=model)

        loss, grads = value_and_grad(loss_fn, trainable)
        lr = lr_fn(opt_state["step"]) if lr_fn else opt_cfg.lr
        new_t, new_opt, m = optim.update(grads, opt_state, trainable,
                                         opt_cfg, lr=lr)
        metrics = {"loss": loss, "grad_norm": m["grad_norm"],
                   "lr": torch.as_tensor(lr, dtype=torch.float32,
                                         device=loss.device)}
        return new_t, new_opt, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, global_batch: int, seq_len: int,
                      model=None, *, device=None):
    """``prefill_step(params, batch) -> (logits, cache)`` into a fresh
    cache on ``device`` (default: the CUDA card)."""
    model = model or deploy.compile_model(cfg)

    def prefill_step(params, batch):
        cache = model.init_cache(global_batch, seq_len, device=device)
        with torch.no_grad():
            return model.prefill(params, batch, cache)
    return prefill_step


def make_serve_step(cfg: ArchConfig, model=None):
    """``serve_step(params, batch, cache) -> (next_tok int32, cache)``:
    one greedy decode token; the cache is updated in place."""
    model = model or deploy.compile_model(cfg)

    def serve_step(params, batch, cache):
        with torch.no_grad():
            logits, cache = model.decode_step(params, batch["tokens"], cache)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    return serve_step
