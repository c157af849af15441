"""Step builders for training and serving (port of
``repro.launch.steps``):

  train_step   : fwd + bwd (branch-only grads) + AdamW + metrics
  prefill_step : full-sequence forward writing a fresh KV cache
  serve_step   : one decode token against the cache

``input_specs`` gives each step's inputs as meta-device tensors (shapes
and dtypes, no allocation).  The sharding half is the reference's
(``batch_pspec`` / ``batch_shardings``, ``cache_pspecs`` /
``cache_shardings``, ``model_state_shardings``), as the port's
``sharding.NamedSharding`` records.

Under a bound mesh of more than one rank a train step is data-parallel
over the batch axes (``pod``, ``data``): each rank computes the loss on
what it holds (an LM rank its block of the batch; a CNN rank the whole
output, gathered from every rank's slab), and every trainable gradient
is all-reduced as a mean over those axes before AdamW.  Over a ``model``
axis (dense LMs) the step is tensor-parallel as serving is: each model
rank keeps its blocks of the parameters and their gradients, the leaves
it holds whole are reduced to the same gradient on every model rank, the
loss is the vocab-parallel cross entropy (:func:`chunked_readout_loss`)
and the clip's norm is the whole tree's (``optim.adamw.global_norm``),
so the update is one process's on every rank.

Serving runs over a ``(data, model)`` mesh: the prefill and serve steps
of a model compiled with ``mesh=`` take the whole batch on every rank,
run the rank's rows (:func:`local_batch`) tensor-parallel on its block
of the parameters (``CompiledModel.shard_params``) and cache, and return
the logits and next tokens whole and bitwise equal on every rank; the
next token is a distributed argmax over the vocab-parallel logits
(``sharding.vocab_argmax``).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

from repro_torch import bridge, deploy, optim
from repro_torch.core import rebranch
from repro_torch.distributed import sharding as shd
from repro_torch.launch import cost
from repro_torch.models import api, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.optim import compress as compress_lib

P = shd.PartitionSpec


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


def batch_pspec(cfg: ArchConfig, mesh, global_batch: int):
    """The batch dim's spec part for token-like inputs: over pod+data, or
    replicated (None) for a batch smaller than those axes."""
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    total = math.prod(mesh.shape[a] for a in axes)
    if global_batch >= total:
        return tuple(axes) if len(axes) > 1 else axes[0]
    return None


def batch_shardings(cfg: ArchConfig, mesh, specs: dict, global_batch: int):
    """A :class:`~repro_torch.distributed.sharding.NamedSharding` per input
    of ``specs``: the batch dim by :func:`batch_pspec`, the rest whole."""
    b = batch_pspec(cfg, mesh, global_batch)

    def one(s):
        if s.dim() >= 2:
            return shd.NamedSharding(mesh, P(b, *([None] * (s.dim() - 1))))
        return shd.NamedSharding(mesh, P())
    return {k: one(v) for k, v in specs.items()}


def local_batch(cfg: ArchConfig, mesh, batch: dict, global_batch: int):
    """This rank's block of every input of a whole ``batch``."""
    sh = batch_shardings(cfg, mesh, batch, global_batch)
    return {k: shd.local_block(v, sh[k]) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# cache specs + shardings
# ---------------------------------------------------------------------------

def cache_specs(cfg: ArchConfig, global_batch: int, max_len: int):
    """The cache tree of a ``global_batch`` x ``max_len`` decode as meta
    tensors (no allocation)."""
    model = deploy.compile_model(cfg)
    return model.init_cache(global_batch, max_len, device="meta")


def cache_pspecs(cfg: ArchConfig, mesh, cache_tree):
    """Path+shape-aware PartitionSpecs for KV/SSM caches (the
    reference's rules, ``sharding.cache_spec``)."""
    return bridge.map_named(cache_tree,
                            lambda p, leaf: shd.cache_spec(p, leaf, mesh))


def cache_shardings(cfg: ArchConfig, mesh, cache_tree):
    return bridge.map_named(cache_tree, lambda p, leaf: shd.NamedSharding(
        mesh, shd.cache_spec(p, leaf, mesh)))


def model_state_shardings(cfg, mesh, model=None):
    """(trainable, frozen, opt) shardings and the parameter shapes (meta
    tensors), without allocating parameters; ``None`` where the other
    side of the ROM/SRAM split holds a leaf.  LM and CNN configs."""
    model = model or deploy.compile_model(cfg)
    shapes = bridge.abstract(lambda: model.init(seed=0, device="cpu"))
    with shd.use_mesh(mesh):
        t_sh, f_sh = rebranch.partition(shd.param_shardings(shapes, mesh))
    opt_sh = {"step": shd.NamedSharding(mesh, P()), "m": t_sh, "v": t_sh}
    return t_sh, f_sh, opt_sh, shapes


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


def _ce_sum_vocab(logits, labels, vocab: int, mesh, axis):
    """:func:`_ce_sum` of the whole logits from this rank's vocab columns
    (GSPMD's even layout over the model axis), the reference's one-hot
    contraction plus one psum: the max over the ranks (a shift, out of
    the graph), then one rank-order sum of each rank's sum of exp and of
    the label's logit from the rank that holds it (0 elsewhere).  The
    loss is equal on every rank; the logits' gradient is each rank's
    columns of the softmax less the one-hot."""
    lo, hi = shd.h_layout(vocab, mesh.shape[axis])[mesh.coordinate(axis)]
    lf = logits.float()
    big = shd.rank_max(lf.amax(dim=-1), mesh, axis, "loss")
    sum_exp = torch.exp(lf - big[..., None]).sum(dim=-1)
    local = labels.long() - lo
    own = (local >= 0) & (local < hi - lo)
    picked = lf.gather(-1, local.clamp(0, hi - lo - 1)[..., None])[..., 0]
    picked = torch.where(own, picked, torch.zeros((), device=lf.device))
    tot = shd.reduce_model(torch.stack([sum_exp, picked], dim=-1), "loss",
                           at=(mesh, axis))
    return torch.sum(torch.log(tot[..., 0]) + big - tot[..., 1])


def token_cross_entropy(logits, labels):
    """Mean CE over the last axis; [B, S, V] or [B, S, Q, V] logits."""
    return _ce_sum(logits, labels) / labels.numel()


def chunked_readout_loss(params, feats, labels, cfg: ArchConfig,
                         num_chunks: int = 8, model=None, count=None):
    """ln_f + readout + CE in sequence chunks, each under a non-reentrant
    ``torch.utils.checkpoint`` (the port of the reference's checkpointed
    scan): the full-vocab logits exist for one chunk at a time, and the
    backward recomputes each chunk's logits.  The chunk count falls to the
    largest divisor of S at or below ``num_chunks``, as the reference's.
    Labels are [B, S] or [B, S, Q] (multi-codebook logits [B, S, Q, V]).
    Over a model axis a vocab-parallel readout's logits stay the rank's
    columns (:func:`_ce_sum_vocab`): whole logits are never formed.  The
    sum is divided by ``count`` (default: the labels' own count)."""
    model = model or deploy.compile_model(cfg)
    s = feats.shape[1]
    nc = num_chunks
    while s % nc:
        nc -= 1
    w = s // nc
    at = shd.model_axis(model.mesh)

    def chunk(xc, yc):
        if at is None:
            return _ce_sum(model.apply_head(params, xc), yc)
        logits = model.apply_head(params, xc, whole_logits=False)
        if logits.shape[-1] == cfg.vocab_size:      # a readout kept whole
            return _ce_sum(logits, yc)
        return _ce_sum_vocab(logits, yc, cfg.vocab_size, *at)

    total = torch.zeros((), dtype=torch.float32, device=feats.device)
    for i in range(nc):
        total = total + transformer.checkpointed(
            chunk, feats[:, i * w:(i + 1) * w], labels[:, i * w:(i + 1) * w])
    return total / (labels.numel() if count is None else count)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def value_and_grad(loss_fn, trainable, partial: set | None = None):
    """(loss, grads) of ``loss_fn(trainable)`` over every trainable leaf;
    a leaf the loss does not reach gets zeros (as ``jax.grad`` gives),
    not ``None``, so AdamW still decays it and its moments.  ``partial``
    gets the names of the leaves the forward marked as used by this rank
    its own way (``sharding.mark_partial``)."""
    named = bridge.flatten(trainable)
    leaves = {k: v.detach().requires_grad_(True) for k, v in named.items()}
    with torch.enable_grad(), shd.partial_leaves() as seen:
        loss = loss_fn(bridge.map_named(trainable, lambda k, _: leaves[k]))
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    if partial is not None:
        partial.update(k for k, v in leaves.items() if id(v) in seen)
    grads = dict(zip(leaves, grads))
    return loss.detach(), bridge.map_named(
        trainable, lambda k, p: torch.zeros_like(p) if grads[k] is None
        else grads[k])


def train_mesh(mesh=None):
    """The mesh a train step reduces over (``mesh``, else the bound one),
    or None when there is none or it has one rank."""
    mesh = mesh or shd.current_mesh()
    if mesh is None or mesh.size == 1:
        return None
    return mesh


def reduce_partial(grads, names, mesh):
    """The gradients of the leaves ``names`` (held whole on every model
    rank, each rank's gradient a part of the whole) summed over the model
    axis in rank order, all in one f32 exchange (``"grads"``): the same
    bits on every model rank.  ``grads`` itself without a model axis."""
    at = shd.model_axis(mesh)
    named = bridge.flatten(grads)
    keys = [k for k in named if k in names]
    if at is None or not keys:
        return grads
    flat = shd.sum_parts(torch.cat([named[k].reshape(-1).float()
                                    for k in keys]), *at, "grads")
    out, i = dict(named), 0
    for k in keys:
        g = named[k]
        out[k] = flat[i:i + g.numel()].reshape(g.shape).to(g.dtype)
        i += g.numel()
    return bridge.map_named(grads, lambda k, _: out[k])


def reduce_grads(loss, grads, mesh):
    """(loss, grads) as means over the batch axes of ``mesh``
    (``sharding.batch_axes``: ``pod`` and ``data``; each model rank keeps
    its blocks): every leaf and the loss packed into one f32 buffer, one
    all-reduce (SUM) on each axis' group, the innermost first (host
    buffers for CUDA tensors over gloo), divided by the ranks they
    span."""
    axes = shd.batch_axes(mesh)
    if not axes:
        return loss, grads
    named = bridge.flatten(grads)
    flat = torch.cat([loss.reshape(1).float()]
                     + [g.reshape(-1).float() for g in named.values()])
    buf = flat
    for a in reversed(axes):
        group = mesh.group(a)
        host = (dist.get_backend(group) != "nccl"
                and flat.device.type == "cuda")
        buf = buf.cpu() if host else buf
        dist.all_reduce(buf, group=group)
        compress_lib.count_wire("f32", buf.numel() * 4)
    flat = buf.to(flat.device) / math.prod(mesh.shape[a] for a in axes)
    out, at = {}, 1
    for k, g in named.items():
        out[k] = flat[at:at + g.numel()].reshape(g.shape).to(g.dtype)
        at += g.numel()
    return (flat[0].to(loss.dtype),
            bridge.map_named(grads, lambda k, _: out[k]))


class BranchStep:
    """``step(trainable, frozen, opt_state, batch) -> (new_trainable,
    new_opt_state, {"loss", "grad_norm", "lr"})``: the gradient of
    ``loss_fn(params, batch)`` over the trainable (SRAM) tree only, then
    one AdamW step at ``lr_fn(step)`` (or ``opt_cfg.lr``).  The frozen
    (ROM) tree is read, never written: the trunk ops' straight-through
    backward gives no gradient for it.

    Called under a bound mesh of more than one rank
    (``sharding.use_mesh``, or ``mesh``), :meth:`grads` sums over the
    model axis the gradients of the leaves each model rank holds whole
    but uses its own way (:func:`reduce_partial`), then all-reduces the
    loss and every gradient as a mean over the batch axes before AdamW,
    so ``grad_norm`` (over the whole tree: ``split`` gives, per mesh, the
    leaves the model ranks hold in blocks), clipping and the update are
    one process's on every rank.  With ``compress=True`` the batch mean
    goes through the error-feedback int8 all-reduce (``optim.compress``);
    its error state lives in this object, one per rank, and is not
    checkpointed (a restored run starts it at zero).  Without a mesh
    there is nothing to reduce, so ``compress`` changes nothing."""

    def __init__(self, loss_fn, opt_cfg: optim.AdamWConfig | None = None,
                 lr_fn=None, *, compress: bool = False, split=None,
                 mesh=None):
        self.loss_fn = loss_fn
        self.opt_cfg = opt_cfg or optim.AdamWConfig()
        self.lr_fn = lr_fn
        self.compress = compress
        self.split = split
        self.mesh = mesh
        self.err = None
        self._split_of = {}

    def split_leaves(self, mesh) -> set:
        """The trainable leaves the ranks of ``mesh``'s model axis hold in
        blocks (none without ``split`` or a model axis)."""
        if self.split is None or mesh is None:
            return set()
        if id(mesh) not in self._split_of:
            self._split_of[id(mesh)] = (mesh, self.split(mesh))
        return self._split_of[id(mesh)][1]

    def grads(self, trainable, frozen, batch):
        """(loss, grads), reduced over the mesh's ranks when there is
        one."""
        partial = set()
        loss, grads = value_and_grad(
            lambda t: self.loss_fn(rebranch.combine(t, frozen), batch),
            trainable, partial)
        mesh = train_mesh(self.mesh)
        if mesh is None:
            return loss, grads
        grads = reduce_partial(grads, partial, mesh)
        if not self.compress or not shd.batch_axes(mesh):
            return reduce_grads(loss, grads, mesh)
        if self.err is None:
            self.err = compress_lib.init_error_state(grads)
        grads, self.err = compress_lib.tree_all_reduce_int8(grads, self.err,
                                                            mesh)
        loss, _ = reduce_grads(loss, {}, mesh)
        return loss, grads

    def __call__(self, trainable, frozen, opt_state, batch):
        loss, grads = self.grads(trainable, frozen, batch)
        return self.update(trainable, opt_state, loss, grads)

    def update(self, trainable, opt_state, loss, grads):
        """The AdamW half of a step on :meth:`grads`' (loss, grads)."""
        lr = self.lr_fn(opt_state["step"]) if self.lr_fn else self.opt_cfg.lr
        mesh = train_mesh(self.mesh)
        with shd.use_mesh(mesh) if mesh is not None else \
                contextlib.nullcontext():
            new_t, new_opt, m = optim.update(
                grads, opt_state, trainable, self.opt_cfg, lr=lr,
                split=self.split_leaves(mesh))
        metrics = {"loss": loss, "grad_norm": m["grad_norm"],
                   "lr": torch.as_tensor(lr, dtype=torch.float32,
                                         device=loss.device)}
        return new_t, new_opt, metrics


def make_train_step(cfg: ArchConfig, opt_cfg: optim.AdamWConfig | None = None,
                    lr_fn=None, loss_chunks: int = 8, model=None, *,
                    compress: bool = False,
                    global_batch: int | None = None) -> BranchStep:
    """The LM train step: a :class:`BranchStep` on the chunked readout
    loss of ``model.features``.  Under a mesh (bound, or the model's)
    each rank passes its block of the batch (:func:`local_batch`) and of
    the parameters (``CompiledModel.shard_params``), and over batch axes
    ``global_batch``, the batch's whole size B (a rank's block does not
    fix it: GSPMD's uneven layout gives 2 rows to rank 0 of 4 for any B
    from 5 to 8).  The loss is the global mean over the batch's tokens
    whatever the layout: each rank divides its token sum by the global
    count over the number of batch ranks (on equal blocks its own
    count), so the step's mean over the batch ranks is the global mean
    (a rank without rows adds zeros), and the moe block routes the whole
    batch's groups (``rows=(lo, hi, B)``).  The dense and moe families
    train over a mesh (``api.check_mesh``)."""
    model = model or deploy.compile_model(cfg)

    def loss_fn(params, batch):
        mesh = model.mesh or shd.current_mesh()
        api.check_mesh(cfg, mesh)
        labels = batch["labels"]
        kw, count = {}, None
        if train_mesh(mesh) is not None:
            big = _global_rows(mesh, labels.shape[0], global_batch)
            lo, hi = shd.batch_block(big, mesh)
            kw["rows"] = (lo, hi, big)
            if hi - lo < big:   # else the batch is whole on every rank
                count = big * math.prod(labels.shape[1:]) / math.prod(
                    mesh.shape[a] for a in shd.batch_axes(mesh))
        with shd.use_mesh(mesh) if mesh is not None else \
                contextlib.nullcontext():
            feats = model.features(params, batch, **kw)
            return chunked_readout_loss(params, feats, labels, cfg,
                                        loss_chunks, model=model,
                                        count=count)

    def split(mesh):
        with cost.untracked():              # shapes only
            shapes = bridge.abstract(lambda: model.init(seed=0,
                                                        device="cpu"))
        return model.split_leaves(shapes, mesh)

    return BranchStep(loss_fn, opt_cfg, lr_fn, compress=compress,
                      split=split, mesh=model.mesh)


def _global_rows(mesh, rows: int, global_batch: int | None) -> int:
    """The batch's whole size B from a rank's ``rows`` of it: B itself
    where the mesh splits no batch; else ``global_batch``, checked
    against the rank's block."""
    axes = shd.batch_axes(mesh)
    if global_batch is None:
        if axes:
            raise ValueError(
                f"a train step over the batch axes {axes} needs the "
                f"batch's whole size: make_train_step(global_batch=B)")
        return rows
    lo, hi = shd.batch_block(global_batch, mesh)
    if hi - lo != rows:
        raise ValueError(f"{rows} rows are not this rank's block "
                         f"{(lo, hi)} of a batch of {global_batch}")
    return global_batch


def gather_rows(x: torch.Tensor, mesh, global_batch: int) -> torch.Tensor:
    """The whole batch (dim 0) of ``global_batch`` rows on every rank from
    the ranks' blocks of :func:`local_batch` (``x`` itself when the batch
    is not split): over ``pod`` and ``data`` the blocks are dealt to the
    two axes flattened in mesh order, and gathered one axis at a time
    (``sharding.gather_flat``)."""
    lo, hi = shd.batch_block(global_batch, mesh)
    if hi - lo == global_batch:
        return x
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    return shd.gather_flat(x, global_batch, mesh, axes, dim=0)


def _serving_mesh(model):
    mesh = model.mesh
    return None if mesh is None or mesh.size == 1 else mesh


def make_prefill_step(cfg: ArchConfig, global_batch: int, seq_len: int,
                      model=None, *, device=None):
    """``prefill_step(params, batch) -> (logits, cache)`` into a fresh
    cache on ``device`` (default: the CUDA card).  Under the model's mesh
    every rank passes the whole batch and its block of the parameters;
    the cache is the rank's block, the logits come back whole."""
    model = model or deploy.compile_model(cfg)

    def prefill_step(params, batch):
        cache = model.init_cache(global_batch, seq_len, device=device)
        mesh = _serving_mesh(model)
        with torch.no_grad():
            if mesh is None:
                return model.prefill(params, batch, cache)
            local = local_batch(cfg, mesh, batch, global_batch)
            logits, cache = model.prefill(params, local, cache)
            return gather_rows(logits, mesh, global_batch), cache
    return prefill_step


def make_serve_step(cfg: ArchConfig, model=None):
    """``serve_step(params, batch, cache) -> (next_tok int32, cache)``:
    one greedy decode token; the cache is updated in place.  Under the
    model's mesh every rank passes the whole batch, its blocks of the
    parameters and cache; the next tokens (a distributed argmax over the
    rank's vocab columns, ``torch.argmax``'s tie rule) come back whole."""
    model = model or deploy.compile_model(cfg)

    def serve_step(params, batch, cache):
        mesh = _serving_mesh(model)
        with torch.no_grad():
            if mesh is None:
                logits, cache = model.decode_step(params, batch["tokens"],
                                                  cache)
                return torch.argmax(logits, dim=-1).to(torch.int32), cache
            b = batch["tokens"].shape[0]
            local = local_batch(cfg, mesh, batch, b)
            logits, cache = model.decode_step(params, local["tokens"], cache,
                                              whole_logits=False)
            with shd.use_mesh(mesh):
                tok = shd.vocab_argmax(logits, cfg.vocab_size)
            return gather_rows(tok.to(torch.int32), mesh, b), cache
    return serve_step
