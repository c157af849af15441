"""Mixture-of-Experts block (granite-moe, qwen2-moe) with ReBranch experts
(port of ``repro.models.moe``).

Dispatch is the reference's grouped capacity scheme: tokens are split into
groups of ``moe_group_size``; within a group every token's top-k experts
get a capacity slot, in token order, round by round over the k choices; a
choice past the capacity is dropped.  The reference moves tokens with
one-hot dispatch/combine einsums; the port moves them with an index per
kept (token, expert, slot) assignment, which gives the same slots (each
holds at most one token).  As in the reference the dispatched tokens go
through bf16 (``moe.py:169-171``), whatever the activation dtype.

ReBranch on experts: the stacked trunk ``w_q`` [E, d_in, d_out] is frozen
int8 ROM with per-(expert, output channel) scales; the branch shares one
fixed compress/decompress pair (C, U) across the experts and keeps a
per-expert trainable core [E, d_in/D, d_out/U].  The router and the
shared-expert gate stay trainable ("SRAM").

The stacked trunk is plain PyTorch, as it is plain ``dot_general`` in the
reference: the int8 codes are multiplied as f32 on K-chunks of at most
:data:`EXACT_K` rows, where every partial sum is an integer below 2**24
and so exact in f32 whatever the summation order (on the card too); the
chunks are added in int32 and cast to f32 once, as the reference's int32
accumulation is.

Over a mesh (serving) the block follows the reference's expert policy
(``sharding.expert_layout``):

* ``"expert"`` (E divides the model axis): each rank routes the tokens it
  holds with the whole router, fills the dispatched stack of its E/m
  experts only, runs its stacked linears on them and combines its kept
  choices (ascending expert order) into a partial output; the partials
  are summed over the model axis in rank order (``sharding.sum_parts``,
  or ``sum_chunk`` onto the rank's sequence chunk under ``seq_sp``).
* ``"expert_mlp"``: gate and up on the rank's ff columns; down
  row-parallel on its ff rows, each row quantised at the whole row's
  absmax, the integer partials added in int32 before the one scale (the
  trunk bitwise the unsharded one's), the branch's t1 summed onto the
  rank's d_c block of the core and its product summed in rank order; the
  combine is then local.
* ``"whole"``: every rank runs the unsharded block.

Routing groups are the whole batch's (:func:`token_groups`): a rank
holding some rows of the batch routes its tokens in the global token
order, and where a group spans ranks of the batch axes it offsets its
capacity slots by the other ranks' per-round, per-expert counts (one
small all-gather, which a rank without rows joins too); each rank fills
only its own tokens' slots.

Training over a mesh keeps ``sharding``'s convention (Megatron's): a
tensor whole on every model rank carries its whole gradient wherever
every rank uses it alike.  The partial outputs' sum feeds such work (its
adjoint the identity; under ``seq_sp`` a gather of the chunks'
gradients); where a rank uses a whole tensor its own way it enters it
through ``sharding.replicate`` (an ``expert`` rank's routing and
dispatch, which reach its experts only; ``expert_mlp``'s gate and up on
the rank's ff columns, or under ``seq_sp`` the combine on its chunk),
and the leaves so used are marked partial (:func:`_mark_partial`).  The
row-parallel down's trunk is straight-through on the rank's ff rows
(:class:`_RowTrunkSTE`); the routing counts carry no gradient.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig

# 127 * 127 * EXACT_K < 2**24: an f32 dot of int8 codes over this many
# rows holds its exact integer value
EXACT_K = 1040


# ---------------------------------------------------------------------------
# stacked ReBranch expert linear
# ---------------------------------------------------------------------------

def init_expert_linear(gen: torch.Generator, n_exp: int, d_in: int,
                       d_out: int, spec):
    """Stacked expert linear drawn from ``gen`` on its device (trunk, C,
    U): int8 W [E, d_in, d_out], one shared C/U, a zero core per expert;
    a disabled spec (SRAM residency) is a plain trainable stack."""
    dev = gen.device
    w = torch.randn((n_exp, d_in, d_out), generator=gen, device=dev,
                    dtype=torch.float32) / math.sqrt(d_in)
    if not spec.enabled:
        return {"sram": {"w": w}}
    w_q, w_scale = quant.quantize_weights(w, axis=1)      # scale [E,1,out]
    del w
    d_c = max(1, d_in // spec.d_ratio)
    d_u = max(1, d_out // spec.u_ratio)
    dt = spec.param_dtype
    return {
        "rom": {
            "w_q": w_q, "w_scale": w_scale.to(dt),
            "C": torch.randn((d_in, d_c), generator=gen, device=dev,
                             dtype=dt) / math.sqrt(d_in),
            "U": torch.randn((d_u, d_out), generator=gen, device=dev,
                             dtype=dt) / math.sqrt(d_u),
        },
        "sram": {"core": torch.zeros((n_exp, d_c, d_u), dtype=dt,
                                     device=dev)},
    }


def int8_bmm_int32(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int8 batched product [E, C, K] x [E, K, N] as int32:
    f32 products on K-chunks of at most :data:`EXACT_K` (each exact),
    added in int32."""
    acc = None
    for k0 in range(0, x_q.shape[-1], EXACT_K):
        part = torch.bmm(x_q[..., k0:k0 + EXACT_K].float(),
                         w_q[:, k0:k0 + EXACT_K].float()).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def int8_bmm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int8 batched product [E, C, K] x [E, K, N] -> f32 [E, C, N]:
    f32 products on K-chunks of at most :data:`EXACT_K` (each exact),
    added in int32, cast to f32 once."""
    if x_q.shape[-1] <= EXACT_K:
        return torch.bmm(x_q.float(), w_q.float())
    return int8_bmm_int32(x_q, w_q).float()


class _StackedTrunkMatmul(torch.autograd.Function):
    """y[e] = quant(x[e]) @ w_q[e] * scales; straight-through backward."""

    @staticmethod
    def forward(ctx, x, w_q, w_scale):
        x_q, sx = quant.quantize_activations(x)             # [E, C, d]
        out = int8_bmm(x_q, w_q)
        ctx.save_for_backward(w_q, w_scale)
        return (out * sx * w_scale.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        w_q, w_scale = ctx.saved_tensors
        w_deq = w_q.to(g.dtype) * w_scale.to(g.dtype)      # [E, d, f]
        return g @ w_deq.transpose(1, 2), None, None


def stacked_trunk_matmul(x, w_q, w_scale):
    """The stacked expert trunk, x [E, C, d_in] -> [E, C, d_out]."""
    return _StackedTrunkMatmul.apply(x, w_q, w_scale)


def apply_expert_linear(params, x):
    """x: [E, C, d_in] -> [E, C, d_out]: the trunk plus the reassociated
    branch ``(x @ C) @ (core[e] @ U)``; an SRAM-resident stack is a plain
    batched matmul."""
    if "rom" not in params:
        return torch.bmm(x, params["sram"]["w"].to(x.dtype))
    rom, sram = params["rom"], params["sram"]
    y = stacked_trunk_matmul(x, rom["w_q"], rom["w_scale"])
    t1 = x @ rom["C"].to(x.dtype)                          # [E, C, dc]
    cu = sram["core"].to(x.dtype) @ rom["U"].to(x.dtype)   # [E, dc, f]
    return y + torch.bmm(t1, cu)


# ---------------------------------------------------------------------------
# MoE block
# ---------------------------------------------------------------------------

def init_moe_block(gen: torch.Generator, cfg: ArchConfig):
    """Router, the three expert stacks, then (if any) the shared experts'
    MLP and their gate, drawn from ``gen`` in that order."""
    spec, dev = cfg.rebranch, gen.device
    d, ff, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts
    p = {
        "router": {"sram": {"w": torch.randn(
            (d, e), generator=gen, device=dev) / math.sqrt(d)}},
        "experts": {
            "gate": init_expert_linear(gen, e, d, ff, spec),
            "up": init_expert_linear(gen, e, d, ff, spec),
            "down": init_expert_linear(gen, e, ff, d, spec),
        },
    }
    if cfg.num_shared_experts:
        shared_ff = cfg.num_shared_experts * (cfg.moe_d_ff or cfg.d_ff)
        p["shared"] = layers.init_mlp(gen, cfg, d_ff=shared_ff)
        p["shared_gate"] = {"sram": {"w": torch.randn(
            (d, 1), generator=gen, device=dev) / math.sqrt(d)}}
    return p


def _capacity(cfg: ArchConfig) -> int:
    g, k, e = cfg.moe_group_size, cfg.num_experts_per_tok, cfg.num_experts
    c = int(math.ceil(g * k * cfg.moe_capacity_factor / e))
    return max(4, -(-c // 4) * 4)          # multiple of 4


@dataclasses.dataclass(frozen=True)
class Groups:
    """The reference's routing groups of a global batch as one rank sees
    them: the rank routes a frame of ``n`` whole groups of ``g`` tokens
    (global groups ``first``..``first + n - 1``) in which its ``t`` tokens
    start at ``off``, followed by the ``pad`` zero tokens that end the
    last group (the last holder's only).  ``spans`` (set where a group
    spans ranks of the batch axes ``axes`` of ``mesh``): per batch rank,
    its (first, last) group, None without tokens; ``rank`` is this one."""
    g: int
    n: int
    first: int = 0
    off: int = 0
    t: int = 0
    pad: int = 0
    spans: tuple = ()
    rank: int = 0
    mesh: object = None
    axes: tuple = ()

    def own(self, device) -> torch.Tensor | None:
        """[n, g] whether each frame position is this rank's to route (a
        token or a pad), None where all are."""
        if self.off == 0 and self.t + self.pad == self.n * self.g:
            return None
        pos = torch.arange(self.n * self.g, device=device)
        return ((pos >= self.off) & (pos < self.off + self.t + self.pad)
                ).reshape(self.n, self.g)

    def offsets(self, counts: torch.Tensor):
        """(before, total) [n, k, E] from this rank's per-round, per-expert
        counts [n, k, E] of each frame group: the counts of the batch
        ranks before this one in each group, and the group's whole
        counts, from the ranks' counts of their first and last groups
        all-gathered over the batch axes (set ``spans`` first)."""
        mine = counts.new_zeros((1, 2, *counts.shape[1:]))
        if self.n:
            mine[0, 0] = counts[0]
        if self.n > 1:
            mine[0, 1] = counts[-1]
        every = shd.gather_flat(mine, len(self.spans), self.mesh, self.axes,
                                dim=0, kind="routing")
        before, total = torch.zeros_like(counts), counts.clone()
        for q, span in enumerate(self.spans):
            if q == self.rank or span is None:
                continue
            ends = (span[0],) if span[0] == span[1] else span
            for slot, j in enumerate(ends):
                if self.first <= j < self.first + self.n:
                    total[j - self.first] += every[q, slot]
                    if q < self.rank:
                        before[j - self.first] += every[q, slot]
        return before, total


def token_groups(b: int, s: int, cfg: ArchConfig, rows=None) -> Groups:
    """The routing groups of the ``b`` x ``s`` tokens a rank holds: rows
    ``(lo, hi, B)`` of a batch of B split over the batch axes of the bound
    mesh (None: ``b`` rows are the whole batch).  The reference groups
    the global batch's tokens in order, ``g = min(moe_group_size, B*s)``,
    zero tokens padding the last group."""
    lo, hi, big = rows or (0, b, b)
    total = big * s
    g = max(1, min(cfg.moe_group_size, total))
    n_all = -(-total // g)
    pad_all = n_all * g - total

    def span(a: int, e: int):
        e += pad_all if e == total and e > a else 0
        return None if e == a else (a // g, -(-e // g) - 1)
    a = lo * s
    mine = span(a, hi * s)
    if mine is None:                 # no rows: routes nothing, but joins
        base = Groups(g=g, n=0, first=a // g)       # the counts' exchange
    else:
        first, last = mine
        base = Groups(g=g, n=last - first + 1, first=first,
                      off=a - first * g, t=(hi - lo) * s,
                      pad=pad_all if hi * s == total else 0)
    if rows is None or hi - lo == big:
        return base
    mesh = shd.current_mesh()
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    n_b = math.prod(mesh.shape[x] for x in axes)
    spans = tuple(span(x0 * s, x1 * s) for x0, x1 in shd.h_layout(big, n_b))
    held = [sp for sp in spans if sp is not None]
    if all(p[1] < q[0] for p, q in zip(held, held[1:])):
        return base                  # every group lies on one rank
    rank = 0
    for x in axes:
        rank = rank * mesh.shape[x] + mesh.coordinate(x)
    return dataclasses.replace(base, spans=spans, rank=rank, mesh=mesh,
                               axes=axes)


def route(params, xg, cfg: ArchConfig, groups: Groups | None = None):
    """The capacity dispatch of token groups xg [G, g, d]:
    (idx [G, g, k] the chosen experts, gates [G, g, k] their normalised
    probabilities, slot [G, g, k] each choice's capacity slot, keep
    [G, g, k] whether it got one).  Priority is token order within each of
    the k rounds, the rounds in order; a dropped choice still counts
    against its expert, as in the reference.  ``groups``: xg is a rank's
    frame of the global groups (:func:`token_groups`): only its own
    positions route, their slots offset by the other ranks' counts."""
    n_groups, g, _ = xg.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = xg.float() @ params["router"]["sram"]["w"]
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower expert index, as jax.lax.top_k (a
    # zero pad token's uniform probabilities tie everywhere)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]               # [G, g, k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    own = None if groups is None else groups.own(xg.device)

    def one_hot(j):                                         # [G, g, E]
        oh = F.one_hot(idx[..., j], e)
        return oh if own is None else oh * own[..., None]
    before = total = None
    if groups is not None and groups.spans:
        before, total = groups.offsets(torch.stack(
            [one_hot(j).sum(1) for j in range(k)], dim=1))
    counts = torch.zeros((n_groups, e), dtype=torch.int64, device=xg.device)
    slots = []
    for j in range(k):
        oh = one_hot(j)
        ahead = counts if total is None else counts + before[:, j]
        pos = torch.cumsum(oh, dim=1) - oh + ahead[:, None, :]
        slots.append((pos * oh).sum(-1))                    # [G, g]
        counts = counts + (oh.sum(1) if total is None else total[:, j])
    slot = torch.stack(slots, dim=-1)
    keep = slot < _capacity(cfg)
    return idx, gates, slot, keep if own is None else keep & own[..., None]


def _experts_held(params, cfg: ArchConfig):
    """(layout, first expert, end expert) of this rank's expert blocks
    (``sharding.expert_layout``; layout None without a model axis)."""
    e, ff = cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
    layout = shd.expert_layout(e, ff)
    lo, hi, cols = 0, e, ff
    if layout in ("expert", "expert_mlp"):
        mesh, axis = shd.model_axis()
        m = mesh.shape[axis]
        if layout == "expert":
            lo, hi = shd.h_layout(e, m)[mesh.coordinate(axis)]
        else:
            cols = ff // m
    gate = params["experts"]["gate"]
    held = (gate["rom"]["w_q"] if "rom" in gate else gate["sram"]["w"]).shape
    if (held[0], held[2]) != (hi - lo, cols):
        raise ValueError(
            f"expert blocks {tuple(held)} are not this rank's under the "
            f"{layout or 'unsharded'} layout ({hi - lo} experts of ff "
            f"{cols}): cut them with CompiledModel.shard_params")
    if layout == "expert_mlp" and "rom" not in gate:
        raise NotImplementedError(
            f"SRAM-resident experts split on their hidden size come with "
            f"{shd.LM_SLICE}")
    return layout, lo, hi


def row_parallel_trunk(x: torch.Tensor, w_q: torch.Tensor, mesh,
                       axis: str):
    """A stacked trunk row-parallel on its contraction over ``axis``: x
    [E, C, k] (the rank's columns of the contraction) and w_q [E, k, N]
    (its rows).  Every row is quantised at the whole row's absmax (an
    exact max over the ranks); the integer partials are added in int32 in
    rank order.  (int32 sums [E, C, N], the row scales): the sums are the
    unsharded :func:`int8_bmm`'s integers, whatever the split."""
    absmax = shd.rank_max(x.abs().amax(dim=-1, keepdim=True), mesh, axis)
    x_q, sx = quant.quantize_activations_at(x, absmax)
    return shd.sum_parts(int8_bmm_int32(x_q, w_q), mesh, axis,
                         "expert"), sx


class _RowTrunkSTE(torch.autograd.Function):
    """A row-parallel stacked trunk's output from its reduced int32 sums
    (:func:`row_parallel_trunk`): the one scale, as the unsharded trunk
    applies it, with the reference's straight-through backward for this
    rank's ff rows, ``dh = g @ (w_q * w_scale)^T`` (``g`` whole on every
    rank: no exchange), as :class:`_StackedTrunkMatmul`'s unsharded."""

    @staticmethod
    def forward(ctx, h, trunk, sx, w_q, w_scale):
        ctx.save_for_backward(w_q, w_scale)
        return (trunk.float() * sx * w_scale.float()).to(h.dtype)

    @staticmethod
    def backward(ctx, g):
        w_q, w_scale = ctx.saved_tensors
        w_deq = w_q.to(g.dtype) * w_scale.to(g.dtype)      # [E, k, d]
        return g @ w_deq.transpose(1, 2), None, None, None, None


def _down_rows(params, h):
    """The down stack row-parallel on the rank's ff rows (the
    ``expert_mlp`` layout): the trunk by :func:`row_parallel_trunk` and
    the one scale, the branch's t1 summed onto the rank's d_c block of
    the core (whole where the size rule keeps the core whole) and its
    product ``t1 @ (core @ U)`` summed in rank order, in f32.  The output
    feeds work every rank does alike: the sums' adjoints send nothing
    (t1's reduce-scatter gathers its chunks' gradients) and the trunk's
    is straight-through on the rank's rows (:class:`_RowTrunkSTE`)."""
    mesh, axis = shd.model_axis()
    rom, sram = params["rom"], params["sram"]
    trunk, sx = row_parallel_trunk(h.detach(), rom["w_q"], mesh, axis)
    y = _RowTrunkSTE.apply(h, trunk, sx, rom["w_q"], rom["w_scale"])
    t1 = h.float() @ rom["C"].float()                      # partial
    core, uf = sram["core"].float(), rom["U"].float()
    if core.shape[1] != t1.shape[-1]:                      # core on d_c
        t1 = shd.sum_chunk(t1, 2, shd.h_layout(t1.shape[-1],
                                                mesh.shape[axis]),
                           mesh, axis, "expert_scatter")
        branch = shd.sum_parts(torch.bmm(t1, core @ uf), mesh, axis,
                               "expert")
    else:
        branch = torch.bmm(shd.sum_parts(t1, mesh, axis, "expert"),
                           core @ uf)
    return y + branch.to(h.dtype)


class _Dispatch(torch.autograd.Function):
    """The dispatched expert stack from the routed tokens ``xt`` [T, d]:
    each kept choice's token, through bf16 as the reference's dispatch
    einsum takes it, into its row ``rows[t, j]`` of [n_rows, d] (the
    other choices write one spare row, dropped), back in ``xt``'s dtype.
    The backward gives a token the f32 sum of its choices' row gradients
    in choice order, not rounded to bf16: where ranks hold different
    experts, their partial sums then differ from one process's only in
    the order of the f32 adds."""

    @staticmethod
    def forward(ctx, xt, rows, n_rows):
        stack = xt.new_zeros((n_rows + 1, xt.shape[1]), dtype=torch.bfloat16)
        xb = xt.to(torch.bfloat16)
        for j in range(rows.shape[1]):
            stack.index_put_((rows[:, j],), xb)
        ctx.save_for_backward(rows)
        return stack[:n_rows].to(xt.dtype)

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        g = F.pad(g, (0, 0, 0, 1))                        # the spare row: 0
        dx = None
        for j in range(rows.shape[1]):
            term = g[rows[:, j]]
            dx = term if dx is None else dx + term
        return dx, None, None


def apply_moe_block(params, x, cfg: ArchConfig, sp=None, rows=None):
    """x [B, S, d] -> [B, S, d]: routed experts (plus the shared experts
    behind their sigmoid gate).  The combine adds a token's kept choices
    in ascending expert order (the reference's one-hot einsum sums over
    (expert, slot); the order of its few non-zero terms may differ, so a
    token's output may differ from it in the last f32 bits).

    Over a mesh (see the module docstring): ``rows`` ``(lo, hi, B)``, this
    rank's rows of the batch of B (the routing groups are the whole
    batch's); ``sp``, the seq_sp layout of the residual: ``x`` is the
    whole sequence and the output this rank's sequence chunk."""
    b, s, d = x.shape
    mesh = shd.current_mesh()
    if rows is None and mesh is not None and shd.batch_axes(mesh):
        raise ValueError(
            "the moe block over batch ranks needs the rank's rows of the "
            "batch (its routing groups are the whole batch's): pass rows="
            "(lo, hi, B), as the serving and train steps do")
    groups = token_groups(b, s, cfg, rows)
    n, g = groups.n, groups.g
    cap = _capacity(cfg)
    layout, e_lo, e_hi = _experts_held(params, cfg)
    _mark_partial(params, layout, sp)
    # the routing and dispatch of an "expert" rank reach its experts only:
    # its gradient there is a part (Megatron's f); under seq_sp x comes
    # from a gather whose adjoint sums the parts already
    xr = shd.replicate(x) if layout == "expert" and sp is None else x
    xf = xr.reshape(b * s, d)
    if n * g != b * s:
        xf = F.pad(xf, (0, 0, groups.off, n * g - groups.off - b * s))
    xg = xf.reshape(n, g, d)

    idx, gates, slot, keep = route(params, xg, cfg, groups)
    mine = keep if (e_lo, e_hi) == (0, cfg.num_experts) else \
        keep & (idx >= e_lo) & (idx < e_hi)
    # flat row of each kept choice of a held expert in the [E_held, G*cap]
    # dispatched stack; the other choices write one spare row, dropped
    grp = torch.arange(n, device=x.device)[:, None, None]
    dest = torch.where(mine, (idx - e_lo) * (n * cap) + grp * cap + slot, 0)
    spare = (e_hi - e_lo) * n * cap
    k = idx.shape[-1]
    x_exp = _Dispatch.apply(xg.reshape(-1, d),
                            torch.where(mine, dest, spare).reshape(n * g, k),
                            spare).reshape(e_hi - e_lo, n * cap, d)
    if layout == "expert_mlp" and sp is None:
        x_exp = shd.replicate(x_exp)   # into the rank's ff columns

    ex = params["experts"]
    hg = apply_expert_linear(ex["gate"], x_exp)
    hu = apply_expert_linear(ex["up"], x_exp)
    h = F.silu(hg) * hu
    if layout == "expert_mlp":
        h = _down_rows(ex["down"], h)
        if sp is not None:             # combined, then cut to the rank's
            h = shd.replicate(h)       # sequence chunk: its own use
    else:
        h = apply_expert_linear(ex["down"], h)

    # combine: each token's kept choices, gate-weighted, by expert order
    order = torch.argsort(idx, dim=-1)
    dest = torch.gather(dest, -1, order).reshape(n * g, k)
    w = (torch.gather(gates, -1, order)
         * torch.gather(mine, -1, order)).reshape(n * g, k)
    hf = h.reshape(-1, d).float()
    y = None
    for j in range(k):
        term = w[:, j:j + 1] * hf[dest[:, j]]
        y = term if y is None else y + term
    y = y[groups.off:groups.off + b * s].reshape(b, s, d)
    if layout == "expert":            # the ranks' partials, in rank order
        at = shd.model_axis()
        y = shd.sum_parts(y, *at, "expert") if sp is None else \
            shd.sum_chunk(y, 1, sp, *at, "expert_scatter")
    y = y.to(x.dtype)
    xs = x
    if sp is not None:                # this rank's sequence chunk
        mesh, axis = shd.model_axis()
        lo, hi = sp[mesh.coordinate(axis)]
        xs = x.narrow(1, lo, hi - lo)
        if layout != "expert":
            y = y.narrow(1, lo, hi - lo)

    if "shared" in params:
        kw = {} if sp is None else {"sp": sp}
        sh = layers.apply_mlp(params["shared"], x, cfg, d_ff=(
            cfg.num_shared_experts * (cfg.moe_d_ff or cfg.d_ff)), **kw)
        sg = torch.sigmoid(xs.float() @ params["shared_gate"]["sram"]["w"])
        y = y + sh * sg.to(x.dtype)
    return y


def _mark_partial(params, layout, sp):
    """Mark the block's trainable leaves that each model rank holds whole
    but uses its own way (``sharding.mark_partial``; their gradients are
    summed by the train step): the router where a rank combines only its
    experts' choices (``expert``) or only its sequence chunk (``sp``),
    the column-parallel gate and up cores of ``expert_mlp`` (U cut on
    ff), every expert leaf of ``whole`` under ``sp``, and the shared
    gate under ``sp`` (it meets the rank's chunk)."""
    if layout is None:
        return
    ex = params["experts"]
    if layout == "expert" or sp is not None:
        shd.mark_partial(params["router"]["sram"])
    if layout == "expert_mlp":
        shd.mark_partial(ex["gate"]["sram"], ex["up"]["sram"])
    if sp is not None:
        if layout == "whole":
            shd.mark_partial(*(ex[k]["sram"] for k in ex))
        if "shared_gate" in params:
            shd.mark_partial(params["shared_gate"]["sram"])


def aux_load_balance_loss(params, x, cfg: ArchConfig):
    """Switch-style auxiliary load-balancing loss (for the training loop)."""
    logits = x.float() @ params["router"]["sram"]["w"]
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][
        ..., :cfg.num_experts_per_tok]
    frac = F.one_hot(idx, cfg.num_experts).float().mean(dim=(0, 1, 2))
    imp = probs.mean(dim=(0, 1))
    return cfg.num_experts * (frac * imp).sum()
