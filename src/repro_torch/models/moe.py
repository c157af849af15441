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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import quant
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


def int8_bmm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int8 batched product [E, C, K] x [E, K, N] -> f32 [E, C, N]:
    f32 products on K-chunks of at most :data:`EXACT_K` (each exact),
    added in int32, cast to f32 once."""
    k = x_q.shape[-1]
    acc = None
    for k0 in range(0, k, EXACT_K):
        part = torch.bmm(x_q[..., k0:k0 + EXACT_K].float(),
                         w_q[:, k0:k0 + EXACT_K].float())
        if k <= EXACT_K:
            return part
        part = part.to(torch.int32)
        acc = part if acc is None else acc + part
    return acc.float()


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


def route(params, xg, cfg: ArchConfig):
    """The capacity dispatch of token groups xg [G, g, d]:
    (idx [G, g, k] the chosen experts, gates [G, g, k] their normalised
    probabilities, slot [G, g, k] each choice's capacity slot, keep
    [G, g, k] whether it got one).  Priority is token order within each of
    the k rounds, the rounds in order; a dropped choice still counts
    against its expert, as in the reference."""
    n_groups, g, _ = xg.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = xg.float() @ params["router"]["sram"]["w"]
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower expert index, as jax.lax.top_k (a
    # zero pad token's uniform probabilities tie everywhere)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]               # [G, g, k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    counts = torch.zeros((n_groups, e), dtype=torch.int64, device=xg.device)
    slots = []
    for j in range(k):
        oh = F.one_hot(idx[..., j], e)                      # [G, g, E]
        pos = torch.cumsum(oh, dim=1) - oh + counts[:, None, :]
        slots.append((pos * oh).sum(-1))                    # [G, g]
        counts = counts + oh.sum(1)
    slot = torch.stack(slots, dim=-1)
    return idx, gates, slot, slot < _capacity(cfg)


def apply_moe_block(params, x, cfg: ArchConfig):
    """x [B, S, d] -> [B, S, d]: routed experts (plus the shared experts
    behind their sigmoid gate).  The combine adds a token's kept choices
    in ascending expert order (the reference's one-hot einsum sums over
    (expert, slot); the order of its few non-zero terms may differ, so a
    token's output may differ from it in the last f32 bits)."""
    b, s, d = x.shape
    t = b * s
    g = min(cfg.moe_group_size, t)
    n_groups = -(-t // g)
    pad = n_groups * g - t
    xf = x.reshape(t, d)
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    xg = xf.reshape(n_groups, g, d)
    e, cap = cfg.num_experts, _capacity(cfg)

    idx, gates, slot, keep = route(params, xg, cfg)
    # flat row of each kept choice in the [E, G*cap] dispatched stack
    grp = torch.arange(n_groups, device=x.device)[:, None, None]
    dest = torch.where(keep, idx * (n_groups * cap) + grp * cap + slot, 0)
    kept = keep.reshape(-1)
    src = torch.arange(n_groups * g, device=x.device)[:, None].expand(
        -1, idx.shape[-1]).reshape(-1)[kept]
    x_exp = xg.new_zeros((e * n_groups * cap, d), dtype=torch.bfloat16)
    x_exp[dest.reshape(-1)[kept]] = xg.reshape(-1, d)[src].to(torch.bfloat16)
    x_exp = x_exp.reshape(e, n_groups * cap, d).to(x.dtype)

    hg = apply_expert_linear(params["experts"]["gate"], x_exp)
    hu = apply_expert_linear(params["experts"]["up"], x_exp)
    h = apply_expert_linear(params["experts"]["down"], F.silu(hg) * hu)

    # combine: each token's kept choices, gate-weighted, by expert order
    order = torch.argsort(idx, dim=-1)
    dest = torch.gather(dest, -1, order).reshape(n_groups * g, -1)
    w = (torch.gather(gates, -1, order)
         * torch.gather(keep, -1, order)).reshape(n_groups * g, -1)
    hf = h.reshape(-1, d).float()
    y = None
    for j in range(dest.shape[1]):
        term = w[:, j:j + 1] * hf[dest[:, j]]
        y = term if y is None else y + term
    y = y.to(x.dtype)[:t].reshape(b, s, d)

    if "shared" in params:
        sh = layers.apply_mlp(params["shared"], x, cfg)
        sg = torch.sigmoid(x.float() @ params["shared_gate"]["sram"]["w"])
        y = y + sh * sg.to(x.dtype)
    return y


def aux_load_balance_loss(params, x, cfg: ArchConfig):
    """Switch-style auxiliary load-balancing loss (for the training loop)."""
    logits = x.float() @ params["router"]["sram"]["w"]
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][
        ..., :cfg.num_experts_per_tok]
    frac = F.one_hot(idx, cfg.num_experts).float().mean(dim=(0, 1, 2))
    imp = probs.mean(dim=(0, 1))
    return cfg.num_experts * (frac * imp).sum()
