"""AdamW over the *trainable* (SRAM) tree only (port of
``repro.optim.adamw``).

The ROM trunk never enters optimizer state: ``None`` stands where the
trainable tree has ``None``, so the state tree lines up key for key with
the JAX package's (``{"step", "m", "v"}``) and a checkpoint of either
package restores in the other.

Functional, as the reference: :func:`update` returns new trees and writes
into none of its inputs.  The formula is the reference's, written out
(``torch.optim.AdamW`` rounds its bias correction and its decoupled decay
differently): the decay is added into ``delta`` and ``lr * delta`` is
subtracted, in f32 for an f32 leaf.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import bridge
from repro_torch.distributed import sharding as shd


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3               # may be overridden per-step by schedule
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0


def init(trainable) -> dict:
    """``{"step": int32 0-d, "m": zeros, "v": zeros}`` (f32), on the
    trainable leaves' device."""
    leaves = list(bridge.flatten(trainable).values())
    dev = leaves[0].device if leaves else None
    zeros = lambda: bridge.tree_map(
        trainable, lambda p: torch.zeros_like(p, dtype=torch.float32))
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": zeros(), "v": zeros()}


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root.  PyTorch's CPU ``sqrt`` on f32
    is not (it is off by an ulp on ~0.7% of inputs); the f64 root rounded
    to f32 is, on every device, and so matches XLA's."""
    return torch.sqrt(x.double()).float()


def global_norm(tree, split=()) -> torch.Tensor:
    """sqrt(sum of every leaf's sum of squares + 1e-30), f32.  ``split``:
    the leaves that the ranks of the bound mesh's model axis hold in
    blocks; their squared sums are added over the axis in rank order, the
    other leaves (whole on every rank) counted once, so the norm is the
    whole tree's, the same bits on every rank."""
    named = bridge.flatten(tree)
    leaves = [torch.sum(torch.square(x.float()))
              for k, x in named.items() if k not in split]
    total = sum(leaves) if leaves else torch.zeros(())
    blocks = [torch.sum(torch.square(x.float()))
              for k, x in named.items() if k in split]
    at = shd.model_axis()
    if blocks and at is not None:
        total = total + shd.sum_parts(sum(blocks).reshape(1), *at,
                                      "grads")[0]
    elif blocks:
        total = total + sum(blocks)
    return sqrt(total + 1e-30)


def _step_leaf(g, m, v, p, cfg: AdamWConfig, clip, t, lr):
    g = g.float() * clip
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    mhat = m / (1 - cfg.b1 ** t)
    vhat = v / (1 - cfg.b2 ** t)
    delta = mhat / (sqrt(vhat) + cfg.eps)
    delta = delta + cfg.weight_decay * p.float()
    d = delta.to(p.dtype)
    if isinstance(lr, torch.Tensor):
        # JAX promotes a 0-d f32 lr times a narrower leaf to f32 and
        # rounds once; torch would keep the leaf's dtype and round twice
        return (p.float() - lr.float() * d.float()).to(p.dtype), m, v
    return (p - lr * d).to(p.dtype), m, v


def update(grads, state, params, cfg: AdamWConfig,
           lr: torch.Tensor | float | None = None, *, split=()):
    """Returns (new_params, new_state, metrics); ``metrics["grad_norm"]``
    is the norm before the clip (:func:`global_norm`, ``split`` its
    leaves held in blocks over the model axis).  A leaf with no gradient
    (``None``) comes back ``None``, as in the reference."""
    lr = cfg.lr if lr is None else lr
    with torch.no_grad():
        step = state["step"] + 1
        t = step.float()
        gnorm = global_norm(grads, split)
        clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                           max=1.0)
        g_named = bridge.flatten(grads)
        m_named = bridge.flatten(state["m"])
        v_named = bridge.flatten(state["v"])
        out = {name: _step_leaf(g_named[name], m_named[name], v_named[name],
                                p, cfg, clip, t, lr)
               for name, p in bridge.flatten(params).items()
               if name in g_named}
    take = lambda i: bridge.map_named(
        params, lambda name, _: out[name][i] if name in out else None)
    return take(0), {"step": step, "m": take(1), "v": take(2)}, \
        {"grad_norm": gnorm}
