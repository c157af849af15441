"""Error-feedback int8 gradient compression for the branch all-reduce (port
of ``repro.optim.compress``).

ReBranch already shrinks the gradient all-reduce (only the SRAM branch
has gradients); this shrinks the remaining volume further by
all-gathering int8-quantised gradients with one f32 scale per tensor and
rank, and summing the dequantised copies locally, with persistent error
feedback so that the quantisation noise is unbiased over time (Seide et
al. / EF-SGD).  The train step uses it under ``compress=True``
(``launch/steps.py``, ``launch/train.py --compress``).

The reference runs inside ``shard_map`` over a named axis; here the axis
is a process group of a ``launch.mesh.Mesh``.  Over gloo a CUDA tensor
goes through host buffers (gloo sends no CUDA tensor): that follows from
the group's backend.  :data:`wire_bytes` counts what this rank puts into
the collectives, by kind (``"int8"`` here, ``"f32"`` for the plain mean
of ``launch/steps.py``).
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.distributed import sharding as shd
from repro_torch.launch import cost

# bytes this rank contributed to gradient collectives, by kind, since the
# count was last cleared
wire_bytes: collections.Counter = collections.Counter()


def quantize_with_feedback(g, err):
    """(g + err) -> int8 + scale; returns (q, scale, new_err)."""
    target = g.float() + err
    flat = target.reshape(-1)
    absmax = flat.abs().max()
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    new_err = target - deq.reshape(target.shape)
    return q.reshape(target.shape), scale, new_err


def _axes(mesh, axis) -> list:
    """``[axis]``, or for None the mesh's batch axes (``pod``, ``data``:
    the axes a train step averages over)."""
    return shd.batch_axes(mesh) if axis is None else [axis]


def count_wire(kind: str, nbytes: int):
    """Count ``nbytes`` put into a collective under ``kind`` (times the
    runs the call stands for, ``cost.repeated``): into the active
    ``launch.cost`` record, else into :data:`wire_bytes`."""
    nbytes *= cost.times()
    rec = cost.recording()
    if rec is not None:
        rec.sent("wire_bytes", kind, nbytes)
    else:
        wire_bytes[kind] += nbytes


def _gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` in rank order (host buffers for a CUDA tensor
    over gloo; a ``meta`` tensor stays on meta)."""
    host = dist.get_backend(group) != "nccl" and t.device.type == "cuda"
    src = t.cpu() if host else t
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src.contiguous(), group=group)
    return [o.to(t.device) for o in out]


def _gather_axes(t: torch.Tensor, mesh, axes, kind: str) -> list:
    """Every rank's ``t`` over ``axes`` flattened in mesh order: one
    all-gather per axis, the innermost first (each gathers what the
    previous one gathered), counting what this rank puts in under
    ``kind``."""
    parts = [t]
    for a in reversed(axes):
        block = torch.stack(parts)
        count_wire(kind, block.numel() * block.element_size())
        parts = [p for got in _gather(block, mesh.group(a))
                 for p in got.unbind(0)]
    return parts


def _mean_of(scales, qs, n: int):
    """sum_q scale_q * q_q in rank order, over n (the reference's
    ``tensordot(ss, qs) / n``)."""
    acc = scales[0] * qs[0].float()
    for s, q in zip(scales[1:], qs[1:]):
        acc = acc + s * q.float()
    return acc / n


def all_reduce_int8(g, err, mesh, axis: str | None = None):
    """Compressed mean-all-reduce of one gradient tensor over ``axis`` of
    ``mesh`` (the batch axes when None): all-gather the int8 payload and
    one f32 scale per rank, sum the dequantised copies in rank order and
    divide by n.  Returns (mean in ``g``'s dtype, new error)."""
    axes = _axes(mesh, axis)
    q, scale, new_err = quantize_with_feedback(g, err)
    qs = _gather_axes(q, mesh, axes, "int8")
    ss = _gather_axes(scale.reshape(1), mesh, axes, "int8")
    return _mean_of([s[0] for s in ss], qs, len(qs)).to(g.dtype), new_err


def tree_all_reduce_int8(grads, err_state, mesh, axis: str | None = None):
    """:func:`all_reduce_int8` on every leaf (``err_state`` mirrors
    ``grads``), each leaf quantised with its own scale as the reference
    does; the payloads of all leaves travel in one int8 all-gather and
    their scales in one f32 all-gather (one of each per batch axis)."""
    axes = _axes(mesh, axis)
    names = list(bridge.flatten(grads))
    flat_g, flat_e = bridge.flatten(grads), bridge.flatten(err_state)
    quant = [quantize_with_feedback(flat_g[k], flat_e[k]) for k in names]
    if not quant:
        return grads, err_state
    qs = _gather_axes(torch.cat([q.reshape(-1) for q, _, _ in quant]), mesh,
                      axes, "int8")
    ss = _gather_axes(torch.stack([s for _, s, _ in quant]), mesh, axes,
                      "int8")
    out_g, out_e, at = {}, {}, 0
    for i, (k, (q, _, e)) in enumerate(zip(names, quant)):
        n = q.numel()
        mean = _mean_of([s[i] for s in ss], [p[at:at + n] for p in qs],
                        len(qs))
        out_g[k] = mean.reshape(q.shape).to(flat_g[k].dtype)
        out_e[k] = e
        at += n
    return (bridge.map_named(grads, lambda k, _: out_g[k]),
            bridge.map_named(err_state, lambda k, _: out_e[k]))


def init_error_state(trainable):
    """Zero f32 error feedback mirroring the trainable tree."""
    return bridge.tree_map(
        trainable, lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device))
