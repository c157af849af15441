"""Logical-axis sharding rules (port of ``repro.distributed.sharding``),
the layout of a sharded CNN activation, and parameter shardings.

The rules are the reference's letter for letter: models name *logical*
axes, a context-scoped rule set maps them onto mesh axes, and
``param_specs`` derives a PartitionSpec for every parameter from its tree
path.  These are pure metadata here and resolve on any mesh, an
:class:`~repro_torch.launch.mesh.AbstractMesh` of 16x16 included.
``param_shardings`` pairs each spec with its mesh (:class:`NamedSharding`,
a frozen record), and :func:`local_block` cuts a rank's block of a whole
tensor under one, in GSPMD's uneven layout per dimension.

What runs is the CNN layout, the reference's ``shard(x, "cnn_batch",
"cnn_h")``: an NHWC activation split over its batch on the axis the
``"cnn_batch"`` rule names (``pod``) and over H on the axis the
``"cnn_h"`` rule names (``data``), each as GSPMD splits an uneven
dimension: rank r of n holds rows ``[r*c, min((r+1)*c, H))`` with
``c = ceil(H/n)`` (a rank may hold none).  Each rank holds its slab as a
plain tensor; :func:`global_h` recovers H from the slabs' heights (one
small all-gather, which also checks the layout), and :func:`move_rows`
is the one place where rows change owner: halos, re-layouts and gathers
all go through it, and it counts what it sends (``rows_sent``,
``bytes_sent``, by kind).  Over a gloo group, rows of a CUDA tensor go
through host buffers (gloo sends no CUDA tensor); that follows from the
mesh's backend, not from a failed attempt.

:func:`move_rows` is differentiable: its adjoint sends each row's
gradient back to the rank that owns the row and adds it there, so the
``"gather"`` kind's adjoint is a reduce-scatter that sums, and a halo's
adds the halo rows' gradient into their owners' (rows of the zero
padding are dropped).  Every rank's backward runs the same exchanges in
the same order, because every rank builds the same graph: a rank with
no rows still runs each op on empty tensors
(``core.rebranch.zeros_from`` keeps an empty result in the graph).

The LM's tensor parallelism runs over the ``model`` axis (rules
``heads``, ``kv_heads``, ``mlp``, ``vocab`` and ``seq_sp``), its data
parallelism over ``data`` (``batch``; over ``pod`` and ``data`` flattened
in mesh order, :func:`gather_flat`).  :func:`linear_tp` gives a ReBranch
linear its role from the same ``_WIDE_OUT``/``_WIDE_IN`` tables that
:func:`param_specs` reads, so layout and execution cannot disagree: a
column-parallel site holds its output columns, a row-parallel one whole
k-blocks of its contraction (:func:`k_layout`, kept beside
:func:`h_layout`), because a trunk kernel quantises x once per (row,
k-block) and an even split that cuts a block would compute another model.
The attention's q holds whole heads (:func:`head_layout`: GSPMD's uneven
layout of the heads, a trailing rank may hold none) and its o takes them
in that layout, whatever the size rule says of their widths.
The reductions gather every rank's f32 partial (:func:`gather_parts`) and
add them in rank order (:func:`rank_sum`, ascending k), the same bits on
every rank; a gloo all-reduce adds each chunk in another order.  Column
moves go through :func:`move_rows` with ``dim=-1``.  The moe block's
experts take one of the reference's three layouts over the model axis
(:func:`expert_layout`): whole experts a rank (``expert``), each
expert's hidden columns (``expert_mlp``), or every expert whole on every
rank; its large sums go through :func:`sum_parts` and
:func:`sum_chunk` (a reduce-scatter, and an all-gather where every rank
needs the whole).  The axes still not executed (``ssm_inner``,
``kv_seq``) raise naming the item that ports them.

Training over the model axis keeps Megatron's convention: a tensor whole
on every model rank carries its whole gradient on every rank wherever
every rank uses it alike, and tensor-parallel work that each rank does
its own way is entered through *f* (:func:`replicate`: the identity,
whose adjoint is the rank-order sum of the ranks' partial gradients) or
through a gather whose adjoint sums (:func:`move_rows`).  So the
adjoint of :func:`reduce_model` and of :func:`sum_parts` is the identity
(a row-parallel site's t1, which each rank uses its own way, sums
instead: ``core.rebranch._GatherSum``); that of :func:`reduce_chunk` and
of :func:`sum_chunk` a gather of the chunks' gradients; and
:func:`rank_max` stays out of the graph.
Trainable leaves held whole but used by each rank its own way are marked
(:func:`mark_partial`) and their gradients summed by the train step in
one exchange.  Every adjoint counts what it sends under a ``*_adjoint``
kind; the backward's sums (:func:`sum_parts`) are a reduce-scatter and
an all-gather with the rank-order bits.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import math
import re
import types
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.launch import cost

LM_SLICE = "the rest of tensor parallelism (ROADMAP Queue 1 item 5(d))"

# the logical axes shard() executes
CNN_AXES = ("cnn_batch", "cnn_h")
LM_AXES = ("batch", "seq", "seq_sp", "heads", "kv_heads", "mlp", "vocab",
           "embed", "expert", "expert_mlp")

# logical axis -> tuple of mesh axis names (tried in order, first that
# exists in the current mesh wins; missing axes mean "replicated")
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),       # data parallel over pod+data axes
    "seq": (),                      # sequence inside blocks: unsharded
    # Megatron-style sequence parallelism for the residual stream
    "seq_sp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "embed": (),                    # residual stream replicated
    "expert": ("model",),           # EP when divisible (policy in moe.py)
    "expert_mlp": ("model",),       # per-expert hidden when EP not divisible
    "kv_seq": ("data", "model"),    # long-context cache: shard sequence
    "ssm_inner": ("model",),
    "cnn_chan": ("model",),
    # CNN serving (halo-exchange sharded conv, engine 'pallas_sharded'):
    # NHWC activations shard spatial H over the data axis; W is never
    # sharded
    "cnn_batch": ("pod",),          # image batch rides the pod axis
    "cnn_h": ("data",),             # spatial H: halo-exchange sharding
}

_mesh: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)
_rules: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_rules", default=DEFAULT_RULES)

# rows and bytes this process sent through move_rows, by kind ('halo',
# 'relayout', 'gather'; their adjoints as 'halo_adjoint' and so on), since
# the last reset_traffic(); what runs under a ``launch.cost`` record counts
# into that record instead (a dry run's ranks share this process)
rows_sent: collections.Counter = collections.Counter()
bytes_sent: collections.Counter = collections.Counter()


def current_mesh():
    return _mesh.get()


def current_rules() -> dict[str, tuple[str, ...]]:
    return _rules.get()


@contextlib.contextmanager
def use_mesh(mesh, rules: dict | None = None):
    """Bind ``mesh`` (and rules over the defaults) for the calls of this
    thread or asyncio task."""
    tm = _mesh.set(mesh)
    tr = _rules.set({**DEFAULT_RULES, **(rules or {})})
    try:
        yield
    finally:
        _rules.reset(tr)
        _mesh.reset(tm)


def mesh_axis_for(logical: str, mesh=None) -> str | None:
    """The first mesh axis (rule order) a logical axis maps onto, or None;
    axes of size 1 are skipped (sharding over them is a no-op)."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return None
    for a in current_rules().get(logical, ()):
        if a in mesh.axis_names and mesh.shape[a] > 1:
            return a
    return None


class PartitionSpec(tuple):
    """Per dimension: None (replicated), a mesh axis name, or a tuple of
    names, a tuple of one name read as that name
    (``jax.sharding.PartitionSpec``'s layout)."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def logical_to_spec(axes: tuple, mesh=None) -> PartitionSpec:
    """Translate logical axis names to a PartitionSpec for ``mesh``."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return P()
    names = set(mesh.axis_names)
    used: set[str] = set()
    parts = []
    for ax in axes:
        if ax is None or ax == "":
            parts.append(None)
            continue
        mesh_axes = tuple(a for a in current_rules().get(ax, ())
                          if a in names and a not in used)
        used.update(mesh_axes)
        if len(mesh_axes) == 0:
            parts.append(None)
        elif len(mesh_axes) == 1:
            parts.append(mesh_axes[0])
        else:
            parts.append(mesh_axes)
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


# ---------------------------------------------------------------------------
# the H layout of a sharded NHWC activation
# ---------------------------------------------------------------------------

def h_layout(h: int, n: int) -> list[tuple[int, int]]:
    """GSPMD's uneven split of ``h`` rows over ``n`` ranks: rank r holds
    ``[r*c, min((r+1)*c, h))``, ``c = ceil(h/n)``."""
    c = -(-h // n)
    return [(min(r * c, h), min((r + 1) * c, h)) for r in range(n)]


def _need_groups(mesh):
    if not hasattr(mesh, "group"):
        raise TypeError(f"{mesh!r} has no process groups: activations "
                        f"shard over a launch.mesh.Mesh")


def _axis_with_groups(logical: str, mesh):
    """``(mesh, axis)`` when the ``logical`` rule names an axis of size > 1
    of ``mesh`` (which must then have process groups), else None."""
    axis = mesh_axis_for(logical, mesh)
    if axis is None:
        return None
    _need_groups(mesh)
    return mesh, axis


def h_axis(mesh=None):
    """``(mesh, axis)`` when NHWC activations shard over H (the ``"cnn_h"``
    rule names an axis of size > 1), else None."""
    mesh = mesh or current_mesh()
    return None if mesh is None else _axis_with_groups("cnn_h", mesh)


def batch_axis(mesh=None):
    """``(mesh, axis)`` when an image batch shards over its own axis (the
    ``"cnn_batch"`` rule, ``pod``, names an axis of size > 1), else None."""
    mesh = mesh or current_mesh()
    return None if mesh is None else _axis_with_groups("cnn_batch", mesh)


def _collective_device(group, x: torch.Tensor) -> torch.device:
    """Where a collective on ``group`` takes its tensors: the tensor's own
    device over NCCL and on ``meta`` (a dry run's fake world moves
    nothing), host buffers over gloo."""
    if x.device.type == "meta" or dist.get_backend(group) == "nccl":
        return x.device
    return torch.device("cpu")


def _sent(kind: str, nbytes: int, rows: int = 0):
    """Count ``nbytes`` (and ``rows``) this rank sends under ``kind``
    (times the runs the call stands for, ``cost.repeated``): into the
    active ``launch.cost`` record, else into :data:`rows_sent` and
    :data:`bytes_sent`."""
    t = cost.times()
    rec = cost.recording()
    if rec is not None:
        rec.sent("bytes_sent", kind, nbytes * t)
        return
    rows_sent[kind] += rows * t
    bytes_sent[kind] += nbytes * t


def global_h(x: torch.Tensor, mesh, axis: str, dim: int = 1) -> int:
    """H (or, with ``dim=0``, the batch) of the activation whose slab this
    rank holds: an all-gather of the slabs' sizes along ``dim``, checked
    against the uneven layout.  A ``meta`` slab has no value to send: the
    sizes come from the dry run's mesh (``launch.dryrun``), which runs the
    ranks of the axis side by side in this process."""
    n, group = mesh.shape[axis], mesh.group(axis)
    if x.device.type == "meta":
        if not hasattr(mesh, "dry_sizes"):
            raise RuntimeError(
                f"global_h of a meta slab needs the ranks' sizes: run it "
                f"on a launch.dryrun mesh, not {mesh!r}")
        sizes = mesh.dry_sizes(axis, x.shape[dim])
    else:
        mine = torch.tensor([x.shape[dim]], dtype=torch.int64,
                            device=_collective_device(group, x))
        sizes = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(sizes, mine, group=group)
        sizes = [int(t.item()) for t in sizes]
    h = sum(sizes)
    if sizes != [b - a for a, b in h_layout(h, n)]:
        raise RuntimeError(f"slab sizes {sizes} over {n} ranks are not "
                           f"the layout of {h} rows")
    return h


def _exchange(x: torch.Tensor, have: list, want: list, mesh, axis: str,
              kind: str, dim: int, add: bool) -> torch.Tensor:
    """Rows ``want[r]`` along ``dim`` for this rank r, which holds rows
    ``have[r]`` as ``x``; each row is the sum of every rank's copy of it
    (``add``, in rank order) or the one copy (the ``have`` are disjoint).
    Rows nobody holds are zeros."""
    n, r = mesh.shape[axis], mesh.coordinate(axis)
    group = mesh.group(axis)
    host = _collective_device(group, x).type != x.device.type
    lo, hi = want[r]
    a0, a1 = have[r]
    shape = list(x.shape)
    shape[dim] = hi - lo
    out = x.new_zeros(shape)
    ops, parts = [], []
    for q in range(n):
        s0, s1 = max(a0, want[q][0]), min(a1, want[q][1])
        if q == r:
            if s1 > s0:
                parts.append((s0, x.narrow(dim, s0 - a0, s1 - s0)))
            continue
        peer = dist.get_global_rank(group, q)
        if s1 > s0:                       # my rows that q wants
            piece = x.narrow(dim, s0 - a0, s1 - s0).contiguous()
            piece = piece.cpu() if host else piece
            ops.append(dist.P2POp(dist.isend, piece, peer, group=group))
            _sent(kind, piece.numel() * piece.element_size(), s1 - s0)
        t0, t1 = max(have[q][0], lo), min(have[q][1], hi)
        if t1 > t0:                       # q's rows that I want
            shape[dim] = t1 - t0
            buf = torch.empty(shape, dtype=x.dtype,
                              device="cpu" if host else x.device)
            ops.append(dist.P2POp(dist.irecv, buf, peer, group=group))
            parts.append((t0, buf))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for t0, piece in parts:
        dst = out.narrow(dim, t0 - lo, piece.shape[dim])
        if add:
            dst.add_(piece.to(x.device))
        else:
            dst.copy_(piece)
    return out


class _MoveRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, have, want, mesh, axis, kind, dim, replicated):
        ctx.geom = (have, want, mesh, axis, kind, dim, replicated)
        return _exchange(x, have, want, mesh, axis, kind, dim, add=False)

    @staticmethod
    def backward(ctx, g):
        have, want, mesh, axis, kind, dim, replicated = ctx.geom
        if replicated:                  # this rank's rows of a whole gradient
            r = mesh.coordinate(axis)
            dx = g.narrow(dim, have[r][0] - want[r][0],
                          have[r][1] - have[r][0])
        else:
            dx = _exchange(g.contiguous(), want, have, mesh, axis,
                           f"{kind}_adjoint", dim, add=True)
        return dx, None, None, None, None, None, None, None


def move_rows(x: torch.Tensor, have: list, want: list, mesh, axis: str,
              kind: str, dim: int = 1,
              replicated: bool = False) -> torch.Tensor:
    """Rows ``want[r]`` (global ``(lo, hi)`` along ``dim``, H by default)
    of the activation for this rank r, which holds rows ``have[r]`` as
    ``x``; ``have`` and ``want`` are the same lists on every rank.  Rows
    outside every ``have`` (the conv's zero padding, outside ``[0, H)``)
    are zeros.  Only the rows that change owner cross between ranks, one
    message per pair at most.  Differentiable: the adjoint returns each
    row's gradient to its owner, summed over the ranks that read it (each
    rank's gradient a part of the whole).  ``replicated``: every rank
    gathers the whole (``want`` holds each ``have``) into work that is the
    same on every rank, so each rank's gradient is the whole one and the
    adjoint keeps this rank's rows of it, sending nothing."""
    if list(want) == list(have):
        return x
    return _MoveRows.apply(x, list(have), list(want), mesh, axis, kind, dim,
                           replicated)


def reset_traffic():
    """``rows_sent`` and ``bytes_sent`` to empty."""
    rows_sent.clear()
    bytes_sent.clear()


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """This rank's block of a whole (replicated) activation.

    ``shard(x, "cnn_batch", "cnn_h")`` cuts an NHWC activation's ``pod``
    block of the batch and its ``data`` slab of H.  The LM axes
    (:data:`LM_AXES`) cut each dimension whose logical axis maps onto a
    mesh axis of size > 1, by the reference's size rule (a dimension that
    does not divide its mesh axes, or is smaller than them, stays whole),
    in GSPMD's layout (:func:`local_block`).  Without a mesh, on a 1-rank
    mesh or on size-1 axes it returns ``x`` untouched."""
    mesh = current_mesh()
    if mesh is None or mesh.size == 1:
        return x
    for ax in axes:
        if ax not in (None, "", *CNN_AXES, *LM_AXES):
            raise NotImplementedError(
                f"shard over logical axis {ax!r} is not executed by the "
                f"port yet: it comes with {LM_SLICE}")
    if not any(ax in CNN_AXES for ax in axes):
        spec = _size_check(logical_to_spec(axes, mesh), tuple(x.shape), mesh)
        if not spec:
            return x
        _need_groups(mesh)
        return local_block(x, NamedSharding(mesh, spec))
    for logical, dim, at in (("cnn_batch", 0, batch_axis(mesh)),
                             ("cnn_h", 1, h_axis(mesh))):
        if at is None or logical not in axes:
            continue
        if axes.index(logical) != dim:
            raise ValueError(f"{logical!r} shards dim {dim} of an NHWC "
                             f"activation; got logical axes {axes}")
        m, axis = at
        lo, hi = h_layout(x.shape[dim], m.shape[axis])[m.coordinate(axis)]
        x = x.narrow(dim, lo, hi - lo)
    return x.contiguous()


def gather_h(x: torch.Tensor) -> torch.Tensor:
    """The whole activation's H on every rank from the slabs of the H
    layout (``x`` itself when nothing is sharded)."""
    at = h_axis()
    if at is None:
        return x
    mesh, axis = at
    h, n = global_h(x, mesh, axis), mesh.shape[axis]
    return move_rows(x, h_layout(h, n), [(0, h)] * n, mesh, axis, "gather")


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """The whole batch (dim 0) on every rank from the blocks of the batch
    layout over the ``"cnn_batch"`` axis (``x`` itself when the batch is
    not sharded)."""
    at = batch_axis()
    if at is None:
        return x
    mesh, axis = at
    b, n = global_h(x, mesh, axis, dim=0), mesh.shape[axis]
    return move_rows(x, h_layout(b, n), [(0, b)] * n, mesh, axis, "gather",
                     dim=0)


def gather_flat(x: torch.Tensor, size: int, mesh, axes, dim: int = 0,
                kind: str = "gather") -> torch.Tensor:
    """The whole ``size`` along ``dim`` on every rank from the blocks of
    GSPMD's layout over ``axes`` flattened in mesh order (block ``c_a *
    n_b + c_b`` over axes ``(a, b)``, as :func:`block_bounds` deals
    them): one :func:`move_rows` per axis of size > 1, the innermost
    first, each on that axis' own group, so the rows of a line's blocks
    meet before the lines do."""
    sizes = [mesh.shape[a] for a in axes]
    layout = h_layout(size, math.prod(sizes))
    coords = [mesh.coordinate(a) for a in axes]
    for i in reversed(range(len(axes))):
        m = sizes[i]
        if m == 1:
            continue
        span = math.prod(sizes[i + 1:])       # blocks merged so far
        first = 0                             # this line's first block
        for c, n in zip(coords[:i], sizes[:i]):
            first = first * n + c
        first *= m * span

        def rows(b0: int, nb: int) -> tuple[int, int]:
            return layout[b0][0], layout[b0 + nb - 1][1]
        have = [rows(first + c * span, span) for c in range(m)]
        want = [rows(first, m * span)] * m
        x = move_rows(x, have, want, mesh, axes[i], kind, dim=dim)
    return x


def batch_axes(mesh) -> list:
    """The axes of ``mesh`` the batch is split over (the ``"batch"`` rule:
    ``pod`` and ``data``, in mesh order), those of size > 1."""
    return [a for a in current_rules()["batch"]
            if a in mesh.axis_names and mesh.shape[a] > 1]


# ---------------------------------------------------------------------------
# tensor parallelism over the model axis
# ---------------------------------------------------------------------------

def k_layout(k: int, n: int, rows: int = 128) -> list[tuple[int, int]]:
    """The whole k-blocks of ``tiling.k_partition(k, rows)`` dealt to ``n``
    ranks in order, as evenly as whole blocks allow: rank r holds the
    global K range ``(lo, hi)`` of its blocks (``(k, k)`` for none).
    14 blocks over 4 ranks go 4, 4, 3, 3; one block goes to rank 0."""
    from repro_torch.kernels import tiling     # deferred: import cycle
    ends = [0] + [b for _, b in tiling.k_partition(k, rows)] if k else [0]
    nb = len(ends) - 1
    base, extra = divmod(nb, n)
    out, at = [], 0
    for r in range(n):
        c = base + (r < extra)
        out.append((ends[at], ends[at + c]))
        at += c
    return out


def model_axis(mesh=None):
    """``(mesh, axis)`` when the ``"mlp"`` rule names a mesh axis of size
    > 1 (the ``model`` axis), else None."""
    mesh = mesh or current_mesh()
    return None if mesh is None else _axis_with_groups("mlp", mesh)


def axis_layout(logical: str, size: int, mesh=None):
    """``(mesh, axis, layout)`` when :func:`shard` would cut a dimension
    of ``size`` over the ``logical`` axis (the size rule), ``layout`` the
    GSPMD blocks of every rank; else None.  Over several mesh axes
    ``axis`` is their tuple and the blocks are dealt to the axes
    flattened in mesh order (:func:`block_bounds`)."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.size == 1:
        return None
    spec = _size_check(logical_to_spec((logical,), mesh), (size,), mesh)
    if not spec:
        return None
    names = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
    names = tuple(a for a in names if mesh.shape[a] > 1)
    if not names:
        return None
    _need_groups(mesh)
    n = math.prod(mesh.shape[a] for a in names)
    return mesh, names[0] if len(names) == 1 else names, h_layout(size, n)


def batch_block(b: int, mesh=None) -> tuple[int, int]:
    """This rank's rows of a batch of ``b`` under the LM's data
    parallelism (``launch.steps.batch_pspec``: over pod+data once the
    batch is at least their size, GSPMD's uneven blocks), ``(0, b)``
    when the batch is not split."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return 0, b
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    total = math.prod(mesh.shape[a] for a in axes)
    if total == 1 or b < total:
        return 0, b
    return block_bounds((b,), NamedSharding(mesh, P(tuple(axes))))[0]


def expert_layout(n_experts: int, ff: int, mesh=None) -> str | None:
    """How the moe block's experts lie over the model axis (None without
    one), by the reference's policy (``param_specs``' ``experts`` rule and
    its size rule): ``"expert"`` where E divides the axis (each rank
    holds E/m whole experts), else ``"expert_mlp"`` where the expert
    hidden size ff does (gate and up column-parallel on ff, down
    row-parallel on it), else ``"whole"`` (every expert whole on every
    rank)."""
    mesh = mesh or current_mesh()
    axis = None if mesh is None else mesh_axis_for("expert", mesh)
    if axis is None:
        return None
    m = mesh.shape[axis]
    if n_experts % m == 0 and n_experts >= m:
        return "expert"
    if ff % m == 0 and ff >= m:
        return "expert_mlp"
    return "whole"


@dataclasses.dataclass(frozen=True)
class LinearTP:
    """How one ReBranch linear runs over the model axis.  ``column``: x is
    whole and the rank holds output columns ``cols``.  ``row``: x arrives
    in the even layout ``x_layout`` of its K columns (the previous
    column-parallel site's, or the heads') and the rank holds the rows
    ``k_ranges[rank]`` of the contraction (:func:`k_layout`)."""
    role: str
    mesh: Any
    axis: str
    d_in: int
    d_out: int
    cols: tuple = ()
    x_layout: tuple = ()
    k_ranges: tuple = ()

    @property
    def n(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def coord(self) -> int:
        return self.mesh.coordinate(self.axis)


def head_layout(width: int, head_dim: int, n: int) -> list[tuple[int, int]]:
    """The columns of ``width // head_dim`` whole heads dealt to ``n`` ranks
    in GSPMD's uneven layout (:func:`h_layout` of the heads): Yi-34B's 56
    heads over 16 ranks go 4 to each of ranks 0-13 and none to 14-15."""
    return [(a * head_dim, b * head_dim)
            for a, b in h_layout(width // head_dim, n)]


def linear_tp(site: str, d_in: int, d_out: int, rows: int = 128,
              head_dim: int | None = None):
    """The :class:`LinearTP` of the linear ``site`` (its key in the tree:
    ``"q"``, ``"o"``, ``"down"``, ``"lm_head"``...) of ``d_in`` x
    ``d_out`` under the bound mesh; None without a model axis.  The
    attention's head sites run on whole heads of ``head_dim`` columns
    (required for them): ``q`` column-parallel on the rank's heads
    (:func:`head_layout`; ``cols`` gives them), ``o`` row-parallel on
    whole k-blocks, its input in the heads' layout.  Every other site
    takes its role from the spec :func:`param_specs` gives its ``w_q``
    (None where the size rule keeps it whole)."""
    at = model_axis()
    if at is None:
        return None
    mesh, axis = at
    n = mesh.shape[axis]
    if site in ("q", "o"):
        if not head_dim:
            raise ValueError(f"linear_tp({site!r}) deals whole heads: "
                             f"pass head_dim")
        if site == "q":
            return LinearTP("column", mesh, axis, d_in, d_out,
                            cols=head_layout(d_out, head_dim,
                                             n)[mesh.coordinate(axis)])
        return LinearTP("row", mesh, axis, d_in, d_out,
                        x_layout=tuple(head_layout(d_in, head_dim, n)),
                        k_ranges=tuple(k_layout(d_in, n, rows)))
    shape = types.SimpleNamespace(shape=(d_in, d_out), ndim=2)
    spec = tuple(_spec_of(f"['{site}']['rom']['w_q']", shape, mesh))
    if spec == (None, axis):
        return LinearTP("column", mesh, axis, d_in, d_out,
                        cols=h_layout(d_out, n)[mesh.coordinate(axis)])
    if spec == (axis,):
        return LinearTP("row", mesh, axis, d_in, d_out,
                        x_layout=tuple(h_layout(d_in, n)),
                        k_ranges=tuple(k_layout(d_in, n, rows)))
    return None


def gather_parts(x: torch.Tensor, mesh, axis: str,
                 kind: str) -> list[torch.Tensor]:
    """Every rank's ``x`` (one shape on every rank) over ``axis``, in
    rank order, on ``x``'s device (host buffers over gloo); counts the
    bytes this rank sends under ``kind``."""
    n, group = mesh.shape[axis], mesh.group(axis)
    host = _collective_device(group, x).type != x.device.type
    src = x.contiguous()
    src = src.cpu() if host else src
    bufs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(bufs, src, group=group)
    _sent(kind, src.numel() * src.element_size() * (n - 1))
    if not host:
        return bufs
    return list(torch.stack(bufs).to(x.device).unbind(0))


def rank_sum(parts: list[torch.Tensor]) -> torch.Tensor:
    """The parts added in rank order (ascending k for a row-parallel
    site): one association, so every rank and every test names its
    bits."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _scatter_sum(flat: torch.Tensor, layout, mesh, axis: str,
                 kind: str) -> torch.Tensor:
    """Chunk ``layout[r]`` of the rank-order sum of every rank's ``flat``
    (1-D, one length on every rank) for this rank r: rank q's piece of
    each chunk goes to the chunk's rank, which adds the pieces in rank
    order (a reduce-scatter)."""
    n, r = mesh.shape[axis], mesh.coordinate(axis)
    group = mesh.group(axis)
    host = _collective_device(group, flat).type != flat.device.type
    lo, hi = layout[r]
    src = flat.cpu() if host else flat
    ops, pieces = [], []
    for q in range(n):
        if q == r:
            pieces.append(flat[lo:hi])
            continue
        peer = dist.get_global_rank(group, q)
        a, b = layout[q]
        if b > a:                            # my piece of q's chunk
            ops.append(dist.P2POp(dist.isend, src[a:b], peer,
                                  group=group))
            _sent(kind, (b - a) * flat.element_size())
        buf = src.new_empty(hi - lo)
        if hi > lo:                          # q's piece of my chunk
            ops.append(dist.P2POp(dist.irecv, buf, peer, group=group))
        pieces.append(buf)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return rank_sum([p.to(flat.device) for p in pieces])


class _SumParts(torch.autograd.Function):
    """:func:`sum_parts` into work every rank does alike: each rank's part
    had the whole sum's gradient, which is this rank's own (the adjoint
    sends nothing, as :class:`_RankSum`'s)."""

    @staticmethod
    def forward(ctx, g, mesh, axis, kind):
        n = mesh.shape[axis]
        flat = g.contiguous().reshape(-1)
        layout = h_layout(flat.numel(), n)
        total = _scatter_sum(flat, layout, mesh, axis, kind)
        return _exchange(total, layout, [(0, flat.numel())] * n, mesh, axis,
                         kind, 0, add=False).reshape(g.shape)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None


def sum_parts(g: torch.Tensor, mesh, axis: str, kind: str) -> torch.Tensor:
    """The rank-order sum over ``axis`` of every rank's ``g``: the bits of
    :func:`rank_sum` over :func:`gather_parts`, on every rank, at a
    reduce-scatter's and an all-gather's cost.  Rank q adds the ranks'
    pieces of chunk q (GSPMD's layout of the flattened ``g``) in rank
    order, then the sums are gathered: each rank holds one chunk of every
    rank, not every rank's whole ``g``, and sends 2 (n-1)/n of it.

    Differentiable into work every rank does alike (its adjoint the
    identity); where each rank uses the sum its own way, the caller
    enters that work through :func:`replicate`."""
    return _SumParts.apply(g, mesh, axis, kind)


class _SumChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, dim, layout, mesh, axis, kind):
        ctx.geom = (dim, layout, mesh, axis)
        front = g.movedim(dim, 0).contiguous()
        per = math.prod(front.shape[1:])
        lo, hi = layout[mesh.coordinate(axis)]
        part = _scatter_sum(front.reshape(-1),
                            [(a * per, b * per) for a, b in layout], mesh,
                            axis, kind)
        return part.reshape(hi - lo, *front.shape[1:]).movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        dim, layout, mesh, axis = ctx.geom
        return (gather_chunks(grad, layout, mesh, axis, dim, "chunk_adjoint"),
                None, None, None, None, None)


def sum_chunk(g: torch.Tensor, dim: int, layout, mesh, axis: str,
              kind: str) -> torch.Tensor:
    """This rank's chunk ``layout[r]`` along ``dim`` of the rank-order sum
    over ``axis`` of every rank's ``g``: a reduce-scatter (the pieces of
    :func:`sum_parts`' first half, cut along ``dim``), each element the
    bits of :func:`rank_sum`.  Differentiable: every rank's part had the
    whole sum's gradient, so the adjoint gathers the chunks' gradients
    (``"chunk_adjoint"``), as :func:`reduce_chunk`'s does."""
    return _SumChunk.apply(g, dim, list(layout), mesh, axis, kind)


def gather_chunks(g: torch.Tensor, layout, mesh, axis: str, dim: int,
                  kind: str) -> torch.Tensor:
    """The whole extent along ``dim`` on every rank from the chunks of
    ``layout`` (this rank's ``g``): the adjoint of a sum kept as chunks."""
    n = mesh.shape[axis]
    return _exchange(g.contiguous(), list(layout),
                     [(0, layout[-1][1])] * n, mesh, axis, kind, dim,
                     add=False)


class _RankSum(torch.autograd.Function):
    """The rank-order sum over ``axis`` into work every rank does alike:
    each rank's part had the whole sum's gradient, which is this rank's
    own, so the adjoint sends nothing.  (Where each rank uses the sum its
    own way, a row-parallel site's t1, the adjoint sums the ranks'
    gradients: ``core.rebranch._GatherSum``.)"""

    @staticmethod
    def forward(ctx, x, mesh, axis, kind):
        return rank_sum(gather_parts(x, mesh, axis, kind))

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def reduce_model(x: torch.Tensor, kind: str = "reduce",
                 at=None) -> torch.Tensor:
    """The whole sum over the model axis (``at``: ``(mesh, axis)``, by
    default the bound mesh's) of every rank's ``x``, added in rank order
    (``x`` itself without a model axis), into work every rank does alike
    (the embedding's lookup, the loss's sums, a row-parallel site's
    branch ``z``): differentiable, its adjoint the identity
    (:class:`_RankSum`)."""
    at = at or model_axis()
    if at is None:
        return x
    return _RankSum.apply(x, *at, kind)


class _ReduceChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axis, kind):
        layout = h_layout(x.shape[dim], mesh.shape[axis])
        ctx.geom = (layout, mesh, axis, dim)
        lo, hi = layout[mesh.coordinate(axis)]
        return rank_sum([p.narrow(dim, lo, hi - lo)
                         for p in gather_parts(x, mesh, axis, kind)])

    @staticmethod
    def backward(ctx, g):
        layout, mesh, axis, dim = ctx.geom
        return (gather_chunks(g, layout, mesh, axis, dim, "chunk_adjoint"),
                None, None, None, None)


def reduce_chunk(x: torch.Tensor, dim: int,
                 kind: str = "reduce") -> torch.Tensor:
    """This rank's chunk along ``dim`` (GSPMD's layout over the model
    axis) of the rank-order sum of every rank's ``x``: the reference's
    reduce-scatter into ``seq_sp``.  Its adjoint gathers the chunks'
    gradients (``"chunk_adjoint"``): every rank's part had the whole
    gradient."""
    at = model_axis()
    if at is None:
        return x
    return _ReduceChunk.apply(x, dim, *at, kind)


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.geom = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_parts(g, *ctx.geom, "replicate_adjoint"), None, None


def replicate(x: torch.Tensor) -> torch.Tensor:
    """Megatron's *f*: ``x`` (whole, the same on every model rank) as the
    input of tensor-parallel work, where each rank's gradient is a part:
    the identity, whose adjoint is the rank-order sum of the ranks'
    gradients (``"replicate_adjoint"``).  ``x`` itself without a model
    axis or where autograd records nothing for it."""
    at = model_axis()
    if at is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Replicate.apply(x, *at)


def rank_max(x: torch.Tensor, mesh, axis: str,
             kind: str = "absmax") -> torch.Tensor:
    """The elementwise max of every rank's ``x`` over ``axis`` (exact in
    any order).  Out of the autograd graph: it feeds a quantiser's scale
    (straight-through) or a logsumexp's shift, which carry no gradient."""
    parts = gather_parts(x.detach(), mesh, axis, kind)
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p)
    return out


# the trainable leaves held whole on every model rank whose use on this
# rank is its own (a column site's core and bias, a norm scale on the
# rank's sequence chunk...), so that their gradient here is this rank's
# part: marked during a train step's forward (:func:`mark_partial`),
# summed over the model axis by the step (``launch.steps.BranchStep``)
_partial_leaves: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_partial_leaves", default=None)


@contextlib.contextmanager
def partial_leaves():
    """Collect, in the yielded set, the ids of the leaves that
    :func:`mark_partial` marks inside the block (a view stands for the
    leaf it views: a stacked tree's per-layer slices mark the stack)."""
    seen: set = set()
    token = _partial_leaves.set(seen)
    try:
        yield seen
    finally:
        _partial_leaves.reset(token)


def mark_partial(*trees):
    """Mark every tensor of ``trees`` (held whole on every model rank) as
    used by this rank its own way: its gradient on this rank is a part of
    the whole, which the train step sums over the model axis.  Nothing
    outside :func:`partial_leaves` or without a model axis."""
    seen = _partial_leaves.get()
    if seen is None or model_axis() is None:
        return
    for tree in trees:
        leaves = (bridge.flatten(tree).values() if isinstance(tree, dict)
                  else [tree])
        for t in leaves:
            if isinstance(t, torch.Tensor) and t.requires_grad:
                seen.add(id(t if t._base is None else t._base))


class _Seat:
    """``mesh`` as rank ``c`` of its axis ``axis`` sees it: the axis
    names, sizes and coordinates :func:`param_bounds` reads."""

    def __init__(self, mesh, axis: str, c: int):
        self.axis_names, self.shape, self.size = (mesh.axis_names,
                                                  mesh.shape, mesh.size)
        self._mesh, self._axis, self._c = mesh, axis, c

    def coordinate(self, axis: str) -> int:
        return self._c if axis == self._axis else self._mesh.coordinate(axis)


def model_split_leaves(params, mesh, rows, head_dim: int | None,
                       experts: tuple[int, int] | None) -> set:
    """The paths of the leaves of the whole tree ``params`` that the ranks
    of ``mesh``'s model axis hold in blocks: those :func:`param_bounds`
    (``rows(path)``, ``head_dim`` and ``experts`` as it takes them) cuts
    on some rank of the axis; every other leaf is whole on each model
    rank."""
    at = model_axis(mesh)
    if at is None:
        return set()
    seats = [_Seat(mesh, at[1], c) for c in range(mesh.shape[at[1]])]
    out = set()
    for path, leaf in bridge.flatten(params).items():
        shape, spec = tuple(leaf.shape), _spec_of(path, leaf, mesh)
        whole = [(0, n) for n in shape]
        if any(param_bounds(path, shape, NamedSharding(seat, spec),
                            rows(path), head_dim, experts) != whole
               for seat in seats):
            out.add(path)
    return out


def gather_cols(x: torch.Tensor, width: int, mesh, axis: str, dim: int = -1,
                kind: str = "gather") -> torch.Tensor:
    """The whole ``width`` along ``dim`` on every rank from the blocks of
    its even layout over ``axis`` (:func:`move_rows`)."""
    n = mesh.shape[axis]
    return move_rows(x, h_layout(width, n), [(0, width)] * n, mesh, axis,
                     kind, dim=dim)


def gather_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Whole logits from vocab-parallel ones (``logits`` itself when they
    are whole)."""
    at = model_axis()
    if at is None or logits.shape[-1] == vocab:
        return logits
    return gather_cols(logits, vocab, *at)


def vocab_argmax(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """``torch.argmax(whole_logits, -1)`` from vocab-parallel logits: each
    rank's max and its first index, gathered, the lowest global index
    winning a tie (``torch.argmax``'s rule), the same on every rank."""
    at = model_axis()
    if at is None or logits.shape[-1] == vocab:
        return torch.argmax(logits, dim=-1)
    mesh, axis = at
    lo = h_layout(vocab, mesh.shape[axis])[mesh.coordinate(axis)][0]
    idx = torch.argmax(logits, dim=-1, keepdim=True)
    val = logits.gather(-1, idx)
    packed = torch.cat([val.double(), (idx + lo).double()], dim=-1)
    best = None
    for p in gather_parts(packed, mesh, axis, "argmax"):
        best = p if best is None else torch.where(
            (p[..., :1] > best[..., :1]), p, best)
    return best[..., 1].long()


# ---------------------------------------------------------------------------
# parameter sharding from tree paths
# ---------------------------------------------------------------------------

_WIDE_OUT = ("['q']", "['k']", "['v']", "['gate']", "['up']", "['in_proj']",
             "['x_proj']", "['dt_proj']", "['head']", "['lm_head']",
             "['shared_gate']", "['codebook_head']")
_WIDE_IN = ("['o']", "['down']", "['out_proj']")

_LAYER_LIST_RE = re.compile(r"\['layers'\]\[\d+\]")


def _spec_for_param(path: str, leaf, mesh) -> PartitionSpec:
    """Path -> spec rules for every model family (the reference's).

    Weights are [d_in, d_out] with the tensor-parallel ("wide") dim on the
    output side for q/k/v/gate/up/... and on the input side for
    o/down/out_proj; stacked experts [E, d_in, d_out]; embeddings [V, d].
    Branch C is replicated; core and U follow the trunk's wide side.
    Stacked layers (``['layers']`` without an index) get the per-layer
    rule with the leading L unsharded.
    """
    r = lambda *axes: logical_to_spec(axes, mesh)
    nd = getattr(leaf, "ndim", 0)
    stacked = ("['layers']" in path and not _LAYER_LIST_RE.search(path))
    if stacked:
        nd -= 1                            # effective per-layer ndim

    def out(spec: PartitionSpec) -> PartitionSpec:
        return P(None, *spec) if stacked else spec

    if "table_q" in path or "table_scale" in path:
        return r("vocab", None)            # embeddings are never stacked

    wide_out = any(k in path for k in _WIDE_OUT)
    wide_in = any(k in path for k in _WIDE_IN)
    is_weight = ("w_q" in path or "['w']" in path)

    if "experts" in path:
        # EP over the model axis when E divides it; otherwise TP within
        # each expert on its hidden dim
        shp = leaf.shape[1:] if stacked else leaf.shape
        m_size = mesh.shape.get("model", 1)
        ep_ok = len(shp) >= 1 and shp[0] % m_size == 0
        if nd == 3 and "w_scale" in path:            # [E, 1, d_out]
            if ep_ok:
                return out(r("expert", None, None))
            return out(P(None, None, "model")) if wide_out else out(P())
        if nd == 3:                                  # [E, d_in, d_out]
            if ep_ok:
                return out(r("expert", None, None))
            if "core" in path:
                return out(P()) if wide_out else out(P(None, "model", None))
            if wide_out:
                return out(P(None, None, "model"))
            return out(P(None, "model", None))      # down: contract dim
        if nd == 2 and "['C']" in path:              # shared compress
            return out(P()) if wide_out else out(P("model", None))
        if nd == 2 and "['U']" in path:              # shared decompress
            return out(P(None, "model")) if wide_out else out(P())
        return P()

    if nd == 2 and is_weight:
        if wide_out:
            return out(r(None, "mlp"))     # model axis on outputs
        if wide_in:
            return out(r("mlp", None))     # model axis on inputs
        return P()
    if nd == 2 and "w_scale" in path:
        if wide_out:
            return out(r(None, "mlp"))     # scales track the trunk outputs
        return P()
    # branch tensors: column-parallel trunks keep C/core replicated and U
    # on the outputs; row-parallel trunks shard C and core on the
    # contracting side
    if nd == 2 and "['U']" in path:
        return out(r(None, "mlp")) if wide_out else P()
    if nd == 2 and "core" in path:
        return P() if wide_out else out(r("mlp", None))
    if nd == 2 and "['C']" in path:
        return P() if wide_out else out(r("mlp", None))
    return P()                             # small: replicate


def _size_check(spec: PartitionSpec, shape, mesh) -> PartitionSpec:
    """Drop spec axes whose dimension doesn't divide the mesh axes."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    fixed = []
    for dim, part in zip(shape, parts):
        if part is None:
            fixed.append(None)
            continue
        names = part if isinstance(part, tuple) else (part,)
        size = math.prod(mesh.shape[n] for n in names)
        fixed.append(part if dim % size == 0 and dim >= size else None)
    while fixed and fixed[-1] is None:
        fixed.pop()
    return P(*fixed)


def param_specs(params, mesh=None):
    """Tree of PartitionSpec matching ``params`` (leaves named as
    ``jax.tree_util.keystr`` names them)."""
    mesh = mesh or current_mesh()
    return bridge.map_named(params, lambda path, leaf: _spec_of(path, leaf,
                                                                 mesh))


def _spec_of(path: str, leaf, mesh) -> PartitionSpec:
    if mesh is None:
        return P()
    return _size_check(_spec_for_param(path, leaf, mesh), tuple(leaf.shape),
                       mesh)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart): per
    dimension of a leaf, the mesh axes its blocks are spread over."""
    mesh: Any
    spec: PartitionSpec


def param_shardings(params, mesh):
    """Tree of :class:`NamedSharding` matching ``params``."""
    return bridge.map_named(params, lambda path, leaf: NamedSharding(
        mesh, _spec_of(path, leaf, mesh)))


def block_bounds(shape, sharding: NamedSharding) -> list[tuple[int, int]]:
    """This rank's ``(lo, hi)`` per dimension of a leaf of ``shape`` under
    ``sharding``: a dimension over axes ``(a, b)`` is split
    ``size_a * size_b`` ways in GSPMD's uneven layout (:func:`h_layout`),
    block ``coord_a * size_b + coord_b``."""
    mesh, spec = sharding.mesh, tuple(sharding.spec)
    out = []
    for d, size in enumerate(shape):
        part = spec[d] if d < len(spec) else None
        if part is None:
            out.append((0, size))
            continue
        names = part if isinstance(part, tuple) else (part,)
        n, c = 1, 0
        for a in names:
            n, c = n * mesh.shape[a], c * mesh.shape[a] + mesh.coordinate(a)
        out.append(h_layout(size, n)[c])
    return out


def local_block(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``sharding``."""
    return _cut(x, block_bounds(x.shape, sharding))


def _cut(x: torch.Tensor, bounds) -> torch.Tensor:
    """The block of ``x`` within ``bounds`` in storage of its own: a view
    (a cut along dim 0 is contiguous) would keep the whole tensor's
    storage alive on the rank as long as the block lives."""
    whole = x
    for d, (lo, hi) in enumerate(bounds):
        if hi - lo != x.shape[d]:
            x = x.narrow(d, lo, hi - lo)
    if x is whole:
        return x.contiguous()
    return x.clone(memory_format=torch.contiguous_format)


def is_row_contraction(path: str) -> bool:
    """Whether the leaf at ``path`` holds the contracting rows of a
    row-parallel site (its ``w_q``, plain ``w`` or ``C``): those split by
    :func:`k_layout`, not evenly."""
    return (any(k in path for k in _WIDE_IN) and "experts" not in path
            and ("w_q" in path or "['w']" in path or "['C']" in path))


def head_site(path: str) -> str | None:
    """``"q"`` or ``"o"`` for the leaves of the attention's head sites that
    :func:`param_bounds` deals in whole heads (q's ``w_q``/``w``,
    ``w_scale`` and ``U`` columns; o's contracting rows), else None."""
    if "['attn']" not in path or "experts" in path:
        return None
    if "['q']" in path and any(k in path for k in (
            "w_q", "['w']", "w_scale", "['U']")):
        return "q"
    if "['o']" in path and is_row_contraction(path):
        return "o"
    return None


def param_bounds(path: str, shape, sharding: NamedSharding,
                 rows: int = 128, head_dim: int | None = None,
                 experts: tuple[int, int] | None = None
                 ) -> list[tuple[int, int]]:
    """:func:`block_bounds` of a parameter leaf, with the contracting rows
    of a row-parallel site dealt as whole k-blocks (:func:`k_layout`; over
    several mesh axes flattened in mesh order).  Over a model axis of
    size > 1 the head sites' leaves (:func:`head_site`) are cut on whole
    heads of ``head_dim`` columns (required for them), whatever the size
    rule says: q's output columns by :func:`head_layout`, o's contracting
    rows by :func:`k_layout`.  The moe block's expert leaves follow
    :func:`expert_layout` of ``experts`` (E, ff; required for them): a
    rank of the ``"expert"`` layout holds its experts whole, the shared C
    and U with them, and the ``"whole"`` layout cuts nothing, whatever the
    size rule says of C, U or a core alone."""
    m = sharding.mesh
    bounds = block_bounds(shape, sharding)
    if "['experts']" in path and mesh_axis_for("expert", m):
        if not experts:
            raise ValueError(f"{path} follows the expert layout: pass "
                             f"experts=(E, ff)")
        layout = expert_layout(*experts, m)
        if layout == "whole" or (layout == "expert" and any(
                k in path for k in ("['C']", "['U']"))):
            return [(0, s) for s in shape]
        return bounds
    site = head_site(path)
    axis = site and mesh_axis_for("heads", m)
    if axis:
        if not head_dim:
            raise ValueError(f"{path} is cut on whole heads: pass head_dim")
        n, c = m.shape[axis], m.coordinate(axis)
        if site == "q":
            bounds[-1] = head_layout(shape[-1], head_dim, n)[c]
        else:
            bounds[-2] = k_layout(shape[-2], n, rows)[c]
        return bounds
    if not is_row_contraction(path):
        return bounds
    for d, part in enumerate(tuple(sharding.spec)):
        if part is None:
            continue
        n, c = 1, 0
        for a in (part if isinstance(part, tuple) else (part,)):
            n, c = n * m.shape[a], c * m.shape[a] + m.coordinate(a)
        bounds[d] = k_layout(shape[d], n, rows)[c]
    return bounds


def local_param(path: str, x: torch.Tensor, sharding: NamedSharding,
                rows: int = 128, head_dim: int | None = None,
                experts: tuple[int, int] | None = None) -> torch.Tensor:
    """This rank's block of the whole parameter leaf ``x`` at ``path``
    (:func:`param_bounds`)."""
    return _cut(x, param_bounds(path, x.shape, sharding, rows, head_dim,
                                experts))


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------

def cache_spec(p: str, leaf, mesh) -> PartitionSpec:
    """The reference's path+shape rule for one KV/SSM cache leaf (leaf
    names as ``bridge.flatten`` gives them): the batch over pod+data, kv
    heads over ``model`` where they divide it, else the sequence
    (flash-decoding style), a batch-1 cache's sequence over every axis."""
    baxes = [a for a in ("pod", "data") if a in mesh.axis_names]
    b_total = math.prod(mesh.shape[a] for a in baxes)
    m_size = mesh.shape.get("model", 1)
    # scan-over-layers archs stack caches with a leading L dim
    stacked = "['layers']" in p and not _LAYER_LIST_RE.search(p)
    shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
    nd = len(shape)
    pre = (None,) if stacked else ()
    if ("'k'" in p or "'v'" in p) and nd == 4:
        bsz, s, kv, _ = shape
        bspec = tuple(baxes) if bsz >= b_total else None
        if bspec is None:
            # batch-1 long-context: shard the sequence instead
            return P(*pre, None,
                     tuple(mesh.axis_names) if s % mesh.size == 0 else None,
                     None, None)
        if kv % m_size == 0:
            return P(*pre, bspec, None, "model", None)
        if s % m_size == 0:
            # kv heads do not divide the model axis: shard the cache
            # sequence (flash-decoding style)
            return P(*pre, bspec, "model", None, None)
        return P(*pre, bspec, None, None, None)
    if "'h'" in p and nd == 3:                 # [B, d_inner, N]
        bspec = tuple(baxes) if shape[0] >= b_total else None
        return P(*pre, bspec,
                 "model" if shape[1] % m_size == 0 else None, None)
    if "'conv'" in p and nd == 3:              # [B, K-1, d_inner]
        bspec = tuple(baxes) if shape[0] >= b_total else None
        return P(*pre, bspec, None,
                 "model" if shape[2] % m_size == 0 else None)
    return P()
