"""Logical-axis sharding rules (port of ``repro.distributed.sharding``),
and the H layout of a sharded CNN activation.

The rules are the reference's letter for letter: models name *logical*
axes, a context-scoped rule set maps them onto mesh axes, and
``param_specs`` derives a PartitionSpec for every parameter from its tree
path.  These are pure metadata here and resolve on any mesh, an
:class:`~repro_torch.launch.mesh.AbstractMesh` of 16x16 included.

What runs is the CNN serving layout, the reference's
``shard(x, "cnn_batch", "cnn_h")``: an NHWC activation split over H on the
mesh axis the ``"cnn_h"`` rule names, as GSPMD splits an uneven
dimension: rank r of n holds rows ``[r*c, min((r+1)*c, H))`` with
``c = ceil(H/n)`` (a rank may hold none).  Each rank holds its slab as a
plain tensor; :func:`global_h` recovers H from the slabs' heights (one
small all-gather, which also checks the layout), and :func:`move_rows`
is the one place where rows change owner: halos, re-layouts and gathers
all go through it, and it counts what it sends (``rows_sent``,
``bytes_sent``, by kind).  Over a gloo group, rows of a CUDA tensor go
through host buffers (gloo sends no CUDA tensor); that follows from the
mesh's backend, not from a failed attempt.

Logical axes outside the CNN layout (every LM axis, and an image batch
over ``pod``) are not executed yet: :func:`shard` raises naming the slice
that ports them.  ``param_shardings`` waits for the multi-device training
slice, its first caller.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import math
import re

import torch
import torch.distributed as dist

from repro_torch import bridge

TRAIN_SLICE = ("the multi-device training slice (ROADMAP Queue 1 item "
               "5(b))")
LM_SLICE = "the LM tensor-parallel slice (ROADMAP Queue 1 item 5(c))"

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
# 'relayout', 'gather'), since the last reset_traffic()
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
    names; trailing Nones dropped (``jax.sharding.PartitionSpec``'s
    layout)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

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


def h_axis(mesh=None):
    """``(mesh, axis)`` when NHWC activations shard over H (the ``"cnn_h"``
    rule names an axis of size > 1), else None."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return None
    if mesh_axis_for("cnn_batch", mesh) is not None:
        raise NotImplementedError(
            f"an image batch sharded over "
            f"{mesh_axis_for('cnn_batch', mesh)!r} is not executed by the "
            f"port yet: it comes with {TRAIN_SLICE}")
    axis = mesh_axis_for("cnn_h", mesh)
    if axis is None:
        return None
    if not hasattr(mesh, "group"):
        raise TypeError(f"{mesh!r} has no process groups: activations "
                        f"shard over a launch.mesh.Mesh")
    return mesh, axis


def _collective_device(mesh, x: torch.Tensor) -> torch.device:
    """Where a collective of ``mesh``'s backend takes its tensors."""
    return x.device if mesh.backend == "nccl" else torch.device("cpu")


def global_h(x: torch.Tensor, mesh, axis: str) -> int:
    """H of the activation whose slab this rank holds (an all-gather of
    the slabs' heights, checked against the H layout)."""
    n = mesh.shape[axis]
    mine = torch.tensor([x.shape[1]], dtype=torch.int64,
                        device=_collective_device(mesh, x))
    heights = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(heights, mine, group=mesh.group(axis))
    heights = [int(t.item()) for t in heights]
    h = sum(heights)
    if heights != [b - a for a, b in h_layout(h, n)]:
        raise RuntimeError(f"slab heights {heights} over {n} ranks are not "
                           f"the H layout of {h} rows")
    return h


def move_rows(x: torch.Tensor, have: list, want: list, mesh, axis: str,
              kind: str) -> torch.Tensor:
    """Rows ``want[r]`` (global ``(lo, hi)``) of the activation for this
    rank r, which holds rows ``have[r]`` as ``x``; ``have`` and ``want``
    are the same lists on every rank.  Rows outside every ``have`` (the
    conv's zero padding, outside ``[0, H)``) are zeros.  Only the rows that
    change owner cross between ranks, one message per pair at most."""
    if list(want) == list(have):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            f"rows sent between ranks carry no gradient back yet: the "
            f"adjoint of the exchange comes with {TRAIN_SLICE}")
    n, r = mesh.shape[axis], mesh.coordinate(axis)
    group = mesh.group(axis)
    host = mesh.backend == "gloo" and x.device.type != "cpu"
    lo, hi = want[r]
    a0, a1 = have[r]
    out = x.new_zeros((x.shape[0], hi - lo, *x.shape[2:]))
    ops, recvs = [], []
    for q in range(n):
        s0, s1 = max(a0, want[q][0]), min(a1, want[q][1])
        if q == r:
            if s1 > s0:
                out[:, s0 - lo:s1 - lo] = x[:, s0 - a0:s1 - a0]
            continue
        peer = dist.get_global_rank(group, q)
        if s1 > s0:                       # my rows that q wants
            piece = x[:, s0 - a0:s1 - a0].contiguous()
            piece = piece.cpu() if host else piece
            ops.append(dist.P2POp(dist.isend, piece, peer, group=group))
            rows_sent[kind] += s1 - s0
            bytes_sent[kind] += piece.numel() * piece.element_size()
        t0, t1 = max(have[q][0], lo), min(have[q][1], hi)
        if t1 > t0:                       # q's rows that I want
            buf = torch.empty((x.shape[0], t1 - t0, *x.shape[2:]),
                              dtype=x.dtype,
                              device="cpu" if host else x.device)
            ops.append(dist.P2POp(dist.irecv, buf, peer, group=group))
            recvs.append((t0, buf))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for t0, buf in recvs:
        out[:, t0 - lo:t0 - lo + buf.shape[1]] = buf.to(x.device)
    return out


def reset_traffic():
    """``rows_sent`` and ``bytes_sent`` to empty."""
    rows_sent.clear()
    bytes_sent.clear()


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """This rank's slab of a whole (replicated) NHWC activation, for
    ``shard(x, "cnn_batch", "cnn_h")``.  Without a mesh, on a 1-rank mesh
    or on a size-1 axis it returns ``x`` untouched."""
    mesh = current_mesh()
    if mesh is None or mesh.size == 1:
        return x
    for ax in axes:
        if ax not in (None, "", "cnn_batch", "cnn_h"):
            raise NotImplementedError(
                f"shard over logical axis {ax!r} is not executed by the "
                f"port yet: the LM axes come with {LM_SLICE}")
    at = h_axis(mesh)
    if at is None or "cnn_h" not in axes:
        return x
    if axes.index("cnn_h") != 1:
        raise ValueError(f"the H layout shards dim 1 of an NHWC activation; "
                         f"got logical axes {axes}")
    mesh, axis = at
    lo, hi = h_layout(x.shape[1], mesh.shape[axis])[mesh.coordinate(axis)]
    return x[:, lo:hi].contiguous()


def gather_h(x: torch.Tensor) -> torch.Tensor:
    """The whole activation on every rank from the slabs of the H layout
    (``x`` itself when nothing is sharded)."""
    at = h_axis()
    if at is None:
        return x
    mesh, axis = at
    h, n = global_h(x, mesh, axis), mesh.shape[axis]
    return move_rows(x, h_layout(h, n), [(0, h)] * n, mesh, axis, "gather")


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

    def one(path, leaf):
        if mesh is None:
            return P()
        return _size_check(_spec_for_param(path, leaf, mesh),
                           tuple(leaf.shape), mesh)

    return bridge.map_named(params, one)


def param_shardings(params, mesh):
    raise NotImplementedError(
        f"param_shardings places parameters on a sharded mesh; it comes "
        f"with {TRAIN_SLICE}, its first caller")
