"""What a step costs: FLOPs, HBM bytes and collective bytes (port of
``repro.launch.hlo_cost``).

The reference parses the partitioned HLO of a compiled step.  Nothing here
reads HLO: an eager step is counted as it runs, on the card, on the CPU or
on the ``meta`` device (shapes only, nothing computed), so a dry run of a
production cell and a real step on the card give the same counts.

    from repro_torch.launch import cost
    with cost.count() as rec:
        step(params, batch, cache)
    rec["flops"], rec["hbm_bytes"], rec["collective_bytes"]

or ``cost.analyse(fn, *args)`` for the dict the reference's
``analyse_text`` returns.  The record's keys:

  * ``flops``            : ``torch.utils.flop_counter``'s formula for every
                           matmul-like op and convolution (2*M*N*K, int8
                           ``aten._int_mm`` included, as the reference
                           counts int8 dots), plus each hand-written
                           kernel's work (below).
  * ``hbm_bytes``        : operand plus output bytes of every ATen op.
  * ``collective_bytes`` : bytes this rank sends through the port's
                           exchanges, by the reference's op names in
                           ``collectives`` (:data:`COLLECTIVE_OF`).
  * ``by_op``            : per ATen op: calls, FLOPs, bytes.
  * ``kernels``          : per hand-written kernel: ``launches``,
                           ``flops``, ``trunk_flops``, ``bytes`` and
                           ``work``, the launches by their ``(int8_ops,
                           f32_ops, bytes)`` (a roofline bound per
                           launch).
  * ``bytes_sent``, ``wire_bytes``: the port's exchange counters by
                           kind over this record (outside a record they
                           count into ``sharding.bytes_sent`` and
                           ``compress.wire_bytes``).
  * ``fallbacks``        : the 'pallas_sharded' layers run gathered
                           (``engine.sharded.fallbacks`` outside a
                           record).
  * ``peak_bytes``         : the peak of the storages created while
                           counting that are alive at once (storages made
                           before the record are not tracked).

Where the conventions differ from the reference's:

  * **Op-granular bytes.**  An eager op is one kernel, so each op's
    operands and outputs count; the reference's are fusion-granular
    (one fused computation reads its operands once).  A view (``view``,
    ``reshape`` as a view, ``transpose``, ``narrow``, ``as_strided``,
    ...) counts nothing, nor does an allocation without a write
    (``empty``) or a copy between devices (host staging is not HBM
    traffic).  An in-place op counts its written operand once, as the
    output it writes: the reference's alias rule, which keeps a cache
    update from being billed as a copy of the whole cache.
  * **Kernels by the function they compute.**  Each hand-written kernel
    (``trunk_conv``, ``rebranch_matmul``, ``cim_matmul``) counts as one op
    by its geometry, in every CiM mode and on every device, and the ops
    its wrapper runs (the plain version on the CPU) count nothing, so the
    count does not depend on which implementation ran.  ``trunk_conv``
    and ``cim_matmul`` count 2*M*K*N (``trunk_conv``: M = N*OH*OW, K =
    KH*KW*C_in), ``rebranch_matmul`` its trunk plus 2*M*K*Cd for the
    sketch; bytes are x in its dtype, W int8, C in its dtype and the f32
    outputs, each once.
  * **Loops count per iteration.**  A Python loop runs its ops each time,
    where the reference multiplies a ``while`` body by its trip count.
  * **Collective bytes are bytes sent.**  The reference counts each
    collective's output bytes; the port counts what this rank sends
    (``sharding.move_rows``/``gather_parts``, ``optim.compress``), under
    the reference's op that plays the same part (:data:`COLLECTIVE_OF`).

The kernel wrappers and the exchanges reach the active record through a
``contextvars.ContextVar`` (:func:`recording`): outside ``count()`` they
pay one lookup.  A record is per thread (the dispatch mode and the
context variable are both thread-local).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# the reference's collective op names (``hlo_cost._COLLECTIVES``)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# the port's exchange kinds -> the reference's op that plays their part:
# row moves between neighbours are permutes, a gather of every rank's rows
# an all-gather (its adjoint a reduce-scatter), and the rank-order sums
# and maxima (``sharding.gather_parts``) are the reference's psums and
# pmaxes, whatever bytes the port's all-gather moves for them
COLLECTIVE_OF = {
    "halo": "collective-permute", "relayout": "collective-permute",
    "halo_adjoint": "collective-permute",
    "relayout_adjoint": "collective-permute",
    "gather": "all-gather", "gather_adjoint": "reduce-scatter",
    "reduce": "all-reduce", "attention": "all-reduce", "embed": "all-reduce",
    "argmax": "all-reduce", "absmax": "all-reduce", "loss": "all-reduce",
    "f32": "all-reduce", "int8": "all-gather",
    # training over the model axis: the adjoints of a rank-order sum (a
    # sum of the ranks' gradients, or a gather of a chunked sum's) and of
    # Megatron's f, and the model-axis sum of the replicated leaves'
    # gradients
    "reduce_adjoint": "all-reduce", "chunk_adjoint": "all-gather",
    "replicate_adjoint": "all-reduce", "grads": "all-reduce",
    # the moe block over a mesh: its rank-order sums over the model axis
    # (sharding.sum_parts, and sum_chunk's reduce-scatter onto a chunk)
    # and the routing counts gathered over the batch axes
    "expert": "all-reduce", "expert_scatter": "reduce-scatter",
    "routing": "all-gather",
}

# ops that read and write nothing (allocation, metadata, scalars)
_NO_TRAFFIC = {
    aten.empty.memory_format, aten.empty_strided.default,
    aten.empty_like.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten._unsafe_view.default,
    aten.lift_fresh.default, aten._local_scalar_dense.default,
    aten.set_.source_Storage_storage_offset, aten.resize_.default,
}

_active: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_cost", default=None)
_times: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_cost_times", default=1)


def recording():
    """The active :class:`Record` of this thread, or None."""
    return _active.get()


def times() -> int:
    """How many runs the ops now running stand for (:func:`repeated`)."""
    return _times.get()


def _int_mm_flops(a, b, *args, out_val=None, **kwargs):
    return 2 * a.shape[0] * a.shape[1] * b.shape[1]


_FLOPS = dict(flop_counter.flop_registry)
_FLOPS[aten._int_mm] = _int_mm_flops


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class Record(dict):
    """One count (see the module docstring for the keys)."""

    def __init__(self):
        super().__init__(
            flops=0, hbm_bytes=0, collective_bytes=0,
            collectives=dict.fromkeys(COLLECTIVES, 0),
            by_op={}, kernels={}, bytes_sent=collections.Counter(),
            wire_bytes=collections.Counter(), peak_bytes=0, fallbacks=0)
        self._hidden = 0            # counts nothing (a kernel's wrapper)
        self._untracked = 0         # nor tracks storages (shape helpers)
        self._live = {}             # id(storage) -> (serial, nbytes)
        self._serial = 0
        self._live_bytes = 0
        self.timeline = []          # (serial, +nbytes or -nbytes)

    # -- ops ------------------------------------------------------------
    def _op(self, func, args, kwargs, out):
        if func in _NO_TRAFFIC or func.is_view:
            return
        written = set()
        for a, arg in zip(func._schema.arguments, args):
            if a.alias_info is not None and a.alias_info.is_write:
                written.add(id(arg))
        for name, v in kwargs.items():
            if name == "out":
                written.add(id(v))
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if func in (aten._to_copy.default, aten.copy_.default) and any(
                t.device != (outs or ins)[0].device for t in ins):
            return                  # host staging: not HBM traffic
        nbytes = (sum(_nbytes(t) for t in ins if id(t) not in written)
                  + sum(_nbytes(t) for t in outs))
        formula = _FLOPS.get(func.overloadpacket)
        flops = formula(*args, **kwargs, out_val=out) if formula else 0
        t = _times.get()
        flops, nbytes = flops * t, nbytes * t
        self["flops"] += flops
        self["hbm_bytes"] += nbytes
        entry = self["by_op"].setdefault(
            str(func.overloadpacket), {"calls": 0, "flops": 0, "bytes": 0})
        entry["calls"] += t
        entry["flops"] += flops
        entry["bytes"] += nbytes

    # -- storages ---------------------------------------------------------
    def _track(self, args, out):
        seen = {id(t.untyped_storage()) for t in pytree.tree_leaves(args)
                if isinstance(t, torch.Tensor)}
        for t in pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            s = t.untyped_storage()
            if id(s) in seen or id(s) in self._live:
                continue
            seen.add(id(s))
            self._serial += 1
            n = s.nbytes()
            self._live[id(s)] = (self._serial, n)
            self._live_bytes += n
            self["peak_bytes"] = max(self["peak_bytes"], self._live_bytes)
            self.timeline.append((self._serial, n))
            weakref.finalize(s, self._free, id(s))

    def _free(self, key):
        serial, n = self._live.pop(key)
        self._live_bytes -= n
        self.timeline.append((serial, -n))

    def serial_of(self, t: torch.Tensor):
        """The serial of ``t``'s storage if this record saw it made and it
        is alive, else None."""
        entry = self._live.get(id(t.untyped_storage()))
        return None if entry is None else entry[0]

    def peak_excluding(self, serials) -> int:
        """The peak of the live tracked storages, those of ``serials``
        left out (a step's outputs, to count them once)."""
        skip, live, peak = set(serials), 0, 0
        for serial, n in self.timeline:
            if serial in skip:
                continue
            live += n
            peak = max(peak, live)
        return peak

    # -- kernels and exchanges ----------------------------------------------
    def _kernel(self, name: str, int8_ops: int, f32_ops: int, nbytes: int):
        k = self["kernels"].setdefault(name, {
            "launches": 0, "flops": 0, "trunk_flops": 0, "bytes": 0,
            "work": collections.Counter()})
        t = _times.get()
        k["launches"] += t
        k["flops"] += (int8_ops + f32_ops) * t
        k["trunk_flops"] += int8_ops * t
        k["bytes"] += nbytes * t
        k["work"][int8_ops, f32_ops, nbytes] += t
        self["flops"] += (int8_ops + f32_ops) * t
        self["hbm_bytes"] += nbytes * t

    def sent(self, counter: str, kind: str, nbytes: int):
        """``nbytes`` sent under ``kind`` of the port's counter
        ``counter`` (``"bytes_sent"`` or ``"wire_bytes"``), already
        multiplied by :func:`times`."""
        self[counter][kind] += nbytes
        op = COLLECTIVE_OF.get(kind, "collective-permute")
        self["collectives"][op] += nbytes
        self["collective_bytes"] += nbytes

    def summary(self) -> dict:
        """The dict of the reference's ``analyse_text``."""
        return {"flops": self["flops"], "hbm_bytes": self["hbm_bytes"],
                "collective_bytes": self["collective_bytes"],
                "collectives": {k: v for k, v in self["collectives"].items()
                                if v}}


class _Counter(TorchDispatchMode):
    def __init__(self, rec: Record):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "aten" and not self.rec._untracked:
            self.rec._track((args, kwargs), out)
            if not self.rec._hidden:
                self.rec._op(func, args, kwargs, out)
        return out


@contextlib.contextmanager
def count():
    """Count every op this thread runs inside the block into the yielded
    :class:`Record`."""
    rec = Record()
    token = _active.set(rec)
    # a backward cut short leaves no repeat count behind the record
    times = _times.set(_times.get())
    try:
        with _Counter(rec):
            yield rec
    finally:
        _times.reset(times)
        _active.reset(token)


@contextlib.contextmanager
def repeated(n: int):
    """Count what the block runs as ``n`` runs of it (the reference
    multiplies a ``while`` body by its trip count): the ``meta`` route of
    a loop whose iterations all run the same ops on the same shapes
    (``core.rows.rowwise``, a transformer's layers) runs one and stands
    for the rest.  The exchange counters count ``n`` times too."""
    token = _times.set(_times.get() * n)
    try:
        yield
    finally:
        _times.reset(token)


class _RepeatMark(torch.autograd.Function):
    """The identity at one end of a region that :func:`repeated_grad`
    counts ``n`` times in the backward: the mark on its output (``"out"``,
    first in the backward) multiplies the count, the first of the marks on
    its inputs to run (after every node of the region) restores it and
    drops the stand-ins the region keeps alive for its other runs."""

    @staticmethod
    def forward(ctx, x, box, end):
        ctx.box, ctx.end = box, end
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        box = ctx.box
        if ctx.end == "out":
            box["token"] = _times.set(_times.get() * box["n"])
        elif box["token"] is not None:
            _times.reset(box["token"])
            box["token"] = None
            box["keep"].clear()
        return g, None, None


def repeated_grad(n: int, *inputs, keep=()):
    """The backward side of :func:`repeated`: ``(inputs, close)`` for a
    region run once on ``meta`` that stands for ``n`` runs, ``close``
    applied to its output.  Between the output's mark and the first of
    the inputs' marks the backward counts ``n`` times: the engine runs
    the ready node made last, and every node of the region is made after
    the inputs' marks and waits only on nodes of the region (an input the
    region does not use gets no gradient; any other input's mark runs).
    ``keep`` (storages standing for the other runs' saved tensors) lives
    until the region's backward has run.  Nothing is marked unless
    autograd records for some input and ``n`` > 1."""
    box = {"n": n, "token": None, "keep": list(keep)}
    marked, live = [], False
    for x in inputs:
        if n > 1 and torch.is_grad_enabled() and x.requires_grad:
            x = _RepeatMark.apply(x, box, "in")
            live = True
        marked.append(x)

    def close(out):
        if not (live and out.requires_grad):
            return out
        return _RepeatMark.apply(out, box, "out")
    return marked, close


@contextlib.contextmanager
def untracked():
    """Neither count nor track what the block runs: the ``meta`` tensors a
    step makes only to read shapes from (a whole cache whose blocks the
    rank then allocates) are no part of its cost or memory."""
    rec = _active.get()
    if rec is None:
        yield
        return
    rec._untracked += 1
    try:
        yield
    finally:
        rec._untracked -= 1


def analyse(fn, *args, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` counted: the dict the reference's
    ``hlo_cost.analyse_text`` returns (``flops``, ``hbm_bytes``,
    ``collective_bytes``, ``collectives``)."""
    with count() as rec:
        fn(*args, **kwargs)
    return rec.summary()


def kernel(name: str, int8_ops: int, f32_ops: int, nbytes: int, run, meta):
    """One call of the hand-written kernel ``name``, counted by its work
    (``int8_ops`` on the int8 path, ``f32_ops`` beside it, ``nbytes`` moved)
    into the active record, the ops of ``run`` hidden from it.  On the
    ``meta`` device ``meta()`` gives the outputs and nothing runs.  Called
    by a wrapper only when counting or on meta (:func:`recording`)."""
    rec = _active.get()
    if rec is not None:
        rec._kernel(name, int8_ops, f32_ops, nbytes)
    if meta is not None:
        return meta()
    if rec is None:
        return run()
    rec._hidden += 1
    try:
        return run()
    finally:
        rec._hidden -= 1
