"""ReBranch (paper §3.2, Fig. 7): frozen ROM trunk + small trainable
branch (port of ``repro.core.rebranch``).

    y = Trunk_ROM(x) + Decompress(ResCore(Compress(x))) (+ bias)

Parameter convention: every subtree under a ``"rom"`` dict key is frozen
(no gradient, no optimizer state); ``partition``/``combine`` implement
that split.  The trunk ops are ``torch.autograd.Function``s whose
backward is the straight-through estimator: dx only, never a dW (the ROM
cannot be written).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import bridge
from repro_torch.core import cim as cim_lib
from repro_torch.core import quant, rows

ROM_KEY = "rom"


@dataclasses.dataclass(frozen=True)
class ReBranchSpec:
    d_ratio: int = 4                 # compression ratio D (paper Fig. 11)
    u_ratio: int = 4                 # decompression ratio U
    enabled: bool = True             # False -> plain trainable layer ("SRAM")
    # trunk execution backend: a name in the repro_torch.engine registry
    trunk_impl: str = "int8_native"
    cim: cim_lib.CiMConfig = dataclasses.field(
        default_factory=lambda: cim_lib.CiMConfig(mode="ideal"))
    param_dtype: Any = torch.float32  # branch/scale dtype
    branch_enabled: bool = True      # trunk-only (no adapter) if False
    # speculative-draft mode: skip the ROM trunk, run only the branch
    trunk_skip: bool = False

    @property
    def compression(self) -> int:
        return self.d_ratio * self.u_ratio


# ---------------------------------------------------------------------------
# ROM (frozen) vs SRAM (trainable) split of a parameter tree
# ---------------------------------------------------------------------------

def partition(params):
    """Split params into (trainable, frozen) trees; non-members are None."""
    def walk(node, in_rom):
        if isinstance(node, dict):
            train, froz = {}, {}
            for k, v in node.items():
                train[k], froz[k] = walk(v, in_rom or k == ROM_KEY)
            return train, froz
        if isinstance(node, (list, tuple)):
            pairs = [walk(v, in_rom) for v in node]
            return (type(node)(p[0] for p in pairs),
                    type(node)(p[1] for p in pairs))
        return (None, node) if in_rom else (node, None)

    return walk(params, False)


def combine(trainable, frozen):
    """Inverse of :func:`partition`."""
    if isinstance(trainable, dict):
        return {k: combine(trainable[k], frozen[k]) for k in trainable}
    if isinstance(trainable, (list, tuple)):
        return type(trainable)(combine(a, b)
                               for a, b in zip(trainable, frozen))
    return trainable if trainable is not None else frozen


def trainable_count(params) -> int:
    """Elements on the SRAM (trainable) side of :func:`partition`."""
    return sum(t.numel() for t in bridge.flatten(partition(params)[0]).values())


def frozen_count(params) -> int:
    """Elements on the ROM (frozen) side of :func:`partition`."""
    return sum(t.numel() for t in bridge.flatten(partition(params)[1]).values())


# ---------------------------------------------------------------------------
# trunk matmul / conv: frozen int8 path with a straight-through backward
# ---------------------------------------------------------------------------

class _TrunkMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_q, w_scale, cfg):
        x_q, sx = quant.quantize_activations(x)
        out = cim_lib.cim_matmul_model(x_q, w_q, cfg)
        ctx.save_for_backward(w_q, w_scale)
        return (out * sx).to(x.dtype) * w_scale.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        w_q, w_scale = ctx.saved_tensors
        w_deq = w_q.to(g.dtype) * w_scale.to(g.dtype)          # [K, N]
        return g @ w_deq.T, None, None, None


def trunk_matmul(cfg, x, w_q, w_scale):
    """y = CiM(quantize(x), w_q) * (sx * w_scale); STE backward."""
    return _TrunkMatmul.apply(x, w_q, w_scale, cfg)


class _ZerosFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shape, dtype, src, *more):
        ctx.src = [(t.shape, t.dtype, t.device) for t in (src, *more)]
        return src.new_zeros(shape, dtype=dtype)

    @staticmethod
    def backward(ctx, g):
        return (None, None, *(torch.zeros(s, dtype=d, device=v)
                              for s, d, v in ctx.src))


def zeros_from(src: torch.Tensor, shape, *more: torch.Tensor,
               dtype=None) -> torch.Tensor:
    """Zeros of ``shape`` (``src``'s dtype by default) that stand in the
    autograd graph after ``src`` and ``more`` (zero gradient): an empty
    result that still leads back to its inputs, so that a rank of a mesh
    with no rows (or heads, or k-blocks) to compute reaches the exchanges
    before it in its backward, as the other ranks do."""
    return _ZerosFrom.apply(tuple(shape), dtype or src.dtype, src, *more)


def conv_nhwc(x, w, stride: int = 1, padding: str = "SAME"):
    """The port's one NHWC/HWIO conv: explicit XLA-style pads (the odd
    SAME pad at the bottom/right), then an unpadded ``F.conv2d``."""
    kh, kw = w.shape[0], w.shape[1]
    (ph0, ph1), oh = cim_lib.conv_pads(x.shape[1], kh, stride, padding)
    (pw0, pw1), ow = cim_lib.conv_pads(x.shape[2], kw, stride, padding)
    if x.shape[0] * oh * ow == 0:           # F.conv2d rejects empty maps
        return zeros_from(x, (x.shape[0], oh, ow, w.shape[3]))
    xp = F.pad(x, (0, 0, pw0, pw1, ph0, ph1)).permute(0, 3, 1, 2)
    y = F.conv2d(xp, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def trunk_conv_ste_bwd(stride: int, padding: str, x_shape, w_q, w_scale, g):
    """Shared STE backward: dx = conv_transpose(g, dequant(w)), no dW."""
    w_deq = w_q.to(g.dtype) * w_scale.reshape(1, 1, 1, -1).to(g.dtype)
    with torch.enable_grad():
        x0 = torch.zeros(x_shape, dtype=g.dtype, device=g.device,
                         requires_grad=True)
        y = conv_nhwc(x0, w_deq, stride, padding)
        (dx,) = torch.autograd.grad(y, x0, g)
    return dx


class _TrunkConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_q, w_scale, cfg, stride, padding):
        kh, kw, c_in, c_out = w_q.shape
        patches, _ = cim_lib.im2col(x, kh, kw, stride, padding)
        p_q, sp = quant.quantize_activations(patches)
        out = cim_lib.cim_matmul_model(
            p_q, w_q.reshape(kh * kw * c_in, c_out), cfg)
        ctx.save_for_backward(w_q, w_scale)
        ctx.geom = (stride, padding, x.shape)
        return (out * sp).to(x.dtype) * w_scale.reshape(-1).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        stride, padding, x_shape = ctx.geom
        w_q, w_scale = ctx.saved_tensors
        dx = trunk_conv_ste_bwd(stride, padding, x_shape, w_q, w_scale, g)
        return dx, None, None, None, None, None


def trunk_conv(cfg, stride: int, padding: str, x, w_q, w_scale):
    """Frozen int8 ROM trunk conv: im2col, per-patch-row quantisation, the
    CiM macro model; STE backward.  x [N, H, W, C_in] float, w_q
    [KH, KW, C_in, C_out] int8, w_scale per output channel."""
    return _TrunkConv.apply(x, w_q, w_scale, cfg, stride, padding)


def trunk_matmul_dequant(cfg, x, w_q, w_scale):
    """Float baseline: dequantised weights, fake-quantised activations."""
    del cfg
    w = w_q.to(x.dtype) * w_scale.to(x.dtype)
    return quant.fake_quant_ste(x) @ w


def trunk_conv_dequant(cfg, stride: int, padding: str, x, w_q, w_scale):
    """Conv analogue of :func:`trunk_matmul_dequant` on a plain conv."""
    del cfg
    w = w_q.to(x.dtype) * w_scale.to(x.dtype)
    return conv_nhwc(quant.fake_quant_ste(x), w, stride, padding)


# ---------------------------------------------------------------------------
# ReBranch linear layer
# ---------------------------------------------------------------------------

def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                spec: ReBranchSpec, *, w_init=None, use_bias: bool = False,
                name_scale: float = 1.0):
    """ReBranch linear params, drawn from ``gen`` on the generator's device.

    If ``w_init`` is given the trunk ROM image is built from it (freeze a
    pretrained matrix); otherwise the trunk is drawn N(0, 1/d_in) and
    frozen.  C and U are fixed scaled-Gaussian projections (ROM), the
    core starts at zero.  Draw order: trunk, C, U.
    """
    dt, dev = spec.param_dtype, gen.device
    if w_init is None:
        w_init = torch.randn((d_in, d_out), generator=gen, device=dev,
                             dtype=dt).mul_(name_scale / math.sqrt(d_in))
    if not spec.enabled:
        p = {"sram": {"w": w_init.to(dt)}}
        if use_bias:
            p["sram"]["b"] = torch.zeros((d_out,), dtype=dt, device=dev)
        return p
    w_q, w_scale = quant.quantize_weights(w_init, axis=0)
    del w_init
    rom = {"w_q": w_q, "w_scale": w_scale.to(dt)}
    p = {"rom": rom, "sram": {}}
    if spec.branch_enabled:
        d_c = max(1, d_in // spec.d_ratio)
        d_u = max(1, d_out // spec.u_ratio)
        # scaled in place: a readout's U (Qwen1.5-32B's 21.5 GiB) is drawn
        # without a second copy
        rom["C"] = torch.randn((d_in, d_c), generator=gen, device=dev,
                               dtype=dt).div_(math.sqrt(d_in))
        rom["U"] = torch.randn((d_u, d_out), generator=gen, device=dev,
                               dtype=dt).div_(math.sqrt(d_u))
        p["sram"]["core"] = torch.zeros((d_c, d_u), dtype=dt, device=dev)
    if use_bias:
        p["sram"]["b"] = torch.zeros((d_out,), dtype=dt, device=dev)
    return p


def _bias(y, sram):
    b = sram.get("b")
    return y if b is None else y + b.to(y.dtype)


def apply_linear(params, x, spec: ReBranchSpec, tp=None, sp=None):
    """Apply a ReBranch linear layer (or a plain linear if disabled).

    Routes as the JAX package does: ``trunk_skip`` runs the branch alone;
    an engine with a fused matmul computes trunk and sketch in one pass;
    otherwise the engine's trunk matmul plus the reassociated branch
    ``(x @ C) @ (core @ U)``.

    ``tp`` (``sharding.linear_tp``) runs the site over the model axis on
    the rank's block of its parameters (``CompiledModel.shard_params``):
    a column-parallel site on the whole x, giving the rank's output
    columns (its trunk the unsharded site's columns bit for bit), a
    row-parallel one by :func:`row_parallel_parts`, giving the whole
    output (or, with ``sp``, the seq_sp layout of every model rank,
    this rank's sequence chunk of it).

    In training (``launch.steps.BranchStep``) the leaves a site holds
    whole on every model rank but uses its own way (a column site's core,
    which meets only the rank's U columns, and its bias, cut to them; any
    trainable leaf of a site kept whole into the ``sp`` layout) are
    marked (``sharding.mark_partial``): their gradient here is this
    rank's part, which the step sums over the model axis when it reduces
    the gradients, in one exchange for all of them.
    """
    from repro_torch.distributed import sharding as shd
    if tp is not None and tp.role == "row":
        return _row_parallel(params, x, spec, tp, sp)
    if tp is not None:
        sram = params["sram"]
        b = sram.get("b")
        shd.mark_partial(sram.get("core"), b)
        lo, hi = tp.cols
        if hi == lo:              # a rank without columns launches nothing
            return zeros_from(x, (*x.shape[:-1], 0))
        if b is not None and b.shape[-1] != hi - lo:   # biases stay whole
            params = {**params, "sram": {**sram, "b": b[..., lo:hi]}}
    y = _apply_local(params, x, spec)
    if sp is not None:            # a site kept whole, into the seq_sp layout
        shd.mark_partial(params["sram"])
        mesh, axis = shd.model_axis()
        lo, hi = sp[mesh.coordinate(axis)]
        y = y.narrow(1, lo, hi - lo)
    return y


def _apply_local(params, x, spec: ReBranchSpec):
    if not spec.enabled:
        return _bias(x @ params["sram"]["w"].to(x.dtype), params["sram"])

    rom, sram = params["rom"], params["sram"]
    live = spec.branch_enabled and "core" in sram
    if spec.trunk_skip:
        # branch-only draft path: the ROM trunk never runs
        if live:
            c, u = rom["C"].to(x.dtype), rom["U"].to(x.dtype)
            y = (x @ c) @ (sram["core"].to(x.dtype) @ u)
        else:
            y = x.new_zeros((*x.shape[:-1], rom["w_q"].shape[-1]))
        return _bias(y, sram)
    from repro_torch import engine as engine_lib   # deferred: import cycle
    eng = engine_lib.resolve(spec)                 # strict + capability-gated
    if live and "matmul" in eng.capabilities.fused_ops:
        y = eng.fused_matmul(spec.cim, x, rom["w_q"], rom["w_scale"],
                             rom["C"], sram["core"], rom["U"])
        return _bias(y, sram)
    y = eng.matmul(spec.cim, x, rom["w_q"], rom["w_scale"])
    if live:
        c, u = rom["C"].to(x.dtype), rom["U"].to(x.dtype)
        cu = sram["core"].to(x.dtype) @ u
        # reassociated epilogue, as the reference: (x @ C) @ (core @ U),
        # on bucketed rows (batch-invariant bits, see core.rows)
        x2 = x.reshape(-1, x.shape[-1])
        y = y + rows.rowwise(lambda a: (a @ c) @ cu, x2).reshape(y.shape)
    return _bias(y, sram)


def row_parallel_parts(params, x, spec: ReBranchSpec, tp):
    """This rank's part of a row-parallel site, before any reduction: x
    (in the even layout of its K columns, ``tp.x_layout``) moved to the
    rank's whole k-blocks (``tp.k_ranges``: only the straddling columns
    cross), then, on x [M, k] flattened:

    * ``"trunk"``: f32 [M, N].  A fused engine: its kernel's trunk (the
      per-(row, k-block) scales applied, ``w_scale`` not).  Otherwise the
      CiM dot of x quantised at its whole row's absmax (an exact max over
      the ranks), before any scale; ``"scale"`` is that row scale.  A
      plain (SRAM) site: ``x @ w`` in f32.  None under ``trunk_skip``.
    * ``"t1"``: f32 [M, Cd], the sketch ``x @ C`` of the rank's rows of C
      (the fused kernel's, or bucketed rows), when the branch is live.
    * ``"x"``: x [M, k] on the rank's k-blocks (the trunk's
      straight-through gradient goes to it).

    A rank with no k-block computes zeros and launches nothing; its zeros
    stand in the autograd graph after x (``zeros_from``), so its backward
    joins every exchange."""
    from repro_torch.distributed import sharding as shd
    x = shd.move_rows(x, list(tp.x_layout), list(tp.k_ranges), tp.mesh,
                      tp.axis, "relayout", dim=-1)
    x2 = x.reshape(math.prod(x.shape[:-1]), x.shape[-1]).contiguous()
    m, k = x2.shape
    sram = params["sram"]
    rom = params.get("rom", {})
    live = spec.enabled and spec.branch_enabled and "core" in sram
    out = {"trunk": None, "t1": None, "scale": None, "x": x2}
    f32 = dict(dtype=torch.float32, device=x.device)
    if not spec.enabled:
        out["trunk"] = (x2.float() @ sram["w"].float() if k else
                        zeros_from(x2, (m, tp.d_out), dtype=torch.float32))
        return out
    if not spec.trunk_skip:
        from repro_torch import engine as engine_lib
        eng = engine_lib.resolve(spec)
        if live and "matmul" in eng.capabilities.fused_ops:
            if k:
                out["trunk"], out["t1"] = eng.fused_partial(
                    spec.cim, x2, rom["w_q"], rom["C"])
            else:
                out["trunk"] = torch.zeros((m, tp.d_out), **f32)
                out["t1"] = torch.zeros((m, rom["C"].shape[1]), **f32)
        else:
            absmax = (x2.abs().amax(dim=-1, keepdim=True) if k else
                      x2.new_zeros((m, 1)))
            absmax = shd.rank_max(absmax, tp.mesh, tp.axis)
            x_q, out["scale"] = quant.quantize_activations_at(x2, absmax)
            out["trunk"] = (eng.matmul_partial(spec.cim, x_q, rom["w_q"])
                            if k else torch.zeros((m, tp.d_out), **f32))
    if live and out["t1"] is None:
        cf = rom["C"].float()
        out["t1"] = (rows.rowwise(lambda a: a.float() @ cf, x2) if k else
                     zeros_from(x2, (m, cf.shape[1]), dtype=torch.float32))
    return out


def _keep_rows(t, lead, sp, r):
    """[M, c] (M = prod(lead)) -> the rows of this rank r's ``sp``
    sequence chunk (all of them without ``sp``)."""
    if sp is None:
        return t
    lo, hi = sp[r]
    return (t.reshape(*lead, t.shape[-1]).narrow(1, lo, hi - lo)
            .reshape(-1, t.shape[-1]))


def _whole_rows(g, lead, sp, mesh, axis):
    """The adjoint of :func:`_keep_rows`: every rank's kept rows of a
    gradient gathered into all M rows (``"chunk_adjoint"``)."""
    if sp is None:
        return g
    from repro_torch.distributed import sharding as shd
    r = mesh.coordinate(axis)
    chunk = [lead[0], sp[r][1] - sp[r][0], *lead[2:], g.shape[-1]]
    whole = shd.gather_chunks(g.reshape(chunk), sp, mesh, axis, 1,
                              "chunk_adjoint")
    return whole.reshape(-1, g.shape[-1])


class _GatherSum(torch.autograd.Function):
    """A row-parallel site's reduction: one gather of every rank's f32
    [trunk | t1], the trunk added in rank order on the rows this rank
    keeps, t1 on all rows.  Adjoint: each rank's trunk part had the whole
    gradient of the sum, which this rank holds where it keeps all rows
    (the output is then used alike on every rank) and gathers from the
    ranks' chunks under ``sp``; t1's is this rank's gradient, or the
    rank-order sum of the ranks' gradients where each rank uses t1 its own
    way (``t1_partial``: its columns against its rows of a split core,
    or its ``sp`` rows)."""

    @staticmethod
    def forward(ctx, trunk, t1, mesh, axis, lead, sp, t1_partial):
        from repro_torch.distributed import sharding as shd
        r = mesh.coordinate(axis)
        ctx.geom = (mesh, axis, lead, sp, t1_partial)
        pieces = [t for t in (trunk, t1) if t is not None]
        gathered = shd.gather_parts(torch.cat(pieces, dim=-1), mesh, axis,
                                    "reduce")
        if trunk is not None:
            n_out = trunk.shape[1]
            trunk = shd.rank_sum([_keep_rows(g[:, :n_out], lead, sp, r)
                                  for g in gathered])
        if t1 is not None:
            t1 = shd.rank_sum([g[:, -t1.shape[1]:] for g in gathered])
        return trunk, t1

    @staticmethod
    def backward(ctx, g_trunk, g_t1):
        from repro_torch.distributed import sharding as shd
        mesh, axis, lead, sp, t1_partial = ctx.geom
        d_trunk = d_t1 = None
        if ctx.needs_input_grad[0]:
            d_trunk = _whole_rows(g_trunk, lead, sp, mesh, axis)
        if ctx.needs_input_grad[1]:
            d_t1 = (shd.sum_parts(g_t1, mesh, axis, "reduce_adjoint")
                    if t1_partial else g_t1)
        return d_trunk, d_t1, None, None, None, None, None


class _RowTrunkSTE(torch.autograd.Function):
    """A row-parallel trunk's output from its reduced CiM sum: ``(trunk *
    scale).to(dt) * w_scale`` (``ops._TrunkMatmulPallas.forward``'s
    epilogue) with the reference's straight-through backward for this
    rank's k-rows: ``dx = g @ (w_q * w_scale)^T``, ``g`` the whole output
    gradient (gathered from the ranks' chunks under ``sp``)."""

    @staticmethod
    def forward(ctx, x2, trunk, scale, w_q, w_scale, mesh, axis, lead, sp):
        ctx.save_for_backward(w_q, w_scale)
        ctx.geom = (mesh, axis, lead, sp)
        dt = x2.dtype
        return (trunk * scale).to(dt) * w_scale.reshape(1, -1).to(dt)

    @staticmethod
    def backward(ctx, g):
        w_q, w_scale = ctx.saved_tensors
        mesh, axis, lead, sp = ctx.geom
        g = _whole_rows(g, lead, sp, mesh, axis)
        w_deq = w_q.to(g.dtype) * w_scale.reshape(1, -1).to(g.dtype)
        return (g @ w_deq.T, None, None, None, None, None, None, None,
                None)


def _row_parallel(params, x, spec: ReBranchSpec, tp, sp):
    """A row-parallel site: :func:`row_parallel_parts`, one gather of the
    ranks' f32 [trunk | t1] added in rank order (the trunk on the rows
    this rank keeps: all, or its ``sp`` sequence chunk), the branch by
    the reference's rule (C and core split on the contracting side:
    ``z = t1 @ core`` is a second rank-order sum of the ranks' rows of
    core, then ``z @ U``), and ``w_scale`` and the bias once, after the
    reductions, as the unsharded site applies them.

    Differentiable (:class:`_GatherSum`, :class:`_RowTrunkSTE`, the
    adjoints of ``sharding.reduce_model``/``reduce_chunk``): the whole
    output's gradient reaches every rank's parts; a core or bias held
    whole and used on the rank's ``sp`` rows is marked
    (``sharding.mark_partial``)."""
    from repro_torch.distributed import sharding as shd
    mesh, axis, r, n = tp.mesh, tp.axis, tp.coord, tp.n
    lead = list(x.shape[:-1])
    parts = row_parallel_parts(params, x, spec, tp)
    trunk, t1, scale = parts["trunk"], parts["t1"], parts["scale"]
    sram = params["sram"]

    def keep(t):                  # [M, c] -> the rows this rank keeps
        return _keep_rows(t, lead, sp, r)

    out_lead = list(lead)
    if sp is not None:
        out_lead[1] = sp[r][1] - sp[r][0]
        shd.mark_partial(sram.get("b"))
    core_split = t1 is not None and sram["core"].shape[0] != t1.shape[1]
    trunk, t1 = _GatherSum.apply(trunk, t1, mesh, axis, lead, sp,
                                 core_split or sp is not None)
    n_out = tp.d_out
    dt = x.dtype
    if not spec.enabled:
        return _bias(trunk.to(dt).reshape(*out_lead, n_out), sram)
    rom = params["rom"]
    if trunk is None:
        y = torch.zeros((math.prod(out_lead), n_out), dtype=torch.float32,
                        device=x.device)
    elif scale is None:             # the fused kernel's trunk
        y = trunk * rom["w_scale"].reshape(1, -1).float()
    else:                           # as ops._TrunkMatmulPallas.forward
        y = _RowTrunkSTE.apply(parts["x"], trunk.detach(), keep(scale),
                               rom["w_q"], rom["w_scale"], mesh, axis, lead,
                               sp)
    if t1 is not None:
        core = sram["core"].float()
        if not core_split:                        # core kept whole
            if sp is not None:
                shd.mark_partial(sram["core"])
            z = keep(rows.rowwise(lambda a: a @ core, t1))
        else:
            lo, hi = shd.h_layout(t1.shape[1], n)[r]
            zp = rows.rowwise(lambda a: a[:, lo:hi] @ core, t1)
            z = (shd.reduce_model(zp) if sp is None else shd.reduce_chunk(
                zp.reshape(*lead, -1), 1).reshape(-1, zp.shape[-1]))
        uf = rom["U"].float()
        branch = rows.rowwise(lambda a: a @ uf, z)
        y = y + branch if scale is None else y + branch.to(dt)
    return _bias(y.to(dt).reshape(*out_lead, n_out), sram)


def freeze_to_rom(params_dense, gen: torch.Generator, spec: ReBranchSpec):
    """Tape-out of a tree of plain linears (``{'sram': {'w': [d_in,
    d_out]}}``, optional ``'b'``): every trunk quantised into ROM, with its
    branch attached (C and U drawn from ``gen`` in tree order, zero core).

    The trunk (``w_q``, ``w_scale``) is the JAX package's bit for bit; its
    C and U are not (the reference folds the process-salted ``hash`` of
    each path into its key).  Each frozen layer lands on its ``w``'s
    device.
    """
    def conv(node):
        if isinstance(node, dict) and "w" in node.get("sram", {}):
            w = node["sram"]["w"]
            has_b = "b" in node["sram"]
            p = init_linear(gen, w.shape[0], w.shape[1], spec, w_init=w,
                            use_bias=has_b)
            p = bridge.tree_map(p, lambda t: t.to(w.device))
            if has_b:
                p["sram"]["b"] = node["sram"]["b"]
            return p
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return node

    return conv(params_dense)
