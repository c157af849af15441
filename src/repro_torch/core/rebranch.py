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
    def forward(ctx, src, shape):
        ctx.src = (src.shape, src.dtype, src.device)
        return src.new_zeros(shape)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.src
        return torch.zeros(shape, dtype=dtype, device=device), None


def zeros_from(src: torch.Tensor, shape) -> torch.Tensor:
    """Zeros of ``shape`` that stand in the autograd graph after ``src``
    (zero gradient): an empty result that still leads back to its input,
    so that a rank of a mesh with no rows to compute reaches the exchanges
    before it in its backward, as the other ranks do."""
    return _ZerosFrom.apply(src, tuple(shape))


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
                             dtype=dt) * (name_scale / math.sqrt(d_in))
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
        rom["C"] = torch.randn((d_in, d_c), generator=gen, device=dev,
                               dtype=dt) / math.sqrt(d_in)
        rom["U"] = torch.randn((d_u, d_out), generator=gen, device=dev,
                               dtype=dt) / math.sqrt(d_u)
        p["sram"]["core"] = torch.zeros((d_c, d_u), dtype=dt, device=dev)
    if use_bias:
        p["sram"]["b"] = torch.zeros((d_out,), dtype=dt, device=dev)
    return p


def _bias(y, sram):
    b = sram.get("b")
    return y if b is None else y + b.to(y.dtype)


def apply_linear(params, x, spec: ReBranchSpec):
    """Apply a ReBranch linear layer (or a plain linear if disabled).

    Routes as the JAX package does: ``trunk_skip`` runs the branch alone;
    an engine with a fused matmul computes trunk and sketch in one pass;
    otherwise the engine's trunk matmul plus the reassociated branch
    ``(x @ C) @ (core @ U)``.
    """
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
