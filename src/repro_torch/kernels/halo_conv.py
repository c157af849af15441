"""Halo-exchange sharded convolution (port of ``repro.kernels.halo_conv``):
the trunk kernel on NHWC activations sharded over H across ranks.

A KxK conv's receptive field leaks ``kh - stride`` rows across a spatial
cut, so instead of gathering the feature map every rank fetches only the
rows its outputs read from their owners (:func:`~repro_torch.distributed.
sharding.move_rows`: point-to-point sends on the mesh axis's process
group, outside the kernel) and runs kernel 1 (``csrc/trunk_conv.cu``
through ``rebranch_conv.trunk_conv``) on its extended slab with
``padding="VALID"``.  Rows outside the image arrive as zeros, which is
the conv's own SAME padding, as ``ppermute`` fills edge devices with
zeros in the reference.  There is no kernel of its own here.

Each rank computes exactly its rows of the output's H layout (rank r of
n: ``[r*c, min((r+1)*c, OH))``, ``c = ceil(OH/n)``), so a sharded conv
takes the layout in and gives it out.  The reference's two geometries
differ in what they materialise, not in what a rank needs: its aligned
path exchanges a two-sided halo; its general path pads ``pad_top`` rows
globally, gives each device ``ol * stride`` rows of the padded array plus
a bottom halo, and cuts the tail (``_finish``).  Here :func:`_prepare`
turns either into the interval of input rows each rank reads (the
general path's top padding is the offset ``-ph0``, its padded rows the
zeros outside the image), and no tail is computed, so none is cut.  A
rank whose share of the output is empty launches nothing (it still takes
part in the exchange).  1x1 stride-1 convs exchange nothing at all.

Bit contract (the reference's): each rank's trunk rows equal the
unsharded ``trunk_conv`` bit for bit in every CiM mode.  Every patch row
holds the same values (real rows or zeros), the quantisation is per
(patch row, k-block) and the k-blocks add in ascending order whatever
launch plan the local M gets.  The fused ReBranch route adds float branch
GEMMs on local shapes and matches its unsharded twin to rounding.

:func:`plan_halo` is the reference's feasibility rule: None when a halo
would span more than one neighbour's rows; the engine then gathers the
layer (:func:`gathered`), runs it whole and re-splits.

Training runs through the same functions: the trunk's backward is the
STE of the unsharded trunk on the extended slab (dx only), the plain
convs' is autograd's, and the exchange's adjoint (``move_rows``) returns
each halo row's gradient to its owner.  The fused ReBranch conv stays
forward-only, as the reference's.
"""

from __future__ import annotations

import dataclasses

import torch.nn.functional as F

from repro_torch.core import cim as cim_lib
from repro_torch.core.cim import conv_pads
from repro_torch.core.rebranch import conv_nhwc, zeros_from
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops as kops
from repro_torch.kernels import rebranch_conv as rc


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Static geometry of one H-sharded conv (the reference's fields).

    top/bot: halo rows a device receives from its previous/next neighbour.
    pad_top/pad_bot: zero rows the general path materialises (0/0 on the
        aligned path).
    oh: true output rows; ol: output rows per device on the reference's
        grid (``n * ol > oh`` means it cuts a tail).
    """
    n: int
    aligned: bool
    top: int
    bot: int
    pad_top: int
    pad_bot: int
    oh: int
    ol: int


def plan_halo(h: int, kh: int, stride: int, padding: str,
              n: int) -> HaloPlan | None:
    """Halo geometry for H rows / KHxK kernel sharded n ways, or None when
    a halo would span more than one neighbour shard (fall back unsharded).
    """
    (ph0, _), oh = conv_pads(h, kh, stride, padding)
    if padding == "SAME" and h % (n * stride) == 0:
        hl = h // n
        top, bot = ph0, max(kh - stride - ph0, 0)
        if max(top, bot) > hl:
            return None
        return HaloPlan(n=n, aligned=True, top=top, bot=bot,
                        pad_top=0, pad_bot=0, oh=oh, ol=oh // n)
    # general path: ol covers both the outputs (ceil(oh/n)) and the
    # materialised input rows (ceil((ph0+h)/(n*stride))) so no real row is
    # ever truncated into the zero-filled edge halo
    ol = max(-(-oh // n), -(-(ph0 + h) // (n * stride)))
    bot = max(kh - stride, 0)
    if bot > ol * stride:
        return None
    return HaloPlan(n=n, aligned=False, top=0, bot=bot,
                    pad_top=ph0, pad_bot=n * ol * stride - ph0 - h,
                    oh=oh, ol=ol)


def halo_bytes(x_shape, kh: int, stride: int, padding: str, n: int,
               dtype_bytes: int = 4) -> int:
    """Wire bytes one conv's halo exchange moves per device pair on the
    reference's plan (``(top + bot)`` rows of the input)."""
    plan = plan_halo(x_shape[1], kh, stride, padding, n)
    if plan is None or plan.n <= 1:
        return 0
    rows = plan.top + plan.bot
    return rows * x_shape[0] * x_shape[2] * x_shape[3] * dtype_bytes


def no_halo(kh: int, kw: int, stride: int) -> bool:
    """1x1 stride-1: each output row reads only its own input row."""
    return kh == kw == 1 and stride == 1


def _prepare(h: int, kh: int, stride: int, padding: str, n: int):
    """(plan, each rank's output rows, each rank's input rows): rank r
    computes rows ``out[r]`` of the output's H layout and reads input rows
    ``need[r]``, those outside ``[0, h)`` being the conv's zero padding.
    ``(None, None, None)`` when the reference's plan is infeasible."""
    plan = plan_halo(h, kh, stride, padding, n)
    if plan is None:
        return None, None, None
    (ph0, _), oh = conv_pads(h, kh, stride, padding)
    out = shd.h_layout(oh, n)
    need = [(a * stride - ph0, (b - 1) * stride - ph0 + kh) if b > a
            else (a * stride - ph0,) * 2 for a, b in out]
    return plan, out, need


def _sharded(fn, x, kh: int, kw: int, c_out: int, stride: int, padding: str,
             mesh, axis: str, h: int | None):
    """``fn`` (a conv with ``padding="VALID"``) on this rank's extended
    slab: its output rows of the H layout of ``conv(x_global)``.
    Differentiable where ``fn`` is: the exchange has its adjoint."""
    n, r = mesh.shape[axis], mesh.coordinate(axis)
    (pw0, pw1), ow = conv_pads(x.shape[2], kw, stride, padding)
    if no_halo(kh, kw, stride):
        xe, rows = x, x.shape[1]
    else:
        h = shd.global_h(x, mesh, axis) if h is None else h
        plan, out, need = _prepare(h, kh, stride, padding, n)
        if plan is None:
            raise ValueError(
                f"halo plan infeasible: H={h} kernel={kh} stride={stride} "
                f"over {n} shards (halo spans more than one neighbour); use "
                f"the unsharded engine")
        xe = shd.move_rows(x, shd.h_layout(h, n), need, mesh, axis, "halo")
        rows = out[r][1] - out[r][0]
    if rows == 0:
        return zeros_from(xe, (x.shape[0], 0, ow, c_out))
    if pw0 or pw1:
        xe = F.pad(xe, (0, 0, pw0, pw1))
    return fn(xe)


def halo_h(x, kh: int, kw: int, stride: int, padding: str, mesh,
           axis: str) -> tuple[int | None, bool]:
    """(H of the activation, whether :func:`plan_halo` fits it): H is None
    for a 1x1 stride-1 conv, which needs neither (one collective fewer)."""
    if no_halo(kh, kw, stride):
        return None, True
    h = shd.global_h(x, mesh, axis)
    return h, plan_halo(h, kh, stride, padding, mesh.shape[axis]) is not None


def gathered(fn, x, mesh, axis: str, h: int):
    """``fn`` (a SAME conv) on the whole activation, gathered on every
    rank, then this rank's rows of the output's H layout: the fallback
    when :func:`plan_halo` is None.  Differentiable where ``fn`` is: the
    gather's adjoint sums each rank's gradient of the whole input."""
    n = mesh.shape[axis]
    full = shd.move_rows(x, shd.h_layout(h, n), [(0, h)] * n, mesh, axis,
                         "gather")
    y = fn(full)
    a, b = shd.h_layout(y.shape[1], n)[mesh.coordinate(axis)]
    return y[:, a:b].contiguous()


# ---------------------------------------------------------------------------
# trunk conv (the 'pallas_sharded' engine's conv path) and its STE backward
# ---------------------------------------------------------------------------

def sharded_trunk_conv(cfg: cim_lib.CiMConfig, stride: int, padding: str,
                       mesh, axis: str, x, w_q, w_scale, *,
                       h: int | None = None):
    """H-sharded frozen-trunk convolution of this rank's slab ``x``
    (global height ``h``, gathered when None), bit-identical on its rows
    to the unsharded ``trunk_conv``.  Raises when :func:`plan_halo` is
    infeasible (the engine checks first).

    Its backward is the reference's STE (dx only: the ROM cannot be
    written): the unsharded ``trunk_conv_ste_bwd`` with VALID padding on
    the rank's extended slab, then the exchange's adjoint returns the halo
    rows' gradient to their owners and adds it there; rows of the zero
    padding, outside ``[0, H)``, are dropped."""
    kh, kw, _, c_out = w_q.shape
    return _sharded(
        lambda xe: kops.trunk_conv(cfg, stride, "VALID", xe, w_q, w_scale),
        x, kh, kw, c_out, stride, padding, mesh, axis, h)


# ---------------------------------------------------------------------------
# fused ReBranch conv (inference fast path), same halo geometry
# ---------------------------------------------------------------------------

def sharded_rebranch_conv(x, w_q, w_scale, c, core, u,
                          cfg: cim_lib.CiMConfig = rc.IDEAL, *,
                          stride: int = 1, padding: str = "SAME",
                          mesh=None, axis: str = "data",
                          h: int | None = None):
    """H-sharded fused ReBranch conv (``rebranch_conv``: kernel 1 plus the
    branch, compressed once per pixel) on each rank's slab.  The trunk is
    bit-identical to the unsharded fused conv's; the float branch GEMMs
    run on local shapes and match to rounding.  Forward only.  ``mesh``
    defaults to the bound mesh's ``"cnn_h"`` axis; unsharded without
    one."""
    if mesh is None:
        at = shd.h_axis()
        if at is None:
            return rc.rebranch_conv(x, w_q, w_scale, c, core, u, cfg,
                                    stride=stride, padding=padding)
        mesh, axis = at
    kh, kw, _, c_out = w_q.shape
    return _sharded(
        lambda xe: rc.rebranch_conv(xe, w_q, w_scale, c, core, u, cfg,
                                    stride=stride, padding="VALID"),
        x, kh, kw, c_out, stride, padding, mesh, axis, h)


# ---------------------------------------------------------------------------
# plain convs of a sharded model (the branch's KxK core, SRAM sites)
# ---------------------------------------------------------------------------

def sharded_conv_nhwc(x, w, stride: int = 1, padding: str = "SAME"):
    """``conv_nhwc`` of an activation in the H layout under the bound
    mesh, through the same exchange (the reference gets this from GSPMD);
    ``conv_nhwc`` itself without one.  A layer whose halo does not fit is
    gathered, run whole and re-split.  Differentiable in ``x`` and ``w``
    (the branch's KxK core trains through it)."""
    at = shd.h_axis()
    kh, kw, _, c_out = w.shape
    if at is None:
        return conv_nhwc(x, w, stride, padding)
    mesh, axis = at
    h, fits = halo_h(x, kh, kw, stride, padding, mesh, axis)
    if not fits:
        return gathered(lambda xf: conv_nhwc(xf, w, stride, padding), x,
                        mesh, axis, h)
    return _sharded(lambda xe: conv_nhwc(xe, w, stride, "VALID"), x, kh, kw,
                    c_out, stride, padding, mesh, axis, h)
