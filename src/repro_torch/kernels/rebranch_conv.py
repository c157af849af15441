"""Fused ReBranch convolution (port of ``repro.kernels.rebranch_conv``'s
float-in entry points).

trunk_conv    : per-(patch-row, k-block) dynamic int8 quantisation, the
                macro dot and the per-channel scale — the 'pallas' engine
                conv.
rebranch_conv : the trunk plus the branch (:func:`branch_conv`);
                ``out = trunk * w_scale + (t1 @ core) @ U`` — the
                'pallas_fused' engine conv.

Both go through :func:`trunk_conv_dot`, the wrapper of the hand-written
CUDA kernel ``csrc/trunk_conv.cu`` (the port of the Pallas
``_trunk_conv_kernel``), in all three CiM modes.  The kernel is an
implicit GEMM: it reads the NHWC input through the im2col map itself, so
on the card no ``[M, taps*C_in]`` patch matrix is built.  For a CUDA
tensor the wrapper launches the kernel or raises; only a tensor on the
CPU takes the plain PyTorch version of the same function,
:func:`trunk_patch_dot_plain` on :func:`patch_matrix`.  Everything around
the kernel (``w_scale``, the branch GEMMs, the epilogue) stays in PyTorch,
as it stays outside the Pallas kernel in JAX.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core import cim as cim_lib
from repro_torch.core import quant
from repro_torch.kernels import cim_matmul as cm
from repro_torch.kernels import tiling
from repro_torch.launch import cost
from repro_torch.tune import table as tune_table

IDEAL = cim_lib.CiMConfig(mode="ideal")

# Kernel launches of trunk_conv_dot since the count was last set to 0,
# and the ConvLaunch of the last one (the tuner reads its plan back).
launches = 0
last_launch = None


def patch_matrix(x: torch.Tensor, kh: int, kw: int, stride: int,
                 padding: str):
    """im2col + flatten: NHWC -> (P [M, R] contiguous, (n, oh, ow))."""
    n = x.shape[0]
    patches, (oh, ow) = cim_lib.im2col(x, kh, kw, stride, padding)
    return patches.reshape(n * oh * ow, patches.shape[-1]), (n, oh, ow)


def trunk_patch_dot_plain(p: torch.Tensor, w2d: torch.Tensor,
                          cfg: cim_lib.CiMConfig = IDEAL) -> torch.Tensor:
    """Plain PyTorch version of the trunk kernel, on the patch matrix: P
    f32 [M, R] x W int8 [R, C_out] -> UNscaled f32 [M, C_out].

    Per k-block: reciprocal-form quantisation of the block, the macro dot
    (in ideal mode an f32 GEMM of integer values — exact, block dots stay
    below 2**24), ``* scale``, then a separate ``acc +`` in ascending
    k-block order: the bit contract of the kernel.
    """
    rows = cfg.rows_per_subarray
    w_f = w2d.float()
    acc = None
    for k0, k1 in tiling.k_partition(p.shape[1], rows):
        pb = p[:, k0:k1]
        if cfg.mode == "ideal":
            q, scale = quant.quant_rows_f32(pb)
            part = (q @ w_f[k0:k1]) * scale
        else:
            q, scale = quant.quant_rows(pb)
            pad = -(k1 - k0) % rows
            part = cm.cim_block_dot(
                cfg, F.pad(q, (0, pad)), F.pad(w2d[k0:k1], (0, 0, 0, pad))
            ) * scale
        acc = part if acc is None else acc + part
    return acc


# csrc/conv_geom.cuh's ConvGeom and csrc/trunk_conv.cu's ConvLaunch
# (tests/test_torch_split.py holds the names to the sources)
ConvGeom = cm.mirror("ConvGeom", [
    (f, ctypes.c_int) for f in ("n", "h", "w", "c", "oh", "ow", "kh", "kw",
                                "stride", "ph0", "pw0")])
ConvLaunch = cm.mirror("ConvLaunch", [
    ("geom", ConvGeom),
    *((f, ctypes.c_int) for f in ("r", "n", "bk", "mode")),
    ("adc", cm.AdcParams), ("plan", cm.SplitPlan)])


def conv_geometry(x_shape, kh: int, kw: int, stride: int,
                  padding: str) -> ConvGeom:
    """The geometry the kernel reads x [N, H, W, C] through: the pads and
    OH, OW of ``core/cim.py::conv_pads`` (the kernel never recomputes
    them)."""
    n, h, w, c = x_shape
    (ph0, _), oh = cim_lib.conv_pads(h, kh, stride, padding)
    (pw0, _), ow = cim_lib.conv_pads(w, kw, stride, padding)
    return ConvGeom(n, h, w, c, oh, ow, kh, kw, stride, ph0, pw0)


def conv_launch(x_shape: tuple, w_shape: tuple, stride: int, padding: str,
                cfg: cim_lib.CiMConfig, plan: tune_table.Plan | None = None):
    """(ConvLaunch, scratch floats) of one launch: the geometry, the mode,
    the ADC constants and ``tiling.resolve_plan``'s plan of the implied
    [M, R] x [R, C_out] product, made once per shape, config, plan and
    table state (as ``cim_matmul._launch``)."""
    return _conv_launch_at(tune_table.serial(), x_shape, w_shape, stride,
                           padding, cfg, plan)


@functools.lru_cache(maxsize=4096)
def _conv_launch_at(serial: int, x_shape: tuple, w_shape: tuple, stride: int,
                    padding: str, cfg: cim_lib.CiMConfig, plan):
    del serial                  # a key only
    kh, kw, c_in, c_out = w_shape
    mode, lsb, levels = cm.kernel_args(cfg)
    geom = conv_geometry(x_shape, kh, kw, stride, padding)
    m, r = geom.n * geom.oh * geom.ow, kh * kw * c_in
    rows = cfg.rows_per_subarray
    p = tiling.resolve_plan("trunk_conv", cfg.mode, "float32", m, r, c_out,
                            rows, plan)
    sp = tiling.trunk_split(p, m, c_out, r, rows)
    launch = ConvLaunch(geom, r, c_out, tiling.block_k(r, rows), mode,
                        cm.AdcParams(lsb, levels), cm.c_split(sp))
    return launch, sp.scratch_floats(m, c_out)


@functools.cache
def _kernel():
    """The C entry of ``csrc/trunk_conv.cu``, built and bound once."""
    return cm.bind("trunk_conv", "trunk_conv", 5, ConvLaunch)


def trunk_conv_dot(x: torch.Tensor, w_q: torch.Tensor, stride: int = 1,
                   padding: str = "SAME", cfg: cim_lib.CiMConfig = IDEAL,
                   plan: tune_table.Plan | None = None) -> torch.Tensor:
    """UNscaled trunk accumulation [N*OH*OW, C_out] of the conv of x
    [N, H, W, C_in] with w_q int8 [KH, KW, C_in, C_out].

    A CUDA tensor launches ``csrc/trunk_conv.cu`` in ``cfg``'s mode on x
    itself (f32, contiguous NHWC; a config the kernel does not take, or a
    build or launch failure, raises) under ``tiling.resolve_plan``'s plan
    (``plan``, the tuning table's or the shape rule's); a CPU tensor takes
    the plain version :func:`trunk_patch_dot_plain` on
    :func:`patch_matrix`; a ``meta`` tensor only the output's shape.
    Under ``launch.cost.count()`` the call counts as one kernel by its
    geometry, whatever runs.
    """
    if x.device.type == "meta" or cost.recording() is not None:
        kh, kw, c_in, c_out = w_q.shape
        g = conv_geometry(tuple(x.shape), kh, kw, stride, padding)
        m = g.n * g.oh * g.ow
        return cost.kernel(
            "trunk_conv", 2 * m * kh * kw * c_in * c_out, 0,
            x.numel() * x.element_size() + w_q.numel() + 4 * m * c_out,
            lambda: _trunk_conv_dot(x, w_q, stride, padding, cfg, plan),
            (lambda: x.new_empty((m, c_out), dtype=torch.float32))
            if x.device.type == "meta" else None)
    return _trunk_conv_dot(x, w_q, stride, padding, cfg, plan)


def _trunk_conv_dot(x, w_q, stride, padding, cfg, plan):
    kh, kw, c_in, c_out = w_q.shape
    if x.device.type == "cpu":
        p, _ = patch_matrix(x.float(), kh, kw, stride, padding)
        return trunk_patch_dot_plain(p, w_q.reshape(-1, c_out), cfg)
    if (x.dtype != torch.float32 or x.dim() != 4 or w_q.dtype != torch.int8
            or w_q.dim() != 4 or x.shape[3] != c_in):
        raise ValueError(f"trunk kernel takes x f32 [N, H, W, C_in] and W "
                         f"int8 [KH, KW, C_in, C_out]; got x {x.dtype} "
                         f"{tuple(x.shape)}, W {w_q.dtype} "
                         f"{tuple(w_q.shape)}")
    if w_q.device != x.device:
        raise ValueError(f"x on {x.device} but W on {w_q.device}")
    if not (x.is_contiguous() and w_q.is_contiguous()):
        raise ValueError("trunk kernel needs contiguous x and W")
    launch, floats = conv_launch(tuple(x.shape), tuple(w_q.shape), stride,
                                 padding, cfg, plan)
    g = launch.geom
    m = g.n * g.oh * g.ow
    out = torch.empty((m, c_out), dtype=torch.float32, device=x.device)
    if m == 0 or c_out == 0:
        return out
    parts = cm.scratch(floats, x.device)
    rc = cm.call(_kernel(), x.device, x.data_ptr(), w_q.data_ptr(),
                 out.data_ptr(), parts.data_ptr() if floats else 0,
                 cm.adc_pointer(cfg, x.device), launch)
    if rc != 0:
        raise RuntimeError(f"trunk_conv kernel launch failed: CUDA error {rc}")
    global launches, last_launch
    launches += 1
    last_launch = launch
    return out


def _out_hw(x, kh, kw, stride, padding):
    _, oh = cim_lib.conv_pads(x.shape[1], kh, stride, padding)
    _, ow = cim_lib.conv_pads(x.shape[2], kw, stride, padding)
    return oh, ow


def trunk_conv(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
               cfg: cim_lib.CiMConfig = IDEAL, *, stride: int = 1,
               padding: str = "SAME") -> torch.Tensor:
    """Frozen-trunk conv forward, quantisation fused into the macro pass.
    x [N, H, W, C_in] float, w_q [KH, KW, C_in, C_out] int8."""
    kh, kw, _, c_out = w_q.shape
    oh, ow = _out_hw(x, kh, kw, stride, padding)
    n = x.shape[0]
    if n * oh * ow == 0:
        return x.new_zeros((n, oh, ow, c_out))
    out = trunk_conv_dot(x.float().contiguous(), w_q, stride, padding, cfg)
    out = out * w_scale.reshape(1, -1).float()
    return out.reshape(n, oh, ow, c_out).to(x.dtype)


def branch_conv(xf: torch.Tensor, c: torch.Tensor, core: torch.Tensor,
                u: torch.Tensor, stride: int = 1,
                padding: str = "SAME") -> torch.Tensor:
    """The ReBranch branch of a conv, f32 [N*OH*OW, C_out]: the 1x1
    compress, the KxK core and the 1x1 decompress,

      t1     = im2col(x @ C)                            [M, taps*C_c]
      branch = (t1 @ core_flat) @ U

    ``t1[m, t*C_c + j] = x[pixel(m, t)] @ C[:, j]``, a padded pixel giving a
    zero row: the per-tap compress of the patch matrix (the JAX package's
    ``structured_compress(P, C)``), computed once per pixel and gathered at
    C_c channels instead of C_in, so no ``[M, taps*C_in]`` tensor is made.
    The same formula runs on the CPU and on the card (matmuls, as the JAX
    package leaves the branch to XLA)."""
    kh, kw, c_c, c_u = core.shape
    t1, _ = cim_lib.im2col(xf @ c.reshape(-1, c_c).float(), kh, kw, stride,
                           padding)
    return (t1.reshape(-1, kh * kw * c_c)
            @ core.reshape(kh * kw * c_c, c_u).float()
            ) @ u.reshape(c_u, -1).float()


def rebranch_conv(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                  c: torch.Tensor, core: torch.Tensor, u: torch.Tensor,
                  cfg: cim_lib.CiMConfig = IDEAL, *, stride: int = 1,
                  padding: str = "SAME") -> torch.Tensor:
    """Fused ReBranch conv forward (1x1 compress -> KxK core composes into
    one KxK conv over the compressed input):

      trunk = trunk_conv_dot(x, w_q)                    (CUDA kernel)
      out   = trunk * w_scale + branch_conv(x, C, core, U)
    """
    kh, kw, _, c_out = w_q.shape
    if tuple(core.shape[:2]) != (kh, kw):
        raise ValueError(f"core {tuple(core.shape)} does not match the "
                         f"trunk kernel {tuple(w_q.shape)}")
    oh, ow = _out_hw(x, kh, kw, stride, padding)
    n = x.shape[0]
    if n * oh * ow == 0:
        return x.new_zeros((n, oh, ow, c_out))
    xf = x.float().contiguous()
    trunk = trunk_conv_dot(xf, w_q, stride, padding, cfg)
    out = trunk * w_scale.reshape(1, -1).float()
    branch = branch_conv(xf, c, core, u, stride, padding)
    return (out + branch).reshape(n, oh, ow, c_out).to(x.dtype)
