"""Fused im2col ReBranch convolution (port of
``repro.kernels.rebranch_conv``'s float-in entry points).

trunk_conv    : per-(patch-row, k-block) dynamic int8 quantisation, the
                macro dot and the per-channel scale — the 'pallas' engine
                conv.
rebranch_conv : the trunk plus the per-tap compress sketch on the SAME
                patch matrix; ``out = trunk * w_scale + (t1 @ core) @ U``
                — the 'pallas_fused' engine conv.

Both go through :func:`trunk_patch_dot`, the wrapper of the hand-written
CUDA kernel ``csrc/trunk_conv.cu`` (the port of the Pallas
``_trunk_conv_kernel``), in all three CiM modes.  For a CUDA tensor it
launches the kernel or raises; only a tensor on the CPU takes
:func:`trunk_patch_dot_plain`, the plain PyTorch version of the same
function.  Everything around the kernel
(``w_scale``, the branch GEMMs, the epilogue) stays in PyTorch, as it
stays outside the Pallas kernel in JAX.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core import cim as cim_lib
from repro_torch.core import quant
from repro_torch.kernels import _build
from repro_torch.kernels import cim_matmul as cm
from repro_torch.kernels import tiling

IDEAL = cim_lib.CiMConfig(mode="ideal")

# Kernel launches of trunk_patch_dot since the count was last set to 0.
launches = 0


def patch_matrix(x: torch.Tensor, kh: int, kw: int, stride: int,
                 padding: str):
    """im2col + flatten: NHWC -> (P [M, R] contiguous, (n, oh, ow))."""
    n = x.shape[0]
    patches, (oh, ow) = cim_lib.im2col(x, kh, kw, stride, padding)
    return patches.reshape(n * oh * ow, patches.shape[-1]), (n, oh, ow)


def trunk_patch_dot_plain(p: torch.Tensor, w2d: torch.Tensor,
                          cfg: cim_lib.CiMConfig = IDEAL) -> torch.Tensor:
    """Plain PyTorch version of the trunk kernel: P f32 [M, R] x W int8
    [R, C_out] -> UNscaled f32 [M, C_out].

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


@functools.cache
def _kernel():
    """The C entry of ``csrc/trunk_conv.cu``, built and bound once."""
    fn = _build.library("trunk_conv").trunk_conv
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
        cm.ADC_ARGTYPES + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def trunk_patch_dot(p: torch.Tensor, w2d: torch.Tensor,
                    cfg: cim_lib.CiMConfig = IDEAL) -> torch.Tensor:
    """UNscaled trunk accumulation [M, C_out] of P [M, R] and W [R, C_out].

    A CUDA tensor launches ``csrc/trunk_conv.cu`` in ``cfg``'s mode (a
    config the kernel does not take, or a build or launch failure,
    raises); a CPU tensor takes :func:`trunk_patch_dot_plain`.
    """
    if p.device.type == "cpu":
        return trunk_patch_dot_plain(p, w2d, cfg)
    adc = cm.kernel_args(cfg)
    m, r = p.shape
    if (p.dtype != torch.float32 or w2d.dtype != torch.int8
            or w2d.dim() != 2 or w2d.shape[0] != r):
        raise ValueError(f"trunk kernel takes P f32 [M, R] and W int8 "
                         f"[R, N]; got P {p.dtype} {tuple(p.shape)}, W "
                         f"{w2d.dtype} {tuple(w2d.shape)}")
    if w2d.device != p.device:
        raise ValueError(f"P on {p.device} but W on {w2d.device}")
    if not (p.is_contiguous() and w2d.is_contiguous()):
        raise ValueError("trunk kernel needs contiguous P and W")
    n = w2d.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=p.device)
    if m == 0 or n == 0:
        return out
    bk = tiling.block_k(r, cfg.rows_per_subarray)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = _kernel()(p.data_ptr(), w2d.data_ptr(), out.data_ptr(),
                       m, r, n, bk, *adc, stream)
    if rc != 0:
        raise RuntimeError(f"trunk_conv kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
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
    kh, kw, c_in, c_out = w_q.shape
    oh, ow = _out_hw(x, kh, kw, stride, padding)
    if x.shape[0] * oh * ow == 0:
        return x.new_zeros((x.shape[0], oh, ow, c_out))
    p, (n, oh, ow) = patch_matrix(x.float(), kh, kw, stride, padding)
    out = trunk_patch_dot(p, w_q.reshape(-1, c_out), cfg)
    out = out * w_scale.reshape(1, -1).float()
    return out.reshape(n, oh, ow, c_out).to(x.dtype)


def structured_compress(p: torch.Tensor, c2d: torch.Tensor,
                        taps: int) -> torch.Tensor:
    """Per-tap compress sketch of a tap-major patch matrix: p [M,
    taps*C_in] -> t1 [M, taps*C_c], a plain matmul on a zero-copy
    reshape (FLOPs scale with ``taps``, not taps^2)."""
    m = p.shape[0]
    c_in, c_c = c2d.shape
    t1 = p.reshape(m * taps, c_in).float() @ c2d.float()
    return t1.reshape(m, taps * c_c)


def rebranch_conv(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                  c: torch.Tensor, core: torch.Tensor, u: torch.Tensor,
                  cfg: cim_lib.CiMConfig = IDEAL, *, stride: int = 1,
                  padding: str = "SAME") -> torch.Tensor:
    """Fused ReBranch conv forward: the trunk kernel and the compress
    sketch share ONE im2col patch matrix (1x1 compress -> KxK core
    composes into one KxK conv):

      trunk = trunk_patch_dot(P, w_q)                   (CUDA kernel)
      t1    = structured_compress(P, C)                 (matmul)
      out   = trunk * w_scale + (t1 @ core_flat) @ U
    """
    kh, kw, c_in, c_out = w_q.shape
    if tuple(core.shape[:2]) != (kh, kw):
        raise ValueError(f"core {tuple(core.shape)} does not match the "
                         f"trunk kernel {tuple(w_q.shape)}")
    c_c, c_u = core.shape[2], core.shape[3]
    oh, ow = _out_hw(x, kh, kw, stride, padding)
    if x.shape[0] * oh * ow == 0:
        return x.new_zeros((x.shape[0], oh, ow, c_out))
    p, (n, oh, ow) = patch_matrix(x.float(), kh, kw, stride, padding)
    trunk = trunk_patch_dot(p, w_q.reshape(-1, c_out), cfg)
    out = trunk * w_scale.reshape(1, -1).float()
    t1 = structured_compress(p, c.reshape(c_in, c_c), kh * kw)
    branch = (t1 @ core.reshape(kh * kw * c_c, c_u).float()
              ) @ u.reshape(c_u, c_out).float()
    return (out + branch).reshape(n, oh, ow, c_out).to(x.dtype)
