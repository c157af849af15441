"""Fused ReBranch matmul (port of ``repro.kernels.rebranch_matmul``).

One pass over the activations x [M, K] computes both halves of a ReBranch
linear layer's input side:

  trunk[m, n] += macro(quant_blk(x), w_q) * scale_blk   (CiM macro dot)
  t1[m, c]    += x @ C                                  (compress sketch)

with per-(row, k-block) reciprocal-form quantisation, and the epilogue
``out = trunk * w_scale + (t1 @ core) @ U`` left to plain PyTorch (it is
left to XLA in the JAX package).

:func:`rebranch_trunk_sketch` is the wrapper of the hand-written CUDA
kernel ``csrc/rebranch_matmul.cu`` (the port of the Pallas
``_rebranch_kernel``), in all three CiM modes.  For a CUDA tensor it
launches the kernel or raises; only a tensor on the CPU takes
:func:`rebranch_matmul_plain`, the plain PyTorch version of the same
function.  The trunk half is exactly the
trunk-conv kernel's computation with x in the patch matrix's place, so its
plain version is ``rebranch_conv.trunk_patch_dot_plain``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import cim as cim_lib
from repro_torch.core import rows
from repro_torch.kernels import cim_matmul as cm
from repro_torch.kernels import tiling
from repro_torch.kernels.rebranch_conv import trunk_patch_dot_plain
from repro_torch.launch import cost
from repro_torch.tune import table as tune_table

IDEAL = cim_lib.CiMConfig(mode="ideal")

# Kernel launches of rebranch_trunk_sketch since the count was last set
# to 0, and the FusedLaunch of the last one (the tuner reads its plans
# back).
launches = 0
last_launch = None


def rebranch_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                          c: torch.Tensor, cfg: cim_lib.CiMConfig = IDEAL):
    """Plain PyTorch version of the fused kernel: x float [M, K], W int8
    [K, N], C [K, Cd] -> (UNscaled trunk f32 [M, N], t1 f32 [M, Cd]).

    The trunk is the trunk kernel's plain version on x (the bit contract
    of ``trunk_patch_dot_plain``); t1 is an f32 block dot per k-block,
    added in ascending k-block order, as ``_direct_rebranch`` does.
    """
    xf, cf = x.float(), c.float()
    trunk = trunk_patch_dot_plain(xf, w_q, cfg)
    t1 = None
    for k0, k1 in tiling.k_partition(x.shape[1], cfg.rows_per_subarray):
        part = xf[:, k0:k1] @ cf[k0:k1]
        t1 = part if t1 is None else t1 + part
    return trunk, t1


# csrc/rebranch_matmul.cu's FusedLaunch
FusedLaunch = cm.mirror("FusedLaunch", [
    *((f, ctypes.c_int)
      for f in ("m", "k", "n", "cdim", "bk", "mode", "x_bf16")),
    ("adc", cm.AdcParams), ("trunk", cm.SplitPlan),
    ("sketch", cm.SketchPlan)])


def _launch(m: int, k: int, n: int, cdim: int, cfg: cim_lib.CiMConfig,
            x_bf16: bool, plan: tune_table.Plan | None = None,
            x_dtype: torch.dtype | None = None):
    """(FusedLaunch, trunk scratch floats, sketch scratch floats) of one
    launch: the plans of ``tiling.resolve_plan`` (``plan``, the tuning
    table's entry keyed on the name of x's dtype, by default bfloat16
    where the kernel reads bf16, or ``tiling.split_plan``'s and
    ``tiling.split_sketch``'s), made once per shape, config, x dtype, plan
    and table state (as ``cim_matmul._launch``)."""
    return _launch_at(tune_table.serial(), m, k, n, cdim, cfg, x_bf16, plan,
                      x_dtype or (torch.bfloat16 if x_bf16 else
                                  torch.float32))


@functools.lru_cache(maxsize=4096)
def _launch_at(serial: int, m: int, k: int, n: int, cdim: int,
               cfg: cim_lib.CiMConfig, x_bf16: bool, plan,
               x_dtype: torch.dtype):
    del serial                  # a key only
    dtype = str(x_dtype).removeprefix("torch.")
    mode, lsb, levels = cm.kernel_args(cfg)
    rows = cfg.rows_per_subarray
    p = tiling.resolve_plan("rebranch_matmul", cfg.mode, dtype, m, k, n,
                            rows, plan, cdim=cdim)
    st = tiling.trunk_split(p, m, n, k, rows)
    ss = tiling.sketch_split(p, m, cdim, k, rows)
    launch = FusedLaunch(m, k, n, cdim, tiling.block_k(k, rows), mode,
                         int(x_bf16), cm.AdcParams(lsb, levels),
                         cm.c_split(st), cm.c_sketch(ss))
    return launch, st.scratch_floats(m, n), ss.scratch_floats(m, cdim)


def launched_plan(launch) -> tune_table.Plan:
    """The plan a FusedLaunch carries to the kernel."""
    return tune_table.Plan(launch.trunk.tile_m, launch.trunk.kb_per,
                           launch.sketch.tile_m, launch.sketch.sub_per)


@functools.cache
def _kernel():
    """The C entry of ``csrc/rebranch_matmul.cu``, built and bound once."""
    return cm.bind("rebranch_matmul", "rebranch_matmul", 8, FusedLaunch)


def rebranch_trunk_sketch(x: torch.Tensor, w_q: torch.Tensor,
                          c: torch.Tensor, cfg: cim_lib.CiMConfig = IDEAL,
                          plan: tune_table.Plan | None = None):
    """(UNscaled trunk [M, N], t1 [M, Cd]) of x [M, K], W [K, N], C [K, Cd].

    A CUDA tensor launches ``csrc/rebranch_matmul.cu`` in ``cfg``'s mode
    (a config the kernel does not take, or a build or launch failure,
    raises), with the tile heights and splits of ``tiling.resolve_plan``
    (``plan``, the tuning table's, or ``tiling.split_plan``'s for the
    trunk and ``tiling.split_sketch``'s for the sketch); a CPU tensor
    takes :func:`rebranch_matmul_plain`.  The kernel reads x in f32 or,
    at M <= 16, bf16 with K even; any other x, and a bf16 C, is widened
    first.  Widening is exact, so
    the bits do not depend on the route.  A ``meta`` tensor gets only the
    outputs' shapes.  Under ``launch.cost.count()`` the call counts as one
    kernel by its geometry, whatever runs.
    """
    if x.device.type == "meta" or cost.recording() is not None:
        m, k = x.shape
        n, cdim = w_q.shape[1], c.shape[1]
        return cost.kernel(
            "rebranch_matmul", 2 * m * k * n, 2 * m * k * cdim,
            x.numel() * x.element_size() + w_q.numel()
            + c.numel() * c.element_size() + 4 * m * (n + cdim),
            lambda: _rebranch_trunk_sketch(x, w_q, c, cfg, plan),
            (lambda: (x.new_empty((m, n), dtype=torch.float32),
                      x.new_empty((m, cdim), dtype=torch.float32)))
            if x.device.type == "meta" else None)
    return _rebranch_trunk_sketch(x, w_q, c, cfg, plan)


def _rebranch_trunk_sketch(x, w_q, c, cfg, plan):
    if x.device.type == "cpu":
        return rebranch_matmul_plain(x, w_q, c, cfg)
    cm.kernel_args(cfg)
    if (x.dim() != 2 or w_q.dtype != torch.int8 or w_q.dim() != 2
            or c.dim() != 2 or w_q.shape[0] != x.shape[1]
            or c.shape[0] != x.shape[1] or not x.is_floating_point()
            or not c.is_floating_point()):
        raise ValueError(
            f"rebranch kernel takes x float [M, K], W int8 [K, N] and C "
            f"float [K, Cd]; got x {x.dtype} {tuple(x.shape)}, W "
            f"{w_q.dtype} {tuple(w_q.shape)}, C {c.dtype} {tuple(c.shape)}")
    if w_q.device != x.device or c.device != x.device:
        raise ValueError(f"x on {x.device} but W on {w_q.device}, C on "
                         f"{c.device}")
    if not w_q.is_contiguous():
        raise ValueError("rebranch kernel needs a contiguous W")
    m, k = x.shape
    n, cdim = w_q.shape[1], c.shape[1]
    if 0 in (m, k, n, cdim):
        return (torch.zeros((m, n), dtype=torch.float32, device=x.device),
                torch.zeros((m, cdim), dtype=torch.float32, device=x.device))
    # a decode step's bf16 x is read as it is (a cast would cost a
    # launch); at prefill widths (M > 16) the kernel takes f32 only
    x_bf16 = (x.dtype == torch.bfloat16 and m <= 16 and k % 2 == 0
              and x.is_contiguous() and x.data_ptr() % 4 == 0)
    xk = x if x_bf16 else x.float().contiguous()
    cf = c.float().contiguous()
    launch, floats_t, floats_s = _launch(m, k, n, cdim, cfg, x_bf16, plan,
                                         x.dtype)
    trunk = torch.empty((m, n), dtype=torch.float32, device=x.device)
    t1 = torch.empty((m, cdim), dtype=torch.float32, device=x.device)
    parts = cm.scratch(floats_t + floats_s, x.device)
    at = parts.data_ptr() if parts is not None else 0
    rc = cm.call(_kernel(), x.device, xk.data_ptr(), w_q.data_ptr(),
                 cf.data_ptr(), trunk.data_ptr(), t1.data_ptr(),
                 at if floats_t else 0, at + 4 * floats_t if floats_s else 0,
                 cm.adc_pointer(cfg, x.device), launch)
    if rc != 0:
        raise RuntimeError(
            f"rebranch_matmul kernel launch failed: CUDA error {rc}")
    global launches, last_launch
    launches += 1
    last_launch = launch
    return trunk, t1


def epilogue(x_dtype, trunk, t1, w_scale, core, u) -> torch.Tensor:
    """``trunk * w_scale + (t1 @ core) @ U`` in f32, cast to ``x_dtype``
    (``rebranch_matmul.py:201-203``); the branch GEMMs on bucketed rows,
    so a row's bits do not depend on the batch (``core.rows``)."""
    out = trunk * w_scale.reshape(1, -1).float()
    branch = rows.rowwise(lambda t: (t @ core.float()) @ u.float(), t1)
    return (out + branch).to(x_dtype)


def rebranch_matmul(x: torch.Tensor, w_q: torch.Tensor,
                    w_scale: torch.Tensor, c: torch.Tensor,
                    core: torch.Tensor, u: torch.Tensor,
                    cfg: cim_lib.CiMConfig = IDEAL) -> torch.Tensor:
    """Fused ReBranch linear forward, x [M, K] -> [M, N] in x's dtype:
    the kernel's trunk and sketch, then the epilogue."""
    trunk, t1 = rebranch_trunk_sketch(x, w_q, c, cfg)
    return epilogue(x.dtype, trunk, t1, w_scale, core, u)
