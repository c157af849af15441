"""The ROM-CiM macro matmul (port of ``repro.kernels.cim_matmul``).

cim_block_dot : the macro math of one block, all three fidelity modes in
                plain PyTorch; their CUDA device routines are
                ``csrc/cim_block_dot.cuh``, which every kernel calls.
cim_matmul    : int8 [M, K] x int8 [K, N] -> f32 [M, N], one macro dot per
                k-block of ``tiling.k_partition``, the blocks added in f32
                in ascending order.  The wrapper of the hand-written CUDA
                kernel ``csrc/cim_matmul.cu`` (the port of the Pallas
                ``_cim_kernel``): for a CUDA tensor it launches the kernel
                in the config's mode or raises; only a CPU tensor takes
                :func:`cim_matmul_plain`, which mirrors ``_cim_direct``.
kernel_args   : the CiM mode and ADC constants that all three kernels'
                C entries take, and the check of what they do not take.
adc_table     : the bitserial ADC as a table of (popcount, count), built
                once per config with the plain version's formula, which the
                kernels read instead of dividing.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core import adc as adc_lib
from repro_torch.core import cim as cim_lib
from repro_torch.kernels import _build
from repro_torch.kernels import tiling
from repro_torch.launch import cost
from repro_torch.tune import table as tune_table

IDEAL = cim_lib.CiMConfig(mode="ideal")

# Kernel launches of cim_matmul since the count was last set to 0, and
# the CimLaunch of the last one (the tuner reads its plan back).
launches = 0
last_launch = None


def cim_block_dot(cfg: cim_lib.CiMConfig, x: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """Mode-dependent macro math for one block: int8 (bm, bk) x int8
    (bk, bn) -> f32 (bm, bn).  ``bk`` holds whole 128-row subarrays, so
    subarray boundaries align with global K offsets."""
    rows = cfg.rows_per_subarray
    if cfg.mode == "ideal":
        return cim_lib.int_dot(x, w)

    if cfg.mode == "per_subarray":
        acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                          device=x.device)
        for si in range(x.shape[1] // rows):
            xs = x[:, si * rows:(si + 1) * rows].float()
            ws = w[si * rows:(si + 1) * rows, :].float()
            acc = acc + adc_lib.signed_adc(xs @ ws, rows * 127.0, cfg)
        return acc

    if cfg.mode == "bitserial":
        # for each sign pair, subarray si, pulse group g and weight bit
        # plane j, in that order: acc += sign * 4**g * 2**j * ADC(count).
        # The planes j of one (si, g) go through the matmul and the ADC as
        # one batch (integer counts and elementwise ops: the same bits);
        # only the f32 sum into acc runs term by term, in the order above.
        mag_bits, act_groups, gmax = adc_lib.bitserial_planes(cfg)
        dev = x.device
        x_i = x.to(torch.int32)
        w_i = w.to(torch.int32)
        acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                          device=dev)
        g_shift = (torch.arange(act_groups, device=dev, dtype=torch.int32)
                   * cfg.act_group_bits).view(-1, 1, 1)
        j_shift = torch.arange(mag_bits, device=dev,
                               dtype=torch.int32).view(-1, 1, 1)
        # sign * 4**g * 2**j: powers of two, exact in f32
        scales = {sign: torch.tensor(
            [[sign * (4.0 ** g) * (2.0 ** j) for j in range(mag_bits)]
             for g in range(act_groups)], dtype=torch.float32,
            device=dev).view(act_groups, mag_bits, 1, 1)
            for sign in (1.0, -1.0)}
        for sa, a_part in ((0, x_i.clamp_min(0)), (1, (-x_i).clamp_min(0))):
            a_planes = ((a_part.unsqueeze(0) >> g_shift) & gmax).float()
            for sw, w_part in ((0, w_i.clamp_min(0)),
                               (1, (-w_i).clamp_min(0))):
                scale = scales[1.0 if sa == sw else -1.0]
                for si in range(x.shape[1] // rows):
                    w_s = w_part[si * rows:(si + 1) * rows, :]
                    w_js = ((w_s.unsqueeze(0) >> j_shift) & 1).float()
                    popcount = w_js.sum(dim=1, keepdim=True)
                    rng = (popcount * gmax).clamp_min(1.0)
                    for g in range(act_groups):
                        a_g = a_planes[g, :, si * rows:(si + 1) * rows]
                        sensed = adc_lib.adc_transfer(a_g @ w_js, rng, cfg)
                        terms = sensed * scale[g]
                        for j in range(mag_bits):
                            acc = acc + terms[j]
        return acc

    raise ValueError(f"unknown CiM mode: {cfg.mode!r}")


def cim_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                     cfg: cim_lib.CiMConfig = IDEAL) -> torch.Tensor:
    """Plain PyTorch version of the CiM matmul kernel: int8 [M, K] x int8
    [K, N] -> f32 [M, N].

    Mirrors ``_cim_direct``: per k-block of ``k_partition(K, rows)`` the
    macro dot (exact in ``ideal`` mode: a block sums below 2**24), then a
    separate f32 ``acc +`` in ascending k-block order.  NOT one sum over
    all of K, which rounds differently once a row sum passes 2**24.
    Non-ideal modes pad a ragged block with zero rows to whole subarrays
    (zeros read as 0 through every ADC path).
    """
    m, k = x_q.shape
    n = w_q.shape[1]
    if 0 in (m, k, n):
        return torch.zeros((m, n), dtype=torch.float32, device=x_q.device)
    rows = cfg.rows_per_subarray
    acc = None
    for k0, k1 in tiling.k_partition(k, rows):
        xb, wb = x_q[:, k0:k1], w_q[k0:k1]
        if cfg.mode == "ideal":
            part = cim_lib.int_dot(xb, wb)
        else:
            pad = -(k1 - k0) % rows
            part = cim_block_dot(cfg, F.pad(xb, (0, pad)),
                                 F.pad(wb, (0, 0, 0, pad)))
        acc = part if acc is None else acc + part
    return acc


# the CimMode values of csrc/cim_block_dot.cuh
MODES = {"ideal": 0, "per_subarray": 1, "bitserial": 2}
# CiMConfig fields the kernels are built for: one 128-row subarray per
# chunk, 7 weight planes, 4 two-bit activation groups
KERNEL_FIELDS = {"rows_per_subarray": 128, "weight_bits": 8, "act_bits": 8,
                 "act_group_bits": 2}


@functools.lru_cache(maxsize=None)
def kernel_args(cfg: cim_lib.CiMConfig) -> tuple:
    """(mode, lsb, levels) of ``cfg`` for the kernels' C entries: the
    CimMode, the per_subarray step (a Python double that ctypes rounds
    once to f32, as ``adc.signed_adc`` does) and ``adc_levels``.  Raises
    ValueError, naming the field, for a config the kernels do not take
    (the CPU plain versions take any)."""
    for field, want in KERNEL_FIELDS.items():
        got = getattr(cfg, field)
        if got != want:
            raise ValueError(
                f"the CUDA kernels take CiMConfig.{field} == {want} only, "
                f"got {got} (the plain versions on the CPU take any)")
    if cfg.mode not in MODES:
        raise ValueError(f"unknown CiM mode: {cfg.mode!r}")
    if cfg.mode == "bitserial" and cfg.adc_levels > 255:
        raise ValueError(f"the bitserial kernels take CiMConfig.adc_bits <= "
                         f"8 only (uint8 codes), got {cfg.adc_bits}")
    return (MODES[cfg.mode],
            adc_lib.signed_lsb(cfg.rows_per_subarray * 127.0, cfg),
            float(cfg.adc_levels))


@functools.lru_cache(maxsize=None)
def adc_table(cfg: cim_lib.CiMConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The bitserial ADC of ``cfg`` as a table, on the CPU: (code uint8
    [rows + 1, 3 rows + 1], lsb f32 [rows + 1]).  A count of one subarray
    is an integer in [0, 3 p], p the ones of its weight plane in the
    column, and the column's range is max(3 p, 1), so ``adc_transfer``'s
    code is a function of (p, count): ``code[p, count] * lsb[p]`` is the
    plain version's sensed value, computed here by the plain version's
    own f32 formula (``adc.adc_lsb``, ``adc.adc_code``) for every pair."""
    rows, gmax = cfg.rows_per_subarray, cfg.group_max
    pop = torch.arange(rows + 1, dtype=torch.float32)[:, None]
    counts = torch.arange(gmax * rows + 1, dtype=torch.float32)[None, :]
    lsb = adc_lib.adc_lsb((pop * gmax).clamp_min(1.0), cfg, counts)
    code = adc_lib.adc_code(counts, lsb, cfg)
    return code.to(torch.uint8), lsb[:, 0]


# bytes of csrc/cim_block_dot.cuh's table: lsb f32 [129], then row p of
# the codes for the counts 0 .. 3 p that a count can reach, padded to 16
ADC_TABLE_BYTES = -(-(4 * 129 + sum(3 * p + 1 for p in range(129)))
                    // 16) * 16


@functools.lru_cache(maxsize=None)
def _device_table(cfg: cim_lib.CiMConfig, device: torch.device):
    code, lsb = adc_table(cfg)
    gmax = cfg.group_max
    raw = torch.cat([lsb.view(torch.uint8),
                     *(code[p, :gmax * p + 1] for p in range(code.shape[0]))])
    raw = torch.cat([raw, raw.new_zeros(ADC_TABLE_BYTES - raw.numel())])
    return raw.to(device)


def adc_pointer(cfg: cim_lib.CiMConfig, device: torch.device) -> int:
    """The kernels' ADC table argument: the device address of ``cfg``'s
    table in the layout of ``csrc/cim_block_dot.cuh`` (made once per
    config and card) in bitserial mode, else 0."""
    if cfg.mode != "bitserial":
        return 0
    return _device_table(cfg, device).data_ptr()


def mirror(name: str, fields) -> type:
    """A ctypes Structure of a C struct in ``csrc/``, field for field."""
    return type(name, (ctypes.Structure,), {"_fields_": list(fields)})


# csrc/cim_block_dot.cuh's AdcParams and mma_tile.cuh's SplitPlan and
# SketchPlan (tests/test_torch_split.py holds the names to the headers)
AdcParams = mirror("AdcParams", [(f, ctypes.c_float)
                                  for f in ("lsb", "levels")])
SplitPlan = mirror("SplitPlan", [
    (f, ctypes.c_int)
    for f in ("tile_m", "tiles_n", "tiles", "nkb", "kb_per", "n_splits")])
SketchPlan = mirror("SketchPlan", [
    (f, ctypes.c_int) for f in ("tile_m", "tiles_n", "tiles", "nsub", "spk",
                                "sub_per", "n_splits", "nkb", "sub_slots")])
# csrc/cim_matmul.cu's CimLaunch
CimLaunch = mirror("CimLaunch", [
    *((f, ctypes.c_int) for f in ("m", "k", "n", "bk", "mode")),
    ("adc", AdcParams), ("plan", SplitPlan)])


def c_split(s: tiling.Split):
    """``s`` as the kernels' SplitPlan."""
    return SplitPlan(s.tile_m, s.tiles_n, s.tiles, s.n_kblocks,
                     s.kb_per_split, s.n_splits)


def c_sketch(s: tiling.SketchSplit):
    """``s`` as the fused kernel's SketchPlan."""
    return SketchPlan(s.tile_m, s.tiles_n, s.tiles, s.n_sub,
                      s.sub_per_kblock, s.sub_per_split, s.n_splits,
                      s.n_kblocks, int(s.sub_slots))


def _launch(m: int, k: int, n: int, cfg: cim_lib.CiMConfig,
            plan: tune_table.Plan | None = None):
    """(CimLaunch, scratch floats) of one launch: the shapes, the mode,
    the ADC constants and the plan of ``tiling.resolve_plan`` (``plan``,
    else the tuning table's, else ``tiling.split_plan``'s).  Made once per
    shape, config, plan and table state: the state's serial is part of the
    cache key, so an ``overrides()`` or ``disabled()`` context is never
    served a plan resolved outside it."""
    return _launch_at(tune_table.serial(), m, k, n, cfg, plan)


@functools.lru_cache(maxsize=4096)
def _launch_at(serial: int, m: int, k: int, n: int, cfg: cim_lib.CiMConfig,
               plan):
    del serial                  # a key only
    mode, lsb, levels = kernel_args(cfg)
    rows = cfg.rows_per_subarray
    p = tiling.resolve_plan("cim_matmul", cfg.mode, "int8", m, k, n, rows,
                            plan)
    sp = tiling.trunk_split(p, m, n, k, rows)
    launch = CimLaunch(m, k, n, tiling.block_k(k, rows), mode,
                       AdcParams(lsb, levels), c_split(sp))
    return launch, sp.scratch_floats(m, n)


def launched_plan(launch) -> tune_table.Plan:
    """The plan a CimLaunch (or ConvLaunch) carries to the kernel."""
    return tune_table.Plan(launch.plan.tile_m, launch.plan.kb_per)


def bind(lib_name: str, entry: str, n_pointers: int, launch_type) -> object:
    """The C entry ``entry`` of ``csrc/<lib_name>.cu``, bound as (pointers,
    launch struct, stream), after checking that the library's struct has
    the mirror's size."""
    lib = _build.library(lib_name)
    size = getattr(lib, f"{lib_name}_launch_bytes")
    size.argtypes, size.restype = [], ctypes.c_int
    if size() != ctypes.sizeof(launch_type):
        raise RuntimeError(
            f"{lib_name}: the C launch struct has {size()} bytes, its "
            f"mirror {ctypes.sizeof(launch_type)}")
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [
        ctypes.POINTER(launch_type), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    """The C entry of ``csrc/cim_matmul.cu``, built and bound once."""
    return bind("cim_matmul", "cim_matmul", 5, CimLaunch)


def call(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)`` on ``device``'s current stream.  A decode step
    makes 126 calls, so this takes the shortest way: the raw stream handle
    (``torch.cuda.current_stream`` builds a Stream object, about 8 us on
    an H100 host), and the device context only when another card is
    current."""
    index = device.index
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def scratch(floats: int, device):
    """The f32 parts of a split launch, left uninitialised (None for 0)."""
    return torch.empty(floats, dtype=torch.float32, device=device) \
        if floats else None


def cim_matmul(x_q: torch.Tensor, w_q: torch.Tensor,
               cfg: cim_lib.CiMConfig = IDEAL,
               plan: tune_table.Plan | None = None) -> torch.Tensor:
    """Blocked CiM matmul int8 [M, K] x int8 [K, N] -> f32 [M, N].

    A CUDA tensor launches ``csrc/cim_matmul.cu`` in ``cfg``'s mode (a
    config the kernel does not take, or a build or launch failure,
    raises), with the tile height and split of ``tiling.resolve_plan``
    (``plan``, the tuning table's, or ``tiling.split_plan``'s: none moves
    a bit); a CPU tensor takes :func:`cim_matmul_plain`.  The split's f32
    parts are left uninitialised: every part is written before the
    reduction reads it.  A ``meta`` tensor gets only the output's shape.
    Under ``launch.cost.count()`` the call counts as one kernel by its
    geometry, whatever runs.
    """
    if x_q.device.type == "meta" or cost.recording() is not None:
        m, k = x_q.shape
        n = w_q.shape[1]
        return cost.kernel(
            "cim_matmul", 2 * m * k * n, 0,
            x_q.numel() * x_q.element_size() + w_q.numel() + 4 * m * n,
            lambda: _cim_matmul(x_q, w_q, cfg, plan),
            (lambda: x_q.new_empty((m, n), dtype=torch.float32))
            if x_q.device.type == "meta" else None)
    return _cim_matmul(x_q, w_q, cfg, plan)


def _cim_matmul(x_q, w_q, cfg, plan):
    if x_q.device.type == "cpu":
        return cim_matmul_plain(x_q, w_q, cfg)
    kernel_args(cfg)
    if (x_q.dtype != torch.int8 or w_q.dtype != torch.int8
            or x_q.dim() != 2 or w_q.dim() != 2
            or w_q.shape[0] != x_q.shape[1]):
        raise ValueError(f"CiM matmul kernel takes X int8 [M, K] and W int8 "
                         f"[K, N]; got X {x_q.dtype} {tuple(x_q.shape)}, W "
                         f"{w_q.dtype} {tuple(w_q.shape)}")
    if w_q.device != x_q.device:
        raise ValueError(f"X on {x_q.device} but W on {w_q.device}")
    if not (x_q.is_contiguous() and w_q.is_contiguous()):
        raise ValueError("CiM matmul kernel needs contiguous X and W")
    m, k = x_q.shape
    n = w_q.shape[1]
    if 0 in (m, k, n):
        return torch.zeros((m, n), dtype=torch.float32, device=x_q.device)
    launch, floats = _launch(m, k, n, cfg, plan)
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    parts = scratch(floats, x_q.device)
    rc = call(_kernel(), x_q.device, x_q.data_ptr(), w_q.data_ptr(),
              out.data_ptr(), parts.data_ptr() if floats else 0,
              adc_pointer(cfg, x_q.device), launch)
    if rc != 0:
        raise RuntimeError(f"cim_matmul kernel launch failed: CUDA error {rc}")
    global launches, last_launch
    launches += 1
    last_launch = launch
    return out
