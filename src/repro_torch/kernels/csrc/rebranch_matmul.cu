// Fused ReBranch matmul kernel for Hopper (sm_90a), in all three CiM modes.
//
// Replaces the Pallas TPU kernel repro/kernels/rebranch_matmul.py::
// _rebranch_kernel (launched by rebranch_matmul_pallas), with
// repro/kernels/cim_matmul.py::cim_block_dot inside it.  One launch
// computes, from the same x:
//
//   trunk f32 [M, N]  : the UNSCALED trunk of x f32 [M, K] and W int8
//                       [K, N]: per (row, k-block) absmax over the whole
//                       k-block, reciprocal int8 quantisation, the exact
//                       block dot (or its subarray ADC chain), `* scale`,
//                       ascending `+` -- trunk_conv.cu's function, bit for
//                       bit, on x in the patch matrix's place
//   t1    f32 [M, Cd] : the compress sketch x @ C, C f32 [K, Cd]: per
//                       k-block an f32 dot, the k-blocks added in
//                       ascending order
//
// The epilogue out = trunk * w_scale + (t1 @ core) @ U stays outside the
// kernel, as it stays outside the Pallas kernel (rebranch_matmul.py:201).
// The TPU kernel computes t1 in the n == 0 blocks of its grid, where the
// grid runs in order on one core.  Hopper blocks run in parallel, and at
// the LM shapes C is larger than W (16384 x 4096 f32, 268 MB, for a
// `down` projection), so the sketch has tiles of its own in the same
// launch: the grid is the trunk's blocks, then the sketch's.
//
// What bounds it on an H100, and the design (mma_tile.cuh; times in
// PERF.md, from chip_smoke.py):
//   decode (M = 8): bytes.  A Gemma-2B step reads 7.3 GB of W and C over
//     its 126 launches, 2.18 ms at 3.35 TB/s, 89% of it C, in grids of a
//     few dozen tiles.  So the trunk tiles are 16 rows high on the int8
//     MMA and split over k-blocks (tiling.split_k); the
//     sketch tiles are 8 rows high at M <= 8 (their f32 FMAs are spent on
//     every tile row) and split over 128-row sub-blocks
//     (tiling.split_sketch, about 1024 blocks), so each byte of W and C is
//     read once per launch through 16-byte cp.async in 3-stage rings, and
//     a second kernel adds the parts in k order.  A bf16 x is read as it
//     is (K even, 4-byte aligned) and widened exactly in the tile, which
//     spares the wrapper a cast launch: at most of these shapes a call
//     costs the host more than the launch takes on the card.
//   prefill (M = 128): operations: the sketch's 2 M K Cd f32 FMAs at 67
//     TFLOP/s outweigh the int8 MMA work and the bytes; 64-row tiles.
//   bitserial: operations, the trunk's 112 binary counts through the ADC
//     per (row, column, subarray): bitserial_tile.cuh's trunk tiles (binary
//     tensor-core counts, a table ADC), in the same grid as the sketch's,
//     with the plan of tiling.split_bitserial.
// Rows are independent: each output row depends on its own input row only,
// in an order that depends on neither M, the tile height nor the split.
#include <cuda_runtime.h>

#include <cstdint>

#include "bitserial_tile.cuh"
#include "mma_tile.cuh"

using namespace repro_torch;

namespace repro_torch {

// One launch as kernels/rebranch_matmul.py::FusedLaunch describes it
// (field for field): the shapes, the k-block width bk
// (tiling.block_k(k, 128)), the CimMode, the ADC constants, and the plans
// of tiling.split_plan (the trunk) and tiling.split_sketch (the sketch).
struct FusedLaunch {
  int m;
  int k;
  int n;
  int cdim;
  int bk;
  int mode;
  int x_bf16;   // x holds bf16 (M <= 16, K even, x 4-byte aligned), else f32
  AdcParams adc;
  mma::SplitPlan trunk;
  mma::SketchPlan sketch;
};

}  // namespace repro_torch

namespace {

template <int kMode, int TM, int TMS, class XT>
constexpr int fused_smem() {
  constexpr int trunk = mma::tile_smem<kMode, TM, mma::FloatAct<XT>>();
  return trunk > mma::SketchShape<TMS>::kSmem ? trunk
                                              : mma::SketchShape<TMS>::kSmem;
}

// Blocks [0, trunk_blocks) compute trunk tiles (TM rows), the rest sketch
// tiles (TMS rows).  XT: x's element type, float or mma::bf16_t.
template <int kMode, int TM, int TMS, class XT>
__global__ void __launch_bounds__(mma::kThreads)
    rebranch_mma(const XT* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ c, float* __restrict__ trunk,
                 float* __restrict__ t1, float* __restrict__ parts_t,
                 float* __restrict__ parts_s,
                 const unsigned char* __restrict__ adc_table, int m, int k,
                 int n, int cdim, int bk, mma::SplitPlan plan_t,
                 mma::SketchPlan plan_s, int trunk_blocks, AdcParams adc,
                 bool xvec, bool wvec, bool cvec) {
  extern __shared__ __align__(16) unsigned char smem[];
  int b = blockIdx.x;
  if (b < trunk_blocks) {
    const int tile = b % plan_t.tiles;
    const mma::FloatAct<XT> act{x, m, k, xvec};
    const mma::WSrc ws{w, k, n, wvec};
    const int kb0 = (b / plan_t.tiles) * plan_t.kb_per;
    const long long m0 = static_cast<long long>(tile / plan_t.tiles_n) * TM;
    const int n0 = (tile % plan_t.tiles_n) * mma::kTileN;
    if constexpr (kMode == kBitserial) {
      mma::bitserial_tile<TM>(act, ws, trunk, parts_t, bk, plan_t, kb0, m0,
                              n0, adc_table, smem);
    } else {
      mma::mma_tile<kMode, TM>(act, ws, trunk, parts_t, bk, plan_t, kb0, m0,
                               n0, adc, smem);
    }
  } else {
    b -= trunk_blocks;
    const int tile = b % plan_s.tiles;
    mma::sketch_tile<TMS, XT>(
        x, c, t1, parts_s, m, k, cdim, cvec, plan_s,
        (b / plan_s.tiles) * plan_s.sub_per,
        static_cast<long long>(tile / plan_s.tiles_n) * TMS,
        (tile % plan_s.tiles_n) * mma::kTileN, smem);
  }
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

struct Args {
  const void* x;
  const int8_t* w;
  const float* c;
  float* trunk;
  float* t1;
  float* parts_t;
  float* parts_s;
  const unsigned char* adc_table;
  const FusedLaunch& l;
  cudaStream_t stream;
};

template <int kMode, int TM, int TMS, class XT>
int launch_mma(const Args& a) {
  constexpr int smem = fused_smem<kMode, TM, TMS, XT>();
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        rebranch_mma<kMode, TM, TMS, XT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    // all of the SM's shared memory to shared use: the most blocks per SM
    const cudaError_t f = cudaFuncSetAttribute(
        rebranch_mma<kMode, TM, TMS, XT>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (f != cudaSuccess) return static_cast<int>(f);
    attr = true;
  }
  const FusedLaunch& l = a.l;
  const mma::SplitPlan& pt = l.trunk;
  const mma::SketchPlan& ps = l.sketch;
  const bool split_t = pt.n_splits > 1;
  const bool split_s = ps.n_splits > 1;
  if ((split_t && a.parts_t == nullptr) ||
      (split_s && a.parts_s == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long trunk_blocks =
      static_cast<long long>(pt.tiles) * pt.n_splits;
  const long long blocks =
      trunk_blocks + static_cast<long long>(ps.tiles) * ps.n_splits;
  const XT* x = static_cast<const XT*>(a.x);
  rebranch_mma<kMode, TM, TMS, XT><<<static_cast<unsigned>(blocks),
                                     mma::kThreads, smem, a.stream>>>(
      x, a.w, a.c, a.trunk, a.t1, a.parts_t, a.parts_s, a.adc_table, l.m,
      l.k, l.n, l.cdim, l.bk, pt, ps, static_cast<int>(trunk_blocks), l.adc,
      l.k % 4 == 0 && aligned(x, 4 * sizeof(XT)),
      l.n % 16 == 0 && aligned(a.w, 16),
      l.cdim % 4 == 0 && aligned(a.c, 16));
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) {
    e = mma::launch_split_reduce(
        a.parts_t, a.trunk, split_t ? static_cast<long long>(l.m) * l.n : 0,
        pt.nkb, a.parts_s, a.t1,
        split_s ? static_cast<long long>(l.m) * l.cdim : 0, ps, a.stream);
  }
  return static_cast<int>(e);
}

// The tile heights that run together: (16, 8) at M <= 8 (decode), (16,
// 16) at 9 <= M <= 16 (the prefill of a short prompt) and (64, 64) above
// ((32, 64) in bitserial), where x is f32 only: at those widths the
// sketch is bound by its FMAs, and widening bf16 in its inner loop
// measured slower than a cast first.
template <int kMode, class XT>
int launch_height(const Args& a) {
  const int tile_m = a.l.trunk.tile_m;
  const int tile_ms = a.l.sketch.tile_m;
  if (tile_m == 16 && tile_ms == 8) {
    return launch_mma<kMode, 16, 8, XT>(a);
  }
  if (tile_m == 16 && tile_ms == 16) {
    return launch_mma<kMode, 16, 16, XT>(a);
  }
  // above 16 rows: 64-row trunk tiles, or 32-row ones in bitserial
  constexpr int kTall = kMode == kBitserial ? 32 : 64;
  if constexpr (sizeof(XT) == 4) {
    if (tile_m == kTall && tile_ms == 64) {
      return launch_mma<kMode, kTall, 64, XT>(a);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int kMode>
int launch_dtype(const Args& a) {
  return a.l.x_bf16 ? launch_height<kMode, mma::bf16_t>(a)
                    : launch_height<kMode, float>(a);
}

}  // namespace

// Launch `*l` on `stream`; returns cudaGetLastError() (0 on success).  A
// split trunk needs `parts_t` (n_kblocks * m * n floats), a split sketch
// `parts_s` (its slots * m * cdim); either adds a second kernel
// (split_reduce) on the stream.  x is bf16 where `x_bf16` says so (16-row
// tiles, K even, 4-byte aligned), else f32.  Bitserial reads the ADC table
// `adc_table` (cim_block_dot.cuh; 16-byte aligned), the other modes none.
extern "C" int rebranch_matmul(const void* x, const int8_t* w,
                               const float* c, float* trunk, float* t1,
                               float* parts_t, float* parts_s,
                               const unsigned char* adc_table,
                               const FusedLaunch* l, cudaStream_t stream) {
  if (l->m <= 0 || l->k <= 0 || l->n <= 0 || l->cdim <= 0 || l->bk <= 0 ||
      l->bk % mma::kChunkK != 0 || l->bk > mma::kBlockK ||
      !mma::covers(l->sketch, l->m, l->cdim, l->k, l->bk) ||
      !mma::covers(l->trunk, l->m, l->n, l->k, l->bk) ||
      (l->x_bf16 && (l->k % 2 != 0 || !aligned(x, 4))) ||
      (l->mode == kBitserial &&
       (adc_table == nullptr || !aligned(adc_table, 16)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, w, c, trunk, t1, parts_t, parts_s, adc_table, *l, stream};
  switch (l->mode) {
    case kIdeal:
      return launch_dtype<kIdeal>(a);
    case kPerSubarray:
      return launch_dtype<kPerSubarray>(a);
    case kBitserial:
      return launch_dtype<kBitserial>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of the fused tile of height tile_m in CimMode
// mode, in bytes (for the build report); -1 for a height the kernel does
// not take.
extern "C" int rebranch_matmul_smem(int tile_m, int mode) {
  if (mode == kBitserial) {
    return tile_m == 16   ? fused_smem<kBitserial, 16, 16, float>()
           : tile_m == 32 ? fused_smem<kBitserial, 32, 64, float>()
                          : -1;
  }
  return tile_m == 16   ? fused_smem<kIdeal, 16, 16, float>()
         : tile_m == 64 ? fused_smem<kIdeal, 64, 64, float>()
                        : -1;
}

// sizeof(FusedLaunch), for the wrapper's check of its mirror
extern "C" int rebranch_matmul_launch_bytes() { return sizeof(FusedLaunch); }
