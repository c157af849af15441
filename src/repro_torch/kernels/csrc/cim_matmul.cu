// CiM matmul kernel for Hopper (sm_90a), in all three CiM modes.
//
// Replaces the Pallas TPU kernel repro/kernels/cim_matmul.py::_cim_kernel
// (launched by cim_matmul_pallas, and through it by cim_conv_pallas), with
// repro/kernels/cim_matmul.py::cim_block_dot inside it:
//
//   X int8 [M, K], W int8 [K, N]  ->  f32 [M, N]
//   for each k-block [k0, k1) of k_partition(K, 128), ascending:
//     out += cim_block_dot<mode>(X[:, k0:k1], W[k0:k1])
//
// There is no quantisation and no scale; X may hold -128, which the
// bitserial planes read as a magnitude of 128 (cim_block_dot.cuh).  In
// ideal mode the block dot is exact in int32 and converts to f32 exactly
// (a 512-row block sums below 512 * 128 * 128 < 2**24); in per_subarray
// mode it is the block's chain of subarray ADC outputs.  The blocks are
// added in f32, one rounding each, in ascending order (__fadd_rn; the
// library is built with -fmad=false).  It is NOT one int32 sum over all K:
// at K = 16384 a row sum reaches 2.6e8 > 2**24, and a blocked f32
// accumulation rounds differently, so this matches cim_matmul_pallas /
// _cim_direct, not core/cim.py::cim_matmul_model.  Columns past K read as
// zeros.  Each output row depends on its own input row only, in an order
// that does not depend on M, the tile height or the split.
//
// What bounds it on an H100, and the design (ideal and per_subarray:
// mma_tile.cuh; times in PERF.md, from chip_smoke.py):
//   decode (M = 8, Gemma-2B's K x N from 2048 x 256 to 16384 x 2048):
//     bytes.  W is read once, 0.5 to 33.5 MB per launch, 0.60 ms per
//     126-launch step at 3.35 TB/s, against 0.03 ms of int8 tensor-core
//     work, and a 64-row tile would be 56 rows of padding.  So: a 16-row
//     tile; where the (row tile, column tile) grid is under two
//     blocks per SM the k-blocks are split over the grid (tiling.split_k:
//     a `down` launch has 512 blocks, not 32) and a second kernel adds
//     the parts in k order; W arrives by 16-byte cp.async in a 3-stage
//     ring (3 stages, not 4, leave room for 4 blocks per SM, which
//     measured faster).
//   prefill (M = 128): operations, 2 M K N int8 at 1979 TOP/s, against
//     the bytes of W.  mma.sync m16n8k32 on 64 x 64 tiles, 2 x 2 warps;
//     it still loses to torch._int_mm (by 2-3x at the Gemma-2B widths,
//     PERF.md): the in-kernel
//     transposition of each W chunk and two barriers per 128 k feed the
//     MMA too slowly.  wgmma on larger tiles is the next step.
//   bitserial: operations, 112 binary counts through the ADC per (row,
//     column, subarray): bitserial_tile.cuh on Int8Act, the counts from
//     the binary tensor cores, the ADC a table (no division); 16-row tiles
//     at decode, 32-row above, split over k-blocks where the grid is small
//     (tiling.split_bitserial).
#include <cuda_runtime.h>

#include <cstdint>

#include "bitserial_tile.cuh"
#include "mma_tile.cuh"

using namespace repro_torch;

namespace repro_torch {

// One launch as kernels/cim_matmul.py::CimLaunch describes it (field for
// field): the shapes, the k-block width bk (tiling.block_k(k, 128)), the
// CimMode, the ADC constants and tiling.split_plan's plan.
struct CimLaunch {
  int m;
  int k;
  int n;
  int bk;
  int mode;
  AdcParams adc;
  mma::SplitPlan plan;
};

}  // namespace repro_torch

namespace {

template <int kMode, int TM>
__global__ void __launch_bounds__(mma::kThreads)
    cim_matmul_mma(const int8_t* __restrict__ x,
                   const int8_t* __restrict__ w, float* __restrict__ out,
                   float* __restrict__ parts,
                   const unsigned char* __restrict__ adc_table, int m, int k,
                   int n, int bk, mma::SplitPlan plan, AdcParams adc,
                   bool xvec, bool wvec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tile = b % plan.tiles;
  const int split = b / plan.tiles;
  const mma::Int8Act act{x, m, k, xvec};
  const mma::WSrc ws{w, k, n, wvec};
  const long long m0 = static_cast<long long>(tile / plan.tiles_n) * TM;
  const int n0 = (tile % plan.tiles_n) * mma::kTileN;
  if constexpr (kMode == kBitserial) {
    mma::bitserial_tile<TM>(act, ws, out, parts, bk, plan,
                            split * plan.kb_per, m0, n0, adc_table, smem);
  } else {
    mma::mma_tile<kMode, TM>(act, ws, out, parts, bk, plan,
                             split * plan.kb_per, m0, n0, adc, smem);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int kMode, int TM>
int launch_mma(const int8_t* x, const int8_t* w, float* out, float* parts,
               const unsigned char* adc_table, const CimLaunch& l,
               cudaStream_t stream) {
  constexpr int smem = mma::tile_smem<kMode, TM, mma::Int8Act>();
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        cim_matmul_mma<kMode, TM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    // all of the SM's shared memory to shared use: the most blocks per SM
    const cudaError_t f = cudaFuncSetAttribute(
        cim_matmul_mma<kMode, TM>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (f != cudaSuccess) return static_cast<int>(f);
    attr = true;
  }
  const mma::SplitPlan& plan = l.plan;
  const long long blocks = static_cast<long long>(plan.tiles) * plan.n_splits;
  cim_matmul_mma<kMode, TM><<<static_cast<unsigned>(blocks), mma::kThreads,
                              smem, stream>>>(
      x, w, out, parts, adc_table, l.m, l.k, l.n, l.bk, plan, l.adc,
      l.k % 16 == 0 && aligned16(x), l.n % 16 == 0 && aligned16(w));
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess && plan.n_splits > 1) {
    e = mma::launch_split_reduce(parts, out, static_cast<long long>(l.m) * l.n,
                                 plan.nkb, nullptr, nullptr, 0,
                                 mma::SketchPlan{}, stream);
  }
  return static_cast<int>(e);
}

template <int kMode>
int launch_mode(const int8_t* x, const int8_t* w, float* out, float* parts,
                const unsigned char* adc_table, const CimLaunch& l,
                cudaStream_t stream) {
  // tile heights 16 and 64, or 16 and 32 in bitserial
  constexpr int kTall = kMode == kBitserial ? 32 : 64;
  if (l.plan.tile_m == 16) {
    return launch_mma<kMode, 16>(x, w, out, parts, adc_table, l, stream);
  }
  if (l.plan.tile_m == kTall) {
    return launch_mma<kMode, kTall>(x, w, out, parts, adc_table, l, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launch `*l` on `stream`; returns cudaGetLastError() (0 on success).  With
// more than one split, `parts` holds n_kblocks * m * n floats, and a
// second kernel (split_reduce) follows on the stream.  Bitserial reads the
// ADC table `adc_table` (cim_block_dot.cuh; 16-byte aligned), the other
// modes none.
extern "C" int cim_matmul(const int8_t* x, const int8_t* w, float* out,
                          float* parts, const unsigned char* adc_table,
                          const CimLaunch* l, cudaStream_t stream) {
  if (l->m <= 0 || l->k <= 0 || l->n <= 0 || l->bk <= 0 ||
      l->bk % mma::kChunkK != 0 || l->bk > mma::kBlockK ||
      !mma::covers(l->plan, l->m, l->n, l->k, l->bk) ||
      (l->plan.n_splits > 1 && parts == nullptr) ||
      (l->mode == kBitserial &&
       (adc_table == nullptr || !aligned16(adc_table)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (l->mode) {
    case kIdeal:
      return launch_mode<kIdeal>(x, w, out, parts, adc_table, *l, stream);
    case kPerSubarray:
      return launch_mode<kPerSubarray>(x, w, out, parts, adc_table, *l,
                                       stream);
    case kBitserial:
      return launch_mode<kBitserial>(x, w, out, parts, adc_table, *l,
                                     stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of the tile of height tile_m in CimMode mode, in
// bytes (for the build report); -1 for a height the mode does not take.
extern "C" int cim_matmul_smem(int tile_m, int mode) {
  using mma::Int8Act;
  using mma::tile_smem;
  if (mode == kBitserial) {
    return tile_m == 16   ? tile_smem<kBitserial, 16, Int8Act>()
           : tile_m == 32 ? tile_smem<kBitserial, 32, Int8Act>()
                          : -1;
  }
  return tile_m == 16   ? tile_smem<kIdeal, 16, Int8Act>()
         : tile_m == 64 ? tile_smem<kIdeal, 64, Int8Act>()
                        : -1;
}

// sizeof(CimLaunch), for the wrapper's check of its mirror
extern "C" int cim_matmul_launch_bytes() { return sizeof(CimLaunch); }
