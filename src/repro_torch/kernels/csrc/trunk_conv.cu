// Trunk conv kernel for Hopper (sm_90a), in all three CiM modes: an
// implicit GEMM straight from the NHWC input.
//
// Replaces the Pallas TPU kernel repro/kernels/rebranch_conv.py::
// _trunk_conv_kernel (launched by _trunk_patch_dot), with
// repro/kernels/cim_matmul.py::cim_block_dot inside it.  It computes the
// UNSCALED trunk of a ReBranch conv,
//
//   x f32 [N, H, W, C] (NHWC), W int8 [R, Cout] (R = kh*kw*C, tap-major)
//     ->  f32 [M, Cout], M = N*OH*OW
//   for each k-block [k0, k1) of k_partition(R, 128), ascending:
//     scale = f32(max(absmax(P[m, k0:k1]), 1e-8) * f32(1/127))
//     q     = clip(rint(P[m, k] * (1/scale)), -127, 127)        (int8)
//     out  += cim_block_dot<mode>(q, W[k0:k1]) * scale
//
// where P is the im2col patch matrix of x, which is never built: each
// tile gathers its rows' k-block from x through the implicit im2col map of
// conv_geom.cuh (padded pixels read 0, as P's padding does).  The codes,
// the dot order and every rounding are the plain version's
// (kernels/rebranch_conv.py::trunk_patch_dot_plain on patch_matrix(x)),
// bit for bit: the contract of ROADMAP Queue 2.
//
// Bounds on an H100 (per DarkNet-19 forward at 416x416, batch 8: 1.01e11
// MACs; x of the 20 sites 263 MB, W 38.7 MB, output 509 MB):
//   ideal        bytes: reading x and W once and writing the output takes
//                0.242 ms at 3.35 TB/s, against 0.102 ms of int8
//                tensor-core work.  (With P in HBM, as until this kernel
//                read NHWC, the bytes were 1.57e9 more: 0.632 ms.)  The
//                tile is mma_tile.cuh's int8 mma.sync tile, 64 rows (64
//                neighbouring output pixels, whose taps overlap in L1) x
//                64 columns, with mma_tile.cuh's NhwcAct as its activation
//                source: per k-block the tile's rows are gathered (float4
//                along C where C % 4 == 0), their absmax taken over the
//                whole k-block, and the codes packed into shared memory;
//                W arrives by cp.async.  Staging A, not the MMA, is the
//                tile's largest cost, and every 64-wide column tile of a
//                row tile needs the same codes: so where the column tiles
//                come in pairs, two blocks form a cluster, each stages
//                half of the rows and writes the codes into both blocks'
//                shared memory (distributed shared memory), and at Cout =
//                1024 a value of x is quantised 8 times per tap, not 16.
//                A grid of under two blocks per SM (the 13x13 sites at
//                Cout = 512) is split over k-blocks (tiling.split_k), and
//                split_reduce adds the parts in k order.
//   per_subarray bytes as well: the same dot plus one ADC evaluation per
//                (row, column, subarray), 8.5e8 per forward, a few f32
//                operations each.
//   bitserial    operations: 112 binary counts per (row, column, subarray),
//                each through the ADC, 9.6e10 per forward.  bitserial_tile.cuh
//                on NhwcAct: the counts from the binary tensor cores, the
//                ADC a table in shared memory (no division), each k-block
//                staged once as bit planes; 32-row tiles, two blocks per
//                SM, split (tiling.split_bitserial) where the grid is
//                small.
#include <cuda_runtime.h>

#include <cstdint>

#include "conv_geom.cuh"
#include "bitserial_tile.cuh"
#include "mma_tile.cuh"

using namespace repro_torch;

namespace repro_torch {

// One launch as kernels/rebranch_conv.py::ConvLaunch describes it (field
// for field): the geometry, the k-block width bk (tiling.block_k(r, 128)),
// the CimMode, the ADC constants and tiling.split_plan's plan of the
// implied [M, R] x [R, Cout] product.
struct ConvLaunch {
  ConvGeom geom;
  int r;
  int n;
  int bk;
  int mode;
  AdcParams adc;
  mma::SplitPlan plan;
};

}  // namespace repro_torch

namespace {

__host__ __device__ inline long long rows_of(const ConvGeom& g) {
  return static_cast<long long>(g.n) * g.oh * g.ow;
}

template <int kMode, int TM, bool kVec, bool kPair>
__device__ __forceinline__ void conv_tile(const float* __restrict__ x,
                                          const mma::WSrc& w,
                                          float* __restrict__ out,
                                          float* __restrict__ parts,
                                          const unsigned char* adc_table,
                                          const ConvLaunch& l) {
  extern __shared__ __align__(16) unsigned char smem[];
  const mma::SplitPlan& plan = l.plan;
  const int b = blockIdx.x;
  const int tile = b % plan.tiles;
  const int split = b / plan.tiles;
  const mma::NhwcAct<kVec> act{x, l.geom, rows_of(l.geom), l.r};
  const long long m0 = static_cast<long long>(tile / plan.tiles_n) * TM;
  const int n0 = (tile % plan.tiles_n) * mma::kTileN;
  if constexpr (kMode == kBitserial) {
    mma::bitserial_tile<TM>(act, w, out, parts, l.bk, plan,
                            split * plan.kb_per, m0, n0, adc_table, smem);
  } else {
    mma::mma_tile<kMode, TM, mma::NhwcAct<kVec>, kPair>(
        act, w, out, parts, l.bk, plan, split * plan.kb_per, m0, n0, l.adc,
        smem);
  }
}

template <int kMode, int TM, bool kVec>
__global__ void __launch_bounds__(mma::kThreads)
    trunk_conv_mma(const float* __restrict__ x, mma::WSrc w,
                   float* __restrict__ out, float* __restrict__ parts,
                   const unsigned char* __restrict__ adc_table,
                   ConvLaunch l) {
  conv_tile<kMode, TM, kVec, false>(x, w, out, parts, adc_table, l);
}

// Blocks 2j and 2j + 1 are column tiles 2c and 2c + 1 of one row tile
// (tiles_n even): a cluster of two that stage the row tile's codes once,
// half the rows each.
template <int kMode, bool kVec>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(mma::kThreads)
    trunk_conv_pair(const float* __restrict__ x, mma::WSrc w,
                    float* __restrict__ out, float* __restrict__ parts,
                    const unsigned char* __restrict__ adc_table,
                    ConvLaunch l) {
  conv_tile<kMode, 64, kVec, true>(x, w, out, parts, adc_table, l);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int kMode, int TM, bool kVec, bool kPair>
int launch_mma(const float* x, const mma::WSrc& w, float* out, float* parts,
               const unsigned char* adc_table, const ConvLaunch& l,
               cudaStream_t stream) {
  constexpr int smem = mma::tile_smem<kMode, TM, mma::NhwcAct<kVec>>();
  const auto kernel = [] {
    if constexpr (kPair) {
      return trunk_conv_pair<kMode, kVec>;
    } else {
      return trunk_conv_mma<kMode, TM, kVec>;
    }
  }();
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const cudaError_t f = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (f != cudaSuccess) return static_cast<int>(f);
    attr = true;
  }
  const mma::SplitPlan& plan = l.plan;
  const long long blocks = static_cast<long long>(plan.tiles) * plan.n_splits;
  kernel<<<static_cast<unsigned>(blocks), mma::kThreads, smem, stream>>>(
      x, w, out, parts, adc_table, l);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess && plan.n_splits > 1) {
    e = mma::launch_split_reduce(parts, out, rows_of(l.geom) * l.n, plan.nkb,
                                 nullptr, nullptr, 0, mma::SketchPlan{},
                                 stream);
  }
  return static_cast<int>(e);
}

// Tile heights 16 and 64 (ideal, per_subarray; 64-row tiles in pairs
// where the column tiles come in pairs and the rows are wider than one
// narrow pass, R > 32) or 16 and 32 (bitserial).
template <int kMode, bool kVec>
int launch_tile(const float* x, const mma::WSrc& w, float* out, float* parts,
                const unsigned char* adc_table, const ConvLaunch& l,
                cudaStream_t stream) {
  if (l.plan.tile_m == 16) {
    return launch_mma<kMode, 16, kVec, false>(x, w, out, parts, adc_table, l,
                                              stream);
  }
  if constexpr (kMode == kBitserial) {
    if (l.plan.tile_m == 32) {
      return launch_mma<kMode, 32, kVec, false>(x, w, out, parts, adc_table,
                                                l, stream);
    }
  } else {
    if (l.plan.tile_m == 64 && l.plan.tiles_n % 2 == 0 && l.r > 32) {
      return launch_mma<kMode, 64, kVec, true>(x, w, out, parts, adc_table,
                                               l, stream);
    }
    if (l.plan.tile_m == 64) {
      return launch_mma<kMode, 64, kVec, false>(x, w, out, parts, adc_table,
                                                l, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int kMode>
int launch_mode(const float* x, const int8_t* w, float* out, float* parts,
                const unsigned char* adc_table, const ConvLaunch& l,
                cudaStream_t stream) {
  const mma::WSrc ws{w, l.r, l.n, l.n % 16 == 0 && aligned16(w)};
  if (l.geom.c % 4 == 0 && aligned16(x)) {
    return launch_tile<kMode, true>(x, ws, out, parts, adc_table, l, stream);
  }
  return launch_tile<kMode, false>(x, ws, out, parts, adc_table, l, stream);
}

// What the implicit im2col map and the tile can take (conv_geom.cuh).
bool geometry_ok(const ConvGeom& g, int r) {
  const long long elements = static_cast<long long>(g.n) * g.h * g.w * g.c;
  const long long m = rows_of(g);
  return g.n > 0 && g.h > 0 && g.w > 0 && g.c > 0 && g.c < (1 << 15) &&
         g.oh > 0 && g.ow > 0 && g.kh > 0 && g.kh < (1 << 7) && g.kw > 0 &&
         g.kw < (1 << 8) && g.stride > 0 && g.ph0 >= 0 && g.pw0 >= 0 &&
         elements < (1LL << 31) && m < (1LL << 31) &&
         static_cast<long long>(g.kh) * g.kw * g.c == r;
}

}  // namespace

// Launch `*l` on `stream`: x f32 NHWC, w int8 [r, n], out f32 [M, n];
// returns cudaGetLastError() (0 on success).  With more than one split,
// `parts` holds n_kblocks * M * n floats and a second kernel
// (split_reduce) follows on the stream.  Bitserial reads the ADC table
// `adc_table` (cim_block_dot.cuh; 16-byte aligned), the other modes none.
extern "C" int trunk_conv(const float* x, const int8_t* w, float* out,
                          float* parts, const unsigned char* adc_table,
                          const ConvLaunch* l, cudaStream_t stream) {
  if (!geometry_ok(l->geom, l->r) || l->n <= 0 || l->bk <= 0 ||
      l->bk % mma::kChunkK != 0 || l->bk > mma::kBlockK ||
      !mma::covers(l->plan, rows_of(l->geom), l->n, l->r, l->bk) ||
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

// sizeof(ConvLaunch), for the wrapper's check of its mirror
extern "C" int trunk_conv_launch_bytes() { return sizeof(ConvLaunch); }
