// Fused ReBranch matmul kernel for Hopper (sm_90a), in all three CiM modes.
//
// Replaces the Pallas TPU kernel repro/kernels/rebranch_matmul.py::
// _rebranch_kernel (launched by rebranch_matmul_pallas), with
// repro/kernels/cim_matmul.py::cim_block_dot inside it.  One launch
// computes, from the same x:
//
//   trunk f32 [M, N]  : the UNSCALED trunk of x f32 [M, K] and W int8
//                       [K, N], exactly what trunk_conv.cu computes on a
//                       patch matrix (the shared trunk_tile.cuh: per
//                       (row, k-block) absmax, reciprocal int8 quantisation,
//                       exact dp4a block dot, `* scale`, ascending `+`)
//   t1    f32 [M, Cd] : the compress sketch x @ C, C f32 [K, Cd]: per
//                       k-block an f32 block dot, added to the f32
//                       accumulator in ascending k-block order
//
// The epilogue out = trunk * w_scale + (t1 @ core) @ U stays outside the
// kernel, as it stays outside the Pallas kernel (rebranch_matmul.py:201).
//
// The TPU kernel computes t1 in the n == 0 blocks of its grid, because
// there the grid runs in order on one core and t1 must be computed once
// per (row, k-block), not once per output column tile.  Hopper blocks run
// in parallel and in no order, and at the LM shapes C is as large as W
// (16384 x 4096 f32 for a down projection): one column of blocks would
// read it on a few SMs.  So here the sketch has column tiles of its own in
// the same launch: grid.y holds the N / 64 trunk tiles and then the
// Cd / 64 sketch tiles, and every t1 element is still computed once, from
// the same x, by one block.
//
// Bound on an H100: memory in ideal and per_subarray modes.  A Gemma-2B
// decode step (M = 8 rows) reads 7.3 GB of W and C over its 126 launches
// (about 2.2 ms at 3.35 TB/s) against 0.5 GOP of int8 and 0.6 GFLOP of f32
// work.  In bitserial mode the trunk's 112 ADC evaluations per (row,
// column, subarray) make it bound by operations.  This first version is
// simple, not fast: at M = 8 every 64-row tile computes 56 padding rows,
// and W is read through byte loads.  Rows are independent: each output row
// depends on its own input row only, in an order that does not depend on
// M.
#include <cuda_runtime.h>

#include <cstdint>

#include "trunk_tile.cuh"

using namespace repro_torch;

namespace {

constexpr int kSketchK = 32;   // k chunk of the sketch's f32 block dot

// One (kTileM, kTileN) tile of t1 = x @ C, rows from m0, columns from c0.
__device__ __forceinline__ void sketch_tile(const float* __restrict__ x,
                                            const float* __restrict__ c,
                                            float* __restrict__ t1, int m,
                                            int k, int cdim, int bk,
                                            long long m0, int c0) {
  __shared__ float xs[kTileM][kSketchK + 1];
  __shared__ float cs[kSketchK][kTileN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < k; k0 += bk) {
    const int k1 = min(k0 + bk, k);
    float part[kTM][kTN] = {};
    for (int kc = k0; kc < k1; kc += kSketchK) {
      for (int idx = tid; idx < kTileM * kSketchK; idx += kTileThreads) {
        const int i = idx / kSketchK;
        const int kk = idx % kSketchK;
        const long long row = m0 + i;
        xs[i][kk] = (row < m && kc + kk < k1) ? __ldg(x + row * k + kc + kk)
                                              : 0.0f;
      }
      for (int idx = tid; idx < kSketchK * kTileN; idx += kTileThreads) {
        const int kk = idx / kTileN;
        const int j = idx % kTileN;
        const int col = c0 + j;
        cs[kk][j] = (col < cdim && kc + kk < k1)
                        ? __ldg(c + static_cast<long long>(kc + kk) * cdim +
                                col)
                        : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kSketchK; ++kk) {
        float a[kTM], b[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[i] = xs[ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < kTN; ++j) b[j] = cs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            part[i][j] = __fmaf_rn(a[i], b[j], part[i][j]);
          }
        }
      }
      __syncthreads();
    }
    // the k-block's dot joins the accumulator with one rounding
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < cdim) t1[row * cdim + col] = acc[i][j];
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kTileThreads)
    rebranch_matmul_kernel(const float* __restrict__ x,
                           const int8_t* __restrict__ w,
                           const float* __restrict__ c,
                           float* __restrict__ trunk, float* __restrict__ t1,
                           int m, int k, int n, int cdim, int bk, int gn,
                           AdcParams adc) {
  const long long m0 = static_cast<long long>(blockIdx.x) * kTileM;
  if (static_cast<int>(blockIdx.y) < gn) {
    cim_tile<kMode>(F32Rows{x, m, k}, w, trunk, n, bk, m0,
                    blockIdx.y * kTileN, adc);
  } else {
    sketch_tile(x, c, t1, m, k, cdim, bk, m0,
                (static_cast<int>(blockIdx.y) - gn) * kTileN);
  }
}

template <int kMode>
void launch(const float* x, const int8_t* w, const float* c, float* trunk,
            float* t1, int m, int k, int n, int cdim, int bk, AdcParams adc,
            cudaStream_t stream) {
  const int gn = (n + kTileN - 1) / kTileN;
  const int gc = (cdim + kTileN - 1) / kTileN;
  const dim3 grid((m + kTileM - 1) / kTileM, gn + gc);
  rebranch_matmul_kernel<kMode><<<grid, kTileThreads, 0, stream>>>(
      x, w, c, trunk, t1, m, k, n, cdim, bk, gn, adc);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `bk` is
// the k-block width of the partition, kernels/tiling.py::block_k(k, 128);
// `mode` a CimMode, `adc_*` the AdcParams of the CiMConfig.
extern "C" int rebranch_matmul(const float* x, const int8_t* w,
                               const float* c, float* trunk, float* t1,
                               int m, int k, int n, int cdim, int bk,
                               int mode, float adc_lsb, float adc_frac,
                               float adc_levels, cudaStream_t stream) {
  if (m <= 0 || k <= 0 || n <= 0 || cdim <= 0 || bk <= 0 ||
      bk % kChunkK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AdcParams adc{adc_lsb, adc_frac, adc_levels};
  switch (mode) {
    case kIdeal:
      launch<kIdeal>(x, w, c, trunk, t1, m, k, n, cdim, bk, adc, stream);
      break;
    case kPerSubarray:
      launch<kPerSubarray>(x, w, c, trunk, t1, m, k, n, cdim, bk, adc,
                           stream);
      break;
    case kBitserial:
      launch<kBitserial>(x, w, c, trunk, t1, m, k, n, cdim, bk, adc, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
