// Device code of the bitserial trunks of all three kernels: the trunk
// conv (trunk_conv.cu), the fused ReBranch matmul (rebranch_matmul.cu) and
// the CiM matmul (cim_matmul.cu).  Their ideal and per_subarray trunks are
// mma_tile.cuh's int8 tensor-core tiles.
//
// cim_tile_bitserial computes one 64x64 output tile of
//
//   A [M, K] (activations), W int8 [K, N]  ->  out f32 [M, N]
//   for each k-block [k0, k1) of k_partition(K, 128), ascending:
//     q    = A[m, k0:k1] as int8 codes
//     part = cim_block_dot<bitserial>(q, W[k0:k1, n])            (f32)
//     out  = out + part * scale  (F32Rows, NhwcRows)  or  out + part  (Int8Rows)
//
// With F32Rows (a linear layer's float input) or NhwcRows (a conv's NHWC
// input, read through the implicit im2col map of conv_geom.cuh) this is
// the UNSCALED trunk of the Pallas kernels
// repro/kernels/rebranch_matmul.py::_rebranch_kernel and
// repro/kernels/rebranch_conv.py::_trunk_conv_kernel:
//     scale = f32(max(absmax(A[m, k0:k1]), 1e-8) * f32(1/127))
//     q     = clip(rint(A[m, k] * (1/scale)), -127, 127)
// With Int8Rows (int8 activations, no scale) it is
// repro/kernels/cim_matmul.py::_cim_kernel.
//
// Bit contract (ROADMAP Queue 2): `part` is computed exactly as the plain
// version computes it (cim_block_dot.cuh), `part * scale` rounds once,
// `acc + ...` rounds once, in ascending k-block order.  nvcc would
// contract the pair into an FMA, so the arithmetic is written with
// __fmul_rn / __fadd_rn / __fdiv_rn (and the libraries are built with
// -fmad=false as well).  Columns past K read as zeros, in the absmax and
// in the dot, and a zero row adds exactly 0 through every ADC.
//
// The block owns its output tile to the end and loops over the k-blocks
// itself (Hopper blocks carry nothing across the grid); for each k-block
// it reduces the per-row absmax of the WHOLE k-block first, then works in
// 128-wide chunks, one subarray each.  Every row depends on its own input
// row only, in an order that does not depend on M.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "cim_block_dot.cuh"
#include "conv_geom.cuh"

namespace repro_torch {

constexpr int kTileM = 64;           // output rows per block
constexpr int kTileN = 64;           // output columns per block
constexpr int kChunkK = 128;         // k chunk: one 128-row subarray
constexpr int kBlockKMax = 512;      // widest k-block (tiling.BLOCK_K)
constexpr int kBitW = kChunkK / 32;  // bit-plane words per chunk row
constexpr int kTileThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTM = kTileM / 16;
constexpr int kTN = kTileN / 16;
constexpr float kInv127 = 0x1.020408p-7f;  // np.float32(1 / 127)

static_assert(kTileN * kBitW == kTileThreads,
              "one thread per (column, plane word) of a W chunk");

// The per-row scale and reciprocal of one k-block from its absmax: one
// warp per row, `value(i, kk)` the row's value at k-block column kk (0 past
// the block and past M).
template <class Value>
__device__ __forceinline__ void row_scales(int width, float* scale_s,
                                           float* inv_s, const Value& value) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < kTileM; i += kTileThreads / 32) {
    float amax = 0.0f;
    for (int kk = lane; kk < width; kk += 32) {
      amax = fmaxf(amax, fabsf(value(i, kk)));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    }
    if (lane == 0) {
      const float s = __fmul_rn(fmaxf(amax, 1e-8f), kInv127);
      scale_s[i] = s;
      inv_s[i] = __fdiv_rn(1.0f, s);
    }
  }
}

__device__ __forceinline__ int quantise(float x, float inv) {
  return static_cast<int>(
      fminf(fmaxf(rintf(__fmul_rn(x, inv)), -127.0f), 127.0f));
}

// Float activations [M, K], quantised per (row, k-block) in the reciprocal
// form.
struct F32Rows {
  static constexpr bool kTables = false;
  const float* a;
  long long m;
  int k;

  __device__ __forceinline__ float value(long long row, int kk) const {
    return row < m ? __ldg(a + row * k + kk) : 0.0f;
  }

  __device__ __forceinline__ void block_scales(long long m0, int k0, int k1,
                                               float* scale_s,
                                               float* inv_s) const {
    row_scales(k1 - k0, scale_s, inv_s,
               [&](int i, int kk) { return value(m0 + i, k0 + kk); });
  }

  // the int8 code of A[m0 + i, kk]; 0 at or past k1 and past M
  __device__ __forceinline__ int code(long long m0, int i, int, int kk,
                                      int k1, float inv) const {
    return quantise(kk < k1 ? value(m0 + i, kk) : 0.0f, inv);
  }

  __device__ __forceinline__ float finish(float acc, float part,
                                          float scale) const {
    return __fadd_rn(acc, __fmul_rn(part, scale));
  }
};

// The tables of NhwcRows, one per block: the tile's row windows and the
// k-block's packed column taps (conv_geom.cuh).
__device__ __forceinline__ int4* nhwc_rows_s() {
  __shared__ int4 rows_s[kTileM];
  return rows_s;
}
__device__ __forceinline__ int* nhwc_cols_s() {
  __shared__ int cols_s[kBlockKMax];
  return cols_s;
}

// Float activations of a conv, f32 NHWC x, read through the implicit
// im2col map (conv_geom.cuh) and quantised as F32Rows.  prepare() tabulates
// the tile's row windows and the k-block's column taps in shared memory,
// so that no division runs per element.
struct NhwcRows {
  static constexpr bool kTables = true;
  const float* x;
  ConvGeom g;
  long long m;
  int k;   // kh * kw * c

  // the tables of rows [m0, m0 + kTileM) and k-block [k0, k1); the caller
  // publishes them with a barrier
  __device__ __forceinline__ void prepare(long long m0, int k0,
                                          int k1) const {
    const int t = threadIdx.x;
    if (t < kTileM) nhwc_rows_s()[t] = row_pixel(g, m, m0 + t);
    for (int kk = k0 + t; kk < k1; kk += kTileThreads) {
      nhwc_cols_s()[kk - k0] = col_tap(g, kk);
    }
  }

  // tile row i at k-block column kk
  __device__ __forceinline__ float value(int i, int kk) const {
    return __ldg(tap_ptr<float>(
        x, tap_offset(g, nhwc_rows_s()[i], nhwc_cols_s()[kk])));
  }

  __device__ __forceinline__ void block_scales(long long, int k0, int k1,
                                               float* scale_s,
                                               float* inv_s) const {
    row_scales(k1 - k0, scale_s, inv_s,
               [&](int i, int kk) { return value(i, kk); });
  }

  __device__ __forceinline__ int code(long long, int i, int k0, int kk,
                                      int k1, float inv) const {
    return quantise(kk < k1 ? value(i, kk - k0) : 0.0f, inv);
  }

  __device__ __forceinline__ float finish(float acc, float part,
                                          float scale) const {
    return __fadd_rn(acc, __fmul_rn(part, scale));
  }
};

// Int8 activations, taken as they are (-128 included); no scale.
struct Int8Rows {
  static constexpr bool kTables = false;
  const int8_t* a;
  long long m;
  int k;

  __device__ __forceinline__ void block_scales(long long, int, int, float*,
                                               float*) const {}

  __device__ __forceinline__ int code(long long m0, int i, int, int kk,
                                      int k1, float) const {
    const long long row = m0 + i;
    return (row < m && kk < k1) ? static_cast<int>(__ldg(a + row * k + kk))
                                : 0;
  }

  __device__ __forceinline__ float finish(float acc, float part,
                                          float) const {
    return __fadd_rn(acc, part);
  }
};

__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           const float (&acc)[kTM][kTN],
                                           long long m, int n, long long m0,
                                           int n0) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n) out[row * n + col] = acc[i][j];
    }
  }
}

// bitserial: for each sign pair, each 128-row chunk of the k-block is
// staged again as bit planes (cim_block_dot.cuh says why the pairs are
// outermost).  Codes are recomputed per pair from A; the kernel is bound
// by its popcounts and ADC evaluations, not by these reads.
template <class Src>
__device__ __forceinline__ void cim_tile_bitserial(
    const Src& src, const int8_t* __restrict__ w, float* __restrict__ out,
    int n, int bk, long long m0, int n0, const AdcParams& adc) {
  __shared__ unsigned ap[kActBits * kBitW * kTileM];  // [bit][word][row]
  __shared__ unsigned wp[kPlanes * kBitW * kTileN];   // [plane][word][col]
  __shared__ float lsb_s[kPlanes * kTileN];           // [plane][col]
  __shared__ float scale_s[kTileM];
  __shared__ float inv_s[kTileM];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < src.k; k0 += bk) {
    const int k1 = min(k0 + bk, src.k);
    if constexpr (Src::kTables) {
      src.prepare(m0, k0, k1);
      __syncthreads();
    }
    src.block_scales(m0, k0, k1, scale_s, inv_s);
    __syncthreads();

    float part[kTM][kTN] = {};
#pragma unroll 1
    for (int pair = 0; pair < 4; ++pair) {
      const int sa = pair >> 1;          // (a+, w+), (a+, w-), (a-, w+), (a-, w-)
      const int sw = pair & 1;
      const float sign = sa == sw ? 1.0f : -1.0f;
      for (int kc = k0; kc < k1; kc += kChunkK) {
        // activation planes: one warp per (row, word), one lane per k
        for (int t = warp; t < kTileM * kBitW; t += kTileThreads / 32) {
          const int i = t / kBitW;
          const int wd = t % kBitW;
          const int q =
              src.code(m0, i, k0, kc + wd * 32 + lane, k1, inv_s[i]);
          const int mag = max(sa ? -q : q, 0);
#pragma unroll
          for (int b = 0; b < kActBits; ++b) {
            const unsigned bits = __ballot_sync(0xffffffffu, (mag >> b) & 1);
            if (lane == b) ap[(b * kBitW + wd) * kTileM + i] = bits;
          }
        }
        // weight planes: one thread per (column, word), 32 k values each
        {
          const int c = tid % kTileN;
          const int wd = tid / kTileN;
          const int col = n0 + c;
          unsigned bits[kPlanes] = {};
          for (int e = 0; e < 32; ++e) {
            const int kk = kc + wd * 32 + e;
            const int v =
                (col < n && kk < k1)
                    ? static_cast<int>(
                          __ldg(w + static_cast<long long>(kk) * n + col))
                    : 0;
            const int mag = max(sw ? -v : v, 0);   // -128 -> 128: no plane
#pragma unroll
            for (int p = 0; p < kPlanes; ++p) {
              bits[p] |= static_cast<unsigned>((mag >> p) & 1) << e;
            }
          }
#pragma unroll
          for (int p = 0; p < kPlanes; ++p) {
            wp[(p * kBitW + wd) * kTileN + c] = bits[p];
          }
        }
        __syncthreads();
        // per-column ADC ranges of the chunk's planes
        for (int t = tid; t < kPlanes * kTileN; t += kTileThreads) {
          const int p = t / kTileN;
          const int c = t % kTileN;
          int ones = 0;
#pragma unroll
          for (int wd = 0; wd < kBitW; ++wd) {
            ones += __popc(wp[(p * kBitW + wd) * kTileN + c]);
          }
          lsb_s[p * kTileN + c] = bitserial_lsb(ones, adc);
        }
        __syncthreads();
        cim_block_dot_bitserial<kTM, kTN, kBitW, kTileM, kTileN>(
            ap, wp, lsb_s, ty, 16, tx, 16, sign, adc, part);
        __syncthreads();
      }
    }

#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float s = scale_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        acc[i][j] = src.finish(acc[i][j], part[i][j], s);
      }
    }
    __syncthreads();
  }
  store_tile(out, acc, src.m, n, m0, n0);
}

}  // namespace repro_torch
