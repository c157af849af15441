// Device code of the trunk-conv kernel (trunk_conv.cu) in all three CiM
// modes, and of the bitserial trunks of the fused ReBranch matmul
// (rebranch_matmul.cu) and the CiM matmul (cim_matmul.cu); their ideal and
// per_subarray trunks are mma_tile.cuh's.
//
// cim_tile<Mode> computes one 64x64 output tile of
//
//   A [M, K] (activations), W int8 [K, N]  ->  out f32 [M, N]
//   for each k-block [k0, k1) of k_partition(K, 128), ascending:
//     q    = A[m, k0:k1] as int8 codes
//     part = cim_block_dot<Mode>(q, W[k0:k1, n])                (f32)
//     out  = out + part * scale     (F32Rows)  or  out + part   (Int8Rows)
//
// With F32Rows (a float im2col patch matrix, or a linear layer's input)
// this is the UNSCALED trunk of the Pallas kernels
// repro/kernels/rebranch_conv.py::_trunk_conv_kernel and
// repro/kernels/rebranch_matmul.py::_rebranch_kernel:
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

namespace repro_torch {

constexpr int kTileM = 64;           // output rows per block
constexpr int kTileN = 64;           // output columns per block
constexpr int kChunkK = 128;         // k chunk: one 128-row subarray
constexpr int kChunkW = kChunkK / 4; // packed int8x4 words per chunk row
constexpr int kLdsW = kChunkW + 1;   // padded word stride: no bank conflicts
constexpr int kBitW = kChunkK / 32;  // bit-plane words per chunk row
constexpr int kTileThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTM = kTileM / 16;
constexpr int kTN = kTileN / 16;
constexpr float kInv127 = 0x1.020408p-7f;  // np.float32(1 / 127)

static_assert(kTileN * kBitW == kTileThreads,
              "one thread per (column, plane word) of a W chunk");

// Float activations, quantised per (row, k-block) in the reciprocal form.
struct F32Rows {
  const float* a;
  long long m;
  int k;

  // per-row scale and reciprocal of the k-block [k0, k1), one warp per row
  __device__ __forceinline__ void block_scales(long long m0, int k0, int k1,
                                               float* scale_s,
                                               float* inv_s) const {
    const int lane = threadIdx.x & 31;
    for (int i = threadIdx.x >> 5; i < kTileM; i += kTileThreads / 32) {
      const long long row = m0 + i;
      float amax = 0.0f;
      if (row < m) {
        const float* ar = a + row * k;
        for (int kk = k0 + lane; kk < k1; kk += 32) {
          amax = fmaxf(amax, fabsf(__ldg(ar + kk)));
        }
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

  // the int8 code of A[row, kk]; 0 at or past k1 and past M
  __device__ __forceinline__ int code(long long row, int kk, int k1,
                                      float inv) const {
    const float x = (row < m && kk < k1) ? __ldg(a + row * k + kk) : 0.0f;
    return static_cast<int>(
        fminf(fmaxf(rintf(__fmul_rn(x, inv)), -127.0f), 127.0f));
  }

  __device__ __forceinline__ float finish(float acc, float part,
                                          float scale) const {
    return __fadd_rn(acc, __fmul_rn(part, scale));
  }
};

// Int8 activations, taken as they are (-128 included); no scale.
struct Int8Rows {
  const int8_t* a;
  long long m;
  int k;

  __device__ __forceinline__ void block_scales(long long, int, int, float*,
                                               float*) const {}

  __device__ __forceinline__ int code(long long row, int kk, int k1,
                                      float) const {
    return (row < m && kk < k1) ? static_cast<int>(__ldg(a + row * k + kk))
                                : 0;
  }

  __device__ __forceinline__ float finish(float acc, float part,
                                          float) const {
    return __fadd_rn(acc, part);
  }
};

// Stage the (kChunkK, kTileN) slab of W [k, n] starting at row kc into
// `ws`, transposed to columns and packed four k values to a word.  Rows at
// or past k1 and columns past n read as zeros.
__device__ __forceinline__ void stage_w_chunk(int* __restrict__ ws,
                                              const int8_t* __restrict__ w,
                                              int n, int n0, int kc, int k1) {
  for (int idx = threadIdx.x; idx < kTileN * kChunkW; idx += kTileThreads) {
    const int j = idx % kTileN;
    const int kw = idx / kTileN;
    const int col = n0 + j;
    unsigned packed = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = kc + kw * 4 + e;
      const int v = (col < n && k < k1)
                        ? static_cast<int>(
                              __ldg(w + static_cast<long long>(k) * n + col))
                        : 0;
      packed |= (static_cast<unsigned>(v) & 0xffu) << (8 * e);
    }
    ws[j * kLdsW + kw] = static_cast<int>(packed);
  }
}

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

// ideal and per_subarray: int8 chunks in shared memory, the dp4a dot.
template <int kMode, class Src>
__device__ __forceinline__ void cim_tile_dp4a(const Src& src,
                                              const int8_t* __restrict__ w,
                                              float* __restrict__ out, int n,
                                              int bk, long long m0, int n0,
                                              const AdcParams& adc) {
  __shared__ int xs[kTileM * kLdsW];   // activation codes, by row
  __shared__ int ws[kTileN * kLdsW];   // ROM weights, by column
  __shared__ float scale_s[kTileM];
  __shared__ float inv_s[kTileM];

  const int tid = threadIdx.x;
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
    // (1) per-row scales over the whole k-block
    src.block_scales(m0, k0, k1, scale_s, inv_s);
    __syncthreads();

    int dot[kTM][kTN] = {};
    float part[kTM][kTN] = {};
    for (int kc = k0; kc < k1; kc += kChunkK) {
      // (2) the (kTileM, kChunkK) slab of codes, packed four to a word
      for (int idx = tid; idx < kTileM * kChunkW; idx += kTileThreads) {
        const int i = idx / kChunkW;
        const int kw = idx % kChunkW;
        const float inv = inv_s[i];
        unsigned packed = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = src.code(m0 + i, kc + kw * 4 + e, k1, inv);
          packed |= (static_cast<unsigned>(q) & 0xffu) << (8 * e);
        }
        xs[i * kLdsW + kw] = static_cast<int>(packed);
      }
      // (3) the (kChunkK, kTileN) slab of W, transposed to columns
      stage_w_chunk(ws, w, n, n0, kc, k1);
      __syncthreads();
      if constexpr (kMode == kPerSubarray) {
        cim_block_dot_per_subarray<kTM, kTN, kChunkW, kLdsW>(
            xs, ws, ty, 16, tx, 16, adc, part);
      } else {
        cim_block_dot_ideal<kTM, kTN, kChunkW, kLdsW>(xs, ws, ty, 16, tx, 16,
                                                      dot);
      }
      __syncthreads();
    }

    // (4) one rounding for part * scale, one for acc + part
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float s = scale_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        if constexpr (kMode == kIdeal) part[i][j] = __int2float_rn(dot[i][j]);
        acc[i][j] = src.finish(acc[i][j], part[i][j], s);
      }
    }
    __syncthreads();   // scale_s / inv_s are rewritten by the next k-block
  }
  store_tile(out, acc, src.m, n, m0, n0);
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
          const int q = src.code(m0 + i, kc + wd * 32 + lane, k1, inv_s[i]);
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

// One (kTileM, kTileN) output tile, rows from m0 and columns from n0, in
// CiM mode kMode.  Called by all kTileThreads threads of the block.
template <int kMode, class Src>
__device__ __forceinline__ void cim_tile(const Src& src,
                                         const int8_t* __restrict__ w,
                                         float* __restrict__ out, int n,
                                         int bk, long long m0, int n0,
                                         const AdcParams& adc) {
  if constexpr (kMode == kBitserial) {
    cim_tile_bitserial(src, w, out, n, bk, m0, n0, adc);
  } else {
    cim_tile_dp4a<kMode>(src, w, out, n, bk, m0, n0, adc);
  }
}

}  // namespace repro_torch
