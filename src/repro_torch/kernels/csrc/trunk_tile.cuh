// Device code shared by the float-in trunk kernels (trunk_conv.cu,
// rebranch_matmul.cu) and the int8-in CiM matmul (cim_matmul.cu).
//
// trunk_tile_ideal computes one 64x64 tile of the UNSCALED trunk of the
// Pallas kernels repro/kernels/rebranch_conv.py::_trunk_conv_kernel and
// repro/kernels/rebranch_matmul.py::_rebranch_kernel (ideal CiM mode):
//
//   A f32 [M, R] (an im2col patch matrix, or a linear layer's input),
//   W int8 [R, N]  ->  out f32 [M, N]
//   for each k-block [k0, k1) of k_partition(R, 128), ascending:
//     scale = f32(max(absmax(A[m, k0:k1]), 1e-8) * f32(1/127))
//     q     = clip(rint(A[m, k] * (1/scale)), -127, 127)        (int8)
//     out  += f32(sum_k q * W[k, n]) * scale
//
// Bit contract (ROADMAP Queue 2): the integer dot of a k-block is exact,
// `part * scale` rounds once, `acc + ...` rounds once, in ascending k-block
// order.  nvcc would contract the pair into an FMA, so the arithmetic is
// written with __fmul_rn / __fadd_rn / __fdiv_rn (and the libraries are
// built with -fmad=false as well).  rintf rounds half to even, as
// jnp.round.  Columns past R read as zeros, in the absmax and in the dot.
//
// The block owns its 64x64 output tile to the end and loops over the
// k-blocks itself (Hopper blocks carry nothing across the grid); for each
// k-block it reduces the per-row absmax of the WHOLE k-block first, then
// quantises 128-wide chunks into shared memory and runs the dp4a macro dot
// (cim_block_dot.cuh) over them.  Every row depends on its own input row
// only, in an order that does not depend on M.
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
constexpr int kTileThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTM = kTileM / 16;
constexpr int kTN = kTileN / 16;
constexpr float kInv127 = 0x1.020408p-7f;  // np.float32(1 / 127)

// Stage the (kChunkK, kTileN) slab of W [r, n] starting at row kc into
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

// One (kTileM, kTileN) tile of the unscaled trunk, rows from m0 and
// columns from n0.  Called by all kTileThreads threads of the block.
__device__ __forceinline__ void trunk_tile_ideal(
    const float* __restrict__ p, const int8_t* __restrict__ w,
    float* __restrict__ out, int m, int r, int n, int bk, long long m0,
    int n0) {
  __shared__ int xs[kTileM * kLdsW];   // quantised activations, by row
  __shared__ int ws[kTileN * kLdsW];   // ROM weights, by column
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

  for (int k0 = 0; k0 < r; k0 += bk) {
    const int k1 = min(k0 + bk, r);

    // (1) per-row absmax over the whole k-block, one warp per row
    for (int i = warp; i < kTileM; i += kTileThreads / 32) {
      const long long row = m0 + i;
      float amax = 0.0f;
      if (row < m) {
        const float* pr = p + row * r;
        for (int k = k0 + lane; k < k1; k += 32) {
          amax = fmaxf(amax, fabsf(__ldg(pr + k)));
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
    __syncthreads();

    int dot[kTM][kTN] = {};
    for (int kc = k0; kc < k1; kc += kChunkK) {
      // (2) quantise the (kTileM, kChunkK) slab of A into packed int8
      for (int idx = tid; idx < kTileM * kChunkW; idx += kTileThreads) {
        const int i = idx / kChunkW;
        const int kw = idx % kChunkW;
        const long long row = m0 + i;
        const float inv = inv_s[i];
        unsigned packed = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = kc + kw * 4 + e;
          const float x = (row < m && k < k1) ? __ldg(p + row * r + k) : 0.0f;
          const float q =
              fminf(fmaxf(rintf(__fmul_rn(x, inv)), -127.0f), 127.0f);
          packed |= (static_cast<unsigned>(static_cast<int>(q)) & 0xffu)
                    << (8 * e);
        }
        xs[i * kLdsW + kw] = static_cast<int>(packed);
      }
      // (3) stage the (kChunkK, kTileN) slab of W, transposed to columns
      stage_w_chunk(ws, w, n, n0, kc, k1);
      __syncthreads();
      cim_block_dot_ideal<kTM, kTN, kChunkW, kLdsW>(xs, ws, ty, 16, tx, 16,
                                                    dot);
      __syncthreads();
    }

    // (4) one rounding for part * scale, one for acc + part
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float s = scale_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        acc[i][j] =
            __fadd_rn(acc[i][j], __fmul_rn(__int2float_rn(dot[i][j]), s));
      }
    }
    __syncthreads();   // scale_s / inv_s are rewritten by the next k-block
  }

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

}  // namespace repro_torch
