// CiM matmul kernel for Hopper (sm_90a), ideal CiM mode.
//
// Replaces the Pallas TPU kernel repro/kernels/cim_matmul.py::_cim_kernel
// (launched by cim_matmul_pallas), with the ideal mode of
// repro/kernels/cim_matmul.py::cim_block_dot inside it:
//
//   X int8 [M, K], W int8 [K, N]  ->  f32 [M, N]
//   for each k-block [k0, k1) of k_partition(K, 128), ascending:
//     out += f32(sum_k X[m, k] * W[k, n])
//
// The block dot is exact in int32 and converts to f32 exactly (a 512-row
// block sums below 512 * 127 * 127 < 2**24); the blocks are added in f32,
// one rounding each, in ascending order (__fadd_rn; the library is built
// with -fmad=false).  It is NOT one int32 sum over all K: at K = 16384 a
// row sum reaches 2.6e8 > 2**24, and a blocked f32 accumulation rounds
// differently, so this matches cim_matmul_pallas / _cim_direct, not
// core/cim.py::cim_matmul_model.  Columns past K read as zeros.
//
// Bound on an H100: at the LM decode shapes (M = 8 rows, K x N of
// 2048 x 2048 up to 2048 x 16384) memory, reading W once (4 MB to 33 MB
// per launch).  This first version is simple, not fast: the tile, W
// staging and dp4a dot are those of the trunk kernels (trunk_tile.cuh,
// cim_block_dot.cuh), one 64x64 output tile per block with the k-block
// loop inside the block; at M = 8 it computes 56 padding rows of every
// 64-row tile.  Rows are independent: each output row depends on its own
// input row only, in an order that does not depend on M.
#include <cuda_runtime.h>

#include <cstdint>

#include "trunk_tile.cuh"

using namespace repro_torch;

namespace {

__global__ void __launch_bounds__(kTileThreads)
    cim_matmul_ideal_kernel(const int8_t* __restrict__ x,
                            const int8_t* __restrict__ w,
                            float* __restrict__ out, int m, int k, int n,
                            int bk) {
  __shared__ int xs[kTileM * kLdsW];   // activations, by row
  __shared__ int ws[kTileN * kLdsW];   // ROM weights, by column

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * kTileM;
  const int n0 = blockIdx.y * kTileN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < k; k0 += bk) {
    const int k1 = min(k0 + bk, k);
    int dot[kTM][kTN] = {};
    for (int kc = k0; kc < k1; kc += kChunkK) {
      for (int idx = tid; idx < kTileM * kChunkW; idx += kTileThreads) {
        const int i = idx / kChunkW;
        const int kw = idx % kChunkW;
        const long long row = m0 + i;
        unsigned packed = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = kc + kw * 4 + e;
          const int v = (row < m && kk < k1)
                            ? static_cast<int>(__ldg(x + row * k + kk))
                            : 0;
          packed |= (static_cast<unsigned>(v) & 0xffu) << (8 * e);
        }
        xs[i * kLdsW + kw] = static_cast<int>(packed);
      }
      stage_w_chunk(ws, w, n, n0, kc, k1);
      __syncthreads();
      cim_block_dot_ideal<kTM, kTN, kChunkW, kLdsW>(xs, ws, ty, 16, tx, 16,
                                                    dot);
      __syncthreads();
    }
    // the exact block dot, to f32 exactly, added with one rounding
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        acc[i][j] = __fadd_rn(acc[i][j], __int2float_rn(dot[i][j]));
      }
    }
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

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `bk` is
// the k-block width of the partition, kernels/tiling.py::block_k(k, 128).
extern "C" int cim_matmul_ideal(const int8_t* x, const int8_t* w, float* out,
                                int m, int k, int n, int bk,
                                cudaStream_t stream) {
  if (m <= 0 || k <= 0 || n <= 0 || bk <= 0 || bk % kChunkK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN);
  cim_matmul_ideal_kernel<<<grid, kTileThreads, 0, stream>>>(x, w, out, m, k,
                                                             n, bk);
  return static_cast<int>(cudaGetLastError());
}
