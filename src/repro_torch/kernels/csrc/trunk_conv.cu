// Trunk conv kernel for Hopper (sm_90a), ideal CiM mode.
//
// Replaces the Pallas TPU kernel repro/kernels/rebranch_conv.py::
// _trunk_conv_kernel (launched by _trunk_patch_dot), with the ideal mode of
// repro/kernels/cim_matmul.py::cim_block_dot inside it.  It computes the
// UNSCALED trunk of a ReBranch conv from the im2col patch matrix:
//
//   P f32 [M, R] (R = kh*kw*C_in, tap-major), W int8 [R, N]  ->  f32 [M, N]
//   for each k-block [k0, k1) of k_partition(R, 128), ascending:
//     scale = f32(max(absmax(P[m, k0:k1]), 1e-8) * f32(1/127))
//     q     = clip(rint(P[m, k] * (1/scale)), -127, 127)        (int8)
//     out  += f32(sum_k q * W[k, n]) * scale
//
// Bit contract (ROADMAP Queue 2): the integer dot of a k-block is exact,
// `part * scale` rounds once, `acc + ...` rounds once, in ascending k-block
// order.  nvcc would contract the pair into an FMA, so the arithmetic is
// written with __fmul_rn / __fadd_rn / __fdiv_rn (and the library is built
// with -fmad=false as well).  rintf rounds half to even, as jnp.round.
// Columns past R read as zeros, in the absmax and in the dot alike.
//
// Bound on an H100: memory.  Per DarkNet-19 forward at 416x416, batch 8,
// the P matrices are ~1.4 GB of f32 against ~0.10 ms of int8 tensor-core
// work, so reading P once takes ~0.4 ms at 3.35 TB/s (0.63 ms with W and
// the output).  This first version is simple, not fast: one thread block
// per 64x64 output tile loops over the k-blocks itself (Hopper blocks
// carry nothing across the grid); for each k-block it reduces the per-row
// absmax of the WHOLE k-block in a first pass over P, then quantises
// 128-wide chunks into shared memory and runs __dp4a over them.  P is thus
// read twice per column tile; L2 absorbs part of that.  In practice the
// dp4a issue and the shared-memory operand loads limit it, not memory
// (about 7.5 ms per forward, chip_smoke.py, PERF.md).  An implicit GEMM
// straight from NHWC on int8 wgmma, which never writes P and moves the
// dot onto the tensor cores, is the later PR that makes it fast (ROADMAP
// Queue 2).
#include <cuda_runtime.h>

#include <cstdint>

#include "cim_block_dot.cuh"

namespace {

constexpr int kBM = 64;            // output rows per block
constexpr int kBN = 64;            // output columns per block
constexpr int kKC = 128;           // k chunk: one 128-row subarray
constexpr int kKW = kKC / 4;       // packed int8x4 words per chunk row
constexpr int kLDS = kKW + 1;      // padded word stride: no bank conflicts
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTM = kBM / 16;
constexpr int kTN = kBN / 16;
constexpr float kInv127 = 0x1.020408p-7f;  // np.float32(1 / 127)

__global__ void __launch_bounds__(kThreads)
    trunk_conv_ideal_kernel(const float* __restrict__ p,
                            const int8_t* __restrict__ w,
                            float* __restrict__ out, int m, int r, int n,
                            int bk) {
  __shared__ int xs[kBM * kLDS];   // quantised activations, by row
  __shared__ int ws[kBN * kLDS];   // ROM weights, by column
  __shared__ float scale_s[kBM];
  __shared__ float inv_s[kBM];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < r; k0 += bk) {
    const int k1 = min(k0 + bk, r);

    // (1) per-row absmax over the whole k-block, one warp per row
    for (int i = warp; i < kBM; i += kThreads / 32) {
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
    for (int kc = k0; kc < k1; kc += kKC) {
      // (2) quantise the (kBM, kKC) slab of P into packed int8
      for (int idx = tid; idx < kBM * kKW; idx += kThreads) {
        const int i = idx / kKW;
        const int kw = idx % kKW;
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
        xs[i * kLDS + kw] = static_cast<int>(packed);
      }
      // (3) stage the (kKC, kBN) slab of W, transposed to columns
      for (int idx = tid; idx < kBN * kKW; idx += kThreads) {
        const int j = idx % kBN;
        const int kw = idx / kBN;
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
        ws[j * kLDS + kw] = static_cast<int>(packed);
      }
      __syncthreads();
      repro_torch::cim_block_dot_ideal<kTM, kTN, kKW, kLDS>(xs, ws, ty, 16,
                                                            tx, 16, dot);
      __syncthreads();
    }

    // (4) one rounding for part * scale, one for acc + part
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float s = scale_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(__int2float_rn(dot[i][j]), s));
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

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `bk` is
// the k-block width of the partition, kernels/tiling.py::block_k(r, 128).
extern "C" int trunk_conv_ideal(const float* p, const int8_t* w, float* out,
                                int m, int r, int n, int bk,
                                cudaStream_t stream) {
  if (m <= 0 || r <= 0 || n <= 0 || bk <= 0 || bk % kKC != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  trunk_conv_ideal_kernel<<<grid, kThreads, 0, stream>>>(p, w, out, m, r, n,
                                                         bk);
  return static_cast<int>(cudaGetLastError());
}
