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
// The tile code and its bit contract (ROADMAP Queue 2) live in
// trunk_tile.cuh, which the fused LM kernel rebranch_matmul.cu shares.
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

#include "trunk_tile.cuh"

namespace {

__global__ void __launch_bounds__(repro_torch::kTileThreads)
    trunk_conv_ideal_kernel(const float* __restrict__ p,
                            const int8_t* __restrict__ w,
                            float* __restrict__ out, int m, int r, int n,
                            int bk) {
  repro_torch::trunk_tile_ideal(
      p, w, out, m, r, n, bk,
      static_cast<long long>(blockIdx.x) * repro_torch::kTileM,
      blockIdx.y * repro_torch::kTileN);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `bk` is
// the k-block width of the partition, kernels/tiling.py::block_k(r, 128).
extern "C" int trunk_conv_ideal(const float* p, const int8_t* w, float* out,
                                int m, int r, int n, int bk,
                                cudaStream_t stream) {
  using namespace repro_torch;
  if (m <= 0 || r <= 0 || n <= 0 || bk <= 0 || bk % kChunkK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN);
  trunk_conv_ideal_kernel<<<grid, kTileThreads, 0, stream>>>(p, w, out, m, r,
                                                             n, bk);
  return static_cast<int>(cudaGetLastError());
}
