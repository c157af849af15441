// Trunk conv kernel for Hopper (sm_90a), in all three CiM modes.
//
// Replaces the Pallas TPU kernel repro/kernels/rebranch_conv.py::
// _trunk_conv_kernel (launched by _trunk_patch_dot), with
// repro/kernels/cim_matmul.py::cim_block_dot inside it.  It computes the
// UNSCALED trunk of a ReBranch conv from the im2col patch matrix:
//
//   P f32 [M, R] (R = kh*kw*C_in, tap-major), W int8 [R, N]  ->  f32 [M, N]
//   for each k-block [k0, k1) of k_partition(R, 128), ascending:
//     scale = f32(max(absmax(P[m, k0:k1]), 1e-8) * f32(1/127))
//     q     = clip(rint(P[m, k] * (1/scale)), -127, 127)        (int8)
//     out  += cim_block_dot<mode>(q, W[k0:k1]) * scale
//
// The tile code and its bit contract (ROADMAP Queue 2) live in
// trunk_tile.cuh, which the fused LM kernel and the CiM matmul share; the
// macro math of each mode lives in cim_block_dot.cuh.
//
// Bounds on an H100 (per DarkNet-19 forward at 416x416, batch 8:
// 1.01e11 MACs, 1.57e9 bytes of P):
//   ideal        memory: reading P once takes ~0.5 ms at 3.35 TB/s (0.63 ms
//                with W and the output), against ~0.10 ms of int8
//                tensor-core work.  This first version is simple, not
//                fast: one thread block per 64x64 output tile loops over
//                the k-blocks itself (Hopper blocks carry nothing across
//                the grid); for each k-block it reduces the per-row absmax
//                of the WHOLE k-block in a first pass over P, then
//                quantises 128-wide chunks into shared memory and runs
//                __dp4a over them.  In practice the dp4a issue and the
//                shared-memory operand loads limit it, not memory (about
//                7.5 ms per forward, chip_smoke.py, PERF.md).  An implicit
//                GEMM straight from NHWC on int8 wgmma is the later PR that
//                makes it fast (ROADMAP Queue 2).
//   per_subarray memory as well: the same dot plus one ADC evaluation per
//                (row, column, subarray), 8.5e8 per forward, a few f32
//                operations each.
//   bitserial    operations: 112 binary counts per (row, column, subarray),
//                each through the ADC, 9.6e10 per forward.  The counts are
//                AND + __popc over bit planes (8 popcounts per count) and
//                each ADC evaluation is an IEEE division and ~6 other f32
//                operations, so it is bound by the popcount and f32 issue.
#include <cuda_runtime.h>

#include <cstdint>

#include "trunk_tile.cuh"

using namespace repro_torch;

namespace {

template <int kMode>
__global__ void __launch_bounds__(kTileThreads)
    trunk_conv_kernel(const float* __restrict__ p,
                      const int8_t* __restrict__ w, float* __restrict__ out,
                      int m, int r, int n, int bk, AdcParams adc) {
  cim_tile<kMode>(F32Rows{p, m, r}, w, out, n, bk,
                  static_cast<long long>(blockIdx.x) * kTileM,
                  blockIdx.y * kTileN, adc);
}

template <int kMode>
void launch(const float* p, const int8_t* w, float* out, int m, int r,
            int n, int bk, AdcParams adc, cudaStream_t stream) {
  const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN);
  trunk_conv_kernel<kMode><<<grid, kTileThreads, 0, stream>>>(p, w, out, m,
                                                              r, n, bk, adc);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `bk` is
// the k-block width of the partition, kernels/tiling.py::block_k(r, 128);
// `mode` a CimMode, `adc_*` the AdcParams of the CiMConfig.
extern "C" int trunk_conv(const float* p, const int8_t* w, float* out, int m,
                          int r, int n, int bk, int mode, float adc_lsb,
                          float adc_frac, float adc_levels,
                          cudaStream_t stream) {
  if (m <= 0 || r <= 0 || n <= 0 || bk <= 0 || bk % kChunkK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AdcParams adc{adc_lsb, adc_frac, adc_levels};
  switch (mode) {
    case kIdeal:
      launch<kIdeal>(p, w, out, m, r, n, bk, adc, stream);
      break;
    case kPerSubarray:
      launch<kPerSubarray>(p, w, out, m, r, n, bk, adc, stream);
      break;
    case kBitserial:
      launch<kBitserial>(p, w, out, m, r, n, bk, adc, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
