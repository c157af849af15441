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
// (a 512-row block sums below 512 * 127 * 127 < 2**24); in per_subarray
// mode it is the block's chain of subarray ADC outputs.  The blocks are
// added in f32, one rounding each, in ascending order (__fadd_rn; the
// library is built with -fmad=false).  It is NOT one int32 sum over all K:
// at K = 16384 a row sum reaches 2.6e8 > 2**24, and a blocked f32
// accumulation rounds differently, so this matches cim_matmul_pallas /
// _cim_direct, not core/cim.py::cim_matmul_model.  Columns past K read as
// zeros.  The tile is trunk_tile.cuh's, with int8 activations.
//
// Bound on an H100: at the LM decode shapes (M = 8 rows, K x N of
// 2048 x 2048 up to 2048 x 16384) memory in ideal and per_subarray
// modes, reading W once (4 MB to 33 MB per launch); in bitserial mode the
// 112 ADC evaluations per (row, column, subarray), i.e. operations.  This
// first version is simple, not fast: one 64x64 output tile per block with
// the k-block loop inside the block; at M = 8 it computes 56 padding rows
// of every 64-row tile.  Rows are independent: each output row depends on
// its own input row only, in an order that does not depend on M.
#include <cuda_runtime.h>

#include <cstdint>

#include "trunk_tile.cuh"

using namespace repro_torch;

namespace {

template <int kMode>
__global__ void __launch_bounds__(kTileThreads)
    cim_matmul_kernel(const int8_t* __restrict__ x,
                      const int8_t* __restrict__ w, float* __restrict__ out,
                      int m, int k, int n, int bk, AdcParams adc) {
  cim_tile<kMode>(Int8Rows{x, m, k}, w, out, n, bk,
                  static_cast<long long>(blockIdx.x) * kTileM,
                  blockIdx.y * kTileN, adc);
}

template <int kMode>
void launch(const int8_t* x, const int8_t* w, float* out, int m, int k,
            int n, int bk, AdcParams adc, cudaStream_t stream) {
  const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN);
  cim_matmul_kernel<kMode><<<grid, kTileThreads, 0, stream>>>(x, w, out, m,
                                                              k, n, bk, adc);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `bk` is
// the k-block width of the partition, kernels/tiling.py::block_k(k, 128);
// `mode` a CimMode, `adc_*` the AdcParams of the CiMConfig.
extern "C" int cim_matmul(const int8_t* x, const int8_t* w, float* out,
                          int m, int k, int n, int bk, int mode,
                          float adc_lsb, float adc_frac, float adc_levels,
                          cudaStream_t stream) {
  if (m <= 0 || k <= 0 || n <= 0 || bk <= 0 || bk % kChunkK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AdcParams adc{adc_lsb, adc_frac, adc_levels};
  switch (mode) {
    case kIdeal:
      launch<kIdeal>(x, w, out, m, k, n, bk, adc, stream);
      break;
    case kPerSubarray:
      launch<kPerSubarray>(x, w, out, m, k, n, bk, adc, stream);
      break;
    case kBitserial:
      launch<kBitserial>(x, w, out, m, k, n, bk, adc, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
