// Device routines of the macro math: the CUDA counterpart of
// repro/kernels/cim_matmul.py::cim_block_dot in all three fidelity modes.
// The plain PyTorch version of the same modes is
// repro_torch/kernels/cim_matmul.py::cim_block_dot; the kernels call these
// routines one 128-row subarray (a "chunk") at a time.
//
// ideal        : the exact int8 x int8 dot that the Pallas kernels run on
//                the MXU; mma_tile.cuh computes it on the int8 tensor cores
//                (mma.m16n8k32, int32 accumulators).  The dot over a chunk
//                is exact (|sum| <= 128 * 127 * 127 < 2**31), and so is its
//                conversion to f32 (< 2**24), also after a whole 512-wide
//                k-block.
// per_subarray : the same exact chunk dot, then core/adc.py::signed_adc:
//                code = clamp(rint(psum / lsb + 1e-3), -levels/2,
//                levels/2), sensed = code * lsb, added to the k-block's
//                part in ascending subarray order.  The lsb is a Python
//                double rounded once to f32 by the wrapper.
// bitserial    : sign-split activations (a+ = max(a, 0), a- = max(-a, 0),
//                in int32, so -128 gives 128) and weights, 4 two-bit
//                activation groups x 7 weight bit planes per subarray;
//                each binary count goes through core/adc.py::adc_transfer
//                with a per-column range max(popcount * 3, 1), and
//                +-4^g * 2^j * sensed joins the part.  The loop nest of
//                the plain version is  for (sa, sw): for subarray: for g:
//                for j,  so a caller walks the four sign pairs OUTSIDE its
//                chunk loop (restaging each chunk per pair): a chunk-outer
//                walk would add the same terms in another order.  The
//                counts come from bit planes: one 32-bit word holds one
//                bit of 32 consecutive k values, so a 128-row count is
//                4 words x (AND + __popc) for each of the group's two
//                activation bits, 8 popcounts in all.  __popc was chosen
//                over packed 2-bit __dp4a (32 per count) because it needs
//                a quarter of the instructions for the same count.
//
// Every f32 step is one IEEE rounding, written out: __fdiv_rn (the plain
// version divides by a device tensor, which CUDA does not turn into a
// reciprocal multiply), __fadd_rn, __fmul_rn, rintf (half to even, as
// torch.round); the libraries build with -fmad=false as well.
#pragma once

namespace repro_torch {

enum CimMode : int { kIdeal = 0, kPerSubarray = 1, kBitserial = 2 };

// The ADC constants of a CiMConfig, in f32, from the wrapper.
struct AdcParams {
  float lsb;      // per_subarray: f32(rows * 127 * psum_range_frac / (levels / 2))
  float frac;     // bitserial: f32(adc_range_frac)
  float levels;   // 2**adc_bits - 1
};

constexpr float kThresholdBias = 1e-3f;   // core/adc.py::THRESHOLD_BIAS
constexpr int kPlanes = 7;                // weight magnitude bit planes
constexpr int kActBits = 8;               // activation magnitude bits (<= 128)
constexpr int kGroups = 4;                // two-bit activation groups
constexpr int kGroupMax = 3;

// signed_adc of one subarray's partial sum (exact in f32).
__device__ __forceinline__ float adc_signed(float psum, const AdcParams& adc) {
  const float half = __fmul_rn(adc.levels, 0.5f);
  const float code = fminf(
      fmaxf(rintf(__fadd_rn(__fdiv_rn(psum, adc.lsb), kThresholdBias)),
            -half),
      half);
  return __fmul_rn(code, adc.lsb);
}

// adc_transfer of one non-negative count with its column's lsb.
__device__ __forceinline__ float adc_count(float count, float lsb,
                                           const AdcParams& adc) {
  const float code = fminf(
      fmaxf(rintf(__fadd_rn(__fdiv_rn(count, lsb), kThresholdBias)), 0.0f),
      adc.levels);
  return __fmul_rn(code, lsb);
}

// The bitserial lsb of a column whose plane holds `popcount` ones in the
// subarray: (max(popcount * 3, 1) * frac) / levels, two roundings.
__device__ __forceinline__ float bitserial_lsb(int popcount,
                                               const AdcParams& adc) {
  const float range = fmaxf(__int2float_rn(popcount * kGroupMax), 1.0f);
  return __fdiv_rn(__fmul_rn(range, adc.frac), adc.levels);
}

// bitserial, one 128-row chunk of one sign pair (sign = +1 for (a+, w+)
// and (a-, w-), -1 otherwise), from bit planes in shared memory:
//   ap[b][w][row]  bit b (0..7) of the activation part, k = 32w .. 32w+31
//   wp[j][w][col]  bit j (0..6) of the weight part, the same k
//   lsb_s[j][col]  the ADC lsb of plane j of the column
// part[i][j] += sign * 4^g * 2^p * adc(count), in the order g, then p.
template <int TM, int TN, int W, int LDA, int LDW>
__device__ __forceinline__ void cim_block_dot_bitserial(
    const unsigned* __restrict__ ap, const unsigned* __restrict__ wp,
    const float* __restrict__ lsb_s, int row0, int row_step, int col0,
    int col_step, float sign, const AdcParams& adc, float (&part)[TM][TN]) {
#pragma unroll 1
  for (int g = 0; g < kGroups; ++g) {
    unsigned lo[TM][W], hi[TM][W];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        lo[i][w] = ap[((2 * g) * W + w) * LDA + row0 + i * row_step];
        hi[i][w] = ap[((2 * g + 1) * W + w) * LDA + row0 + i * row_step];
      }
    }
#pragma unroll 1
    for (int p = 0; p < kPlanes; ++p) {
      // +-2^(2g + p), exact; so is its product with a sensed value
      const float coef = sign * __int2float_rn(1 << (2 * g + p));
      unsigned b[TN][W];
      float lsb[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        lsb[j] = lsb_s[p * LDW + col0 + j * col_step];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          b[j][w] = wp[(p * W + w) * LDW + col0 + j * col_step];
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          int count = 0;
#pragma unroll
          for (int w = 0; w < W; ++w) {
            count += __popc(lo[i][w] & b[j][w]) +
                     2 * __popc(hi[i][w] & b[j][w]);
          }
          const float sensed = adc_count(__int2float_rn(count), lsb[j], adc);
          part[i][j] = __fadd_rn(part[i][j], __fmul_rn(coef, sensed));
        }
      }
    }
  }
}

}  // namespace repro_torch
