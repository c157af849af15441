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
//                for j,  and the f32 part follows it term for term
//                (bitserial_tile.cuh).  The counts are exact integers from
//                the binary tensor cores (ptx.cuh's mma_b1); the ADC is a
//                table, below.
//
// Every f32 step is one IEEE rounding, written out: __fdiv_rn (the plain
// version divides by a device tensor, which CUDA does not turn into a
// reciprocal multiply), __fadd_rn, __fmul_rn, rintf (half to even, as
// torch.round); the libraries build with -fmad=false as well.
#pragma once

#include <cstdint>

namespace repro_torch {

enum CimMode : int { kIdeal = 0, kPerSubarray = 1, kBitserial = 2 };

// The ADC constants of a CiMConfig, in f32, from the wrapper.
struct AdcParams {
  float lsb;      // per_subarray: f32(rows * 127 * psum_range_frac / (levels / 2))
  float levels;   // 2**adc_bits - 1
};

constexpr float kThresholdBias = 1e-3f;   // core/adc.py::THRESHOLD_BIAS
constexpr int kPlanes = 7;                // weight magnitude bit planes
constexpr int kActBits = 8;               // activation magnitude bits (<= 128)
constexpr int kGroups = 4;                // two-bit activation groups

// signed_adc of one subarray's partial sum (exact in f32).
__device__ __forceinline__ float adc_signed(float psum, const AdcParams& adc) {
  const float half = __fmul_rn(adc.levels, 0.5f);
  const float code = fminf(
      fmaxf(rintf(__fadd_rn(__fdiv_rn(psum, adc.lsb), kThresholdBias)),
            -half),
      half);
  return __fmul_rn(code, adc.lsb);
}

// The bitserial ADC as a table.  A count of a 128-row subarray is an
// integer in [0, 3 p], p the ones of its weight plane in the column
// (p in [0, 128]), and the column's lsb depends on p alone, so the code
// adc_transfer gives is a function of (p, count).  The wrapper
// (kernels/cim_matmul.py::adc_table) evaluates it once per CiMConfig with
// the plain version's own f32 formula, for every (p, count), and hands
// the kernels the pairs a count can reach (count <= 3 p):
//   lsb  f32 [129]              f32((max(3 p, 1) * frac) / levels)
//   code u8  [sum (3 p + 1)]    row p at adc_row(p): clamp(rint(count /
//                               lsb + 1e-3), 0, levels) for count 0 .. 3 p
// (kAdcTableBytes, 16-byte padded), which a block copies into shared
// memory.  sensed = code * lsb is then one rounding, as in the plain
// version, with no division on the card.
constexpr int kAdcPops = 129;                     // p = 0 .. 128
constexpr int kAdcLsbBytes = 4 * kAdcPops;
constexpr int kAdcCodes = 3 * 128 * 129 / 2 + kAdcPops;
constexpr int kAdcTableBytes = (kAdcLsbBytes + kAdcCodes + 15) / 16 * 16;

// where row p of the codes starts in the table: after the lsbs and the
// rows 0 .. p - 1 (3 q + 1 codes each)
__host__ __device__ constexpr int adc_row(int p) {
  return kAdcLsbBytes + p + 3 * p * (p - 1) / 2;
}

// sensed * coef of the code at `index`, given lsbc = lsb * coef and big =
// -2**23 * lsbc (both exact: coef is a power of two, and nothing over- or
// underflows): the code's byte in the low bits of 2**23's gives the f32
// 2**23 + code, and one fused multiply-add (2**23 + code) * lsbc + big
// rounds the exact code * lsbc once, to RN(code * lsb) * coef: the plain
// version's sensed value times coef, with no conversion instruction.
__device__ __forceinline__ float adc_sensed(const uint8_t* table, int index,
                                            float lsbc, float big) {
  return __fmaf_rn(__uint_as_float(0x4B000000u | table[index]), lsbc, big);
}

}  // namespace repro_torch
