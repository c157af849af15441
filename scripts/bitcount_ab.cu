// Microbenchmark of the bitserial CiM macro's binary counts on Hopper:
// one 128-row count (popc(lo & w) + 2 popc(hi & w)) from the binary tensor
// cores (mma.m16n8k128 .b1 .and.popc) against AND + __popc on the CUDA
// cores, each alone and followed by an ADC evaluation (the uint8 code
// table in shared memory, or the IEEE division of the earlier tile).
// Driven by scripts/bitcount_ab.py; nothing of the package uses it.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTable = 129 * 385;   // code[popcount][count]
constexpr int kUnits = 4;           // n8 tiles (or 4-column groups) per warp

__device__ __forceinline__ void mma_b1(int (&d)[4], unsigned a0, unsigned a1,
                                       unsigned b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// D[16][8] = popc(A[r] & B[c]) over 128 bits, A [16][4] and B [8][4]
// words, through the assumed fragment layout: lane 4 g + t holds word t of
// rows g (a0) and g + 8 (a1) and of column g (b0).
__global__ void layout_check(const unsigned* a, const unsigned* b, int* d) {
  const int lane = threadIdx.x;
  const int g = lane >> 2;
  const int t = lane & 3;
  int acc[4] = {0, 0, 0, 0};
  mma_b1(acc, a[g * 4 + t], a[(g + 8) * 4 + t], b[g * 4 + t]);
  d[g * 8 + 2 * t] = acc[0];
  d[g * 8 + 2 * t + 1] = acc[1];
  d[(g + 8) * 8 + 2 * t] = acc[2];
  d[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

// kAdc: 0 counts only, 1 the code table, 2 the IEEE division.
template <int kAdc>
__device__ __forceinline__ void adc(float& part, int idx, int count,
                                    const uint8_t* table, float lsb) {
  if constexpr (kAdc == 0) {
    part = __int_as_float(__float_as_int(part) ^ idx);
  } else if constexpr (kAdc == 1) {
    const float code =
        __fadd_rn(__uint_as_float(0x4B000000u | table[idx]), -8388608.0f);
    part = __fadd_rn(part, __fmul_rn(code, lsb));
  } else {
    const float code = fminf(
        fmaxf(rintf(__fadd_rn(__fdiv_rn(__int2float_rn(count), lsb), 1e-3f)),
              0.0f),
        31.0f);
    part = __fadd_rn(part, __fmul_rn(code, lsb));
  }
}

// Each warp computes, per iteration, 512 counts (16 per lane): kMma as
// 4 n8 tiles x (lo, hi) = 8 MMAs; otherwise as the earlier tile did, a
// lane's 4 rows x 4 columns, 8 AND + __popc each.
template <bool kMma, int kAdc>
__global__ void __launch_bounds__(256)
    bench(const unsigned* seed, const uint8_t* table_g, float* out,
          int iters) {
  extern __shared__ uint8_t table[];
  if constexpr (kAdc == 1) {
    for (int i = threadIdx.x; i < kTable; i += blockDim.x) {
      table[i] = table_g[i];
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int p = (lane * 37 + blockIdx.x) % 129;
  const int off = p * 385;
  const float lsb = __fdiv_rn(__int2float_rn(max(3 * p, 1)), 31.0f);
  float part[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) part[i] = 0.0f;

  if constexpr (kMma) {
    const unsigned lo0 = seed[lane], lo1 = seed[32 + lane];
    const unsigned hi0 = seed[64 + lane], hi1 = seed[96 + lane];
    unsigned b[kUnits];
#pragma unroll
    for (int u = 0; u < kUnits; ++u) b[u] = seed[128 + 32 * u + lane];
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        int dl[4] = {off, off, off, off};
        int dh[4] = {0, 0, 0, 0};
        mma_b1(dl, lo0, lo1, b[u]);
        mma_b1(dh, hi0, hi1, b[u]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int idx = dl[i] + 2 * dh[i];
          adc<kAdc>(part[4 * u + i], idx, idx - off, table, lsb);
        }
        b[u] = __funnelshift_l(b[u], b[u], 1) ^ it;
      }
    }
  } else {
    unsigned lo[4][4], hi[4][4], w[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        lo[i][k] = seed[(i * 4 + k) * 8 + lane % 8];
        hi[i][k] = seed[128 + (i * 4 + k) * 8 + lane % 8];
        w[i][k] = seed[256 + (i * 4 + k) * 8 + lane % 8];
      }
    }
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int c = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            c += __popc(lo[i][k] & w[j][k]) + 2 * __popc(hi[i][k] & w[j][k]);
          }
          adc<kAdc>(part[4 * i + j], off + c, c, table, lsb);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          w[j][k] = __funnelshift_l(w[j][k], w[j][k], 1) ^ it;
        }
      }
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s = __fadd_rn(s, part[i]);
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <bool kMma, int kAdc>
int launch(const unsigned* seed, const uint8_t* table, float* out, int blocks,
           int iters) {
  const int smem = kAdc == 1 ? kTable : 0;
  cudaFuncSetAttribute(bench<kMma, kAdc>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  bench<kMma, kAdc><<<blocks, 256, smem>>>(seed, table, out, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int run_layout(const unsigned* a, const unsigned* b, int* d) {
  layout_check<<<1, 32>>>(a, b, d);
  return static_cast<int>(cudaGetLastError());
}

// variant: 2 * adc + mma (adc 0 none, 1 table, 2 division; mma 0 or 1)
extern "C" int run_bench(int variant, const unsigned* seed,
                         const uint8_t* table, float* out, int blocks,
                         int iters) {
  switch (variant) {
    case 0: return launch<false, 0>(seed, table, out, blocks, iters);
    case 1: return launch<true, 0>(seed, table, out, blocks, iters);
    case 2: return launch<false, 1>(seed, table, out, blocks, iters);
    case 3: return launch<true, 1>(seed, table, out, blocks, iters);
    case 4: return launch<false, 2>(seed, table, out, blocks, iters);
    case 5: return launch<true, 2>(seed, table, out, blocks, iters);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
