// Int8 tensor-core tiles of all three kernels (trunk_conv.cu,
// cim_matmul.cu, rebranch_matmul.cu) in the ideal and per_subarray CiM
// modes, and the f32 sketch tile of the fused ReBranch matmul.  The
// bitserial mode is bitserial_tile.cuh's, on the same activation sources,
// W source and split plan.
//
// mma_tile<Mode, TM> computes one (TM, 64) output tile of
//
//   A [M, K] (activations), W int8 [K, N]  ->  out f32 [M, N]
//   for each k-block [k0, k1) of k_partition(K, 128) (bk wide), ascending:
//     q    = A[m, k0:k1] as int8 codes         (FloatAct, NhwcAct: per
//                                               (row, k-block) scale from
//                                               the absmax of the whole
//                                               k-block; Int8Act: as they
//                                               are)
//     part = ideal        : the exact int32 dot of the k-block
//            per_subarray : sum over its 128-row subarrays, ascending, of
//                           adc_signed(exact int32 dot of the subarray)
//     p    = part * scale (FloatAct, one rounding)  or  part (Int8Act)
//     out  = p0, then out + p1, out + p2, ...   (one rounding each)
//
// which is the plain version's contract (ROADMAP Queue 2) bit for bit.  The
// int32 dots come from mma.m16n8k32, its operands from ldmatrix (ptx.cuh),
// and a chunk's 32-deep steps past K are skipped; every f32 step is written
// with __fmul_rn / __fadd_rn, and each thread owns its output elements
// from the first k-block to the last, so the order is fixed by k alone.
//
// Tile height TM: 16 rows for M <= 16 (a decode step: 8 of 16 rows are
// padding, not 56 of 64) and 64 above.  4 warps; for TM = 16 each warp
// owns 16 rows x 16 columns, for TM = 64 32 rows x 32 columns.  The tile
// height moves no bits: the dots are exact and every row is quantised,
// dotted and summed on its own.
//
// Split-K (kernels/tiling.py::split_k decides it from the shapes alone):
// a block takes the k-blocks [kb0, kb1).  With one split it adds them
// itself.  With more, every block writes each of its k-blocks' p to the
// scratch parts [n_kblocks, M, N], and a second kernel, split_reduce, adds
// each element's parts in ascending k-block order, the first taken as it
// is.  The order is fixed by k, never by which block finished first, so
// the split moves no bits.  (A ticket in the last block of each tile did
// the same in one launch, but left each tile's whole reduction to one
// block and needed zeroed counters; the second kernel spreads it over the
// card and measured faster on the H100 at every Gemma-2B geometry.)
//
// Staging, per block:
//   W    16-byte cp.async (zero fill past K and N) into a ring of kStages
//        chunks of 128 k x 64 n bytes, so the next chunks are in flight
//        while one is dotted; each chunk is then transposed in shared memory
//        (4 words of 4 k rows -> 4 words of 4 columns, __byte_perm) to the
//        k-contiguous columns the MMA's B operand wants.  N % 16 != 0
//        falls back to byte loads.
//   A    the whole k-block of the tile's rows at once (it is needed whole
//        for the absmax anyway).  FloatAct: one warp per row, four rows'
//        loads in flight together, float4 loads where the rows are
//        aligned, scalar loads where not (K = 300), codes packed four k to
//        a word.  NhwcAct: the same, each row gathered from a conv's NHWC
//        input through the implicit im2col map (conv_geom.cuh), float4
//        along C where C % 4 == 0; with kPair, half the rows, the codes
//        written into the cluster peer's xa too.  Int8Act: 16-byte cp.async where the
//        rows are aligned, bytes where not (K = 27, 45, 300).
// Shared arrays indexed by (row or column, word) are XOR-swizzled at
// 4-word granularity so the MMA fragment loads hit 32 distinct banks.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cim_block_dot.cuh"
#include "conv_geom.cuh"
#include "ptx.cuh"

namespace repro_torch {
namespace mma {

constexpr int kThreads = 128;                // 4 warps
constexpr int kTileN = 64;                   // output columns per block
constexpr int kChunkK = 128;                 // one subarray
constexpr int kBlockK = 512;                 // widest k-block (tiling.BLOCK_K)
constexpr int kBlockW = kBlockK / 4;         // words per staged A row
constexpr int kStages = 3;                   // W cp.async ring depth
constexpr int kRawStride = kTileN + 16;      // bytes per staged W row
constexpr int kRawBytes = kChunkK * kRawStride;
constexpr int kWtWords = kTileN * (kChunkK / 4);
constexpr int kSketchK = 32;                 // k rows per sketch chunk
constexpr int kSketchStages = 3;             // sketch cp.async ring depth
constexpr int kXsStride = kSketchK + 4;      // float4 rows, banks apart
constexpr float kInv127 = 0x1.020408p-7f;    // np.float32(1 / 127)

// The position of word kw of row (or column) r: kw ^ swz(r).
__device__ __forceinline__ int swz(int r) { return ((r ^ (r >> 3)) & 7) << 2; }

// The 4 warps of a tile: 1 x 4 for TM = 16 (16 rows x 16 columns each),
// 2 x 2 for TM = 64 (32 rows x 32 columns each, so each A and B fragment
// feeds two MMAs).
template <int TM>
struct Shape {
  static_assert(TM == 16 || TM == 64, "tile heights 16 and 64");
  static constexpr int kWarpsM = TM == 16 ? 1 : 2;
  static constexpr int kWarpsN = 4 / kWarpsM;
  static constexpr int kWarpM = TM / kWarpsM;
  static constexpr int kWarpN = kTileN / kWarpsN;
  static constexpr int kMT = kWarpM / 16;   // m16 MMA tiles per warp
  static constexpr int kNT = kWarpN / 8;    // n8 MMA tiles per warp
  // shared memory of mma_tile with FloatAct or Int8Act and WSrc: the W
  // ring, the transposed chunk, the k-block of A codes and its row scales
  // (trunk_smem below in general)
  static constexpr int kTrunkSmem =
      kStages * kRawBytes + 4 * kWtWords + 4 * TM * kBlockW + 4 * TM;
};

// How the k-blocks are split over the grid: kernels/tiling.py::split_k
// decides it from the shapes and the wrapper hands it over as it is
// (kernels/cim_matmul.py::SplitPlan mirrors this struct field for field).
// The grid is tiles * n_splits blocks, block b taking tile b % tiles and
// the k-blocks [s * kb_per, (s + 1) * kb_per) of split s = b / tiles.
struct SplitPlan {
  int tile_m;
  int tiles_n;
  int tiles;
  int nkb;
  int kb_per;
  int n_splits;
};

// Whether `p` covers an [m, k] x [k, n] launch with k-blocks bk wide in
// tiles of its tile_m rows (a guard against a plan made for another shape:
// the plan is not remade here).
inline bool covers(const SplitPlan& p, long long m, int n, int k, int bk) {
  return p.tile_m > 0 && p.kb_per > 0 &&
         p.tiles_n == (n + kTileN - 1) / kTileN &&
         p.tiles == (m + p.tile_m - 1) / p.tile_m * p.tiles_n &&
         p.nkb == (k + bk - 1) / bk &&
         p.n_splits == (p.nkb + p.kb_per - 1) / p.kb_per;
}

// The int8 codes of four values, packed four to a word.  For finite values
// of a row whose absmax is at least |v|, |v * inv| <= 127 (1 + 4 2**-24):
// three roundings from 127 (core/quant.py::quant_rows_f32 relies on the
// same), so the clamp to [-127, 127] never binds and is not written.
// rint (half to even, as torch.round) is one f32 add of 1.5 * 2**23, where
// the floats are the integers: v + 1.5 * 2**23 rounds to the integer
// nearest v, ties to even (2**23 * 1.5 is even), and the low byte of its
// bits is rint(v) as an int8 (the constant's low byte is 0).  Two full-rate
// f32 operations per code, where a float-to-int conversion runs at a
// quarter of the rate.
__device__ __forceinline__ unsigned code_bits(float v, float inv) {
  return __float_as_uint(__fadd_rn(__fmul_rn(v, inv), 12582912.0f));
}

__device__ __forceinline__ unsigned pack_codes(float a, float b, float c,
                                               float d, float inv) {
  return __byte_perm(__byte_perm(code_bits(a, inv), code_bits(b, inv), 0x0040),
                     __byte_perm(code_bits(c, inv), code_bits(d, inv), 0x0040),
                     0x5410);
}

// bfloat16 activations arrive as their bits; widening one to f32 is exact
// (the bits are the upper half of the f32), so a bf16 x gives the bits of
// the same x widened first.
using bf16_t = uint16_t;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16_t h) {
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}

// The four bf16 of 8 bytes (the first in the low half of u.x) as f32.
__device__ __forceinline__ float4 widen4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// The rows a block stages and where their codes go besides its own xa and
// scale_s: alone, all TM rows; in a block pair (two column tiles of one
// row tile, a cluster of two), half the rows each, written into both
// blocks' shared memory (the peer's through distributed shared memory).
// (Clusters of four, a quarter of the rows each, measured slower on the
// H100: three remote copies of every code.)
struct Pair {
  unsigned* xa;    // the peer's xa and scale_s, nullptr alone
  float* scale;
  int row_lo;      // the rows [row_lo, row_lo + rows) this block stages
  int rows;
};

// Codes of the tile's rows pair.row_lo .. + pair.rows over one k-block
// `width` wide into xa, row scales into scale_s (and the peer's), in the
// reciprocal form (the plain version's core/quant.py::quant_rows).
// `load(v, i)` puts the lane's 16 values of tile row i in v: k-block
// column 4 (lane + 32 j) + e in v[4 j + e], zeros past the k-block and
// past M.  One warp per row, the
// row's values in registers between the absmax and the quantisation; each
// warp's rows are loaded four at a time, so their loads are in flight
// together.  Only the 128-column groups j that hold columns of the block
// are packed: the MMA reads no further.
template <int TM, class Load>
__device__ __forceinline__ void stage_rows(unsigned* xa, float* scale_s,
                                           int width, const Load& load,
                                           const Pair& pair) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kBatch = 4;
  static_assert(TM % (kWarps * kBatch) == 0, "whole batches of rows");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int i0 = 0; i0 < pair.rows / kWarps; i0 += kBatch) {
    float v[kBatch][16];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      load(v[b], pair.row_lo + warp + kWarps * (i0 + b));
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = pair.row_lo + warp + kWarps * (i0 + b);
      float amax = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) amax = fmaxf(amax, fabsf(v[b][j]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      }
      const float s = __fmul_rn(fmaxf(amax, 1e-8f), kInv127);
      const float inv = __frcp_rn(s);   // RN(1 / s), as __fdiv_rn(1, s)
      if (lane == 0) {
        scale_s[i] = s;
        if (pair.scale) pair.scale[i] = s;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (128 * j >= width) break;
        const int at = i * kBlockW + ((lane + 32 * j) ^ swz(i));
        const unsigned w =
            pack_codes(v[b][4 * j], v[b][4 * j + 1], v[b][4 * j + 2],
                       v[b][4 * j + 3], inv);
        xa[at] = w;
        if (pair.xa) pair.xa[at] = w;
      }
    }
  }
}

// stage_rows for a k-block at most 32 wide (a 3x3 conv of 3 channels, R =
// 27): four rows per warp pass, eight lanes to a row.  `load(v, i, cl)`
// puts columns 4 cl .. 4 cl + 3 of tile row i in v (zeros past the block
// and past M).  The same absmax, scale and codes as stage_rows, with a
// quarter of the passes.
template <int TM, class Load>
__device__ __forceinline__ void stage_rows_narrow(unsigned* xa,
                                                  float* scale_s,
                                                  const Load& load) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kPasses = TM / kWarps / 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cl = lane & 7;
  float v[kPasses][4];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    load(v[p], warp + kWarps * (4 * p + (lane >> 3)), cl);
  }
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int i = warp + kWarps * (4 * p + (lane >> 3));
    float amax = fmaxf(fmaxf(fabsf(v[p][0]), fabsf(v[p][1])),
                       fmaxf(fabsf(v[p][2]), fabsf(v[p][3])));
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    }
    const float s = __fmul_rn(fmaxf(amax, 1e-8f), kInv127);
    const float inv = __frcp_rn(s);
    if (cl == 0) scale_s[i] = s;
    xa[i * kBlockW + (cl ^ swz(i))] =
        pack_codes(v[p][0], v[p][1], v[p][2], v[p][3], inv);
  }
}

// Float activations (T float or bf16_t), quantised per (row, k-block).
template <class T>
struct FloatAct {
  static constexpr bool kScaled = true;
  const T* a;
  long long m;
  int k;
  bool vec;   // k % 4 == 0 and `a` aligned to 4 values: vector loads

  template <int TM>
  static constexpr int table_bytes() { return 0; }

  template <int TM>
  __device__ __forceinline__ void prepare(unsigned char*, long long, int,
                                          int) const {}

  // The lane's 16 values of row `row` over [k0, k0 + width): k = 4 * (lane
  // + 32 j) + e holds v[4 j + e]; zeros past the row's end and past M.
  __device__ __forceinline__ void load_row(float (&v)[16], long long row,
                                           int k0, int width,
                                           int lane) const {
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = 0.0f;
    if (row >= m) return;
    const T* ar = a + row * k + k0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = 4 * (lane + 32 * j);
      if (vec) {
        if (e < width) {
          float4 f;
          if constexpr (sizeof(T) == 4) {
            f = __ldg(reinterpret_cast<const float4*>(ar + e));
          } else {
            f = widen4(__ldg(reinterpret_cast<const uint2*>(ar + e)));
          }
          v[4 * j] = f.x;
          v[4 * j + 1] = f.y;
          v[4 * j + 2] = f.z;
          v[4 * j + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (e + q < width) v[4 * j + q] = widen(__ldg(ar + e + q));
        }
      }
    }
  }

  // Codes of rows [m0, m0 + TM) over [k0, k1) into xa, row scales into
  // scale_s.
  template <int TM>
  __device__ __forceinline__ void stage(unsigned* xa, float* scale_s,
                                        const unsigned char*, long long m0,
                                        int k0, int k1,
                                        const Pair& pair) const {
    const int lane = threadIdx.x & 31;
    stage_rows<TM>(xa, scale_s, k1 - k0, [&](float (&v)[16], int i) {
      load_row(v, m0 + i, k0, k1 - k0, lane);
    }, pair);
  }
};

// Float activations of a conv, f32 NHWC x [N, H, W, C], read through the
// implicit im2col map of conv_geom.cuh: row m of the patch matrix is
// gathered from x where it is staged, and the patch matrix is never
// written.  Quantised as FloatAct.  prepare() tabulates the tile's row
// windows and the k-block's (tap, channel) columns in `tables`, before the
// barrier that precedes stage().  kVec (C % 4 == 0, x 16-byte aligned:
// every DarkNet-19 site but the first): four neighbouring columns are four
// channels of one tap, one float4 load, the lane's taps read once per
// k-block.  Otherwise (C = 3) each value is loaded on its own.  The gather
// is straight-line: a padded pixel, or a column past the block, loads from
// kZeros, so the loads of a batch of rows are all in flight before the
// first is used.  A 64-row tile is 64 neighbouring output pixels, so the
// taps of its rows overlap in L1.
template <bool kVec>
struct NhwcAct {
  static constexpr bool kScaled = true;
  const float* x;
  ConvGeom g;
  long long m;
  int k;      // kh * kw * c

  // TM row windows (int4), then kBlockK packed column taps
  template <int TM>
  static constexpr int table_bytes() { return 16 * TM + 4 * kBlockK; }

  template <int TM>
  __device__ __forceinline__ void prepare(unsigned char* tables, long long m0,
                                          int k0, int k1) const {
    int4* rows = reinterpret_cast<int4*>(tables);
    int* cols = reinterpret_cast<int*>(tables + 16 * TM);
    for (int i = threadIdx.x; i < TM; i += kThreads) {
      rows[i] = row_pixel(g, m, m0 + i);
    }
    for (int kk = k0 + threadIdx.x; kk < k1; kk += kThreads) {
      cols[kk - k0] = col_tap(g, kk);
    }
  }

  template <int TM>
  __device__ __forceinline__ void stage(unsigned* xa, float* scale_s,
                                        const unsigned char* tables,
                                        long long, int k0, int k1,
                                        const Pair& pair) const {
    const int4* rows = reinterpret_cast<const int4*>(tables);
    const int* cols = reinterpret_cast<const int*>(tables + 16 * TM);
    const int lane = threadIdx.x & 31;
    const int width = k1 - k0;
    // kVec: the lane's column taps, one per 4-column group j (kNoTap past
    // the block); otherwise each value's tap is read from the table
    if (width <= 32 && !pair.xa) {   // narrow rows (C = 3: R = 27)
      stage_rows_narrow<TM>(xa, scale_s, [&](float (&v)[4], int i, int cl) {
        const int4 p = rows[i];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = 4 * cl + q;
          const int t = e < width ? cols[e] : kNoTap;
          v[q] = __ldg(tap_ptr<float>(x, tap_offset(g, p, t)));
        }
      });
      return;
    }
    int tap[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = 4 * (lane + 32 * j);
      tap[j] = kVec && e < width ? cols[e] : kNoTap;
    }
    stage_rows<TM>(xa, scale_s, width, [&](float (&v)[16], int i) {
      const int4 p = rows[i];
      // groups j past the block (a warp-uniform test) are not loaded
      if constexpr (kVec) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (128 * j < width) {
            f = __ldg(tap_ptr<float4>(x, tap_offset(g, p, tap[j])));
          }
          v[4 * j] = f.x;
          v[4 * j + 1] = f.y;
          v[4 * j + 2] = f.z;
          v[4 * j + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int e = 4 * (lane + 32 * (j >> 2)) + (j & 3);
          v[j] = 0.0f;
          if (128 * (j >> 2) < width) {
            const int t = e < width ? cols[e] : kNoTap;
            v[j] = __ldg(tap_ptr<float>(x, tap_offset(g, p, t)));
          }
        }
      }
    }, pair);
  }
};

// Int8 activations, taken as they are (-128 included); no scale.
struct Int8Act {
  static constexpr bool kScaled = false;
  const int8_t* a;
  long long m;
  int k;
  bool vec;   // k % 16 == 0 and `a` 16-byte aligned: cp.async

  template <int TM>
  static constexpr int table_bytes() { return 0; }

  template <int TM>
  __device__ __forceinline__ void prepare(unsigned char*, long long, int,
                                          int) const {}

  // Rows [m0, m0 + TM) over [k0, k1) into xa: a lane's 16 bytes of a row
  // are its words 4 lane .. 4 lane + 3, which stay contiguous under the
  // swizzle.  Aligned rows arrive by cp.async, all rows at once (waited
  // for here; the caller's next barrier publishes them); others by bytes.
  template <int TM>
  __device__ __forceinline__ void stage(unsigned* xa, float*,
                                        const unsigned char*, long long m0,
                                        int k0, int k1, const Pair&) const {
    const int lane = threadIdx.x & 31;
    const int width = k1 - k0;
    const int e = 16 * lane;
    for (int i = threadIdx.x >> 5; i < TM; i += kThreads / 32) {
      const long long row = m0 + i;
      const bool ok = row < m && e < width;
      const int8_t* ar = ok ? a + row * k + k0 + e : a;
      uint4* dst =
          reinterpret_cast<uint4*>(xa + i * kBlockW + ((4 * lane) ^ swz(i)));
      if (vec) {
        cp_async16(dst, ar, ok);
        continue;
      }
      unsigned wd[4] = {0u, 0u, 0u, 0u};
      if (ok) {
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          if (e + b < width) {
            wd[b >> 2] |= (static_cast<unsigned>(__ldg(ar + b)) & 0xffu)
                          << (8 * (b & 3));
          }
        }
      }
      *dst = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
    if (vec) {
      cp_async_commit();
      cp_async_wait<0>();
    }
  }
};

// W int8 [K, N].  (W handed over transposed, [N, K], would need no
// transposition in shared memory and one barrier less per chunk, but with
// the wrapper's copy it measured slower per DarkNet-19 forward on the
// H100.)
struct WSrc {
  const int8_t* w;
  int k;
  int n;
  bool vec;   // n % 16 == 0 and `w` 16-byte aligned: cp.async
};

// The (kChunkK, kTileN) slab of W at rows kc.., columns n0.. into one ring
// stage, row by row as in W; zeros past K and N.
__device__ __forceinline__ void load_w_chunk(uint8_t* raw, const WSrc& W,
                                             int kc, int n0) {
  if (W.vec) {
    for (int s = threadIdx.x; s < kChunkK * (kTileN / 16); s += kThreads) {
      const int r = s >> 2;
      const int seg = s & 3;
      const int kr = kc + r;
      const int col = n0 + 16 * seg;
      const bool ok = kr < W.k && col < W.n;
      const int8_t* src =
          ok ? W.w + static_cast<long long>(kr) * W.n + col : W.w;
      cp_async16(raw + r * kRawStride + 16 * seg, src, ok);
    }
  } else {
    for (int s = threadIdx.x; s < kChunkK * (kTileN / 4); s += kThreads) {
      const int r = s >> 4;
      const int wc = s & 15;
      const int kr = kc + r;
      unsigned packed = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + 4 * wc + e;
        if (kr < W.k && col < W.n) {
          packed |= (static_cast<unsigned>(
                         __ldg(W.w + static_cast<long long>(kr) * W.n + col)) &
                     0xffu)
                    << (8 * e);
        }
      }
      *reinterpret_cast<unsigned*>(raw + r * kRawStride + 4 * wc) = packed;
    }
  }
}

// The first `quads` k quads of a staged chunk, rows of W, to
// wt[column][k word] (four k per word).
__device__ __forceinline__ void transpose_chunk(unsigned* wt,
                                                const uint8_t* raw,
                                                int quads) {
  const unsigned* rw = reinterpret_cast<const unsigned*>(raw);
  constexpr int kRowW = kRawStride / 4;
  for (int s = threadIdx.x; s < quads * (kTileN / 4); s += kThreads) {
    const int c = s & 15;     // columns 4c .. 4c+3
    const int kq = s >> 4;    // k rows 4kq .. 4kq+3
    const unsigned r0 = rw[(4 * kq) * kRowW + c];
    const unsigned r1 = rw[(4 * kq + 1) * kRowW + c];
    const unsigned r2 = rw[(4 * kq + 2) * kRowW + c];
    const unsigned r3 = rw[(4 * kq + 3) * kRowW + c];
    const unsigned t0 = __byte_perm(r0, r1, 0x5140);
    const unsigned t1 = __byte_perm(r2, r3, 0x5140);
    const unsigned t2 = __byte_perm(r0, r1, 0x7362);
    const unsigned t3 = __byte_perm(r2, r3, 0x7362);
    const unsigned col[4] = {__byte_perm(t0, t1, 0x5410),
                             __byte_perm(t0, t1, 0x7632),
                             __byte_perm(t2, t3, 0x5410),
                             __byte_perm(t2, t3, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = 4 * c + j;
      wt[cc * (kChunkK / 4) + (kq ^ swz(cc))] = col[j];
    }
  }
}

// The ordered sum of one element's parts (stride apart), the first taken
// as it is; loads issued eight at a time, adds in ascending order.
__device__ __forceinline__ float ordered_sum(const float* parts, int n,
                                             long long stride) {
  float acc = __ldcg(parts);
  for (int i0 = 1; i0 < n; i0 += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = i0 + j < n ? __ldcg(parts + (i0 + j) * stride) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (i0 + j < n) acc = __fadd_rn(acc, v[j]);
    }
  }
  return acc;
}

// Shared memory of mma_tile<Mode, TM, Act>: Shape<TM>::kTrunkSmem, then
// the Act's tables.
template <int TM, class Act>
constexpr int trunk_smem() {
  return Shape<TM>::kTrunkSmem + Act::template table_bytes<TM>();
}

// One (TM, kTileN) output tile, rows from m0 and columns from n0, over the
// k-blocks [kb0, kb1) of the split; all kThreads threads of the block.
// `smem` holds trunk_smem<TM, Act>() bytes.  kPair: the block is one of a
// cluster of two that share the row tile (neighbouring column tiles); each
// stages half of the rows' codes into both blocks' xa, and the k-block's
// barriers are the cluster's.
template <int kMode, int TM, class Act, bool kPair = false>
__device__ __forceinline__ void mma_tile(const Act& act, const WSrc& W,
                                         float* __restrict__ out,
                                         float* __restrict__ parts, int bk,
                                         const SplitPlan& plan, int kb0,
                                         long long m0, int n0,
                                         const AdcParams& adc,
                                         unsigned char* smem) {
  static_assert(kMode == kIdeal || kMode == kPerSubarray,
                "bitserial is bitserial_tile.cuh's tile");
  using S = Shape<TM>;
  uint8_t* raw = smem;
  unsigned* wt = reinterpret_cast<unsigned*>(smem + kStages * kRawBytes);
  unsigned* xa = wt + kWtWords;
  float* scale_s = reinterpret_cast<float*>(xa + TM * kBlockW);
  unsigned char* tables = reinterpret_cast<unsigned char*>(scale_s + TM);
  Pair pair{nullptr, nullptr, 0, TM};
  if constexpr (kPair) {
    auto cluster = cooperative_groups::this_cluster();
    const unsigned peer = cluster.block_rank() ^ 1u;
    pair = Pair{cluster.map_shared_rank(xa, peer),
                cluster.map_shared_rank(scale_s, peer),
                static_cast<int>(cluster.block_rank()) * (TM / 2), TM / 2};
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  // the warp's first row (its m16 tile mt holds rows r0 + 16 mt + g and
  // + 8) and first column
  const int wr0 = (warp % S::kWarpsM) * S::kWarpM;
  const int r0 = wr0 + g;
  const int cw = (warp / S::kWarpsM) * S::kWarpN;
  const int lrow = lane & 7;   // ldmatrix: the row this lane addresses
  const int lmat = lane >> 3;  // ... in matrix lmat
  const int kb1 = min(kb0 + plan.kb_per, plan.nkb);
  const bool split = plan.n_splits > 1;
  const int kbeg = kb0 * bk;
  const int nq = (min(kb1 * bk, W.k) - kbeg + kChunkK - 1) / kChunkK;

#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < nq) load_w_chunk(raw + q * kRawBytes, W, kbeg + q * kChunkK, n0);
    cp_async_commit();
  }

  int dot[S::kMT][S::kNT][4];
  float part[S::kMT][S::kNT][4];
  float acc[S::kMT][S::kNT][4];
#pragma unroll
  for (int mt = 0; mt < S::kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < S::kNT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dot[mt][nt][i] = 0;
        part[mt][nt][i] = 0.0f;
        acc[mt][nt][i] = 0.0f;
      }
    }
  }

  int q = 0;
  for (int kb = kb0; kb < kb1; ++kb) {
    const int k0 = kb * bk;
    const int k1 = min(k0 + bk, W.k);
    // the previous k-block's stage() is done with the tables (every
    // thread has passed a chunk barrier since)
    act.template prepare<TM>(tables, m0, k0, k1);
    // the previous k-block's MMAs are done with xa (in a pair, the peer's
    // too: this block writes into it; the first sync also makes sure the
    // peer is running before its shared memory is written)
    if constexpr (kPair) {
      cooperative_groups::this_cluster().sync();
    } else {
      __syncthreads();
    }
    act.template stage<TM>(xa, scale_s, tables, m0, k0, k1, pair);
    if constexpr (kPair) {
      cooperative_groups::this_cluster().sync();   // the peer's rows landed
    }
    const int nch = (k1 - k0 + kChunkK - 1) / kChunkK;
    for (int c = 0; c < nch; ++c, ++q) {
      cp_async_wait<kStages - 2>();   // chunk q has landed (this thread's)
      __syncthreads();                // ... everyone's; wt is free
      // the chunk's 32-deep MMA steps that hold columns of the block (R =
      // 27 has one): past them the codes are zero, so skipping is exact
      const int nks = (min(kChunkK, k1 - k0 - c * kChunkK) + 31) / 32;
      transpose_chunk(wt, raw + (q % kStages) * kRawBytes, 8 * nks);
      __syncthreads();
      // refill the stage that chunk q - 1 used
      if (q + kStages - 1 < nq) {
        load_w_chunk(raw + ((q + kStages - 1) % kStages) * kRawBytes, W,
                     kbeg + (q + kStages - 1) * kChunkK, n0);
      }
      cp_async_commit();
      // fragments by ldmatrix: lane L addresses row L % 8 of matrix L / 8,
      // a 16-byte segment, which the swizzle keeps whole
#pragma unroll
      for (int ks = 0; ks < kChunkK / 32; ++ks) {
        if (ks >= nks) break;
        const int kw = c * 32 + ks * 8 + 4 * (lmat >> 1);
        unsigned a[S::kMT][4];
#pragma unroll
        for (int mt = 0; mt < S::kMT; ++mt) {
          const int r = wr0 + 16 * mt + 8 * (lmat & 1) + lrow;
          ldmatrix_x4(a[mt], xa + r * kBlockW + (kw ^ swz(r)));
        }
        const int kwb = ks * 8 + 4 * (lmat & 1);
#pragma unroll
        for (int np = 0; np < S::kNT / 2; ++np) {
          const int col = cw + (2 * np + (lmat >> 1)) * 8 + lrow;
          unsigned b[4];   // b0, b1 of n8 tiles 2 np and 2 np + 1
          ldmatrix_x4(b, wt + col * (kChunkK / 4) + (kwb ^ swz(col)));
#pragma unroll
          for (int mt = 0; mt < S::kMT; ++mt) {
            mma_s8(dot[mt][2 * np], a[mt], b[0], b[1]);
            mma_s8(dot[mt][2 * np + 1], a[mt], b[2], b[3]);
          }
        }
      }
      if constexpr (kMode == kPerSubarray) {
        // the subarray's exact sums through the ADC, in subarray order;
        // rows past M (8 of 16 at decode) skip the division
#pragma unroll
        for (int mt = 0; mt < S::kMT; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (m0 + r0 + 16 * mt + 8 * h >= act.m) continue;
#pragma unroll
            for (int nt = 0; nt < S::kNT; ++nt) {
#pragma unroll
              for (int i = 2 * h; i < 2 * h + 2; ++i) {
                part[mt][nt][i] = __fadd_rn(
                    part[mt][nt][i],
                    adc_signed(__int2float_rn(dot[mt][nt][i]), adc));
              }
            }
          }
#pragma unroll
          for (int nt = 0; nt < S::kNT; ++nt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) dot[mt][nt][i] = 0;
          }
        }
      }
    }

    // the k-block's p: one rounding for * scale, one for acc + p
#pragma unroll
    for (int mt = 0; mt < S::kMT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < S::kNT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p;
          if constexpr (kMode == kIdeal) {
            p = __int2float_rn(dot[mt][nt][i]);
            dot[mt][nt][i] = 0;
          } else {
            p = part[mt][nt][i];
            part[mt][nt][i] = 0.0f;
          }
          const int tr = r0 + 16 * mt + 8 * (i >> 1);
          if constexpr (Act::kScaled) p = __fmul_rn(p, scale_s[tr]);
          if (split) {
            const long long row = m0 + tr;
            const int col = n0 + cw + nt * 8 + 2 * t + (i & 1);
            if (row < act.m && col < W.n) {
              parts[(static_cast<long long>(kb) * act.m + row) * W.n + col] =
                  p;
            }
          } else {
            acc[mt][nt][i] = kb == kb0 ? p : __fadd_rn(acc[mt][nt][i], p);
          }
        }
      }
    }
  }

  if (split) return;   // split_reduce adds the parts
#pragma unroll
  for (int mt = 0; mt < S::kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < S::kNT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long row = m0 + r0 + 16 * mt + 8 * (i >> 1);
        const int col = n0 + cw + nt * 8 + 2 * t + (i & 1);
        if (row >= act.m || col >= W.n) continue;
        out[row * W.n + col] = acc[mt][nt][i];
      }
    }
  }
}

// How the sketch's k range is split: kernels/tiling.py::split_sketch
// decides it and the wrapper hands it over as it is (mirrored field for
// field by kernels/cim_matmul.py::SketchPlan).  In units of one 128-row
// subarray ("sub-blocks", kChunkK), `sub_per` of them per split.  A
// k-block's part is the ordered sum of its sub-blocks' FMA chains, whatever
// the split, so a split may cut inside a k-block; the scratch then holds
// one part per sub-block (sub_slots), else one per k-block.
struct SketchPlan {
  int tile_m;
  int tiles_n;
  int tiles;
  int nsub;      // sub-blocks of K
  int spk;       // sub-blocks per full k-block (bk / 128)
  int sub_per;   // sub-blocks per split: < spk, or a multiple of it
  int n_splits;
  int nkb;
  int sub_slots;
};

inline bool covers(const SketchPlan& p, long long m, int cdim, int k,
                   int bk) {
  return p.tile_m > 0 && p.sub_per > 0 &&
         p.tiles_n == (cdim + kTileN - 1) / kTileN &&
         p.tiles == (m + p.tile_m - 1) / p.tile_m * p.tiles_n &&
         p.nsub == (k + kChunkK - 1) / kChunkK && p.spk == bk / kChunkK &&
         p.nkb == (k + bk - 1) / bk &&
         p.n_splits == (p.nsub + p.sub_per - 1) / p.sub_per &&
         p.sub_slots == (p.sub_per % p.spk != 0);
}

template <int TMS>
struct SketchShape {
  static_assert(TMS == 8 || TMS == 16 || TMS == 64,
                "sketch tile heights 8, 16 and 64");
  static constexpr int kSmem =
      4 * kSketchStages * (kSketchK * kTileN + TMS * kXsStride);
};

// The ordered reduction of one sketch element from the scratch: the
// k-blocks ascending, each the ordered sum of its sub-blocks' parts when
// the scratch holds sub-blocks.
__device__ __forceinline__ float sketch_sum(const float* parts,
                                            const SketchPlan& sp,
                                            long long stride) {
  if (!sp.sub_slots) return ordered_sum(parts, sp.nkb, stride);
  float acc = 0.0f;
  for (int kb = 0; kb < sp.nkb; ++kb) {
    const int s0 = kb * sp.spk;
    const float p =
        ordered_sum(parts + s0 * stride, min(sp.spk, sp.nsub - s0), stride);
    acc = kb == 0 ? p : __fadd_rn(acc, p);
  }
  return acc;
}

// The second kernel of a split launch: every element of the trunk (or
// kernel 4's output) from its n_kblocks parts [nkb, mn_t], then every
// element of the sketch from its slots [.., mn_s]; one thread per element,
// neighbouring threads on neighbouring elements.  mn_t or mn_s is 0 for a
// half that was not split.
__global__ void __launch_bounds__(256)
    split_reduce(const float* __restrict__ parts_t, float* __restrict__ out_t,
                 long long mn_t, int nkb_t, const float* __restrict__ parts_s,
                 float* __restrict__ out_s, long long mn_s, SketchPlan sp) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i < mn_t) {
    out_t[i] = ordered_sum(parts_t + i, nkb_t, mn_t);
  } else if (i - mn_t < mn_s) {
    out_s[i - mn_t] = sketch_sum(parts_s + (i - mn_t), sp, mn_s);
  }
}

inline cudaError_t launch_split_reduce(const float* parts_t, float* out_t,
                                       long long mn_t, int nkb_t,
                                       const float* parts_s, float* out_s,
                                       long long mn_s, const SketchPlan& sp,
                                       cudaStream_t stream) {
  const long long n = mn_t + mn_s;
  if (n == 0) return cudaSuccess;
  split_reduce<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      parts_t, out_t, mn_t, nkb_t, parts_s, out_s, mn_s, sp);
  return cudaGetLastError();
}

// One (TMS, kTileN) tile of the sketch t1 = x @ C (x [M, K] f32 or bf16,
// C f32 [K, Cd]), columns from c0, over the split's sub-blocks [sub0, sub0 +
// sub_per).  Each element's sub-block part is one serial FMA chain over
// its 128 k, ascending, from 0; a k-block's part is its sub-blocks' parts
// added in order; the k-block parts join as in mma_tile.  The same chains
// and sums whatever M, the tile height and the split are, so a row's t1
// does not depend on the batch.  C and x arrive through cp.async (C in
// 16-byte pieces where Cd % 4 == 0), kSketchStages chunks of kSketchK k;
// a bf16 x is staged as it is, two values per 4-byte copy (K even, x
// 4-byte aligned), and widened where it is read.  A thread owns TMS / 8
// rows x 4 columns.  `smem` holds SketchShape<TMS>::kSmem bytes.
template <int TMS, class T>
__device__ __forceinline__ void sketch_tile(
    const T* __restrict__ x, const float* __restrict__ c,
    float* __restrict__ t1, float* __restrict__ parts,
    long long m, int k, int cdim, bool cvec, const SketchPlan& sp,
    int sub0, long long m0, int c0, unsigned char* smem) {
  constexpr int kRows = TMS / 8;                  // rows per thread
  constexpr int kSubChunks = kChunkK / kSketchK;  // chunks per sub-block
  float* cs = reinterpret_cast<float*>(smem);     // [stage][k][col]
  float* xs = cs + kSketchStages * kSketchK * kTileN;   // [stage][row][k]
  const int cq = threadIdx.x & 15;                // columns 4cq .. 4cq+3
  const int rg = threadIdx.x >> 4;                // rows rg*kRows ..
  const int sub1 = min(sub0 + sp.sub_per, sp.nsub);
  const bool split = sp.n_splits > 1;
  const int kbeg = sub0 * kChunkK;
  const int nq = (min(sub1 * kChunkK, k) - kbeg + kSketchK - 1) / kSketchK;

  auto load = [&](int qq) {
    const int kc = kbeg + qq * kSketchK;
    float* cst = cs + (qq % kSketchStages) * kSketchK * kTileN;
    float* xst = xs + (qq % kSketchStages) * TMS * kXsStride;
    if (cvec) {
      for (int s = threadIdx.x; s < kSketchK * (kTileN / 4); s += kThreads) {
        const int r = s >> 4;
        const int seg = s & 15;
        const int kr = kc + r;
        const int col = c0 + 4 * seg;
        const bool ok = kr < k && col < cdim;
        cp_async16(cst + r * kTileN + 4 * seg,
                   ok ? c + static_cast<long long>(kr) * cdim + col : c, ok);
      }
    } else {
      for (int s = threadIdx.x; s < kSketchK * kTileN; s += kThreads) {
        const int r = s / kTileN;
        const int j = s % kTileN;
        const int kr = kc + r;
        const int col = c0 + j;
        const bool ok = kr < k && col < cdim;
        cp_async4(cst + r * kTileN + j,
                  ok ? c + static_cast<long long>(kr) * cdim + col : c, ok);
      }
    }
    // x: one f32, or two bf16, per 4-byte copy
    constexpr int kPer = 4 / sizeof(T);
    T* xt = reinterpret_cast<T*>(xst);
    for (int s = threadIdx.x; s < TMS * kSketchK / kPer; s += kThreads) {
      const int i = s / (kSketchK / kPer);
      const int kk = kPer * (s % (kSketchK / kPer));
      const long long row = m0 + i;
      const bool ok = row < m && kc + kk < k;
      cp_async4(xt + i * kXsStride * kPer + kk,
                ok ? x + row * k + kc + kk : x, ok);
    }
  };

#pragma unroll
  for (int qq = 0; qq < kSketchStages - 1; ++qq) {
    if (qq < nq) load(qq);
    cp_async_commit();
  }

  float part[kRows][4];   // the running sub-block chain
  float kbp[kRows][4];    // the running k-block part
  float acc[kRows][4];    // the running output (no split)
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      part[r][j] = 0.0f;
      kbp[r][j] = 0.0f;
      acc[r][j] = 0.0f;
    }
  }

  int q = 0;
  for (int sub = sub0; sub < sub1; ++sub) {
    const int nch = min(kSubChunks, (k - sub * kChunkK + kSketchK - 1) /
                                        kSketchK);
    for (int ch = 0; ch < nch; ++ch, ++q) {
      cp_async_wait<kSketchStages - 2>();
      __syncthreads();   // chunk q is everyone's; chunk q - 1 is read
      if (q + kSketchStages - 1 < nq) load(q + kSketchStages - 1);
      cp_async_commit();
      const float* cst = cs + (q % kSketchStages) * kSketchK * kTileN;
      const float* xst = xs + (q % kSketchStages) * TMS * kXsStride;
#pragma unroll 2
      for (int kk = 0; kk < kSketchK; kk += 4) {
        float4 xv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if constexpr (sizeof(T) == 4) {
            xv[r] = *reinterpret_cast<const float4*>(
                xst + (rg * kRows + r) * kXsStride + kk);
          } else {
            xv[r] = widen4(*reinterpret_cast<const uint2*>(
                reinterpret_cast<const T*>(xst) +
                (rg * kRows + r) * kXsStride * 2 + kk));
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 cv = *reinterpret_cast<const float4*>(
              cst + (kk + e) * kTileN + 4 * cq);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float xe = e == 0 ? xv[r].x
                             : e == 1 ? xv[r].y
                             : e == 2 ? xv[r].z
                                      : xv[r].w;
            part[r][0] = __fmaf_rn(xe, cv.x, part[r][0]);
            part[r][1] = __fmaf_rn(xe, cv.y, part[r][1]);
            part[r][2] = __fmaf_rn(xe, cv.z, part[r][2]);
            part[r][3] = __fmaf_rn(xe, cv.w, part[r][3]);
          }
        }
      }
    }
    // the sub-block's chain joins its k-block's part, in order
    const int kb = sub / sp.spk;
    const bool kb_first = sub % sp.spk == 0;
    const bool kb_last = sub % sp.spk == sp.spk - 1 || sub == sp.nsub - 1;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long row = m0 + rg * kRows + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + 4 * cq + j;
        const float p = part[r][j];
        part[r][j] = 0.0f;
        if (split && sp.sub_slots) {
          if (row < m && col < cdim) {
            parts[(static_cast<long long>(sub) * m + row) * cdim + col] = p;
          }
          continue;
        }
        kbp[r][j] = kb_first ? p : __fadd_rn(kbp[r][j], p);
        if (!kb_last) continue;
        if (split) {
          if (row < m && col < cdim) {
            parts[(static_cast<long long>(kb) * m + row) * cdim + col] =
                kbp[r][j];
          }
        } else {
          acc[r][j] = kb == 0 ? kbp[r][j] : __fadd_rn(acc[r][j], kbp[r][j]);
        }
      }
    }
  }

  if (split) return;   // split_reduce adds the parts
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long row = m0 + rg * kRows + r;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + 4 * cq + j;
      if (col >= cdim) continue;
      t1[row * cdim + col] = acc[r][j];
    }
  }
}

}  // namespace mma
}  // namespace repro_torch
