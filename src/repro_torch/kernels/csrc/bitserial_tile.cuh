// The bitserial tile of all three kernels (trunk_conv.cu, cim_matmul.cu,
// rebranch_matmul.cu): the macro's 5-bit ADC fidelity model on Hopper,
// with the counts from the binary tensor cores and the ADC from a table.
//
// bitserial_tile<TM> computes one (TM, 64) output tile of
//
//   A [M, K] (activations), W int8 [K, N]  ->  out f32 [M, N]
//   for each k-block [k0, k1) of k_partition(K, 128) (bk wide), ascending:
//     q    = A[m, k0:k1] as int8 codes    (mma_tile.cuh's Act sources: the
//                                          same quantiser as ideal mode)
//     part = 0
//     for (sa, sw) in (+,+), (+,-), (-,+), (-,-):  sign = sa == sw ? 1 : -1
//       for each 128-row subarray of the k-block, ascending:
//         for g in 0..3:  for j in 0..6:
//           count = sum_k a_g[k] w_j[k]    (a_g the 2-bit group g of the
//                                           a_sa part, w_j bit j of w_sw)
//           p     = sum_k w_j[k]           (the column's plane popcount)
//           part += (sign 2^(2g+j)) * (code[p][count] * lsb[p])
//     p    = part * scale (FloatAct, NhwcAct)  or  part (Int8Act)
//     out  = p0, then out + p1, ...  (or, split, parts[kb] and split_reduce)
//
// which is the plain version's bitserial cim_block_dot term for term
// (cim_block_dot.cuh): every count is an exact integer, the table gives
// the plain version's code and lsb, code * lsb and each add round once, and
// coef * sensed is exact (coef a power of two), so folding coef into the
// lsb first gives the same product (adc_sensed).  The counts come in any
// order; the f32 adds follow the plain version's loop nest.
//
// Per k-block the block stages its operands once, not once per sign pair:
//   A  Act::stage quantises the tile's rows into int8 codes (xa), then each
//      code becomes bits of 9 planes: the 8 magnitude bits of |q| (128 for
//      -128, whose bit 7 lies in activation group 3) and the sign.
//   W  16-byte loads of W (where N % 16 == 0), 128 k rows of 16 columns per
//      warp pass, turned into 8 planes (the 7 magnitude bits of |w|, the
//      sign; -128 has magnitude 128, so no magnitude bit, and adds nothing,
//      as in the plain version) by 32 x 32 bit transposes across the warp.
//   p  the ones of each (subarray, sign, plane, column), as uint8.
// A sign pair's planes are then the magnitude planes AND the sign plane
// (a-, w-) or AND-NOT it (a+, w+), in registers.  Plane word (c, e), bit l,
// holds k = k0 + 128 c + 4 l + e: A and W share the order, so the counts
// are those of the natural order.  Codes past the k-block (a ragged last
// subarray, R = 27) read as 0, and so do W rows past K.
//
// The counts: mma.m16n8k128 .b1 .and.popc (ptx.cuh), one subarray per MMA:
// count = popc(lo_g & w_j) + 2 popc(hi_g & w_j) as two MMAs, the first
// accumulating from row p's start in the table, so that it ends as the
// index of the count's code.  The table (25 KB) is copied into shared
// memory once per block.
//
// Warps: 4, warp w owning columns 16 w .. 16 w + 15 (two n8 MMA tiles) of
// all TM rows (TM / 16 m16 tiles).  Tile height TM (tiling.split_bitserial):
// 16 for M <= 16 (one m16 tile: a decode step) and 32 above (kernel 1,
// prefill: two blocks of about 100 KB of shared memory per SM, where 64
// rows allowed one); neither moves a bit: each row is quantised, counted
// and summed on its own, in an order fixed by k.  Rows past M and columns
// past N read as zeros, go through the ADC like the others (a branch per
// element cost more than the work) and are not stored; only a 16-row tile
// of at most 8 live rows (a decode step) skips its other 8 rows whole.
// Split-K as mma_tile.cuh: whole k-blocks per split, their parts added by
// split_reduce in k order.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "cim_block_dot.cuh"
#include "mma_tile.cuh"
#include "ptx.cuh"

namespace repro_torch {
namespace mma {

constexpr int kBitChunks = kBlockK / kChunkK;   // subarrays per k-block
constexpr int kAPlanes = kActBits + 1;          // |q| bits 0..7, sign
constexpr int kWPlanes = kPlanes + 1;           // |w| bits 0..6, sign
constexpr int kPlaneWords = kChunkK / 32;       // words per plane per chunk

template <int TM, class Act>
struct BitShape {
  static_assert(TM == 16 || TM == 32, "tile heights 16 and 32");
  static constexpr int kMT = TM / 16;      // m16 tiles per warp
  static constexpr int kNT = 2;            // n8 tiles per warp
  // shared memory, in this order: the ADC table; the A planes
  // [chunk][plane][row][word]; the W planes [chunk][plane][column][word];
  // the plane popcounts [chunk][sign][plane][column]; the codes xa
  // [row][kBlockW] and row scales of Act::stage; the Act's tables
  static constexpr int kAPlaneBytes =
      4 * kBitChunks * kAPlanes * TM * kPlaneWords;
  static constexpr int kWPlaneBytes =
      4 * kBitChunks * kWPlanes * kTileN * kPlaneWords;
  static constexpr int kPopBytes = kBitChunks * 2 * kPlanes * kTileN;
  static constexpr int kSmem = kAdcTableBytes + kAPlaneBytes + kWPlaneBytes +
                               kPopBytes + 4 * TM * kBlockW + 4 * TM +
                               Act::template table_bytes<TM>();
};

// Dynamic shared memory of a trunk tile of height TM on activation source
// Act in CimMode kMode: this file's tile in bitserial, mma_tile.cuh's
// otherwise.
template <int kMode, int TM, class Act>
constexpr int tile_smem() {
  if constexpr (kMode == kBitserial) {
    return BitShape<TM, Act>::kSmem;
  } else {
    return trunk_smem<TM, Act>();
  }
}

// The 32 x 32 bit matrix whose row r is lane r's x, transposed: lane c
// gets column c (bit r of the result is bit c of lane r's x).  Five steps,
// each swapping the off-diagonal blocks of every 2s x 2s block with the
// lane s apart.
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
  constexpr unsigned kLow[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                                0x33333333u, 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int s = 16 >> i;
    const unsigned m = kLow[i];
    const unsigned y = __shfl_xor_sync(0xffffffffu, x, s);
    x = (lane & s) ? (x & ~m) | ((y & ~m) >> s) : (x & m) | ((y & m) << s);
  }
  return x;
}

// The k-block's W [k0, k1) x [n0, n0 + 64) as planes: wp[c][b][col][e],
// bit l of word e the plane bit of k = k0 + 128 c + 4 l + e; zeros past K
// and N.  One warp pass per (chunk, 16-column group): lane l loads rows
// 4 l .. 4 l + 3 of the chunk (16 bytes each); for each row e and four
// columns, the byte of column cb holds |w|'s bits 0..6 and the sign in
// bit 7, and a bit transpose hands lane 8 cb + b plane b of that column.
__device__ __forceinline__ void stage_w_planes(unsigned* wp, const WSrc& W,
                                               int k0, int k1, int n0,
                                               int nch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll 2
  for (int task = warp; task < nch * 4; task += kThreads / 32) {
    const int c = task >> 2;
    const int q = task & 3;
    const int col0 = n0 + 16 * q;
    uint4 v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = k0 + kChunkK * c + 4 * lane + e;
      v[e] = make_uint4(0u, 0u, 0u, 0u);
      if (row >= k1 || col0 >= W.n) continue;
      const int8_t* src = W.w + static_cast<long long>(row) * W.n + col0;
      if (W.vec) {
        v[e] = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        unsigned wd[4] = {0u, 0u, 0u, 0u};
        for (int b = 0; b < 16 && col0 + b < W.n; ++b) {
          wd[b >> 2] |= (static_cast<unsigned>(__ldg(src + b)) & 0xffu)
                        << (8 * (b & 3));
        }
        v[e] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned words[4] = {v[e].x, v[e].y, v[e].z, v[e].w};
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        // |-128| reads 0x80: no bit in 0..6
        const unsigned bits = transpose32(
            (__vabs4(words[qq]) & 0x7f7f7f7fu) | (words[qq] & 0x80808080u),
            lane);
        const int col = 16 * q + 4 * qq + (lane >> 3);
        wp[((c * kWPlanes + (lane & 7)) * kTileN + col) * kPlaneWords + e] =
            bits;
      }
    }
  }
}

// The codes of the tile's rows (xa, as Act::stage wrote them) as planes:
// ap[c][b][row][e], bit l of word e the plane bit of k = k0 + 128 c + 4 l
// + e; codes at or past `width` read as 0 (Act::stage leaves words past the
// k-block unwritten).  One warp pass per (row, chunk): lane l reads code
// word 32 c + l; a bit transpose of the four codes' magnitudes hands lane
// 8 e + b plane b of word e, and four ballots give the sign words.
template <int TM>
__device__ __forceinline__ void stage_a_planes(unsigned* ap,
                                               const unsigned* xa, int width,
                                               int nch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll 2
  for (int task = warp; task < TM * nch; task += kThreads / 32) {
    const int i = task % TM;
    const int c = task / TM;
    const int kw = 32 * c + lane;
    const int valid = width - 4 * kw;        // codes of the word in the block
    unsigned word = 0u;
    if (valid > 0) {
      word = xa[i * kBlockW + (kw ^ swz(i))];
      if (valid < 4) word &= (1u << (8 * valid)) - 1u;
    }
    // |-128| reads 0x80: bit 7, in activation group 3
    const unsigned mags = transpose32(__vabs4(word), lane);
    unsigned sign = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned bits =
          __ballot_sync(0xffffffffu, (word >> (8 * e + 7)) & 1u);
      if (lane == e) sign = bits;
    }
    ap[((c * kAPlanes + (lane & 7)) * TM + i) * kPlaneWords + (lane >> 3)] =
        mags;
    if (lane < 4) {
      ap[((c * kAPlanes + kActBits) * TM + i) * kPlaneWords + lane] = sign;
    }
  }
}

// pc[c][s][j][col]: the ones of plane j of the w+ (s = 0) or w- (s = 1)
// part of column col in chunk c.
__device__ __forceinline__ void plane_popcounts(uint8_t* pc,
                                                const unsigned* wp, int nch) {
  for (int s = threadIdx.x; s < nch * kTileN; s += kThreads) {
    const int c = s / kTileN;
    const int col = s % kTileN;
    const uint4 sg = *reinterpret_cast<const uint4*>(
        wp + ((c * kWPlanes + kPlanes) * kTileN + col) * kPlaneWords);
#pragma unroll
    for (int j = 0; j < kPlanes; ++j) {
      const uint4 m = *reinterpret_cast<const uint4*>(
          wp + ((c * kWPlanes + j) * kTileN + col) * kPlaneWords);
      const int neg = __popc(m.x & sg.x) + __popc(m.y & sg.y) +
                      __popc(m.z & sg.z) + __popc(m.w & sg.w);
      const int all = __popc(m.x) + __popc(m.y) + __popc(m.z) + __popc(m.w);
      pc[((c * 2) * kPlanes + j) * kTileN + col] =
          static_cast<uint8_t>(all - neg);
      pc[((c * 2 + 1) * kPlanes + j) * kTileN + col] =
          static_cast<uint8_t>(neg);
    }
  }
}

// One (TM, kTileN) output tile, rows from m0 and columns from n0, over the
// k-blocks [kb0, kb1) of the split; all kThreads threads of the block.
// `adc` is the wrapper's ADC table (kAdcTableBytes, 16-byte aligned);
// `smem` holds BitShape<TM, Act>::kSmem bytes.
template <int TM, class Act>
__device__ __forceinline__ void bitserial_tile(
    const Act& act, const WSrc& W, float* __restrict__ out,
    float* __restrict__ parts, int bk, const SplitPlan& plan, int kb0,
    long long m0, int n0, const unsigned char* __restrict__ adc,
    unsigned char* smem) {
  using S = BitShape<TM, Act>;
  constexpr int kMT = S::kMT;
  constexpr int kNT = S::kNT;
  const float* lsb_s = reinterpret_cast<const float*>(smem);
  unsigned* ap = reinterpret_cast<unsigned*>(smem + kAdcTableBytes);
  unsigned* wp = ap + S::kAPlaneBytes / 4;
  uint8_t* pc = reinterpret_cast<uint8_t*>(wp + S::kWPlaneBytes / 4);
  unsigned* xa = reinterpret_cast<unsigned*>(pc + S::kPopBytes);
  float* scale_s = reinterpret_cast<float*>(xa + TM * kBlockW);
  unsigned char* tables = reinterpret_cast<unsigned char*>(scale_s + TM);

  for (int i = threadIdx.x; i < kAdcTableBytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(smem)[i] =
        __ldg(reinterpret_cast<const uint4*>(adc) + i);
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g8 = lane >> 2;   // the fragment's row (and B column) in 8
  const int t = lane & 3;     // ... and its word
  const int cw = warp * (8 * kNT);
  const int kb1 = min(kb0 + plan.kb_per, plan.nkb);
  const bool split = plan.n_splits > 1;
  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    }
  }

  for (int kb = kb0; kb < kb1; ++kb) {
    const int k0 = kb * bk;
    const int k1 = min(k0 + bk, W.k);
    const int nch = (k1 - k0 + kChunkK - 1) / kChunkK;
    // the previous k-block's stage() is done with the tables (every thread
    // has passed two barriers since)
    act.template prepare<TM>(tables, m0, k0, k1);
    // the tables are published; the previous k-block's counts are done
    // with the planes and the popcounts (and the table copy has landed)
    __syncthreads();
    act.template stage<TM>(xa, scale_s, tables, m0, k0, k1,
                           Pair{nullptr, nullptr, 0, TM});
    stage_w_planes(wp, W, k0, k1, n0, nch);
    __syncthreads();
    stage_a_planes<TM>(ap, xa, k1 - k0, nch);
    plane_popcounts(pc, wp, nch);
    __syncthreads();

    float part[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.0f;
      }
    }
    // the counts and the ADC, kEvals elements of each thread's four in an
    // m16n8 tile: 4, or 2 where the tile's rows 8..15 are all past M (a
    // decode step of at most 8 rows), which then skip the ADC
    auto count = [&](auto evals) {
      constexpr int kEvals = decltype(evals)::value;
#pragma unroll 1
      for (int pair = 0; pair < 4; ++pair) {
        const int sa = pair >> 1;   // (a+, w+), (a+, w-), (a-, w+), (a-, w-)
        const int sw = pair & 1;
        const float sign = sa == sw ? 1.0f : -1.0f;
#pragma unroll 1
        for (int c = 0; c < nch; ++c) {
          const unsigned* apc = ap + c * kAPlanes * TM * kPlaneWords;
          const unsigned* wpc = wp + c * kWPlanes * kTileN * kPlaneWords;
          const uint8_t* pcc = pc + (c * 2 + sw) * kPlanes * kTileN;
          // the thread's columns: table rows and lsbs of each plane
          int off[kPlanes][kNT][2];
          float lsb[kPlanes][kNT][2];
#pragma unroll
          for (int j = 0; j < kPlanes; ++j) {
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int p = pcc[j * kTileN + cw + 8 * nt + 2 * t + h];
                off[j][nt][h] = adc_row(p);
                lsb[j][nt][h] = lsb_s[p];
              }
            }
          }
          // the sign masks of the pair: the A rows' and the B columns'
          unsigned amask[kMT][2];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const unsigned s = apc[(kActBits * TM + 16 * mt + 8 * h + g8) *
                                         kPlaneWords + t];
              amask[mt][h] = sa ? s : ~s;
            }
          }
          unsigned bmask[kNT];
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const unsigned s =
                wpc[(kPlanes * kTileN + cw + 8 * nt + g8) * kPlaneWords + t];
            bmask[nt] = sw ? s : ~s;
          }
          // two groups in flight where the tile is one m16 tile high
#pragma unroll(TM == 16 ? 2 : 1)
          for (int g = 0; g < kGroups; ++g) {
            unsigned lo[kMT][2], hi[kMT][2];
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = 16 * mt + 8 * h + g8;
                lo[mt][h] =
                    apc[((2 * g) * TM + r) * kPlaneWords + t] & amask[mt][h];
                hi[mt][h] =
                    apc[((2 * g + 1) * TM + r) * kPlaneWords + t] &
                    amask[mt][h];
              }
            }
            // sign * 4^g, exact
            const float gcoef = sign * __int2float_rn(1 << (2 * g));
#pragma unroll
            for (int j = 0; j < kPlanes; ++j) {
              const float coef =
                  __fmul_rn(gcoef, static_cast<float>(1 << j));
              unsigned b[kNT];
              float lsbc[kNT][2], big[kNT][2];
#pragma unroll
              for (int nt = 0; nt < kNT; ++nt) {
                b[nt] =
                    wpc[(j * kTileN + cw + 8 * nt + g8) * kPlaneWords + t] &
                    bmask[nt];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  lsbc[nt][h] = __fmul_rn(lsb[j][nt][h], coef);
                  big[nt][h] = __fmul_rn(lsbc[nt][h], -8388608.0f);
                }
              }
#pragma unroll
              for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
                for (int nt = 0; nt < kNT; ++nt) {
                  const int off4[4] = {off[j][nt][0], off[j][nt][1],
                                       off[j][nt][0], off[j][nt][1]};
                  const int zero4[4] = {0, 0, 0, 0};
                  int dl[4], dh[4];
                  mma_b1(dl, lo[mt][0], lo[mt][1], b[nt], off4);
                  mma_b1(dh, hi[mt][0], hi[mt][1], b[nt], zero4);
#pragma unroll
                  for (int i = 0; i < kEvals; ++i) {
                    part[mt][nt][i] = __fadd_rn(
                        part[mt][nt][i],
                        adc_sensed(smem, dl[i] + 2 * dh[i], lsbc[nt][i & 1],
                                   big[nt][i & 1]));
                  }
                }
              }
            }
          }
        }
      }
    };
    if constexpr (TM == 16) {
      if (m0 + 8 >= act.m) {
        count(std::integral_constant<int, 2>{});
      } else {
        count(std::integral_constant<int, 4>{});
      }
    } else {
      count(std::integral_constant<int, 4>{});
    }


    // the k-block's p: one rounding for * scale, one for acc + p
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int tr = 16 * mt + 8 * (i >> 1) + g8;
          float p = part[mt][nt][i];
          if constexpr (Act::kScaled) p = __fmul_rn(p, scale_s[tr]);
          if (split) {
            const long long row = m0 + tr;
            const int col = n0 + cw + 8 * nt + 2 * t + (i & 1);
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
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long row = m0 + 16 * mt + 8 * (i >> 1) + g8;
        const int col = n0 + cw + 8 * nt + 2 * t + (i & 1);
        if (row >= act.m || col >= W.n) continue;
        out[row * W.n + col] = acc[mt][nt][i];
      }
    }
  }
}

}  // namespace mma
}  // namespace repro_torch
