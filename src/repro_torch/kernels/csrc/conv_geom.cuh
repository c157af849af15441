// The implicit im2col map of the trunk-conv kernel (trunk_conv.cu), read by
// the NHWC activation source of mma_tile.cuh (NhwcAct), which the int8 and
// the bitserial tiles share.
//
// Row m of the patch matrix P [M, R] (M = N OH OW, R = kh kw C, tap-major)
// is the output pixel (img, oh, ow); its column kk is the tap t = kk / C,
// channel c = kk % C, and reads
//
//   x[img, oh * stride + t / kw - ph0, ow * stride + t % kw - pw0, c]
//
// or 0 where that pixel lies in the padding: P's entry exactly
// (kernels/rebranch_conv.py::patch_matrix), without P.  The pads and OH, OW
// come from the wrapper (core/cim.py::conv_pads); nothing here recomputes
// them.  The sources tabulate a tile's rows (row_pixel) and a k-block's
// columns (col_tap) once per k-block in shared memory, so that no division
// runs per element.  Limits, checked by the C entry: C < 2**15, kw < 2**8,
// kh < 2**7, M and the elements of x below 2**31 (offsets are ints).
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// kernels/rebranch_conv.py::ConvGeom mirrors it field for field.
struct ConvGeom {
  int n;        // x [n, h, w, c] f32, contiguous
  int h;
  int w;
  int c;
  int oh;       // output [n, oh, ow]
  int ow;
  int kh;       // taps kh x kw
  int kw;
  int stride;
  int ph0;      // top and left pads
  int pw0;
};

// Output row `row`'s window: (x's pixel index of (img, 0, 0), the window's
// top input row, its left input column, 1), or all 0 at or past M.
__device__ __forceinline__ int4 row_pixel(const ConvGeom& g, long long m,
                                          long long row) {
  if (row >= m) return make_int4(0, 0, 0, 0);
  const unsigned r = static_cast<unsigned>(row);
  const unsigned ohw = static_cast<unsigned>(g.oh * g.ow);
  const unsigned img = r / ohw;
  const unsigned rem = r - img * ohw;
  const unsigned oh = rem / static_cast<unsigned>(g.ow);
  const unsigned ow = rem - oh * static_cast<unsigned>(g.ow);
  return make_int4(static_cast<int>(img) * g.h * g.w,
                   static_cast<int>(oh) * g.stride - g.ph0,
                   static_cast<int>(ow) * g.stride - g.pw0, 1);
}

// Column kk's tap row, tap column and channel, packed
// c | (t % kw) << 16 | (t / kw) << 24 (bit 15 is kNoTap's).
__device__ __forceinline__ int col_tap(const ConvGeom& g, int kk) {
  const int t = kk / g.c;
  const int c = kk - t * g.c;
  const int dh = t / g.kw;
  return c | (t - dh * g.kw) << 16 | dh << 24;
}

// A packed tap that reads nothing: a column past the k-block.
constexpr int kNoTap = 1 << 15;

// The offset in x of (row window p, packed column tap), or -1 where the
// pixel lies in the padding, the row past M or the column past the block
// (kNoTap).  Branch-free, so that a gather of many values keeps its loads
// in flight together.
__device__ __forceinline__ int tap_offset(const ConvGeom& g, int4 p,
                                          int tap) {
  const int ih = p.y + (tap >> 24);
  const int iw = p.z + ((tap >> 16) & 0xff);
  const bool in = p.w && !(tap & kNoTap) &&
                  static_cast<unsigned>(ih) < static_cast<unsigned>(g.h) &&
                  static_cast<unsigned>(iw) < static_cast<unsigned>(g.w);
  return in ? (p.x + ih * g.w + iw) * g.c + (tap & 0x7fff) : -1;
}

// Four zeros in device memory: a gather reads padded pixels from here, so
// every load is unconditional.
static __device__ __align__(16) const float kZeros[4] = {0.0f, 0.0f, 0.0f,
                                                        0.0f};

// The address of x's value (or float4 of four channels) at `off`, or of
// kZeros where off < 0.
template <class T>
__device__ __forceinline__ const T* tap_ptr(const float* x, int off) {
  return reinterpret_cast<const T*>(off >= 0 ? x + off : kZeros);
}

}  // namespace repro_torch
