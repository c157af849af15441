// Device routine of the macro math, ideal mode: the CUDA counterpart of
// repro/kernels/cim_matmul.py::cim_block_dot (mode 'ideal'), the exact
// int8 x int8 dot that the Pallas kernels run on the MXU.  The plain
// PyTorch version of all three modes is repro_torch/kernels/cim_matmul.py.
//
// Operands sit in shared memory as packed words: each int holds four
// consecutive int8 values along K (activations by row, ROM weights by
// column), so one __dp4a does four signed multiply-adds into an int32.
// A chunk is one 128-row subarray (32 words); the dot over it is exact
// (|sum| <= 128 * 127 * 127 < 2**31), and callers convert to f32 only
// after a whole k-block, where the sum stays below 2**24 and the
// conversion is exact too.
//
// per_subarray / bitserial device routines are not ported yet (ROADMAP
// Queue 2).
#pragma once

namespace repro_torch {

// acc[i][j] += sum_kw dp4a(xs[row0 + i*row_step][kw], ws[col0 + j*col_step][kw])
// xs, ws: word arrays with row stride LDS (padded against bank conflicts).
template <int TM, int TN, int KW, int LDS>
__device__ __forceinline__ void cim_block_dot_ideal(
    const int* __restrict__ xs, const int* __restrict__ ws, int row0,
    int row_step, int col0, int col_step, int (&acc)[TM][TN]) {
#pragma unroll 4
  for (int kw = 0; kw < KW; ++kw) {
    int a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = xs[(row0 + i * row_step) * LDS + kw];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = ws[(col0 + j * col_step) * LDS + kw];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
  }
}

}  // namespace repro_torch
