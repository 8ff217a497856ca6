// softmax_rows: row softmax through the dual-mode unit.
//
// Replaces repro/kernels/dualmode_softmax.py:softmax_pallas (pallas_call
// at :82).  precision=int: quantize to S5.10, softmax_int (Eq. 10 in the
// log2 domain), dequantize at 2^-14.  precision=float: datapath.row_softmax.
//
// Bound on the H100: memory.  It reads each input once and writes each
// output once (8 bytes per element) against a handful of int32 ops per
// element, far below the card's ops-per-byte balance.
//
// Design: one block of 256 threads per row, three strided sweeps over the
// row (max, guard-shifted int32 sum, emit).  The row is re-read from
// global memory on each sweep; at the main path's rows (n = 2048, 8 KB)
// the second and third sweeps hit L1/L2.  The int reductions are
// associative, so the words are bitwise equal to softmax_int whatever the
// reduction order.  guard_shift comes from the caller, from the UNPADDED
// row length n (there is no lane padding on the GPU; the ragged edge is
// the loop bound).
#include <cuda_runtime.h>

#include <cmath>

#include "block_reduce.cuh"
#include "unit.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
softmax_rows_int_kernel(const float* __restrict__ x, float* __restrict__ y,
                        int n, int guard_shift) {
  __shared__ int32_t red[32];
  const float* row = x + static_cast<size_t>(blockIdx.x) * n;
  float* out = y + static_cast<size_t>(blockIdx.x) * n;

  int32_t m = unit::IN_MIN;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    m = max(m, unit::quantize(row[i], unit::IN_FRAC));
  m = block_reduce(m, MaxOp(), static_cast<int32_t>(unit::IN_MIN), red);

  int32_t s = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int32_t t = unit::to_log2_domain(unit::quantize(row[i], unit::IN_FRAC) - m,
                                     unit::IN_FRAC);
    s += unit::exp2_int(t) >> guard_shift;
  }
  s = block_reduce(s, SumOp(), 0, red);
  s = s < 1 ? 1 : s;
  const int32_t log2s = unit::log2_int(s, unit::EXP_FRAC - guard_shift);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int32_t t = unit::to_log2_domain(unit::quantize(row[i], unit::IN_FRAC) - m,
                                     unit::IN_FRAC);
    int32_t w = t - log2s;
    out[i] = unit::dequantize(unit::exp2_int(w < 0 ? w : 0), unit::EXP_FRAC);
  }
}

__global__ void __launch_bounds__(kThreads)
softmax_rows_float_kernel(const float* __restrict__ x, float* __restrict__ y,
                          int n) {
  __shared__ float red[32];
  const float* row = x + static_cast<size_t>(blockIdx.x) * n;
  float* out = y + static_cast<size_t>(blockIdx.x) * n;

  float m = -INFINITY;
  for (int i = threadIdx.x; i < n; i += blockDim.x) m = fmaxf(m, row[i]);
  m = block_reduce(m, MaxOp(), -INFINITY, red);

  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s += exp2f((row[i] - m) * unit::LOG2E);
  s = block_reduce(s, SumOp(), 0.0f, red);
  const float log2s = log2f(s);

  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[i] = exp2f((row[i] - m) * unit::LOG2E - log2s);
}

}  // namespace

// x, y: (rows, n) float32, contiguous.  precision: 1 = int, 0 = float.
extern "C" int softmax_rows_launch(const float* x, float* y, int rows, int n,
                                   int precision, int guard_shift,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (precision == 1)
    softmax_rows_int_kernel<<<rows, kThreads, 0, st>>>(x, y, n, guard_shift);
  else
    softmax_rows_float_kernel<<<rows, kThreads, 0, st>>>(x, y, n);
  return static_cast<int>(cudaGetLastError());
}
