// pair_act: GELU / SiLU elementwise as z * softmax_1^2([k, -k]) (Eq. 8).
//
// Replaces repro/kernels/dualmode_softmax.py:pair_act_pallas (pallas_call
// at :121).  precision=int: gelu_int / silu_int on the quantized z,
// dequantized at 2^-10 (the unit's GELU/SiLU mode, bitwise).
// precision=float: datapath.pair_act.
//
// Bound on the H100: memory (4 bytes in, 4 bytes out per element against
// a few dozen int32 ops, under the card's ops-per-byte balance).
//
// Design: one grid-stride elementwise pass, 256 threads per block and
// enough blocks to fill the card; neighbouring threads touch neighbouring
// words, so every load and store is coalesced.
#include <cuda_runtime.h>

#include "unit.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kGelu, bool kInt>
__global__ void __launch_bounds__(kThreads)
pair_act_kernel(const float* __restrict__ z, float* __restrict__ y, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float v = z[i];
    if (kInt) {
      const int32_t q = unit::quantize(v, unit::IN_FRAC);
      const int32_t r = kGelu ? unit::gelu_int(q) : unit::silu_int(q);
      y[i] = unit::dequantize(r, unit::IN_FRAC);
    } else {
      y[i] = unit::pair_act_f32<kGelu>(v);
    }
  }
}

}  // namespace

// z, y: n float32 words, contiguous.  mode: 0 = gelu, 1 = silu.
// precision: 1 = int, 0 = float.
extern "C" int pair_act_launch(const float* z, float* y, long long n, int mode,
                               int precision, int n_sm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long want = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(n_sm) * 8;
  const int blocks = static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
  if (mode == 0 && precision == 1)
    pair_act_kernel<true, true><<<blocks, kThreads, 0, st>>>(z, y, n);
  else if (mode == 0)
    pair_act_kernel<true, false><<<blocks, kThreads, 0, st>>>(z, y, n);
  else if (precision == 1)
    pair_act_kernel<false, true><<<blocks, kThreads, 0, st>>>(z, y, n);
  else
    pair_act_kernel<false, false><<<blocks, kThreads, 0, st>>>(z, y, n);
  return static_cast<int>(cudaGetLastError());
}
