// pair_act: GELU / SiLU elementwise as z * softmax_1^2([k, -k]) (Eq. 8).
//
// Replaces repro/kernels/dualmode_softmax.py:pair_act_pallas (pallas_call
// at :121).  precision=int: gelu_int / silu_int on the quantized z,
// dequantized at 2^-10 (the unit's GELU/SiLU mode, bitwise).
// precision=float: datapath.pair_act (unit::pair_act_f32).
//
// Bound on the H100: memory for the float mode (4 bytes in, 4 bytes out
// per element against four MUFU ops).  The int mode runs some dozens of
// int32 instructions an element, and Hopper issues int32 at half its f32
// rate, so its body is bound by instruction issue, not by memory (PERF.md
// counts them from the SASS).
//
// Design: a grid-stride elementwise pass of 256-thread blocks.  Where both
// pointers are on 16 bytes (VEC = 4) a thread moves a float4 a trip and
// the last n % 4 words go a float at a time; otherwise every word does.
// The float mode launches a thread for every float4 and no loop (the
// loads of the whole grid in flight, which launch-style probes on the
// H100 found fastest); the int mode caps the grid at 8 blocks an SM, so
// each block fills its shared-memory copy of the ROM (unit::RomTable) once
// for many trips.  The int body takes the one-exponent pair form
// (unit::pair_softmax_first_int) and one 8-byte shared load a PWL lookup.
#include <cuda_runtime.h>

#include <cstdint>

#include "unit.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kGelu, bool kInt>
__device__ __forceinline__ float act(float v, const unit::RomTable& rom) {
  if (kInt) {
    const int32_t q = unit::quantize(v, unit::IN_FRAC);
    const int32_t r = kGelu ? unit::gelu_int(q, rom) : unit::silu_int(q, rom);
    return unit::dequantize(r, unit::IN_FRAC);
  }
  return unit::pair_act_f32<kGelu>(v);
}

template <bool kGelu, bool kInt, int VEC>
__global__ void __launch_bounds__(kThreads)
pair_act_kernel(const float* __restrict__ z, float* __restrict__ y, long long n) {
  __shared__ int2 rom_tab[16];
  if (kInt) {
    if (threadIdx.x < 16) unit::rom_fill(rom_tab, threadIdx.x);
    __syncthreads();
  }
  const unit::RomTable rom{rom_tab};
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long done = 0;
  if (VEC == 4 && !kInt) {
    // a thread for every float4 (no loop); the first n % 4 threads also
    // take the tail
    const long long n4 = n / 4;
    if (tid < n4) {
      float4 a = __ldg(reinterpret_cast<const float4*>(z) + tid);
      a.x = act<kGelu, kInt>(a.x, rom);
      a.y = act<kGelu, kInt>(a.y, rom);
      a.z = act<kGelu, kInt>(a.z, rom);
      a.w = act<kGelu, kInt>(a.w, rom);
      reinterpret_cast<float4*>(y)[tid] = a;
    }
    if (tid < (n & 3)) y[4 * n4 + tid] = act<kGelu, kInt>(__ldg(z + 4 * n4 + tid), rom);
    return;
  }
  if (VEC == 4) {
    const long long n4 = n / 4;
    const float4* z4 = reinterpret_cast<const float4*>(z);
    float4* y4 = reinterpret_cast<float4*>(y);
#pragma unroll 1
    for (long long i = tid; i < n4; i += stride) {
      float4 a = __ldg(z4 + i);
      a.x = act<kGelu, kInt>(a.x, rom);
      a.y = act<kGelu, kInt>(a.y, rom);
      a.z = act<kGelu, kInt>(a.z, rom);
      a.w = act<kGelu, kInt>(a.w, rom);
      y4[i] = a;
    }
    done = 4 * n4;
  }
#pragma unroll 1
  for (long long i = done + tid; i < n; i += stride)
    y[i] = act<kGelu, kInt>(__ldg(z + i), rom);
}

template <bool kGelu, bool kInt, int VEC>
int launch(const float* z, float* y, long long n, int n_sm, cudaStream_t st) {
  const long long per_thread = VEC == 4 ? 4 : 1;
  const long long want = (n + per_thread * kThreads - 1) / (per_thread * kThreads);
  const long long cap = kInt ? static_cast<long long>(n_sm) * 8 : want;
  const int blocks = static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
  pair_act_kernel<kGelu, kInt, VEC><<<blocks, kThreads, 0, st>>>(z, y, n);
  return static_cast<int>(cudaGetLastError());
}

template <bool kGelu, bool kInt>
int launch_vec(int vec, const float* z, float* y, long long n, int n_sm,
               cudaStream_t st) {
  return vec == 4 ? launch<kGelu, kInt, 4>(z, y, n, n_sm, st)
                  : launch<kGelu, kInt, 1>(z, y, n, n_sm, st);
}

}  // namespace

// z, y: n float32 words, contiguous.  mode: 0 = gelu, 1 = silu.
// precision: 1 = int, 0 = float.  vec: 4 (16-byte loads and stores; both
// pointers must be on 16 bytes) or 1; anything else is refused
// (cudaErrorInvalidValue) before any launch.
extern "C" int pair_act_launch(const float* z, float* y, long long n, int mode,
                               int precision, int vec, int n_sm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((vec != 1 && vec != 4) ||
      (vec == 4 && ((reinterpret_cast<uintptr_t>(z) |
                     reinterpret_cast<uintptr_t>(y)) & 15)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 0 && precision == 1)
    return launch_vec<true, true>(vec, z, y, n, n_sm, st);
  if (mode == 0)
    return launch_vec<true, false>(vec, z, y, n, n_sm, st);
  if (precision == 1)
    return launch_vec<false, true>(vec, z, y, n, n_sm, st);
  return launch_vec<false, false>(vec, z, y, n, n_sm, st);
}
