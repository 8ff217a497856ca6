// resnorm: (x + r, norm(x + r) * g + b) -- the residual-add + norm
// epilogue between a sublayer and the next one's input.
//
// Replaces repro/kernels/fused_norm.py:_resnorm_jit (pallas_call at
// :134).  Both outputs come from one read of x and r: the sum is the new
// residual stream and, normalized, the next sublayer's input; the
// unfused graph writes the sum and reads it back for the norm.
//
// Bound on the H100: memory.  A row of d words reads 8d bytes and writes
// 8d against ~10 flops a word, far under the card's ops-per-byte
// balance; at d 4096 a prefill chunk (M = 64) moves 4.2 MB (1.25 us at
// 3.35 TB/s) and a decode tick (M = 4) 262 KB, where the launch dominates.
//
// Design (tiling.resnorm_plan picks the scheme, the words a thread holds
// and the copy width; this file instantiates exactly those):
// 1. The row in registers.  Rows up to 1024 words: a warp a row, 8 rows a
//    block; up to 8192: a block of 256 threads a row.  Thread t of the RT
//    threads that share a row holds chunk j of VEC floats at (j RT + t) VEC,
//    WORDS floats in all, read once from x and r and written once to each
//    output: no shared-memory copy of the row.  Longer rows are streamed:
//    the second sweep reads the sum back from xo (each thread its own
//    words), so nothing of the row is held.
// 2. 16-byte loads and stores where d % 4 == 0 and all six pointers sit on
//    16 bytes; anything else moves 4 bytes a copy on the same plan.
// 3. One fused (s, ss) reduction in a fixed order: each thread's words in
//    j order, the xor butterfly of its warp, then the block's warps in warp
//    order.  No atomics, so two calls give the same bits.
// 4. Few rows stay one block a row: spreading a row of a decode tick (M 4)
//    or a prefill chunk (M 64) over a thread-block cluster of 2 or 4
//    blocks, folded through distributed shared memory, ran 3-23% slower
//    under graph replay on the H100 (PERF.md section 6).
// Moments in f32 with 1/d as the f32 word and rsqrt as
// exp2(-0.5 log2(v + eps)): the datapath's contract (fused_norm._hat).
#include <cuda_runtime.h>

#include "sm90_tile.cuh"

namespace {

constexpr int kThreads = 256;

constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Args {
  const float* x;
  const float* r;
  const float* g;
  const float* b;  // null for rms
  float* xo;
  float* ho;
  int M, d;
  float eps;
};

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

// Sum (s, ss) over the 32 lanes of a warp: the xor butterfly, every lane
// ending with the same bits (each step adds two values, in either order).
__device__ __forceinline__ void warp_moments(float& s, float& ss) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
}

// (s, ss) of the whole row: the warps' sums in warp order (RT == 256).
// Every thread of the row gets the same bits.
template <int RT>
__device__ __forceinline__ void row_moments(float& s, float& ss) {
  warp_moments(s, ss);
  if constexpr (RT == kThreads) {
    __shared__ float2 red[kThreads / 32];
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_float2(s, ss);
    __syncthreads();
    float2 t = red[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) t.x += red[w].x, t.y += red[w].y;
    s = t.x, ss = t.y;
  }
}

// (mu, rs) of a row from its moments
template <bool kLayer>
__device__ __forceinline__ float2 row_stats(float s, float ss, int d, float eps) {
  const float inv_n = 1.0f / static_cast<float>(d);
  float mu = 0.0f, var = ss * inv_n;
  if (kLayer) {
    mu = s * inv_n;
    var = fmaxf(var - mu * mu, 0.0f);
  }
  return make_float2(mu, exp2f(-0.5f * log2f(var + eps)));
}

// the gain and bias of VEC words of a row at column c (no bias: rms)
template <int VEC>
__device__ __forceinline__ void gain_bias(const Args& a, int c, float (&gv)[VEC],
                                          float (&bv)[VEC]) {
  load_vec<VEC>(a.g + c, gv);
  if (a.b != nullptr) load_vec<VEC>(a.b + c, bv);
}

// h of VEC words of a row from its sums v, gains gv and biases bv
template <bool kLayer, int VEC>
__device__ __forceinline__ void normed(const Args& a, float2 st, const float (&v)[VEC],
                                       const float (&gv)[VEC], const float (&bv)[VEC],
                                       float (&h)[VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    h[e] = (kLayer ? v[e] - st.x : v[e]) * st.y * gv[e];
    if (a.b != nullptr) h[e] += bv[e];
  }
}

// A held row: RT threads of a block share it (RT 32: a warp a row, 8 rows a
// block; RT 256: the block); each thread holds WORDS floats in chunks of
// VEC.  Up to 16 words a thread it also holds their gains and biases,
// loaded with x and r, so that no read of device memory waits behind the
// reduction (0.4-0.5 us off a decode tick's or a prefill chunk's row at d
// 4096 on the H100); at 32 words the registers that takes cost more than
// it saves (bert's rows of 768 ran 17% slower).
template <bool kLayer, int RT, int VEC, int WORDS>
__global__ void __launch_bounds__(kThreads) resnorm_held(Args a) {
  constexpr int NCH = WORDS / VEC;
  constexpr bool kEarly = WORDS <= 16;  // gains and biases with x and r
  static_assert(WORDS % VEC == 0, "whole chunks");
  const int row = blockIdx.x * (kThreads / RT) + threadIdx.x / RT;
  const int t = threadIdx.x % RT;
  // a row past M (the last block of the warp scheme) still joins the
  // reductions; it neither reads nor writes
  const bool live = row < a.M;
  const size_t base = static_cast<size_t>(live ? row : 0) * a.d;
  float v[NCH][VEC], gv[kEarly ? NCH : 1][VEC], bv[kEarly ? NCH : 1][VEC];
  float s = 0.0f, ss = 0.0f;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = (j * RT + t) * VEC;
    if (live && c < a.d) {
      float xv[VEC], rv[VEC];
      load_vec<VEC>(a.x + base + c, xv);
      load_vec<VEC>(a.r + base + c, rv);
      if constexpr (kEarly) gain_bias<VEC>(a, c, gv[j], bv[j]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        v[j][e] = xv[e] + rv[e];
        s += v[j][e];
        ss += v[j][e] * v[j][e];
      }
      store_vec<VEC>(a.xo + base + c, v[j]);
    }
  }
  row_moments<RT>(s, ss);
  const float2 st = row_stats<kLayer>(s, ss, a.d, a.eps);
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = (j * RT + t) * VEC;
    if (live && c < a.d) {
      const int jg = kEarly ? j : 0;
      if constexpr (!kEarly) gain_bias<VEC>(a, c, gv[0], bv[0]);
      float h[VEC];
      normed<kLayer, VEC>(a, st, v[j], gv[jg], bv[jg], h);
      store_vec<VEC>(a.ho + base + c, h);
    }
  }
}

// A streamed row (longer than a block holds): one block a row, the first
// sweep writes the sum and takes the moments in the held order, the second
// reads each thread's own sums back from xo.
template <bool kLayer, int VEC>
__global__ void __launch_bounds__(kThreads) resnorm_stream(Args a) {
  const size_t base = static_cast<size_t>(blockIdx.x) * a.d;
  float s = 0.0f, ss = 0.0f;
  for (int c = threadIdx.x * VEC; c < a.d; c += kThreads * VEC) {
    float xv[VEC], rv[VEC], v[VEC];
    load_vec<VEC>(a.x + base + c, xv);
    load_vec<VEC>(a.r + base + c, rv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      v[e] = xv[e] + rv[e];
      s += v[e];
      ss += v[e] * v[e];
    }
    store_vec<VEC>(a.xo + base + c, v);
  }
  row_moments<kThreads>(s, ss);
  const float2 st = row_stats<kLayer>(s, ss, a.d, a.eps);
  for (int c = threadIdx.x * VEC; c < a.d; c += kThreads * VEC) {
    float v[VEC], gv[VEC], bv[VEC], h[VEC];
    load_vec<VEC>(a.xo + base + c, v);
    gain_bias<VEC>(a, c, gv, bv);
    normed<kLayer, VEC>(a, st, v, gv, bv, h);
    store_vec<VEC>(a.ho + base + c, h);
  }
}

// the held entry for ``words`` among W, 2W, ... up to 32
template <bool kLayer, int RT, int VEC, int W>
int held_words(const Args& a, int words, cudaStream_t st) {
  if (words == W) {
    resnorm_held<kLayer, RT, VEC, W><<<cdiv(a.M, kThreads / RT), kThreads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (W < 32) return held_words<kLayer, RT, VEC, W * 2>(a, words, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The instances tiling.resnorm_plan names: a warp or a block a row with
// 1..32 words (at least VEC) at either copy width; the stream.
template <bool kLayer>
int dispatch(const Args& a, int rt, int words, int vec, cudaStream_t st) {
  if (words == 0) {
    if (rt != kThreads) return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = a.M;
    if (vec == 4)
      resnorm_stream<kLayer, 4><<<blocks, kThreads, 0, st>>>(a);
    else
      resnorm_stream<kLayer, 1><<<blocks, kThreads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (rt == 32)
    return vec == 4 ? held_words<kLayer, 32, 4, 4>(a, words, st)
                    : held_words<kLayer, 32, 1, 1>(a, words, st);
  if (rt == kThreads)
    return vec == 4 ? held_words<kLayer, kThreads, 4, 4>(a, words, st)
                    : held_words<kLayer, kThreads, 1, 1>(a, words, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, r, xo, ho (M, d); g, b (d) (b null for rms); all f32, contiguous.
// layer: 0 rms, 1 layer norm.  (row_threads, words, vec): the plan's fields
// (tiling.resnorm_plan); words 0 is the streamed scheme.  Refuses what it
// does not instantiate, 16-byte copies where d % 4 != 0 or a pointer is off
// 16 bytes, and held words that do not cover the row.
extern "C" int resnorm_launch(const float* x, const float* r, const float* g,
                              const float* b, float* xo, float* ho, int M, int d,
                              int layer, float eps, int row_threads, int words, int vec,
                              void* stream) {
  using sm90::aligned16;
  if (M < 1 || d < 1 || (vec != 1 && vec != 4) ||
      (vec == 4 && (d % 4 != 0 || !aligned16(x) || !aligned16(r) || !aligned16(g) ||
                    !aligned16(b) || !aligned16(xo) || !aligned16(ho))) ||
      (words > 0 && static_cast<long long>(words) * row_threads < d))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, r, g, b, xo, ho, M, d, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return layer ? dispatch<true>(a, row_threads, words, vec, st)
               : dispatch<false>(a, row_threads, words, vec, st);
}
