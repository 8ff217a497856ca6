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
// Design: one block of 256 threads per row.  The block adds x + r in
// one coalesced sweep, writes the sum, keeps it in shared memory (d
// words, 16 KB at d 4096) and accumulates the moments; block_reduce.cuh
// folds them; a second sweep over shared memory writes the normalized
// row.  Moments in f32 with 1/d as the f32 word and rsqrt as
// exp2(-0.5 log2(v + eps)): the datapath's contract (fused_norm._hat).
#include <cuda_runtime.h>

#include "block_reduce.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kLayer>
__global__ void __launch_bounds__(kThreads)
resnorm_kernel(const float* __restrict__ x, const float* __restrict__ r,
               const float* __restrict__ g, const float* __restrict__ b,
               float* __restrict__ xo, float* __restrict__ ho, int d, float eps) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  float s = 0.0f, ss = 0.0f;
  for (int k = threadIdx.x; k < d; k += kThreads) {
    const float v = x[base + k] + r[base + k];
    row[k] = v;
    xo[base + k] = v;
    s += v;
    ss += v * v;
  }
  const float inv_n = 1.0f / static_cast<float>(d);
  s = block_reduce(s, SumOp(), 0.0f, red);
  ss = block_reduce(ss, SumOp(), 0.0f, red);
  float mu = 0.0f, var = ss * inv_n;
  if (kLayer) {
    mu = s * inv_n;
    var = fmaxf(var - mu * mu, 0.0f);
  }
  const float rs = exp2f(-0.5f * log2f(var + eps));
  for (int k = threadIdx.x; k < d; k += kThreads) {
    float h = (kLayer ? row[k] - mu : row[k]) * rs * g[k];
    if (b != nullptr) h += b[k];
    ho[base + k] = h;
  }
}

template <bool kLayer>
int launch(const float* x, const float* r, const float* g, const float* b, float* xo,
           float* ho, int M, int d, float eps, cudaStream_t st) {
  const size_t smem = sizeof(float) * static_cast<size_t>(d);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(resnorm_kernel<kLayer>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  resnorm_kernel<kLayer><<<M, kThreads, smem, st>>>(x, r, g, b, xo, ho, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, r, xo, ho (M, d); g, b (d) (b null for rms); all f32, contiguous.
// layer: 0 rms, 1 layer norm.
extern "C" int resnorm_launch(const float* x, const float* r, const float* g,
                              const float* b, float* xo, float* ho, int M, int d,
                              int layer, float eps, void* stream) {
  if (M < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return layer ? launch<true>(x, r, g, b, xo, ho, M, d, eps, st)
               : launch<false>(x, r, g, b, xo, ho, M, d, eps, st);
}
