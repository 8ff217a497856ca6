// glu: act(x @ Wg) * (x @ Wu) -- the gated FFN with its activation
// epilogue fused.
//
// Replaces repro/kernels/fused_ffn.py:_fused_glu_jit (pallas_call at
// :133).  The (M, F) gate and up products never reach device memory:
// each block holds both accumulators of its output tile in registers and
// writes pair_act(g) * u once.  pair_act is the float datapath's pair
// mode from unit.cuh (z * softmax_1^2([k, -k]), k = z / 2 for SiLU or
// the tanh-form cubic for GELU), the same arithmetic as pair_act.cu.
//
// Bound on the H100, at d 4096 and F 11008 (yi-6b's FFN): a decode tick
// (M = 4) moves the 360.7 MB of Wg and Wu for 0.72 GFLOP -- bytes; a
// prefill chunk (M = 64) does 11.5 GFLOP -- float32 operations on the
// CUDA cores (full f32 products, no TF32 or tensor cores).
//
// Design: norm_gemm.cuh's tiled body with two weight matrices sharing
// each x chunk.  344 column tiles of 32 at F 11008, so even a decode
// tick's single row tile spreads the weight stream over every SM.
#include <cuda_runtime.h>

#include "norm_gemm.cuh"
#include "unit.cuh"

namespace {

using namespace norm_gemm;

constexpr int kBK = 32;   // two weight chunks a stage: 8 KB in flight a block

template <int TM, bool kGelu>
__global__ void __launch_bounds__(kThreads) glu_kernel(Args a) {
  __shared__ Smem<TM, kBK> sm;
  const int m0 = blockIdx.y * (kTY * TM);
  const int c0 = blockIdx.x * kBN;
  const int n = a.mats[0].n;
  float acc_g[TM][kTN], acc_u[TM][kTN];
  gemm_tile<TM, kBK, true>(a, m0, a.mats[0].w + c0, a.mats[1].w + c0, c0, n,
                                  sm, acc_g, acc_u);
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = c0 + tx * kTN + j;
      if (c < n)
        a.out[static_cast<size_t>(m) * a.ld_out + c] =
            unit::pair_act_f32<kGelu>(acc_g[i][j]) * acc_u[i][j];
    }
  }
}

template <int TM>
int launch(const Args& a, bool gelu, cudaStream_t st) {
  const dim3 grid((a.mats[0].n + kBN - 1) / kBN, (a.M + kTY * TM - 1) / (kTY * TM));
  if (gelu)
    glu_kernel<TM, true><<<grid, kThreads, 0, st>>>(a);
  else
    glu_kernel<TM, false><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K), wg / wu (K, F), out (M, F) f32, all contiguous.
// mode: 0 = gelu, 1 = silu.  (bm, bk): the tile, one of (16, 32),
// (32, 32), (64, 32).
extern "C" int glu_launch(const float* x, const float* wg, const float* wu, float* out,
                          int M, int K, int F, int mode, int bm, int bk,
                          void* stream) {
  if (M < 1 || K < 1 || F < 1 || mode < 0 || mode > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = x;
  a.out = out;
  a.M = M;
  a.K = K;
  a.ld_out = F;
  a.mats[0] = Matrix{wg, F};
  a.mats[1] = Matrix{wu, F};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool gelu = mode == 0;
  if (bk != kBK) return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 16) return launch<1>(a, gelu, st);
  if (bm == 32) return launch<2>(a, gelu, st);
  if (bm == 64) return launch<4>(a, gelu, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
