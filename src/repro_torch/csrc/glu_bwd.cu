// glu_bwd: the fused GLU's backward tiles -- recompute g = x @ Wg and
// u = x @ Wu, and write
//   d_gate = dY * u * pair_act'(g),   d_up = dY * pair_act(g).
//
// Replaces repro/kernels/fused_ffn.py:_glu_bwd_call (pallas_call at :79,
// body _ffn_bwd_body).  As in the reference, the (M, F) g and u tiles
// never reach device memory; the four products around this kernel (dx,
// dWg, dWu) stay plain matmuls in the caller.  pair_act and its
// derivative are unit.cuh's float pair mode (datapath.pair_act /
// pair_act_grad): the same exponentials the forward kernel (glu.cu) ran.
//
// Bound on the H100, at qwen1.5-0.5b's training shape (M = 8192 tokens,
// d 1024, F 2816): 4 M K F = 94.5 GFLOP of full float32 FMAs against
// ~0.3 GB of operands -- operations, ~1.4 ms at 67 TFLOP/s.
//
// Design: glu.cu's kernel with another epilogue.  norm_gemm.cuh's tiled
// body holds both products of the block's output tile in registers; the
// epilogue reads the dY tile itself (each thread its TM rows x 2
// columns) and writes the two cotangent tiles.  Tiles from
// kernels/tiling.matmul_blocks, as the forward's.
#include <cuda_runtime.h>

#include "norm_gemm.cuh"
#include "unit.cuh"

namespace {

using namespace norm_gemm;

constexpr int kBK = 32;

template <int TM, bool kGelu>
__global__ void __launch_bounds__(kThreads)
    glu_bwd_kernel(Args a, const float* __restrict__ dy, float* __restrict__ d_up) {
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
      if (c < n) {
        const size_t off = static_cast<size_t>(m) * a.ld_out + c;
        const float g = acc_g[i][j], d = dy[off];
        a.out[off] = d * acc_u[i][j] * unit::pair_act_grad_f32<kGelu>(g);
        d_up[off] = d * unit::pair_act_f32<kGelu>(g);
      }
    }
  }
}

template <int TM>
int launch(const Args& a, const float* dy, float* d_up, bool gelu, cudaStream_t st) {
  const dim3 grid((a.mats[0].n + kBN - 1) / kBN, (a.M + kTY * TM - 1) / (kTY * TM));
  if (gelu)
    glu_bwd_kernel<TM, true><<<grid, kThreads, 0, st>>>(a, dy, d_up);
  else
    glu_bwd_kernel<TM, false><<<grid, kThreads, 0, st>>>(a, dy, d_up);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K), wg / wu (K, F), dy / d_gate / d_up (M, F) f32, all
// contiguous.  mode: 0 = gelu, 1 = silu.  (bm, bk): the tile, one of
// (16, 32), (32, 32), (64, 32).
extern "C" int glu_bwd_launch(const float* x, const float* wg, const float* wu,
                              const float* dy, float* d_gate, float* d_up, int M,
                              int K, int F, int mode, int bm, int bk, void* stream) {
  if (M < 1 || K < 1 || F < 1 || mode < 0 || mode > 1 || bk != kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = x;
  a.out = d_gate;
  a.M = M;
  a.K = K;
  a.ld_out = F;
  a.mats[0] = Matrix{wg, F};
  a.mats[1] = Matrix{wu, F};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool gelu = mode == 0;
  if (bm == 16) return launch<1>(a, dy, d_up, gelu, st);
  if (bm == 32) return launch<2>(a, dy, d_up, gelu, st);
  if (bm == 64) return launch<4>(a, dy, d_up, gelu, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
