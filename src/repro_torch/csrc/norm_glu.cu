// norm_glu: act(norm(x) @ Wg) * (norm(x) @ Wu) -- the norm -> gated-GLU
// prologue, the FFN seam of blocks whose attention epilogue made no normed
// stream ('none'-mixer and cross-attention blocks).
//
// Replaces repro/kernels/fused_norm.py:_norm_glu_jit (pallas_call at
// :302, body _norm_glu_body).  Neither the normalized stream h =
// norm(x) * g + b nor the (M, F) gate and up products reach device memory:
// each block normalizes its x chunks as it stages them (norm_linear.cu's
// prologue) and holds both products of its output tile in registers
// (glu.cu's epilogue), writing pair_act(h Wg) * (h Wu) once.
//
// Bound on the H100, at d 4096 and F 14336 (llama-3.2-vision's FFN): a
// decode tick (M = 4) moves the 470 MB of Wg and Wu for 0.94 GFLOP --
// bytes; a prefill bucket (M = 512 .. 4096) does 4 M d F = 120 .. 962
// GFLOP of full float32 FMAs on the CUDA cores -- operations.
//
// Design: norm_gemm.cuh's tiled body with both its options on: the moment
// sweep of the block's rows first (one warp a row, mu and rs kept in
// shared memory), then two weight matrices sharing each normalized x
// chunk.  448 column tiles of 32 at F 14336, so a decode tick's single row
// tile still spreads the weight stream over every SM.  Tiles from
// kernels/tiling.matmul_blocks(m, norm_prologue=True, glu=True): the GLU's
// pairs, since the kernel reads two matrices a chunk as the GLU does.
#include <cuda_runtime.h>

#include "norm_gemm.cuh"
#include "unit.cuh"

namespace {

using namespace norm_gemm;

constexpr int kBK = 32;   // two weight chunks a stage: 8 KB in flight a block

template <int TM, bool kGelu>
__global__ void __launch_bounds__(kThreads) norm_glu_kernel(Args a) {
  __shared__ Smem<TM, kBK> sm;
  const int m0 = blockIdx.y * (kTY * TM);
  const int c0 = blockIdx.x * kBN;
  const int n = a.mats[0].n;
  row_moments<TM, kBK>(a, m0, sm);
  float acc_g[TM][kTN], acc_u[TM][kTN];
  gemm_tile<TM, kBK, true, true>(a, m0, a.mats[0].w + c0, a.mats[1].w + c0, c0, n,
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
    norm_glu_kernel<TM, true><<<grid, kThreads, 0, st>>>(a);
  else
    norm_glu_kernel<TM, false><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K), g / b (K) (b null for rms), wg / wu (K, F), out (M, F) f32,
// all contiguous.  layer: 0 rms, 1 layer norm.  mode: 0 = gelu, 1 = silu.
// (bm, bk): the tile, one of (16, 32), (32, 32), (64, 32).
extern "C" int norm_glu_launch(const float* x, const float* g, const float* b,
                               const float* wg, const float* wu, float* out, int M,
                               int K, int F, int layer, float eps, int mode, int bm,
                               int bk, void* stream) {
  if (M < 1 || K < 1 || F < 1 || mode < 0 || mode > 1 || g == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = x;
  a.g = g;
  a.b = b;
  a.out = out;
  a.M = M;
  a.K = K;
  a.ld_out = F;
  a.n_mats = 2;
  a.mats[0] = Matrix{wg, F, 0, 0};
  a.mats[1] = Matrix{wu, F, 0, 0};
  a.layer = layer;
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool gelu = mode == 0;
  if (bk != kBK) return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 16) return launch<1>(a, gelu, st);
  if (bm == 32) return launch<2>(a, gelu, st);
  if (bm == 64) return launch<4>(a, gelu, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
