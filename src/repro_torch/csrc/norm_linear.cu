// norm_linear: norm(x) @ [w0 | w1 | w2] -- the norm -> QKV prologue.
//
// Replaces repro/kernels/fused_norm.py:_norm_linear_jit (pallas_call at
// :217).  h = norm(x) * g + b is never written to device memory: each
// block normalizes its x chunks as it stages them (norm_gemm.cuh).  The
// three projections are read in place; the reference concatenates
// [wq|wk|wv] into one (d, F) panel on every call (attention.py:271).
//
// Bound on the H100, at d 4096 and F 5120 (yi-6b's QKV): a decode tick
// (M = 4) moves the 83.9 MB of weights for 0.17 GFLOP -- bytes; a
// prefill chunk (M = 64) does 2.68 GFLOP on 85 MB -- float32 operations
// on the CUDA cores (no tensor cores: full f32 products, as the
// reference's contract and the plain version).
//
// Design: norm_gemm.cuh's tiled body.  A grid of 32-column tiles (160
// for F 5120) x row tiles sized to M.  A decode tick's single 16-row
// tile walks K 128 deep, so each block keeps 16 KB of weights in flight;
// a 64-row prefill chunk takes two 32-row tiles, 320 blocks.
#include <cuda_runtime.h>

#include "norm_gemm.cuh"

namespace {

using namespace norm_gemm;

template <int TM, int BK>
__global__ void __launch_bounds__(kThreads) norm_linear_kernel(Args a) {
  __shared__ Smem<TM, BK> sm;
  const int m0 = blockIdx.y * (kTY * TM);
  const int tile = blockIdx.x;          // constant indices: no local copy
  Matrix mat = a.mats[0];
  if (a.n_mats > 1 && tile >= a.mats[1].tile0) mat = a.mats[1];
  if (a.n_mats > 2 && tile >= a.mats[2].tile0) mat = a.mats[2];
  const int c0 = (tile - mat.tile0) * kBN;
  row_moments<TM, BK>(a, m0, sm);
  float acc[TM][kTN], unused[TM][kTN];
  gemm_tile<TM, BK, true, false>(a, m0, mat.w + c0, nullptr, c0, mat.n, sm, acc,
                                 unused);
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = c0 + tx * kTN + j;
      if (c < mat.n)
        a.out[static_cast<size_t>(m) * a.ld_out + mat.out_col + c] = acc[i][j];
    }
  }
}

template <int TM, int BK>
int launch(const Args& a, int tiles, cudaStream_t st) {
  const dim3 grid(tiles, (a.M + kTY * TM - 1) / (kTY * TM));
  norm_linear_kernel<TM, BK><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K), g / b (K) (b null for rms), w_i (K, n_i) for i < n_mats
// (unused pointers null), out (M, n_0 + ... ) f32, all contiguous.
// layer: 0 rms, 1 layer norm.  (bm, bk): the tile, one of (16, 128),
// (32, 32), (64, 32).
extern "C" int norm_linear_launch(const float* x, const float* g, const float* b,
                                  const float* w0, int n0, const float* w1, int n1,
                                  const float* w2, int n2, int n_mats, float* out,
                                  int M, int K, int layer, float eps, int bm, int bk,
                                  void* stream) {
  if (M < 1 || K < 1 || n_mats < 1 || n_mats > kMaxMats)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = x;
  a.g = g;
  a.b = b;
  a.out = out;
  a.M = M;
  a.K = K;
  a.n_mats = n_mats;
  a.layer = layer;
  a.eps = eps;
  const float* ws[kMaxMats] = {w0, w1, w2};
  const int ns[kMaxMats] = {n0, n1, n2};
  int col = 0, tiles = 0;
  for (int i = 0; i < n_mats; ++i) {
    if (ns[i] < 1 || ws[i] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    a.mats[i] = Matrix{ws[i], ns[i], col, tiles};
    col += ns[i];
    tiles += (ns[i] + kBN - 1) / kBN;
  }
  a.ld_out = col;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 16 && bk == 128) return launch<1, 128>(a, tiles, st);
  if (bm == 32 && bk == 32) return launch<2, 32>(a, tiles, st);
  if (bm == 64 && bk == 32) return launch<4, 32>(a, tiles, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
