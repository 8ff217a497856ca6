// norm_glu: act(norm(x) @ Wg) * (norm(x) @ Wu) -- the norm -> gated-GLU
// prologue, the FFN seam of blocks whose attention epilogue made no normed
// stream ('none'-mixer and cross-attention blocks).
//
// Replaces repro/kernels/fused_norm.py:_norm_glu_jit (pallas_call at
// :302, body _norm_glu_body).  Neither the normalized stream h =
// norm(x) * g + b nor the (M, F) gate and up products reach device memory:
// the block normalizes each x chunk in shared memory once it has landed
// (norm_linear.cu's prologue) and holds both products of its output tile in
// registers (glu.cu's epilogue), writing pair_act(h Wg) * (h Wu) once.
//
// Bound on the H100, at d 4096 and F 14336 (llama-3.2-vision's FFN): a
// decode tick (M = 4) moves the 470 MB of Wg and Wu for 0.94 GFLOP --
// bytes; a prefill bucket (M = 512 .. 4096) does 4 M d F = 120 .. 962
// GFLOP of full float32 FMAs on the CUDA cores -- operations.
//
// Design: glu_sm90.cuh's two-matrix kernel (rows 12 and 13 run it
// without the prologue) on norm_gemm_sm90.cuh's pipelined body:
// 128 x 64 of each (8 x 4 x 2 accumulators a thread) from 128 rows, 64 x 64
// below, 16 x 128 for a decode tick with K split so every SM streams Wg /
// Wu, three 16 KB chunks in flight a block, and 64 x 64 with 4-byte copies
// wherever d, F or a pointer is not a multiple of four floats
// (kernels/tiling.norm_gemm_plan).
// A split writes its (g, u) partial sums into an (split, M, 2F) scratch;
// glu_sm90.cuh's finish_kernel sums the splits in order and applies the
// epilogue.
#include <cuda_runtime.h>

#include "glu_sm90.cuh"

using namespace ngemm;

// x (M, K), g / b (K) (b null for rms), wg / wu (K, F), out (M, F), stats
// (M, 2) scratch, part (split, M, 2F) scratch (null when split is 1); f32,
// contiguous.  layer: 0 rms, 1 layer norm.  mode: 0 = gelu, 1 = silu.
// (bm, bn, vec): the tile (bn columns of each matrix) and copy width, one
// of (128, 64, 4), (64, 64, 4), (16, 128, 4), (64, 64, 1); split >= 1 K
// ranges.  vec 4 needs K, F and every pointer a multiple of 16 bytes.
extern "C" int norm_glu_launch(const float* x, const float* g, const float* b,
                               const float* wg, const float* wu, float* out, float* stats,
                               float* part, int M, int K, int F, int layer, float eps,
                               int mode, int bm, int bn, int split, int vec, void* stream) {
  if (M < 1 || K < 1 || F < 1 || mode < 0 || mode > 1 || g == nullptr || wg == nullptr ||
      wu == nullptr || stats == nullptr || split < 1 || (split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_ok = K % 4 == 0 && F % 4 == 0 && aligned16(x) && aligned16(g) &&
                      aligned16(b) && aligned16(wg) && aligned16(wu) && aligned16(out) &&
                      aligned16(part);
  if (vec == 4 && !vec_ok) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = x;
  a.g = g;
  a.b = b;
  a.stats = stats;
  a.M = M;
  a.K = K;
  a.mats[0] = Matrix{wg, F, 0, 0};
  a.mats[1] = Matrix{wu, F, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GluFwd epi{out, mode == 0};
  return with_glu_tile<true>(bm, bn, vec, [&](auto tile) {
    using T = decltype(tile);
    const cudaError_t e = launch_moments<T::VEC>(x, stats, M, K, layer, eps, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    return launch_glu<T>(a, part, split, epi, st);
  });
}
