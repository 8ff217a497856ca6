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
// Design: glu.cu's kernel (glu_sm90.cuh, no norm prologue) with the
// backward epilogue: each thread reads its dY fragment of the tile (16
// bytes at a time where the copies are) and writes its d_gate and d_up
// fragments; with a split K the finish pass reads dY after the fixed-order
// sum.  Tiles, K split and copy width from kernels/tiling.norm_gemm_plan
// (glu=True), as the forward's: at the training shape 128 x 64 of each
// matrix, 64 x 44 tiles, one K range.
#include <cuda_runtime.h>

#include "glu_sm90.cuh"

using namespace ngemm;

// x (M, K), wg / wu (K, F), dy / d_gate / d_up (M, F), part (split, M, 2F)
// scratch (null when split is 1); f32, contiguous.  mode: 0 = gelu, 1 =
// silu.  (bm, bn, vec, split) as glu_launch's; vec 4 needs K, F and every
// pointer a multiple of 16 bytes.
extern "C" int glu_bwd_launch(const float* x, const float* wg, const float* wu,
                              const float* dy, float* d_gate, float* d_up, float* part, int M,
                              int K, int F, int mode, int bm, int bn, int split, int vec,
                              void* stream) {
  if (M < 1 || K < 1 || F < 1 || mode < 0 || mode > 1 || x == nullptr || wg == nullptr ||
      wu == nullptr || dy == nullptr || d_gate == nullptr || d_up == nullptr || split < 1 ||
      (split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_ok = K % 4 == 0 && F % 4 == 0 && aligned16(x) && aligned16(wg) &&
                      aligned16(wu) && aligned16(dy) && aligned16(d_gate) && aligned16(d_up) &&
                      aligned16(part);
  if (vec == 4 && !vec_ok) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = x;
  a.M = M;
  a.K = K;
  a.mats[0] = Matrix{wg, F, 0, 0};
  a.mats[1] = Matrix{wu, F, 0, 0};
  const GluBwd epi{dy, d_gate, d_up, mode == 0};
  return with_glu_tile<false>(bm, bn, vec, [&](auto tile) {
    return launch_glu<decltype(tile)>(a, part, split, epi, static_cast<cudaStream_t>(stream));
  });
}
