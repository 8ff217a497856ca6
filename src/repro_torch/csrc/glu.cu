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
// Bound on the H100: at d 4096 and F 11008 (yi-6b's FFN) a decode tick
// (M = 4) moves the 360.7 MB of Wg and Wu for 0.72 GFLOP -- bytes; a
// prefill chunk (M = 64) does 11.5 GFLOP and llama-3.2-vision's
// bucket-4096 prefill (F 14336) 962 GFLOP -- float32 operations on the
// CUDA cores (full f32 products, no TF32 or tensor cores).
//
// Design: glu_sm90.cuh's two-matrix kernel on norm_gemm_sm90.cuh's
// pipelined body without its norm prologue (no moments pass; the landed x
// chunk is only moved k-major): a cp.async ring three 16-deep chunks
// ahead, 128 x 64 tiles of each matrix (8 x 4 x 2 accumulators a thread)
// from 128 rows, 64 x 64 below, 16 x 128 for a decode tick, K split where
// the tiles leave SMs idle (a 64-row chunk of yi-6b: three ranges, two
// full waves), and 64 x 64 with 4-byte copies wherever d, F or a pointer
// is not a multiple of four floats (kernels/tiling.norm_gemm_plan with
// glu=True).
#include <cuda_runtime.h>

#include "glu_sm90.cuh"

using namespace ngemm;

// x (M, K), wg / wu (K, F), out (M, F), part (split, M, 2F) scratch (null
// when split is 1); f32, contiguous.  mode: 0 = gelu, 1 = silu.  (bm, bn,
// vec): the tile (bn columns of each matrix) and copy width, one of (128,
// 64, 4), (64, 64, 4), (16, 128, 4), (64, 64, 1); split >= 1 K ranges.
// vec 4 needs K, F and every pointer a multiple of 16 bytes.
extern "C" int glu_launch(const float* x, const float* wg, const float* wu, float* out,
                          float* part, int M, int K, int F, int mode, int bm, int bn, int split,
                          int vec, void* stream) {
  if (M < 1 || K < 1 || F < 1 || mode < 0 || mode > 1 || x == nullptr || wg == nullptr ||
      wu == nullptr || out == nullptr || split < 1 || (split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_ok = K % 4 == 0 && F % 4 == 0 && aligned16(x) && aligned16(wg) &&
                      aligned16(wu) && aligned16(out) && aligned16(part);
  if (vec == 4 && !vec_ok) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = x;
  a.M = M;
  a.K = K;
  a.mats[0] = Matrix{wg, F, 0, 0};
  a.mats[1] = Matrix{wu, F, 0, 0};
  const GluFwd epi{out, mode == 0};
  return with_glu_tile<false>(bm, bn, vec, [&](auto tile) {
    return launch_glu<decltype(tile)>(a, part, split, epi, static_cast<cudaStream_t>(stream));
  });
}
