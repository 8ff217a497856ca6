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
// Design: norm_gemm_sm90.cuh's pipelined body with two matrices a tile:
// 128 x 64 of each (8 x 4 x 2 accumulators a thread) from 128 rows, 64 x 64
// below, 16 x 128 for a decode tick with K split so every SM streams Wg /
// Wu, three 16 KB chunks in flight a block, and 64 x 64 with 4-byte copies
// wherever d, F or a pointer is not a multiple of four floats
// (kernels/tiling.norm_gemm_plan).
// A split writes its (g, u) partial sums into an (split, M, 2F) scratch;
// finish_kernel sums the splits in order and applies the epilogue.
#include <cuda_runtime.h>

#include "norm_gemm_sm90.cuh"
#include "unit.cuh"

namespace {

using namespace ngemm;

__device__ __forceinline__ float glu_out(float g, float u, bool gelu) {
  return (gelu ? unit::pair_act_f32<true>(g) : unit::pair_act_f32<false>(g)) * u;
}

// Split 1: out (M, F) gets act(g) * u.  Split z of several: the partial
// sums g at part[z][m][c] and u at part[z][m][F + c].
template <class T>
__global__ void __launch_bounds__(kThreads, 2) norm_glu_kernel(Args a, int split, int gelu) {
  extern __shared__ __align__(16) float sm[];
  const int n = a.mats[0].n;
  int mt, ct;
  tile_coords(blockIdx.x, cdiv(a.M, T::BM), a.tiles, mt, ct);
  const int c0 = ct * T::BN, m0 = mt * T::BM, z = blockIdx.y;
  const int chunk0 = z * a.chunks;
  const int nchunks = max(0, min(a.chunks, cdiv(a.K, kBK) - chunk0));
  const float* const w[2] = {a.mats[0].w + c0, a.mats[1].w + c0};
  float acc[2][T::TM][T::TN];
  gemm_block<T>(a, sm, m0, w, c0, n, chunk0, nchunks, acc);
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int m = m0 + frag_pos<T::TM, T::TY>(ty, i);
    if (m >= a.M) continue;
    if (split == 1) {
      float y[T::TN];
#pragma unroll
      for (int j = 0; j < T::TN; ++j) y[j] = glu_out(acc[0][i][j], acc[1][i][j], gelu);
      store_frag<T::TN, T::TX, T::VEC>(a.out + static_cast<size_t>(m) * n + c0, tx, y, n - c0);
    } else {
      float* row = a.out + (static_cast<size_t>(z) * a.M + m) * 2 * n + c0;
      store_frag<T::TN, T::TX, T::VEC>(row, tx, acc[0][i], n - c0);
      store_frag<T::TN, T::TX, T::VEC>(row + n, tx, acc[1][i], n - c0);
    }
  }
}

// out[m][c] = act(sum_z g) * (sum_z u), z in order
__global__ void __launch_bounds__(kThreads)
    finish_kernel(const float* __restrict__ part, float* __restrict__ out, int M, int F,
                  int split, int gelu) {
  const size_t n = static_cast<size_t>(M) * F, stride = 2 * n;
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * kThreads) {
    const size_t m = i / F, c = i % F, at = m * 2 * F + c;
    float g = part[at], u = part[at + F];
    for (int z = 1; z < split; ++z) {
      g += part[z * stride + at];
      u += part[z * stride + at + F];
    }
    out[i] = glu_out(g, u, gelu);
  }
}

template <class T>
int launch(Args a, int layer, float eps, float* stats, float* part, int split, int gelu,
           cudaStream_t st) {
  cudaError_t e = launch_moments<T::VEC>(a.x, stats, a.M, a.K, layer, eps, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = allow_smem(norm_glu_kernel<T>, T::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  float* out = a.out;
  a.stats = stats;
  a.chunks = cdiv(cdiv(a.K, kBK), split);
  if (split > 1) a.out = part;
  a.tiles = cdiv(a.mats[0].n, T::BN);
  const dim3 grid(a.tiles * cdiv(a.M, T::BM), split);
  norm_glu_kernel<T><<<grid, kThreads, T::BYTES, st>>>(a, split, gelu);
  e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return static_cast<int>(e);
  const size_t n = static_cast<size_t>(a.M) * a.mats[0].n;
  const int blocks = static_cast<int>(n / kThreads < 4096 ? cdiv(static_cast<int>(n), kThreads)
                                                          : 4096);
  finish_kernel<<<blocks, kThreads, 0, st>>>(part, out, a.M, a.mats[0].n, split, gelu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
  a.out = out;
  a.M = M;
  a.K = K;
  a.mats[0] = Matrix{wg, F, 0, 0};
  a.mats[1] = Matrix{wu, F, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gelu = mode == 0;
  const auto go = [&](auto tile) {
    using T = decltype(tile);
    return launch<T>(a, layer, eps, stats, part, split, gelu, st);
  };
  if (vec == 4 && bm == 128 && bn == 64) return go(Tile<16, 8, 4, 2, 4>{});
  if (vec == 4 && bm == 64 && bn == 64) return go(Tile<16, 4, 4, 2, 4>{});
  if (vec == 4 && bm == 16 && bn == 128) return go(Tile<4, 4, 2, 2, 4>{});
  if (vec == 1 && bm == 64 && bn == 64) return go(Tile<16, 4, 4, 2, 1>{});
  return static_cast<int>(cudaErrorInvalidValue);
}
