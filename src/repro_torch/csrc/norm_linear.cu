// norm_linear: norm(x) @ [w0 | w1 | w2] -- the norm -> QKV prologue.
//
// Replaces repro/kernels/fused_norm.py:_norm_linear_jit (pallas_call at
// :217).  h = norm(x) * g + b is never written to device memory: the block
// normalizes each x chunk in shared memory once it has landed
// (norm_gemm_sm90.cuh).  The three projections are read in place; the
// reference concatenates [wq|wk|wv] into one (d, F) panel on every call
// (attention.py:271).
//
// Bound on the H100, at d 4096 and F 5120 (yi-6b's QKV): a decode tick
// (M = 4) moves the 83.9 MB of weights for 0.17 GFLOP -- bytes; a prefill
// chunk (M = 64) does 2.68 GFLOP on 85 MB and a bucket or an encoder batch
// (M = 4096) 14.5 to 206 GFLOP -- float32 operations on the CUDA cores (no
// tensor cores: full f32 products, as the reference's contract and the
// plain version).
//
// Design: norm_gemm_sm90.cuh's pipelined body (moments first, a cp.async
// ring, normalize after landing), one matrix a tile.  Tiles from
// kernels/tiling.norm_gemm_plan: 128 x 128 (8 x 8 outputs a thread) from
// 128 rows; 64 x 128 below, with K split so a 64-row chunk fills the SMs;
// 16 x 256 for a decode tick, K split likewise, each block keeping three
// 16 KB weight chunks in flight; 64 x 128 with 4-byte copies wherever K, a
// width or a pointer is not a multiple of four floats.  Split partials land in an
// (split, M, sum n) scratch, summed in split order by sum_splits_kernel.
#include <cuda_runtime.h>

#include "norm_gemm_sm90.cuh"

namespace {

using namespace ngemm;

template <class T>
__global__ void __launch_bounds__(kThreads, 2) norm_linear_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  int mt, tile;
  tile_coords(blockIdx.x, cdiv(a.M, T::BM), a.tiles, mt, tile);
  const int m0 = mt * T::BM, z = blockIdx.y;
  Matrix mat = a.mats[0];   // constant indices: no local copy
  if (a.n_mats > 1 && tile >= a.mats[1].tile0) mat = a.mats[1];
  if (a.n_mats > 2 && tile >= a.mats[2].tile0) mat = a.mats[2];
  const int c0 = (tile - mat.tile0) * T::BN;
  const int chunk0 = z * a.chunks;
  const int nchunks = max(0, min(a.chunks, cdiv(a.K, kBK) - chunk0));
  const float* const w[2] = {mat.w + c0, nullptr};
  float acc[1][T::TM][T::TN];
  gemm_block<T>(a, sm, m0, w, c0, mat.n, chunk0, nchunks, acc);
  // the output's column slice of this matrix, or split z's partial sums in
  // the same layout
  float* out = a.out + static_cast<size_t>(z) * a.M * a.ld_out + mat.out_col + c0;
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int m = m0 + frag_pos<T::TM, T::TY>(ty, i);
    if (m < a.M)
      store_frag<T::TN, T::TX, T::VEC>(out + static_cast<size_t>(m) * a.ld_out, tx, acc[0][i],
                                       mat.n - c0);
  }
}

// out[i] = sum over z of part[z][i], z in order
__global__ void __launch_bounds__(kThreads)
    sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out, size_t n,
                      int split) {
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * kThreads) {
    float s = part[i];
    for (int z = 1; z < split; ++z) s += part[z * n + i];
    out[i] = s;
  }
}

template <class T>
int launch(Args a, int tiles, int layer, float eps, float* stats, float* part, int split,
           cudaStream_t st) {
  cudaError_t e = launch_moments<T::VEC>(a.x, stats, a.M, a.K, layer, eps, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = allow_smem(norm_linear_kernel<T>, T::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  float* out = a.out;
  a.stats = stats;
  a.chunks = cdiv(cdiv(a.K, kBK), split);
  if (split > 1) a.out = part;
  a.tiles = tiles;
  const dim3 grid(tiles * cdiv(a.M, T::BM), split);
  norm_linear_kernel<T><<<grid, kThreads, T::BYTES, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return static_cast<int>(e);
  const size_t n = static_cast<size_t>(a.M) * a.ld_out;
  const int blocks = static_cast<int>(n / kThreads < 4096 ? cdiv(static_cast<int>(n), kThreads)
                                                          : 4096);
  sum_splits_kernel<<<blocks, kThreads, 0, st>>>(part, out, n, split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K), g / b (K) (b null for rms), w_i (K, n_i) for i < n_mats (unused
// pointers null), out (M, n_0 + ...), stats (M, 2) scratch, part (split, M,
// n_0 + ...) scratch (null when split is 1); f32, contiguous.  layer: 0
// rms, 1 layer norm.  (bm, bn, vec): the tile and copy width, one of (128,
// 128, 4), (64, 128, 4), (16, 256, 4), (64, 128, 1); split >= 1 K ranges.
// vec 4 needs K, every width and every pointer a multiple of 16 bytes.
extern "C" int norm_linear_launch(const float* x, const float* g, const float* b,
                                  const float* w0, int n0, const float* w1, int n1,
                                  const float* w2, int n2, int n_mats, float* out,
                                  float* stats, float* part, int M, int K, int layer,
                                  float eps, int bm, int bn, int split, int vec,
                                  void* stream) {
  if (M < 1 || K < 1 || n_mats < 1 || n_mats > kMaxMats || g == nullptr ||
      stats == nullptr || split < 1 || (split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = x;
  a.g = g;
  a.b = b;
  a.out = out;
  a.M = M;
  a.K = K;
  a.n_mats = n_mats;
  const float* ws[kMaxMats] = {w0, w1, w2};
  const int ns[kMaxMats] = {n0, n1, n2};
  bool vec_ok = K % 4 == 0 && aligned16(x) && aligned16(g) && aligned16(b) &&
                aligned16(out) && aligned16(part);
  int col = 0, tiles = 0;
  for (int i = 0; i < n_mats; ++i) {
    if (ns[i] < 1 || ws[i] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    vec_ok = vec_ok && ns[i] % 4 == 0 && aligned16(ws[i]);
    a.mats[i] = Matrix{ws[i], ns[i], col, tiles};
    col += ns[i];
    tiles += cdiv(ns[i], bn);
  }
  a.ld_out = col;
  if (vec == 4 && !vec_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto tile) {
    using T = decltype(tile);
    return launch<T>(a, tiles, layer, eps, stats, part, split, st);
  };
  if (vec == 4 && bm == 128 && bn == 128) return go(Tile<16, 8, 8, 1, 4>{});
  if (vec == 4 && bm == 64 && bn == 128) return go(Tile<16, 4, 8, 1, 4>{});
  if (vec == 4 && bm == 16 && bn == 256) return go(Tile<4, 4, 4, 1, 4>{});
  if (vec == 1 && bm == 64 && bn == 128) return go(Tile<16, 4, 8, 1, 1>{});
  return static_cast<int>(cudaErrorInvalidValue);
}
