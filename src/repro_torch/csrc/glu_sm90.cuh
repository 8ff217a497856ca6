// The gated-GLU kernel on norm_gemm_sm90.cuh's body, shared by glu.cu (row
// 12, the fused GLU), glu_bwd.cu (row 13, its backward) and norm_glu.cu (row
// 16, norm -> gated GLU): two matrices of one width F a tile, both products
// of the block's output tile in registers, then an epilogue.  The prologue
// (the norm, or none) is the tile's, the epilogue a parameter:
//
//   GluFwd  out = pair_act(g) * u
//   GluBwd  d_gate = dY * u * pair_act'(g),  d_up = dY * pair_act(g)
//
// pair_act and its derivative are unit.cuh's float pair mode (the
// datapath's pair_act / pair_act_grad; SiLU or the tanh-form GELU), in the
// plain versions' order.  Neither g nor u reaches device memory with one K
// range.  With a split K (tiling.norm_gemm_plan), split z writes its
// partial sums g at part[z][m][c] and u at part[z][m][F + c]; finish_kernel
// sums the splits in order and applies the same epilogue.  No float
// atomics: two calls give the same bits.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "norm_gemm_sm90.cuh"
#include "unit.cuh"

namespace ngemm {

__device__ __forceinline__ float glu_act(float g, bool gelu) {
  return gelu ? unit::pair_act_f32<true>(g) : unit::pair_act_f32<false>(g);
}

__device__ __forceinline__ float glu_act_grad(float g, bool gelu) {
  return gelu ? unit::pair_act_grad_f32<true>(g) : unit::pair_act_grad_f32<false>(g);
}

// out (M, F) = act(g) * u
struct GluFwd {
  float* out;
  int gelu;

  template <int TN, int TX, int VEC>
  __device__ __forceinline__ void tile(size_t row, int c0, int tx, const float (&g)[TN],
                                       const float (&u)[TN], int n) const {
    float y[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) y[j] = glu_act(g[j], gelu) * u[j];
    store_frag<TN, TX, VEC>(out + row + c0, tx, y, n);
  }

  __device__ __forceinline__ void at(size_t i, float g, float u) const {
    out[i] = glu_act(g, gelu) * u;
  }
};

// d_gate, d_up (M, F) from dy (M, F)
struct GluBwd {
  const float* dy;
  float* d_gate;
  float* d_up;
  int gelu;

  template <int TN, int TX, int VEC>
  __device__ __forceinline__ void tile(size_t row, int c0, int tx, const float (&g)[TN],
                                       const float (&u)[TN], int n) const {
    float d[TN], dg[TN], du[TN];
    load_row_frag<TN, TX, VEC>(dy + row + c0, tx, d, n);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      dg[j] = d[j] * u[j] * glu_act_grad(g[j], gelu);
      du[j] = d[j] * glu_act(g[j], gelu);
    }
    store_frag<TN, TX, VEC>(d_gate + row + c0, tx, dg, n);
    store_frag<TN, TX, VEC>(d_up + row + c0, tx, du, n);
  }

  __device__ __forceinline__ void at(size_t i, float g, float u) const {
    const float d = dy[i];
    d_gate[i] = d * u * glu_act_grad(g, gelu);
    d_up[i] = d * glu_act(g, gelu);
  }
};

// Split 1: the epilogue on the block's tile.  Split z of several: the
// partial sums into a.out, (split, M, 2F).
template <class T, class Epi>
__global__ void __launch_bounds__(kThreads, 2) glu_kernel(Args a, int split, Epi epi) {
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
      epi.template tile<T::TN, T::TX, T::VEC>(static_cast<size_t>(m) * n, c0, tx, acc[0][i],
                                              acc[1][i], n - c0);
    } else {
      float* row = a.out + (static_cast<size_t>(z) * a.M + m) * 2 * n + c0;
      store_frag<T::TN, T::TX, T::VEC>(row, tx, acc[0][i], n - c0);
      store_frag<T::TN, T::TX, T::VEC>(row + n, tx, acc[1][i], n - c0);
    }
  }
}

// The epilogue on (sum_z g, sum_z u) at every (m, c), z in order
template <class Epi>
__global__ void __launch_bounds__(kThreads)
    finish_kernel(const float* __restrict__ part, int M, int F, int split, Epi epi) {
  const size_t n = static_cast<size_t>(M) * F, stride = 2 * n;
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * kThreads) {
    const size_t m = i / F, c = i % F, at = m * 2 * F + c;
    float g = part[at], u = part[at + F];
    for (int z = 1; z < split; ++z) {
      g += part[z * stride + at];
      u += part[z * stride + at + F];
    }
    epi.at(i, g, u);
  }
}

// The GEMM over a (x, stats with the prologue, mats[0] = Wg, mats[1] = Wu,
// both of width F) in ``split`` K ranges, then the finish pass when there
// are several; part is the (split, M, 2F) scratch.
template <class T, class Epi>
int launch_glu(Args a, float* part, int split, Epi epi, cudaStream_t st) {
  cudaError_t e = allow_smem(glu_kernel<T, Epi>, T::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  a.chunks = cdiv(cdiv(a.K, kBK), split);
  a.out = part;
  a.tiles = cdiv(a.mats[0].n, T::BN);
  const dim3 grid(a.tiles * cdiv(a.M, T::BM), split);
  glu_kernel<T, Epi><<<grid, kThreads, T::BYTES, st>>>(a, split, epi);
  e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return static_cast<int>(e);
  const size_t n = static_cast<size_t>(a.M) * a.mats[0].n;
  const int blocks = static_cast<int>(n / kThreads < 4096 ? cdiv(static_cast<int>(n), kThreads)
                                                          : 4096);
  finish_kernel<<<blocks, kThreads, 0, st>>>(part, a.M, a.mats[0].n, split, epi);
  return static_cast<int>(cudaGetLastError());
}

// The tile of (bm, bn, vec) -- one of (128, 64, 4), (64, 64, 4), (16, 128,
// 4), (64, 64, 1), the GLU bands of tiling.norm_gemm_plan -- handed to
// go(Tile{}), or cudaErrorInvalidValue.
template <bool NORM, class Go>
int with_glu_tile(int bm, int bn, int vec, Go go) {
  if (vec == 4 && bm == 128 && bn == 64) return go(Tile<16, 8, 4, 2, 4, NORM>{});
  if (vec == 4 && bm == 64 && bn == 64) return go(Tile<16, 4, 4, 2, 4, NORM>{});
  if (vec == 4 && bm == 16 && bn == 128) return go(Tile<4, 4, 2, 2, 4, NORM>{});
  if (vec == 1 && bm == 64 && bn == 64) return go(Tile<16, 4, 4, 2, 1, NORM>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ngemm
