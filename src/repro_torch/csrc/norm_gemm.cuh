// The first tiled float32 GEMM body, under the fused GLU's epilogues:
// glu.cu (the forward, row 12) and glu_bwd.cu (the backward tiles, row
// 13).  The norm -> QKV and norm -> gated-GLU kernels (rows 15 and 16) left
// it for norm_gemm_sm90.cuh, the pipelined Hopper body; rows 12 and 13 move
// there in their own change, and this header goes with them.
//
//   out[m, c] = epilogue( sum_k x[m, k] * W[k, c] )
//
// Shapes: x (M, K) row-major; the two weight matrices (Wg, Wu) (K, n)
// row-major, read in place, the same column tile of both.
//
// Grid: one block of 256 threads per (BN = 32 output columns, BM = 16 x
// TM rows); thread (ty, tx) of the 16 x 16 layout holds TM rows x 2
// columns in registers (two accumulators a position for the GLU).  K is
// walked in chunks of BK: the block stages the x chunk (BM x BK,
// transposed so a thread's TM rows are one vector load) and the weight
// chunk (BK x BN, each matrix) in shared memory, then every thread runs
// its outer products from there.  (BM, BK) come from the wrapper
// (kernels/tiling.matmul_blocks); each kernel instantiates the pairs the
// policy picks and refuses the others.  Each thread loads the next chunk into
// registers before computing on the current one, so global loads stay in
// flight during the FMAs.  Full float32 FMAs on the CUDA cores: no TF32,
// no tensor cores.
//
// Ragged edges are the pad-and-slice rule done in registers: rows past
// M, columns past a matrix's width and k past K load as zeros and are
// never stored, so no operand is padded in device memory.
#pragma once

#include <cuda_runtime.h>

namespace norm_gemm {

constexpr int kThreads = 256;
constexpr int kTX = 16;           // thread columns of the block
constexpr int kTY = 16;           // thread rows of the block
constexpr int kTN = 2;            // output columns a thread holds
constexpr int kBN = kTX * kTN;    // output columns a block holds

struct Matrix {
  const float* w;   // (K, n) row-major
  int n;            // its width
};

struct Args {
  const float* x;   // (M, K)
  float* out;       // (M, ld_out)
  int M, K, ld_out;
  Matrix mats[2];   // Wg, Wu
};

template <int TM, int BK>
struct alignas(16) Smem {
  float a[BK][kTY * TM + 4];    // x chunk, transposed (k-major), padded
  float w[2][BK][kBN];          // weight chunk(s)
};

// One thread's share of a K chunk, held in registers from its global
// load until it is stored to shared memory: the next chunk's loads are
// in flight while the block computes on the current one.
template <int TM, int BK, bool kTwo>
struct Stage {
  static constexpr int kA = kTY * TM * BK / kThreads;   // x values
  static constexpr int kW = BK * kBN / kThreads;        // weights a matrix
  float a[kA], w[kW], u[kW];

  // x chunk: a warp reads 32 consecutive k of one row.  Weights: 32
  // consecutive columns of one k.
  __device__ __forceinline__ void load(const Args& p, int m0, int k0, const float* w0,
                                       const float* w1, int c0, int n) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int idx = tid + i * kThreads, m = m0 + idx / BK;
      const int k = k0 + idx % BK;
      a[i] = m < p.M && k < p.K ? p.x[static_cast<size_t>(m) * p.K + k] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const int idx = tid + i * kThreads, k = k0 + idx / kBN, c = idx % kBN;
      const bool ok = k < p.K && c0 + c < n;
      const size_t off = static_cast<size_t>(k) * n + c;
      w[i] = ok ? w0[off] : 0.0f;
      if (kTwo) u[i] = ok ? w1[off] : 0.0f;
    }
  }

  __device__ __forceinline__ void store(Smem<TM, BK>& sm) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int idx = tid + i * kThreads;
      sm.a[idx % BK][idx / BK] = a[i];
    }
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const int idx = tid + i * kThreads;
      sm.w[0][idx / kBN][idx % kBN] = w[i];
      if (kTwo) sm.w[1][idx / kBN][idx % kBN] = u[i];
    }
  }
};

// TM consecutive words of the transposed x chunk, as one vector load
template <int TM>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[TM]) {
  if constexpr (TM == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (TM == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

// The block's (BM x BN) tile: acc (and acc_u for the GLU's second
// matrix) in registers.  ``w0`` / ``w1`` are the tile's first columns in
// the matrices (w1 only when kTwo), ``n`` their width.
template <int TM, int BK, bool kTwo>
__device__ __forceinline__ void gemm_tile(const Args& a, int m0, const float* w0,
                                          const float* w1, int c0, int n,
                                          Smem<TM, BK>& sm, float (&acc)[TM][kTN],
                                          float (&acc_u)[TM][kTN]) {
  static_assert(kTN == 2, "the inner loop reads two columns as a float2");
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = acc_u[i][j] = 0.0f;

  Stage<TM, BK, kTwo> st;
  st.load(a, m0, 0, w0, w1, c0, n);
  for (int k0 = 0; k0 < a.K; k0 += BK) {
    st.store(sm);
    __syncthreads();
    if (k0 + BK < a.K) st.load(a, m0, k0 + BK, w0, w1, c0, n);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM];
      load_rows<TM>(&sm.a[kk][ty * TM], av);
      const float2 bv = *reinterpret_cast<const float2*>(&sm.w[0][kk][tx * kTN]);
      float2 uv = make_float2(0.0f, 0.0f);
      if (kTwo) uv = *reinterpret_cast<const float2*>(&sm.w[1][kk][tx * kTN]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][0] += av[i] * bv.x;
        acc[i][1] += av[i] * bv.y;
        if (kTwo) {
          acc_u[i][0] += av[i] * uv.x;
          acc_u[i][1] += av[i] * uv.y;
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace norm_gemm
