// The tiled float32 GEMM body shared by norm_linear.cu (the norm -> QKV
// prologue), glu.cu / glu_bwd.cu (the gated-FFN epilogues) and
// norm_glu.cu (both: the norm prologue and the GLU epilogue):
//
//   out[m, c] = epilogue( sum_k prologue(x)[m, k] * W[k, c] )
//
// Shapes: x (M, K) row-major; each weight matrix (K, n) row-major, read
// in place.  norm_linear hands up to three matrices (wq, wk, wv) whose
// columns land side by side in one (M, sum n) output: a block's column
// tile lies inside one matrix, so nothing concatenates [wq|wk|wv] in
// device memory.  glu and norm_glu hand two (Wg, Wu) of one width and
// read the same column tile of both.
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
// Norm prologue: the TPU kernel keeps a whole (bm, d) row tile in VMEM
// and normalizes it there; at d 4096 64 such rows are 1 MB, beyond an
// SM.  Here each block first sweeps its BM rows of x once for the
// moments (one warp a row), keeps mu and exp2(-0.5 log2(var + eps)) a
// row in shared memory, and normalizes every x chunk as it is staged:
// h = (x - mu) * rs * g + b, the plain version's order of operations.
//
// Ragged edges are the pad-and-slice rule done in registers: rows past
// M, columns past a matrix's width and k past K load as zeros and are
// never stored, so no operand is padded in device memory.
#pragma once

#include <cuda_runtime.h>

#include "block_reduce.cuh"

namespace norm_gemm {

constexpr int kThreads = 256;
constexpr int kTX = 16;           // thread columns of the block
constexpr int kTY = 16;           // thread rows of the block
constexpr int kTN = 2;            // output columns a thread holds
constexpr int kBN = kTX * kTN;    // output columns a block holds
constexpr int kMaxMats = 3;

struct Matrix {
  const float* w;   // (K, n) row-major
  int n;            // its width
  int out_col;      // its first column in the output
  int tile0;        // its first column tile in the grid
};

struct Args {
  const float* x;   // (M, K)
  const float* g;   // (K) norm gain (prologue only)
  const float* b;   // (K) norm bias, or null (rms)
  float* out;       // (M, ld_out)
  int M, K, ld_out, n_mats;
  Matrix mats[kMaxMats];
  int layer;        // prologue kind: 0 rms, 1 layer
  float eps;
};

template <int TM, int BK>
struct alignas(16) Smem {
  float a[BK][kTY * TM + 4];    // x chunk, transposed (k-major), padded
  float w[2][BK][kBN];          // weight chunk(s)
  float mu[kTY * TM];           // row moments (prologue)
  float rs[kTY * TM];
};

// Moments of the block's rows: mu and exp2(-0.5 log2(var + eps)) a row,
// the datapath's rsqrt (fused_norm._hat), with 1/K as the f32 word.
// Warp w sweeps rows w * R .. w * R + R - 1 together, R loads in flight
// per step, so the sweep is not one L2 round trip per 32 words.
template <int TM, int BK>
__device__ __forceinline__ void row_moments(const Args& a, int m0, Smem<TM, BK>& sm) {
  constexpr int kRows = kTY * TM / (kThreads / 32);   // rows a warp sweeps
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows, live = a.M - (m0 + r0);
  constexpr int kSteps = kRows < 16 ? 16 / kRows : 1;  // 32-word steps a pass
  const float* xr = a.x + static_cast<size_t>(m0 + r0) * a.K;
  float s[kRows], ss[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) s[j] = ss[j] = 0.0f;
  for (int k0 = lane; k0 < a.K; k0 += 32 * kSteps) {
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int k = k0 + 32 * u;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (j < live && k < a.K) {
          const float v = xr[static_cast<size_t>(j) * a.K + k];
          s[j] += v;
          ss[j] += v * v;
        }
      }
    }
  }
  const float inv_n = 1.0f / static_cast<float>(a.K);
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const float sj = warp_reduce(s[j], SumOp());
    const float ssj = warp_reduce(ss[j], SumOp());
    if (lane == 0) {
      float mu = 0.0f, var = ssj * inv_n;
      if (a.layer) {
        mu = sj * inv_n;
        var = fmaxf(var - mu * mu, 0.0f);
      }
      sm.mu[r0 + j] = mu;
      sm.rs[r0 + j] = exp2f(-0.5f * log2f(var + a.eps));
    }
  }
  __syncthreads();
}

// One thread's share of a K chunk, held in registers from its global
// load until it is stored to shared memory: the next chunk's loads are
// in flight while the block computes on the current one.
template <int TM, int BK, bool kNorm, bool kTwo>
struct Stage {
  static constexpr int kA = kTY * TM * BK / kThreads;   // x values
  static constexpr int kW = BK * kBN / kThreads;        // weights a matrix
  float a[kA], w[kW], u[kW];

  // x chunk: a warp reads 32 consecutive k of one row; normalized here
  // when the prologue is on.  Weights: 32 consecutive columns of one k.
  __device__ __forceinline__ void load(const Args& p, int m0, int k0, const float* w0,
                                       const float* w1, int c0, int n,
                                       const Smem<TM, BK>& sm) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int idx = tid + i * kThreads, r = idx / BK, m = m0 + r;
      const int k = k0 + idx % BK;
      float v = 0.0f;
      if (m < p.M && k < p.K) {
        v = p.x[static_cast<size_t>(m) * p.K + k];
        if (kNorm) {
          v = (p.layer ? v - sm.mu[r] : v) * sm.rs[r] * p.g[k];
          if (p.b != nullptr) v += p.b[k];
        }
      }
      a[i] = v;
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
template <int TM, int BK, bool kNorm, bool kTwo>
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

  Stage<TM, BK, kNorm, kTwo> st;
  st.load(a, m0, 0, w0, w1, c0, n, sm);
  for (int k0 = 0; k0 < a.K; k0 += BK) {
    st.store(sm);
    __syncthreads();
    if (k0 + BK < a.K) st.load(a, m0, k0 + BK, w0, w1, c0, n, sm);
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
