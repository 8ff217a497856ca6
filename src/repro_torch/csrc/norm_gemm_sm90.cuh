// The Hopper f32 GEMM body, with or without a norm prologue:
//   norm_linear.cu (row 15, norm -> QKV) and norm_glu.cu (row 16, norm ->
//   gated GLU) run it with the prologue; glu.cu (row 12, the fused GLU) and
//   glu_bwd.cu (row 13, its backward) without it.  glu_sm90.cuh holds the
//   two-matrix kernel, its epilogues and the split finish that rows 12, 13
//   and 16 share.
//
//   out[m, c] = epilogue( sum_k h[m, k] * W[k, c] ),
//   h = (x - mu) * rs * g + b          (mu = 0 for rms, b = 0 without a bias)
//   h = x                              (no prologue)
//
// Shapes: x (M, K) row-major; each weight matrix (K, n) row-major, read in
// place.  norm_linear hands up to three matrices whose columns land side by
// side in one (M, sum n) output (a column tile lies inside one matrix);
// the GLU kernels hand two of one width and read the same column tile of
// both.
//
// Bound: full float32 FMAs on the CUDA cores (the reference's and the plain
// version's contract; the tensor cores take TF32 at most), so a prefill is
// bound by 67 TFLOP/s of f32 and a decode tick by the weight bytes.  What
// the design does about it:
//
// 1. Moments once per row (prologue only).  moments_kernel writes (mu, rs)
//    of every row into an (M, 2) scratch, one warp a row, before the GEMM;
//    no column tile sweeps x for them again.  rs = exp2(-0.5 log2(var +
//    eps)), the datapath's rsqrt (fused_norm._hat), with 1/K as the f32 word.
// 2. Raw tiles land asynchronously in a ring.  The x chunk (BM x kBK), the
//    weight chunk of each matrix (kBK x BN) and, with the prologue, the
//    chunk's g and b land in a kStages-deep ring in dynamic shared memory
//    by cp.async, 16-byte copies (4-byte ones where K, a width or a base
//    pointer is not a multiple of four floats: the copy width is the
//    policy's, tiling.norm_gemm_plan).  Edges are zero-filled by the copy
//    itself (src-size 0): the pad-and-slice rule without padding in device
//    memory.  Nothing is staged in registers.
// 3. Land, then transpose.  Once a stage has landed, the block moves its x
//    chunk in one pass into a k-major buffer padded to BM + 4, so a thread
//    reads its rows as float4s; with the prologue the pass also normalizes,
//    in the plain version's order.  That costs 1/BN of the chunk's FMAs.
// 4. Register tiles.  256 threads as TY x TX; a thread holds TM rows x TN
//    columns of each of NM matrices, in groups of four positions a warp reads
//    side by side.  Prefill tiles (128 x 128, or 128 x 64 per matrix for the
//    GLU) make 8 x 8 outputs a thread from 4 float4 reads per k: 4 FMAs a
//    shared-memory word.
// 5. Split K.  Where the tiles alone leave SMs idle (a prefill chunk, a
//    decode tick), blockIdx.y takes a range of K chunks and writes its partial
//    sums into a scratch the wrapper allocates; a second pass sums the splits
//    in a fixed order.  No float atomics: two calls give the same bits.
//    blockIdx.x walks the tiles in groups of row tiles (tile_coords), so a
//    wave of blocks shares its x panels and weight strips in L2.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "block_reduce.cuh"
#include "sm90_tile.cuh"

namespace ngemm {

using namespace sm90;

constexpr int kThreads = 256;
constexpr int kBK = 16;       // K depth of a ring stage
constexpr int kStages = 5;    // ring depth: three chunks in flight during the FMAs
constexpr int kMaxMats = 3;

struct Matrix {
  const float* w;   // (K, n) row-major
  int n;            // its width
  int out_col;      // its first column in the output
  int tile0;        // its first column tile in the grid
};

struct Args {
  const float* x;       // (M, K)
  const float* g;       // (K) norm gain
  const float* b;       // (K) norm bias, or null
  const float* stats;   // (M, 2): mu, rs of each row
  float* out;           // the output, or the split partials
  int M, K;
  int ld_out, n_mats;   // norm_linear: output width, matrices
  int tiles;            // column tiles (of all matrices)
  int chunks;           // K chunks a split walks
  Matrix mats[kMaxMats];
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// A tile shape: TY x TX threads, TM x TN outputs a thread for each of NM
// matrices, VEC floats a copy, the norm prologue or none.  Shared memory,
// in floats, one region after another: the ring's x chunks
// [kStages][BM][kBK], weight chunks [kStages][NM][kBK][BN], g / b chunks
// [kStages][2][kBK] (prologue only); two k-major chunks [2][kBK][LDA]; the
// block's mu and rs [2][BM] (prologue only).
template <int TY_, int TM_, int TN_, int NM_, int VEC_, bool NORM_ = true>
struct Tile {
  static constexpr int TY = TY_, TX = kThreads / TY_, TM = TM_, TN = TN_;
  static constexpr int NM = NM_, VEC = VEC_;
  static constexpr bool NORM = NORM_;
  static constexpr int BM = TY * TM, BN = TX * TN;
  static constexpr int LDA = BM + 4;
  static constexpr int X_STAGE = BM * kBK;
  static constexpr int W_STAGE = NM * kBK * BN;
  static constexpr int GB_STAGE = NORM ? 2 * kBK : 0;
  static constexpr int OFF_W = kStages * X_STAGE;
  static constexpr int OFF_GB = OFF_W + kStages * W_STAGE;
  static constexpr int OFF_A = OFF_GB + kStages * GB_STAGE;
  static constexpr int OFF_ST = OFF_A + 2 * kBK * LDA;
  static constexpr size_t BYTES = (OFF_ST + (NORM ? 2 * BM : 0)) * sizeof(float);
  static_assert(TM == 4 || TM == 8, "rows come in float4 groups");
  static_assert(TN == 2 || TN == 4 || TN == 8, "columns: a float2 or float4 groups");
  static_assert(VEC == 1 || VEC == 4, "4- or 16-byte copies");
  static_assert(kThreads % TY == 0 && BM % 4 == 0 && BN % 4 == 0, "tile shape");
};

// ---- the pipeline ----------------------------------------------------------

// Issue the copies of K chunk ``chunk`` into ring slot ``slot``: the x rows
// m0 .. m0 + BM - 1, each matrix's columns c0 .. c0 + BN - 1 (``w[i]``
// points at column c0 of matrix i, of width ``n``), and g / b with the
// prologue.
template <class T>
__device__ __forceinline__ void issue(const Args& a, float* sm, int slot, int chunk, int m0,
                                      const float* const (&w)[2], int c0, int n) {
  constexpr int VEC = T::VEC;
  const int k0 = chunk * kBK, tid = threadIdx.x;
  float* xs = sm + slot * T::X_STAGE;
  constexpr int XV = T::X_STAGE / VEC;
#pragma unroll
  for (int i0 = 0; i0 < XV; i0 += kThreads) {
    const int i = i0 + tid;
    if (XV % kThreads == 0 || i < XV) {
      const int r = i / (kBK / VEC), kk = (i % (kBK / VEC)) * VEC;
      const int m = m0 + r, k = k0 + kk;
      const bool ok = m < a.M && k < a.K;
      cp_async<VEC>(xs + r * kBK + kk, ok ? a.x + static_cast<size_t>(m) * a.K + k : a.x, ok);
    }
  }
  float* ws = sm + T::OFF_W + slot * T::W_STAGE;
  constexpr int WV = kBK * T::BN / VEC;
#pragma unroll
  for (int mi = 0; mi < T::NM; ++mi) {
#pragma unroll
    for (int i0 = 0; i0 < WV; i0 += kThreads) {
      const int i = i0 + tid;
      if (WV % kThreads == 0 || i < WV) {
        const int kk = i / (T::BN / VEC), c = (i % (T::BN / VEC)) * VEC;
        const int k = k0 + kk;
        const bool ok = k < a.K && c0 + c < n;
        cp_async<VEC>(ws + (mi * kBK + kk) * T::BN + c,
                      ok ? w[mi] + static_cast<size_t>(k) * n + c : a.x, ok);
      }
    }
  }
  constexpr int GV = kBK / VEC;
  if (T::NORM && tid < 2 * GV) {
    const int which = tid / GV, kk = (tid % GV) * VEC, k = k0 + kk;
    const float* src = which ? a.b : a.g;
    const bool ok = src != nullptr && k < a.K;
    cp_async<VEC>(sm + T::OFF_GB + slot * T::GB_STAGE + which * kBK + kk,
                  ok ? src + k : a.x, ok);
  }
}

// The landed x chunk of ``slot`` into k-major buffer ``buf``: as it is
// without the prologue, else normalized, (x - mu) * rs * g + b, the plain
// version's order.  Zero-filled k past K has x = 0 (and g = b = 0), so its
// h is 0; rows past M are never stored.  A thread takes four k of one row
// a step: one float4 each of x (and g and b).
template <class T>
__device__ __forceinline__ void normalize(float* sm, int slot, int buf) {
  const float* xs = sm + slot * T::X_STAGE;
  float* at = sm + T::OFF_A + buf * kBK * T::LDA;
  constexpr int kQuads = T::X_STAGE / 4;
  if constexpr (!T::NORM) {
#pragma unroll
    for (int i0 = 0; i0 < kQuads; i0 += kThreads) {
      const int i = i0 + threadIdx.x;
      if (kQuads % kThreads == 0 || i < kQuads) {
        const int r = i / (kBK / 4), kk = (i % (kBK / 4)) * 4;
        const float4 x = *reinterpret_cast<const float4*>(xs + 4 * i);
        at[kk * T::LDA + r] = x.x;
        at[(kk + 1) * T::LDA + r] = x.y;
        at[(kk + 2) * T::LDA + r] = x.z;
        at[(kk + 3) * T::LDA + r] = x.w;
      }
    }
  } else {
    const float* gb = sm + T::OFF_GB + slot * T::GB_STAGE;
    const float* mu = sm + T::OFF_ST;
    const float* rs = mu + T::BM;
#pragma unroll
    for (int i0 = 0; i0 < kQuads; i0 += kThreads) {
      const int i = i0 + threadIdx.x;
      if (kQuads % kThreads == 0 || i < kQuads) {
        const int r = i / (kBK / 4), kk = (i % (kBK / 4)) * 4;
        const float4 x = *reinterpret_cast<const float4*>(xs + 4 * i);
        const float4 g = *reinterpret_cast<const float4*>(gb + kk);
        const float4 b = *reinterpret_cast<const float4*>(gb + kBK + kk);
        const float m = mu[r], s = rs[r];
        at[kk * T::LDA + r] = (x.x - m) * s * g.x + b.x;
        at[(kk + 1) * T::LDA + r] = (x.y - m) * s * g.y + b.y;
        at[(kk + 2) * T::LDA + r] = (x.z - m) * s * g.z + b.z;
        at[(kk + 3) * T::LDA + r] = (x.w - m) * s * g.w + b.w;
      }
    }
  }
}

// The chunk's outer products from k-major buffer ``buf`` and the weights
// of ``slot``: acc[i][r][c] += h[r, k] * W_i[k, c].
template <class T>
__device__ __forceinline__ void mma_chunk(const float* sm, int slot, int buf,
                                          float (&acc)[T::NM][T::TM][T::TN]) {
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
  const float* at = sm + T::OFF_A + buf * kBK * T::LDA;
  const float* ws = sm + T::OFF_W + slot * T::W_STAGE;
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    float av[T::TM];
    load_frag<T::TM, T::TY>(at + kk * T::LDA, ty, av);
#pragma unroll
    for (int mi = 0; mi < T::NM; ++mi) {
      float bv[T::TN];
      load_frag<T::TN, T::TX>(ws + (mi * kBK + kk) * T::BN, tx, bv);
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j) acc[mi][i][j] = fmaf(av[i], bv[j], acc[mi][i][j]);
    }
  }
}

// The block's (BM x BN) tile of every matrix over K chunks chunk0 ..
// chunk0 + nchunks - 1, into acc.  ``sm`` is the dynamic shared memory
// (T::BYTES).  One barrier a chunk: at step t the block waits for chunk
// t + 1 to land, issues the copies of chunk t + kStages - 1 into the slot
// chunk t - 1 freed, lands chunk t + 1 in one buffer and runs chunk
// t's FMAs from the other.  One group is committed per step (empty past
// the end), so wait_group<kStages - 3> always means "chunk t + 1 landed".
template <class T>
__device__ __forceinline__ void gemm_block(const Args& a, float* sm, int m0,
                                           const float* const (&w)[2], int c0, int n,
                                           int chunk0, int nchunks,
                                           float (&acc)[T::NM][T::TM][T::TN]) {
#pragma unroll
  for (int mi = 0; mi < T::NM; ++mi)
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
#pragma unroll
      for (int j = 0; j < T::TN; ++j) acc[mi][i][j] = 0.0f;
  if constexpr (T::NORM) {
    float* st = sm + T::OFF_ST;
    for (int r = threadIdx.x; r < T::BM; r += kThreads) {
      const int m = m0 + r;
      st[r] = m < a.M ? a.stats[2 * static_cast<size_t>(m)] : 0.0f;
      st[T::BM + r] = m < a.M ? a.stats[2 * static_cast<size_t>(m) + 1] : 0.0f;
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) issue<T>(a, sm, s, chunk0 + s, m0, w, c0, n);
    cp_commit();
  }
  if (nchunks > 0) {
    cp_wait<kStages - 2>();
    __syncthreads();
    normalize<T>(sm, 0, 0);
  }
  for (int t = 0; t < nchunks; ++t) {
    cp_wait<kStages - 3>();
    // chunk t + 1 landed and chunk t normalized, for all threads; chunk
    // t - 1's slot and buffer are no longer read
    __syncthreads();
    const int ahead = t + kStages - 1;
    if (ahead < nchunks) issue<T>(a, sm, ahead % kStages, chunk0 + ahead, m0, w, c0, n);
    cp_commit();
    if (t + 1 < nchunks) normalize<T>(sm, (t + 1) % kStages, (t + 1) & 1);
    mma_chunk<T>(sm, t % kStages, t & 1, acc);
  }
}

// The (row tile, column tile) of linear block index ``id``: groups of
// kGroupRows row tiles, walked down the rows first, so a wave of blocks
// shares a few x panels and weight strips in L2 instead of streaming every
// weight column once a wave.
constexpr int kGroupRows = 8;

__device__ __forceinline__ void tile_coords(int id, int row_tiles, int col_tiles, int& mt,
                                            int& ct) {
  const int per = kGroupRows * col_tiles, group = id / per, first = group * kGroupRows;
  const int rows = min(row_tiles - first, kGroupRows), r = id - group * per;
  mt = first + r % rows;
  ct = r / rows;
}

// (mu, rs) of each row into stats (M, 2): one warp a row, VEC-wide loads,
// the moment arithmetic of the datapath (mu = 0 for rms).
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    moments_kernel(const float* __restrict__ x, float* __restrict__ stats, int M, int K,
                   int layer, float eps) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* xr = x + static_cast<size_t>(row) * K;
  float s = 0.0f, ss = 0.0f;
  if constexpr (VEC == 4) {
#pragma unroll 4
    for (int k = lane * 4; k < K; k += 128) {
      const float4 v = *reinterpret_cast<const float4*>(xr + k);
      s += v.x;
      s += v.y;
      s += v.z;
      s += v.w;
      ss += v.x * v.x;
      ss += v.y * v.y;
      ss += v.z * v.z;
      ss += v.w * v.w;
    }
  } else {
#pragma unroll 4
    for (int k = lane; k < K; k += 32) {
      const float v = xr[k];
      s += v;
      ss += v * v;
    }
  }
  s = warp_reduce(s, SumOp());
  ss = warp_reduce(ss, SumOp());
  if (lane == 0) {
    const float inv_n = 1.0f / static_cast<float>(K);
    float mu = 0.0f, var = ss * inv_n;
    if (layer) {
      mu = s * inv_n;
      var = fmaxf(var - mu * mu, 0.0f);
    }
    stats[2 * static_cast<size_t>(row)] = mu;
    stats[2 * static_cast<size_t>(row) + 1] = exp2f(-0.5f * log2f(var + eps));
  }
}

template <int VEC>
inline cudaError_t launch_moments(const float* x, float* stats, int M, int K, int layer,
                                  float eps, cudaStream_t st) {
  moments_kernel<VEC><<<cdiv(M, kThreads / 32), kThreads, 0, st>>>(x, stats, M, K, layer,
                                                                    eps);
  return cudaGetLastError();
}

}  // namespace ngemm
