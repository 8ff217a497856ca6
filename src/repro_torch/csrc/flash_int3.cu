// flash_int3: three-sweep blocked attention on the unit's classic
// (unsnapped) int words -- the paper's Eq. 10, blocked.
//
// Replaces repro/kernels/flash_attention_int.py:flash_attention_pallas_int3
// -- the pallas_call of _flash_int_jit (:354), body _flash_int_body
// (:282).  The PWL exp2 is not multiplicative, so a rescale of old sums
// would change words; the kernel runs the reference's three sweeps over
// the same KV tiles instead, recomputing the score words in each:
//   score words  sq = quantize(masked (q * scale) . k), phantoms PHANTOM_Q
//   sweep 1      m = max(m, max sq)                          (int32)
//   sweep 2      l = l + sum(exp2_int(log2dom(sq - m)) >> guard)
//   sweep 3      p = exp2_int(min(log2dom(sq - m) - log2_int(max(l, 1)), 0))
//                acc = acc + (p * 2^-14) @ V                   (f32)
// The max and the sum are int32 reductions, exact in any order, so the
// probability words equal the whole-row softmax_int words bit for bit
// for any tiling; acc differs from the naive p @ v only in f32 summation
// order, and not at all under an identity-v probe.  guard_shift comes
// from the unpadded T, as the whole-row rule.
//
// Every kv tile is swept, causal or not: a masked key scores MASK_VALUE
// and carries its word's mass, so the words are the naive path's without
// a tail fold.  K is read three times and V once (sweeps 1-2 load no V).
//
// Grid and layout are flash_tile.cuh's: one block of 256 threads per
// (q tile, kv head, batch row); thread (ty, tx) holds rows 4 ty + i and
// keys tx + 16 c of the score tile, so a row's 16 threads are one half
// warp and reduce by shuffles; m, l and log2(l) live in registers.
//
// Bound on the H100: operations, as flash_fwd.cu -- one q.k per pair in
// each of three sweeps and one p.v, plus ~40 int ops a score word per
// sweep -- against one q.k and one p.v a pair in the bound.
#include "flash_tile.cuh"

namespace {

using namespace flash;

// The 16 threads of a score-tile row (a half warp) combine their values.
template <typename T, typename Op>
__device__ inline T row_reduce(T v, Op op) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// This thread's 4 x 4 S5.10 score words of the tile (phantoms PHANTOM_Q).
__device__ inline void word_tile(const Args& a, const Smem& sm, int key0, int nk,
                                 int32_t w[4][4]) {
  float s[4][4];
  int kind[4][4];
  score_tile(a, sm, key0, nk, s, kind);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      w[i][c] = kind[i][c] == kPhantom ? unit::PHANTOM_Q
                                       : unit::quantize(s[i][c], unit::IN_FRAC);
}

__global__ void __launch_bounds__(kThreads) flash_int3_kernel(Args a) {
  extern __shared__ float smem[];
  const Smem sm = carve(smem, a.h, a.hv);
  const int qt = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  for (int r = tid; r < kBQ; r += kThreads) sm.row_c[r] = 1.0f;  // no rescale
  load_q_tile(a, sm, b, head, qt);
  const int n_tiles = (a.T + a.bkv - 1) / a.bkv;
  int32_t w[4][4];

  // ---- sweep 1: the int32 row max ----
  int32_t m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = unit::PHANTOM_Q;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int key0 = jt * a.bkv, nk = min(a.bkv, a.T - key0);
    __syncthreads();
    load_kv_tile(a, sm, b, head, key0, nk, false);
    __syncthreads();
    word_tile(a, sm, key0, nk, w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int32_t v = max(max(w[i][0], w[i][1]), max(w[i][2], w[i][3]));
      m[i] = max(m[i], row_reduce(v, MaxOp()));
    }
  }

  // ---- sweep 2: the guard-shifted sum against the final max ----
  int32_t l[4] = {0, 0, 0, 0};
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int key0 = jt * a.bkv, nk = min(a.bkv, a.T - key0);
    __syncthreads();
    load_kv_tile(a, sm, b, head, key0, nk, false);
    __syncthreads();
    word_tile(a, sm, key0, nk, w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int32_t v = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v += unit::exp2_int(unit::to_log2_domain(w[i][c] - m[i], unit::IN_FRAC)) >>
             a.guard_shift;
      l[i] += row_reduce(v, SumOp());
    }
  }
  int32_t log2s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    log2s[i] = unit::log2_int(l[i] < 1 ? 1 : l[i], unit::EXP_FRAC - a.guard_shift);

  // ---- sweep 3: the probability words, dequantized, times V ----
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int key0 = jt * a.bkv, nk = min(a.bkv, a.T - key0);
    __syncthreads();
    load_kv_tile(a, sm, b, head, key0, nk, true);
    __syncthreads();
    word_tile(a, sm, key0, nk, w);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int32_t t = unit::to_log2_domain(w[i][c] - m[i], unit::IN_FRAC);
        const int32_t lp = t - log2s[i];
        sm.ps[(ty * 4 + i) * (kBKV + 1) + tx + 16 * c] =
            unit::dequantize(unit::exp2_int(lp < 0 ? lp : 0), unit::EXP_FRAC);
      }
    __syncthreads();
    pv_update(a, sm, nk, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* orow = out_row(a, b, head, qt, ty * 4 + i);
    if (orow == nullptr) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < a.hv) orow[col] = acc[i][c];
    }
  }
}

}  // namespace

// Shapes as in flash::Args; every tensor contiguous, h and hv <= 128,
// 1 <= bkv <= 64, 0 <= guard_shift <= 31.
extern "C" int flash_int3_launch(const float* q, const float* k, const float* v,
                                 const int32_t* q_pos, const uint8_t* kv_valid,
                                 float* out, int batch, int S, int K, int G, int h,
                                 int hv, int T, int bkv, int causal,
                                 int guard_shift, void* stream) {
  if (h < 1 || h > kMaxHD || hv < 1 || hv > kMaxHD || bkv < 1 || bkv > kBKV ||
      G < 1 || S < 1 || T < 1 || guard_shift < 0 || guard_shift > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, q_pos, kv_valid, out, S, K, G, h, hv, T, bkv, causal, guard_shift};
  const size_t smem = smem_bytes(h, hv);
  cudaError_t e = allow_smem(flash_int3_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S * G + kBQ - 1) / kBQ, K, batch);
  flash_int3_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
