// flash_snap: one-sweep blocked attention on the unit's snapped-max int
// recurrence (the dual-mode prefill).
//
// Replaces repro/kernels/flash_attention_int.py:flash_attention_pallas_int
// -- the pallas_call of _flash_snap_jit (:218), body _flash_snap_body
// (:139).  Per kv tile and row, in the reference's order
// (int_score_words, then snap_tile_update):
//   score words  sq = quantize(masked (q * scale) . k), phantoms PHANTOM_Q
//   t            = to_snap_domain(sq)
//   m'           = max(m, snap_max_int(max t)),  k = (m' - m) >> T_FRAC
//   p, d         = snap_prob_word(t, guard), (m' >> T_FRAC) - (t >> T_FRAC)
//   S'           = slide(S, k) + per-depth int32 sums of p   (16 buckets)
//   acc'         = acc * 2^-k + (p * 2^-d) @ V                (exact scales)
// and the finish is online_finish_int(S) then one f32 division.  A causal
// row's skipped tail (n keys of the one masked word) merges as one
// partial: snap_max of the word, n * p in the bucket of its depth.  Int32
// atomics and reductions are exact in any order, so m and S are bitwise
// the reference's words for any tiling; acc differs from it only in f32
// summation order, and not at all under an identity-v probe.  With
// partial requested it writes the unnormalized acc and the (m, S) words
// instead (the ring's hop partial).
//
// Bound on the H100: operations, as flash_fwd.cu, plus ~60 int ops a
// score for the quantize, the snap domain and the PWL exp2 word.
//
// Grid, masking and the causal skip: see flash_tile.cuh.
#include "flash_tile.cuh"

namespace {

using namespace flash;

constexpr int kNB = unit::N_SNAP_BUCKETS;

__global__ void __launch_bounds__(kThreads) flash_snap_kernel(Args a, int partial) {
  extern __shared__ float smem[];
  const Smem sm = carve(smem, a.h, a.hv);
  const int qt = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  int32_t* mi = sm.row_i;               // kBQ: snapped m
  int32_t* S = mi + kBQ;                // kBQ x 16 buckets
  int32_t* Sblk = S + kBQ * kNB;        // kBQ x 16: this tile's sums
  int32_t* ti = reinterpret_cast<int32_t*>(sm.ps);  // t words, row stride kBKV + 1

  for (int r = tid; r < kBQ; r += kThreads) mi[r] = unit::SNAP_MIN;
  for (int i = tid; i < kBQ * kNB; i += kThreads) S[i] = Sblk[i] = 0;
  const int32_t qmax = load_q_tile(a, sm, b, head, qt);
  const int n_tiles = tiles_to_visit(a, qmax);

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int key0 = jt * a.bkv;
    const int nk = min(a.bkv, a.T - key0);
    load_kv_tile(a, sm, b, head, key0, nk);
    __syncthreads();

    // ---- score words -> snap domain t (phantoms SNAP_MIN: no mass) ----
    {
      float s[4][4];
      int kind[4][4];
      score_tile(a, sm, key0, nk, s, kind);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ti[(ty * 4 + i) * (kBKV + 1) + tx + 16 * c] =
              kind[i][c] == kPhantom
                  ? unit::SNAP_MIN
                  : unit::to_snap_domain(unit::quantize(s[i][c], unit::IN_FRAC));
    }
    __syncthreads();

    // ---- snap_tile_update: 4 threads a row (consecutive lanes) ----
    {
      const int r = tid >> 2, quarter = tid & 3;
      const int j0 = quarter * 16;
      const bool live = row_live(a, sm, r, key0);
      int32_t tmax = unit::SNAP_MIN;
#pragma unroll
      for (int j = 0; j < 16; ++j) tmax = max(tmax, ti[r * (kBKV + 1) + j0 + j]);
      tmax = quad_reduce(tmax, MaxOp());
      const int32_t m_old = mi[r];
      const int32_t m_new = live ? max(m_old, unit::snap_max_int(tmax)) : m_old;
      const int32_t kc = (m_new - m_old) >> unit::T_FRAC;
      // the same slots hold t words on the way in and f32 numerators out
      float* num = sm.ps + r * (kBKV + 1) + j0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int32_t t = ti[r * (kBKV + 1) + j0 + j];
        float nv = 0.0f;
        if (live) {
          const int32_t p = unit::snap_prob_word(t, a.guard_shift);
          const int32_t d = (m_new >> unit::T_FRAC) - (t >> unit::T_FRAC);
          if (p != 0 && d >= 0 && d < kNB) atomicAdd(&Sblk[r * kNB + d], p);
          nv = static_cast<float>(p) * unit::snap_scale_f32(d);
        }
        num[j] = nv;
      }
      __syncwarp();
      // S <- slide(S, k) + Sblk, each lane 4 of the row's 16 buckets
      int32_t nv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int d = quarter * 4 + u, src = d - kc;
        nv[u] = ((kc < kNB && src >= 0) ? S[r * kNB + src] : 0) + Sblk[r * kNB + d];
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        S[r * kNB + quarter * 4 + u] = nv[u];
        Sblk[r * kNB + quarter * 4 + u] = 0;
      }
      if (quarter == 0) {
        mi[r] = m_new;
        sm.row_c[r] = unit::snap_scale_f32(kc);
      }
    }
    __syncthreads();

    pv_update(a, sm, nk, acc);
    __syncthreads();
  }

  // ---- causal tail: n keys of the masked word, merged as one partial ----
  if (a.causal) {
    const int32_t tm = unit::to_snap_domain(unit::quantize(unit::MASK_VALUE, unit::IN_FRAC));
    int32_t* first = reinterpret_cast<int32_t*>(sm.ps);
    for (int r = tid; r < kBQ; r += kThreads) {
      const int32_t qp = sm.qpos[r];
      const int f = tail_start(a, qp);
      const int n = a.T - f * a.bkv;
      float num = 0.0f, corr = 1.0f;
      if (n > 0 && qp != kDeadRow) {
        const int32_t m_old = mi[r];
        const int32_t m_new = max(m_old, unit::snap_max_int(tm));
        const int32_t kc = (m_new - m_old) >> unit::T_FRAC;
        const int32_t p = unit::snap_prob_word(tm, a.guard_shift);
        const int32_t d = (m_new >> unit::T_FRAC) - (tm >> unit::T_FRAC);
        int32_t nv[kNB];
#pragma unroll
        for (int dd = 0; dd < kNB; ++dd) {
          const int src = dd - kc;
          nv[dd] = ((kc < kNB && src >= 0) ? S[r * kNB + src] : 0) +
                   (dd == d ? n * p : 0);
        }
#pragma unroll
        for (int dd = 0; dd < kNB; ++dd) S[r * kNB + dd] = nv[dd];
        mi[r] = m_new;
        corr = unit::snap_scale_f32(kc);
        num = static_cast<float>(p) * unit::snap_scale_f32(d);
      }
      first[r * (kBKV + 1)] = f;
      sm.ps[r * (kBKV + 1) + 1] = num;
      sm.row_c[r] = corr;
    }
    __syncthreads();
    tail_acc_update(a, sm, b, head, acc);
  }

  // ---- finish: acc / online_finish_int(S), or the partial ----
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    float* orow = out_row(a, b, head, qt, r);
    if (orow == nullptr) continue;
    int32_t l = 0;
#pragma unroll
    for (int d = 0; d < kNB; ++d) l += S[r * kNB + d] >> d;
    const float lf = static_cast<float>(l < 1 ? 1 : l);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < a.hv) orow[col] = partial ? acc[i][c] : acc[i][c] / lf;
    }
    if (partial && tx == 0) {
      const size_t si = stat_index(a, b, head, qt, r);
      static_cast<int32_t*>(a.stat_m)[si] = mi[r];
      for (int d = 0; d < kNB; ++d)
        static_cast<int32_t*>(a.stat_l)[si * kNB + d] = S[r * kNB + d];
    }
  }
}

}  // namespace

// Shapes as in flash::Args; every tensor contiguous, h and hv <= 128,
// 1 <= bkv <= 64; v_tail (B, cdiv(T, bkv) + 1, K, hv) f32 when causal.
// With partial != 0, out receives the unnormalized acc,
// stat_m the (B, K, G, S) int32 snapped m and stat_l the (B, K, G, S, 16)
// int32 buckets; otherwise both are ignored.
extern "C" int flash_snap_launch(const float* q, const float* k, const float* v,
                                 const float* v_tail, const int32_t* q_pos,
                                 const uint8_t* kv_valid,
                                 float* out, int32_t* stat_m, int32_t* stat_s,
                                 int batch, int S, int K, int G, int h, int hv,
                                 int T, int bkv, int causal, int guard_shift,
                                 int partial, void* stream) {
  if (h < 1 || h > kMaxHD || hv < 1 || hv > kMaxHD || bkv < 1 || bkv > kBKV ||
      G < 1 || S < 1 || T < 1 || guard_shift < 0 || guard_shift > 31 ||
      (partial && (stat_m == nullptr || stat_s == nullptr)) ||
      (causal && v_tail == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, v_tail, q_pos, kv_valid, out, stat_m, stat_s,
               S, K, G, h, hv, T, bkv, causal, guard_shift};
  const size_t smem = smem_bytes(h, hv);
  cudaError_t e = allow_smem(flash_snap_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S * G + kBQ - 1) / kBQ, K, batch);
  flash_snap_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, partial);
  return static_cast<int>(cudaGetLastError());
}
