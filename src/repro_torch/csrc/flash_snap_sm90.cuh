// The snapped int row state of flash_snap.cu (row 8) on the Hopper body of
// the float forward (flash_fwd_sm90.cuh): the same tiles, ring, scores,
// mask, p tile, P V product, pre-pass and tile order; only the per-tile
// row-state step, the tail's update and the finish differ.
//
// Per tile and row, in the reference's order (int_score_words, then
// snap_tile_update):
//   t   = to_snap_domain(quantize(s)), phantoms (keys past T) SNAP_MIN
//   m'  = max(m, snap_max_int(max t)),  k = (m' - m) >> T_FRAC
//   p   = snap_prob_word(t, guard),     d = (m' >> T_FRAC) - (t >> T_FRAC)
//   S'  = slide(S, k) + per-depth int32 sums of p   (16 buckets)
//   acc = acc 2^-k + (p 2^-d) V                     (exact scales)
// and the finish l = sum_d S_d >> d, then one f32 division (or, with the
// partial requested, the unnormalized acc and the (m, S) words: the ring's
// hop partial).
//
// Why the words do not depend on the tiles: snap_max_int is monotone, a
// slide then an add equals adding at the final depth (both drop depths >=
// 16), and the causal tail's n keys of one word add n p at its depth.  So m
// and S are the full sweep's words for any key tiling, and acc differs from
// it only in f32 summation order (not at all under an identity-v probe).
// Each score is the float body's FMA chain over the head dim in index order,
// so the score words are the plain version's.
//
// Registers: the 16 lanes of a row set hold the row's snapped m (their xor
// max is exact) and one bucket each: lane tx holds bucket tx of each of its
// SR rows, so the state is the float body's m and l in size.  The slide
// S'[d] = S[d - k] is one shuffle within the row set, zero where d < k.
// p 2^-d goes to the p tile as f32 and 2^-k stays in registers.
//
// The buckets fill by shared int32 atomics into a per-warp [SR][2][16]
// tile, read back by the owning lanes after a __syncwarp.  (A register
// histogram of the thread's keys and a 16-lane reduce-scatter, the other
// exact scheme, ran 10-17% slower on the H100; PERF.md section 6.)
//
// The PWL exp2 lookup reads the ROM's 16 pairs from shared memory
// (unit::RomTable): one 8-byte load a score instead of two select chains.
#pragma once

#include "flash_fwd_sm90.cuh"

namespace ffwd {

template <class C>
struct SnapRows : RowsBase {
  static constexpr int kNB = unit::N_SNAP_BUCKETS;
  static constexpr int kWarpWords = C::SR * 2 * kNB;  // a warp's bucket tile
  static_assert(kNB == C::TX, "a lane a bucket");
  // shared-memory words: the warps' bucket tiles, then the ROM's 16 pairs
  static constexpr int EXTRA = kThreads / 32 * kWarpWords + 32;
  int32_t m[C::SR], S[C::SR];
  float lf[C::SR];
  int32_t* bk;  // this row set's bucket rows: bk[i * 2 kNB + d]
  unit::RomTable rom;
  int guard, tx;

  // the ROM's pairs and zeroed bucket tiles, before the block's barrier
  __device__ __forceinline__ void prepare(float* x, int tid) {
    int32_t* w = reinterpret_cast<int32_t*>(x);
    if (tid < 16) unit::rom_fill(reinterpret_cast<int2*>(w + kThreads / 32 * kWarpWords), tid);
    for (int j = tid; j < kThreads / 32 * kWarpWords; j += kThreads) w[j] = 0;
  }

  __device__ __forceinline__ void init(const Args& a, float* x, int tid) {
    int32_t* w = reinterpret_cast<int32_t*>(x);
    rom.tab = reinterpret_cast<const int2*>(w + kThreads / 32 * kWarpWords);
    bk = w + (tid >> 5) * kWarpWords + ((tid >> 4) & 1) * kNB;
    guard = a.guard_shift;
    tx = tid % C::TX;
#pragma unroll
    for (int i = 0; i < C::SR; ++i) {
      m[i] = unit::SNAP_MIN;
      S[i] = 0;
    }
  }

  // S'[tx] = S[tx - k]: zero where tx < k (every lane when k >= 16)
  __device__ __forceinline__ int32_t slide(int32_t s, int32_t k) const {
    const int32_t v = __shfl_sync(0xffffffffu, s, tx >= k ? tx - k : tx, 16);
    return tx >= k ? v : 0;
  }

  __device__ __forceinline__ void step(int, float (&s)[C::SR][C::SC], float (&acc)[C::SR][8]) {
#pragma unroll
    for (int i = 0; i < C::SR; ++i) {
      int32_t t[C::SC], tmax = unit::SNAP_MIN;
#pragma unroll
      for (int c = 0; c < C::SC; ++c) {
        t[c] = s[i][c] == -INFINITY
                   ? unit::SNAP_MIN
                   : unit::to_snap_domain(unit::quantize(s[i][c], unit::IN_FRAC));
        tmax = max(tmax, t[c]);
      }
      const int32_t m_new = max(m[i], unit::snap_max_int(row_reduce(tmax, MaxOp())));
      const int32_t k = (m_new - m[i]) >> unit::T_FRAC, top = m_new >> unit::T_FRAC;
      m[i] = m_new;
      int32_t p[C::SC], d[C::SC];
#pragma unroll
      for (int c = 0; c < C::SC; ++c) {
        p[c] = unit::snap_prob_word(t[c], guard, rom);
        d[c] = top - (t[c] >> unit::T_FRAC);
        s[i][c] = static_cast<float>(p[c]) * unit::snap_scale_f32(d[c]);
      }
      S[i] = slide(S[i], k);
#pragma unroll
      for (int c = 0; c < C::SC; ++c)
        if (p[c] != 0 && d[c] < kNB) atomicAdd(bk + i * 2 * kNB + d[c], p[c]);
      const float corr = unit::snap_scale_f32(k);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // the warp's adds landed; the next tile's come after a barrier
#pragma unroll
    for (int i = 0; i < C::SR; ++i) {
      int32_t* w = bk + i * 2 * kNB + tx;
      S[i] += *w;
      *w = 0;
    }
  }

  // n keys of the MASK_VALUE word (the causal tail), their V sums tv
  __device__ __forceinline__ void tail(int n_tail, const float (&tv)[8], bool add,
                                       float (&acc)[C::SR][8]) {
    const int32_t tm = unit::to_snap_domain(unit::quantize(unit::MASK_VALUE, unit::IN_FRAC));
    const int32_t p = unit::snap_prob_word(tm, guard, rom);
#pragma unroll
    for (int i = 0; i < C::SR; ++i) {
      const int32_t m_new = max(m[i], unit::snap_max_int(tm));
      const int32_t k = (m_new - m[i]) >> unit::T_FRAC;
      const int32_t d = (m_new >> unit::T_FRAC) - (tm >> unit::T_FRAC);
      S[i] = slide(S[i], k) + (tx == d ? unit::mul_wrap(n_tail, p) : 0);
      m[i] = m_new;
      const float corr = unit::snap_scale_f32(k);
      const float num = static_cast<float>(p) * unit::snap_scale_f32(d);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = acc[i][j] * corr + (add ? num * tv[j] : 0.0f);
    }
  }

  // Every lane, before the key groups merge: l = sum_d S_d >> d, and the
  // (m, S) words of the partial.
  __device__ __forceinline__ void publish(const Args& a, int b, int head, int q0, int ty,
                                          int) {
    const bool partial = a.word_m != nullptr;
#pragma unroll
    for (int i = 0; i < C::SR; ++i) {
      const int32_t l = row_reduce(S[i] >> tx, SumOp());
      lf[i] = partial ? 1.0f : static_cast<float>(l < 1 ? 1 : l);
      const int flat = q0 + frag_pos<C::SR, C::TY>(ty, i);
      if (partial && flat < a.S * a.G) {
        const size_t si = stat_index(a, b, head, flat);
        a.word_s[si * kNB + tx] = S[i];
        if (tx == 0) a.word_m[si] = m[i];
      }
    }
  }

  __device__ __forceinline__ float den(int i) const { return lf[i]; }

  __device__ __forceinline__ void stats(const Args&, int, int, int, int, int) const {}
};

}  // namespace ffwd
