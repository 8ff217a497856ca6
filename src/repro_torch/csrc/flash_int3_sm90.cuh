// The classic (unsnapped) int row state of flash_int3.cu (row 9) on the
// Hopper body of the float forward (flash_fwd_sm90.cuh): the same Q load,
// ring, scores, mask, p tile, P V product and tile order; the policy adds
// sweeps of K alone before the body's P V sweep.
//
// The PWL exp2 is not multiplicative, so a rescale of old sums would change
// words; the reference runs three sweeps over the key tiles instead:
//   words  w = quantize(masked (q * scale) . k), phantoms PHANTOM_Q
//   max    m = max over the row of w                          (int32)
//   sum    l = sum of exp2_int(to_log2_domain(w - m)) >> guard  (int32)
//   emit   p = exp2_int(min(to_log2_domain(w - m) - log2_int(max(l, 1)), 0))
//          acc = acc + (p 2^-14) V                              (f32)
// The max and the sum are int32 reductions, exact in any order, so the
// probability words equal the whole-row softmax_int words bit for bit for
// any tiling; acc differs from the naive p V only in f32 summation order
// (not at all under an identity-v probe).  Each score is the float body's
// FMA chain over the head dim in index order.
//
// Two paths, a template flag (CACHE) the plan picks (tiling.flash_int3_plan):
// - The word cache.  Where a q tile's words fit in shared memory beside Q,
//   the ring and the p tile (T up to 1088 at head dims up to 64), one
//   pre-sweep streams K, quantizes each tile's scores, keeps the words
//   (16 bits each: every word but the phantom sentinel lies in [IN_MIN,
//   IN_MAX]) and takes the row max.  The sum is a pass over the kept words,
//   and the body's main sweep streams V alone and makes p from them: one
//   q . k a pair and K read once.  Phantoms (keys at or past T) are told by
//   position, not by their stored word.  A thread keeps the words of its own
//   rows and keys, tile t's as NW / 8 int4 at [t][k][thread], so a warp's
//   16-byte accesses are consecutive and no barrier guards the words.
// - Recomputed words.  Longer rows: two pre-sweeps of K (the max, then the
//   sum against the final max) and the main sweep over K and V recompute
//   the words, as the reference does.
// Each thread keeps partial maxima and sums of its keys and combines them
// over the row set's 16 lanes (xor shuffles) once at the end of a sweep.
// Every tile is swept, causal or not: a masked key carries its word's mass,
// so the words are the naive path's without a tail fold.
//
// The PWL lookups read the ROM's 16 pairs from shared memory
// (unit::RomTable): one 8-byte load a lookup instead of two select chains.
#pragma once

#include "flash_fwd_sm90.cuh"

namespace ffwd {

template <class C, bool CACHE>
struct Int3Rows {
  static constexpr int PRE = CACHE ? 1 : 2;
  static constexpr bool SCORES = !CACHE, FULL = true;
  static constexpr int EXTRA = 32;            // the ROM's 16 pairs
  static constexpr int NW = C::SR * C::SC;    // words a thread a tile
  static constexpr int NV = NW / 8;           // int4 of 16-bit words a thread a tile
  static_assert(NW % 8 == 0, "whole int4 of words");

  // shared-memory bytes of the word cache: every key tile's words
  static size_t dyn_bytes(const Args& a) {
    return CACHE ? static_cast<size_t>(cdiv(a.T, kBK)) * kThreads * NW * sizeof(int16_t) : 0;
  }

  int32_t m[C::SR], l[C::SR], log2s[C::SR];
  int4* words;  // the word cache
  unit::RomTable rom;
  int guard, T, tid, tx;

  __device__ __forceinline__ void prepare(float* x, int tid_) {
    if (tid_ < 16) unit::rom_fill(reinterpret_cast<int2*>(x), tid_);
  }

  __device__ __forceinline__ void pre_begin(const Args& a, float* x, int tid_) {
    rom.tab = reinterpret_cast<const int2*>(x);
    words = reinterpret_cast<int4*>(x + EXTRA);
    guard = a.guard_shift;
    T = a.T;
    tid = tid_;
    tx = tid_ % C::TX;
#pragma unroll
    for (int i = 0; i < C::SR; ++i) {
      m[i] = unit::PHANTOM_Q;
      l[i] = 0;
    }
  }

  __device__ __forceinline__ void init(const Args&, float*, int) {}

  // the S5.10 word of a masked score; a phantom (-inf) is PHANTOM_Q
  static __device__ __forceinline__ int32_t word(float s) {
    return s == -INFINITY ? unit::PHANTOM_Q : unit::quantize(s, unit::IN_FRAC);
  }

  // t = log2 domain of w - m
  static __device__ __forceinline__ int32_t rel(int32_t w, int32_t mi) {
    return unit::to_log2_domain(w - mi, unit::IN_FRAC);
  }

  // tile t's kept words of the thread, phantoms (keys at or past T) as
  // PHANTOM_Q
  __device__ __forceinline__ void load_words(int t, int32_t (&w)[C::SR][C::SC]) const {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int4 u = words[(t * NV + k) * kThreads + tid];
      const int32_t p[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        const int n = 8 * k + h, i = n / C::SC, c = n % C::SC;
        const int32_t lo = static_cast<int32_t>(static_cast<uint32_t>(p[h / 2]) << 16) >> 16;
        const int32_t hi = p[h / 2] >> 16;
        const int j = t * C::BK + tx + C::TX * c;
        w[i][c] = j < T ? (h % 2 ? hi : lo) : unit::PHANTOM_Q;
      }
    }
  }

  __device__ __forceinline__ void store_words(int t, const int32_t (&w)[C::SR][C::SC]) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      int32_t p[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int n = 8 * k + 2 * h;
        const int32_t lo = w[n / C::SC][n % C::SC], hi = w[(n + 1) / C::SC][(n + 1) % C::SC];
        p[h] = static_cast<int32_t>((static_cast<uint32_t>(lo) & 0xffffu) |
                                    (static_cast<uint32_t>(hi) << 16));
      }
      words[(t * NV + k) * kThreads + tid] = make_int4(p[0], p[1], p[2], p[3]);
    }
  }

  // the guard-shifted sum of the thread's words of one tile against m
  __device__ __forceinline__ void add_sum(const int32_t (&w)[C::SR][C::SC]) {
#pragma unroll
    for (int i = 0; i < C::SR; ++i)
#pragma unroll
      for (int c = 0; c < C::SC; ++c) l[i] += unit::exp2_int(rel(w[i][c], m[i]), rom) >> guard;
  }

  // the pre-sweeps: sweep 0 the max (and the kept words), sweep 1 (recomputed
  // words) the sum
  __device__ __forceinline__ void pre(int sweep, int t, const float (&s)[C::SR][C::SC]) {
    int32_t w[C::SR][C::SC];
#pragma unroll
    for (int i = 0; i < C::SR; ++i)
#pragma unroll
      for (int c = 0; c < C::SC; ++c) w[i][c] = word(s[i][c]);
    if (sweep == 0) {
#pragma unroll
      for (int i = 0; i < C::SR; ++i)
#pragma unroll
        for (int c = 0; c < C::SC; ++c) m[i] = max(m[i], w[i][c]);
      if constexpr (CACHE) store_words(t, w);
    } else {
      add_sum(w);
    }
  }

  __device__ __forceinline__ void pre_end(int sweep) {
    if (sweep == 0) {
#pragma unroll
      for (int i = 0; i < C::SR; ++i) m[i] = row_reduce(m[i], MaxOp());
      if constexpr (!CACHE) return;
      const int n_kt = cdiv(T, C::BK);
      for (int t = 0; t < n_kt; ++t) {
        int32_t w[C::SR][C::SC];
        load_words(t, w);
        add_sum(w);
      }
    }
#pragma unroll
    for (int i = 0; i < C::SR; ++i) {
      const int32_t li = row_reduce(l[i], SumOp());
      log2s[i] = unit::log2_int(li < 1 ? 1 : li, unit::EXP_FRAC - guard, rom);
    }
  }

  // tile t's probability words, dequantized, in s; no rescale of acc
  __device__ __forceinline__ void step(int t, float (&s)[C::SR][C::SC], float (&)[C::SR][8]) {
    int32_t w[C::SR][C::SC];
    if constexpr (CACHE) {
      load_words(t, w);
    } else {
#pragma unroll
      for (int i = 0; i < C::SR; ++i)
#pragma unroll
        for (int c = 0; c < C::SC; ++c) w[i][c] = word(s[i][c]);
    }
#pragma unroll
    for (int i = 0; i < C::SR; ++i)
#pragma unroll
      for (int c = 0; c < C::SC; ++c) {
        const int32_t lp = rel(w[i][c], m[i]) - log2s[i];
        s[i][c] = unit::dequantize(unit::exp2_int(lp < 0 ? lp : 0, rom), unit::EXP_FRAC);
      }
  }

  __device__ __forceinline__ void publish(const Args&, int, int, int, int, int) {}

  __device__ __forceinline__ float den(int) const { return 1.0f; }

  __device__ __forceinline__ void stats(const Args&, int, int, int, int, int) const {}
};

}  // namespace ffwd
