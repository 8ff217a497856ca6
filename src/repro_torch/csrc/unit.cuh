// The dual-mode softmax unit on the device: the one definition of the
// unit's int32 arithmetic that every kernel of the port shares, as the
// reference shares repro/core/softmax_unit.py among its kernel bodies.
//
// Word-for-word port of repro_torch/core/softmax_unit.py (itself held
// bitwise to repro.core.softmax_unit).  The ROM tables and constants come
// from unit_constants.h, which repro_torch/kernels/_build.py generates
// from the Python modules at build time, so they are written down once.
//
// C++ traps the reference (XLA) does not have, and what is done here:
//  * signed overflow is undefined: every product goes through mul_wrap
//    (uint32 multiply, truncated), and left shifts through shl_wrap;
//  * a shift by >= 32 is undefined: every variable shift is clamped to
//    [0, 31] as sat_rshift does; right shifts of signed ints are
//    arithmetic on nvcc, as XLA's are;
//  * rounding is half-to-even (__float2int_rn), never roundf.
#pragma once

#include <cstdint>

#include "unit_constants.h"

namespace unit {

__device__ __forceinline__ int32_t mul_wrap(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t shl_wrap(int32_t a, int32_t n) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) << n);
}

__device__ __forceinline__ int32_t sat_rshift(int32_t x, int32_t n) {
  n = n < 0 ? 0 : (n > 31 ? 31 : n);
  return x >> n;
}

// float -> saturating S5.10 word (round half-to-even, then clip)
__device__ __forceinline__ int32_t quantize(float x, int frac_bits) {
  int32_t q = __float2int_rn(x * static_cast<float>(1 << frac_bits));
  return q < IN_MIN ? IN_MIN : (q > IN_MAX ? IN_MAX : q);
}

__device__ __forceinline__ float dequantize(int32_t q, int frac_bits) {
  return static_cast<float>(q) * (1.0f / static_cast<float>(1 << frac_bits));
}

// leading-one position; 0 for v < 1, as the reference's shift ladder gives
__device__ __forceinline__ int32_t floor_log2(int32_t v) {
  return v >= 1 ? 31 - __clz(v) : 0;
}

__device__ __forceinline__ int32_t mantissa_frac(int32_t s, int32_t e_pos) {
  int32_t rem = s - shl_wrap(1, e_pos);
  int32_t up = T_FRAC - e_pos > 0 ? T_FRAC - e_pos : 0;
  int32_t down = e_pos - T_FRAC > 0 ? e_pos - T_FRAC : 0;
  return shl_wrap(rem, up) >> down;
}

// ---- the PWL ROMs ---------------------------------------------------------
//
// A lookup gives one segment's (slope, intercept) Q2.14 pair.  RomChain is
// the generated select chains (two 8-way chains a lookup, no state): every
// kernel's default.  RomTable reads the same 16 pairs from the block's
// shared memory (rom_fill, then a barrier): one 8-byte shared load a lookup.
// Rows 1 and 2 (softmax_rows.cu, pair_act.cu), whose int bodies are bound by
// int32 issue, and the snapped int flash and contiguous decode (rows 8 and 6,
// flash_snap_sm90.cuh, decode_dense_sm90.cuh), where the words ride on the
// f32 dot products, take the table; the other int kernels keep the chains.  Both
// give the same words: every caller's segment lies in [0, 8) (v is in
// [0, 2^T_FRAC), and so is f, since every log2_int caller clamps s >= 1),
// where the chains' fall-through to entry 0 never fires.
struct RomChain {
  __device__ __forceinline__ int2 exp2(int32_t seg) const {
    return make_int2(rom_exp2_slope(seg), rom_exp2_intercept(seg));
  }
  __device__ __forceinline__ int2 log2(int32_t seg) const {
    return make_int2(rom_log2_slope(seg), rom_log2_intercept(seg));
  }
};

struct RomTable {
  const int2* tab;  // 16 pairs in shared memory: exp2's 8, then log2's 8
  __device__ __forceinline__ int2 exp2(int32_t seg) const { return tab[seg & 7]; }
  __device__ __forceinline__ int2 log2(int32_t seg) const {
    return tab[8 + (seg & 7)];
  }
};

// entry i (< 16) of a RomTable, from the chains; the caller syncs after
__device__ __forceinline__ void rom_fill(int2* tab, int i) {
  const RomChain chain;
  tab[i] = i < 8 ? chain.exp2(i) : chain.log2(i - 8);
}

// 8-segment PWL: one lookup, one multiply, one shift, one add
__device__ __forceinline__ int32_t pwl_combine(int2 ab, int32_t frac,
                                               int frac_bits, int out_frac) {
  int32_t prod = mul_wrap(ab.x, frac) >> (PWL_COEF_FRAC + frac_bits - out_frac);
  return prod + (PWL_COEF_FRAC >= out_frac ? (ab.y >> (PWL_COEF_FRAC - out_frac))
                                           : shl_wrap(ab.y, out_frac - PWL_COEF_FRAC));
}

template <class Rom = RomChain>
__device__ __forceinline__ int32_t exp2_frac_int(int32_t v, const Rom& rom = Rom()) {
  return pwl_combine(rom.exp2(v >> (T_FRAC - 3)), v, T_FRAC, EXP_FRAC);
}

template <class Rom = RomChain>
__device__ __forceinline__ int32_t log2_mant_int(int32_t f, const Rom& rom = Rom()) {
  return pwl_combine(rom.log2(f >> (T_FRAC - 3)), f, T_FRAC, T_FRAC);
}

// t = d*log2(e) @ 2^-T_FRAC for d <= 0 @ 2^-in_frac, saturated at -32
__device__ __forceinline__ int32_t to_log2_domain(int32_t d, int in_frac) {
  int32_t lo = -(32 << in_frac);
  d = d < lo ? lo : d;
  return mul_wrap(d, LOG2E_Q) >> (in_frac + LOG2E_FRAC - T_FRAC);
}

// 2^t for t <= 0: a right shift (by -floor(t), clamped) of the PWL 2^frac;
// the fraction t - (floor(t) << T_FRAC) is t's low T_FRAC bits
template <class Rom = RomChain>
__device__ __forceinline__ int32_t exp2_int(int32_t t, const Rom& rom = Rom()) {
  return sat_rshift(exp2_frac_int(t & ((1 << T_FRAC) - 1), rom), -(t >> T_FRAC));
}

template <class Rom = RomChain>
__device__ __forceinline__ int32_t log2_int(int32_t s, int s_frac,
                                            const Rom& rom = Rom()) {
  int32_t e_pos = floor_log2(s);
  int32_t log2m = log2_mant_int(mantissa_frac(s, e_pos), rom);
  return shl_wrap(e_pos - s_frac, T_FRAC) + log2m;
}

// sigma(2k) = softmax_1^2([k, -k]) @ 2^-EXP_FRAC, k @ 2^-k_frac.
// The reference evaluates both exponents; here amax = |k|, so one of
// k - amax and -k - amax is 0, whose exp2_int is the constant PAIR_C0 (the
// PWL at 0, generated from core/pwl.py), and the other is -2|k|.  The
// same words with one to_log2_domain and one exp2_int less (held bitwise
// to the reference over every S5.10 word, tests/test_torch_unit_rows.py).
// The sum is at least PAIR_C0 >= 1, so the reference's clamp never acts.
template <class Rom = RomChain>
__device__ __forceinline__ int32_t pair_softmax_first_int(int32_t k, int k_frac,
                                                          const Rom& rom = Rom()) {
  static_assert(PAIR_C0 >= 1, "the pair sum's clamp is dropped");
  const int32_t a = k < 0 ? -k : k;
  const int32_t t = to_log2_domain(-a - a, k_frac);
  const int32_t s = PAIR_C0 + exp2_int(t, rom);
  const int32_t w = (k < 0 ? t : 0) - log2_int(s, EXP_FRAC, rom);
  return exp2_int(w < 0 ? w : 0, rom);
}

__device__ __forceinline__ int32_t gelu_k_int(int32_t z) {
  const int32_t lim = 8 << IN_FRAC;
  z = z < -lim ? -lim : (z > lim ? lim : z);
  int32_t z2 = mul_wrap(z, z) >> IN_FRAC;
  int32_t z3 = mul_wrap(z2, z) >> IN_FRAC;
  int32_t az3 = mul_wrap(z3, GELU_A_Q) >> 16;
  return mul_wrap(z + az3, GELU_C_Q) >> 14;
}

template <class Rom = RomChain>
__device__ __forceinline__ int32_t gelu_int(int32_t z, const Rom& rom = Rom()) {
  int32_t sig = pair_softmax_first_int(gelu_k_int(z), IN_FRAC, rom);
  return mul_wrap(z, sig) >> EXP_FRAC;
}

template <class Rom = RomChain>
__device__ __forceinline__ int32_t silu_int(int32_t z, const Rom& rom = Rom()) {
  int32_t sig = pair_softmax_first_int(z, IN_FRAC + 1, rom);
  return mul_wrap(z, sig) >> EXP_FRAC;
}

// ---- the float datapath's pair mode (datapath.pair_act) ----------------

// sigma(2k) = softmax_1^2([k, -k]) through the log-domain float datapath
__device__ __forceinline__ float pair_sigmoid_f32(float k) {
  const float amax = fabsf(k);
  const float t1 = (k - amax) * LOG2E;
  const float t2 = (-k - amax) * LOG2E;
  const float s = exp2f(t1) + exp2f(t2);
  return exp2f(t1 - log2f(s));
}

// GELU (Eq. 8, k the tanh-form cubic) or SiLU (k = z / 2) in float
template <bool kGelu>
__device__ __forceinline__ float pair_act_f32(float z) {
  if (kGelu) return z * pair_sigmoid_f32(SQRT_2_OVER_PI * (z + GELU_CUBIC * z * z * z));
  return z * pair_sigmoid_f32(0.5f * z);
}

// d/dz of pair_act_f32 (datapath.pair_act_grad), through the same
// pair_sigmoid_f32 tap as the forward: s + z * 2 s (1 - s) k'(z)
template <bool kGelu>
__device__ __forceinline__ float pair_act_grad_f32(float z) {
  if (kGelu) {
    const float s = pair_sigmoid_f32(SQRT_2_OVER_PI * (z + GELU_CUBIC * z * z * z));
    const float kp = SQRT_2_OVER_PI * (1.0f + 3.0f * GELU_CUBIC * z * z);
    return s + z * (2.0f * s * (1.0f - s)) * kp;
  }
  const float s = pair_sigmoid_f32(0.5f * z);
  return s + z * s * (1.0f - s);
}

// ---- snapped-max monoid ----------------------------------------------------

__device__ __forceinline__ int32_t to_snap_domain(int32_t x) {
  if (x <= PHANTOM_Q) return SNAP_MIN;
  int32_t c = x < IN_MIN ? IN_MIN : (x > IN_MAX ? IN_MAX : x);
  return mul_wrap(c, LOG2E_Q) >> (IN_FRAC + LOG2E_FRAC - T_FRAC);
}

__device__ __forceinline__ int32_t snap_max_int(int32_t t) {
  return shl_wrap((t + ((1 << T_FRAC) - 1)) >> T_FRAC, T_FRAC);
}

template <class Rom = RomChain>
__device__ __forceinline__ int32_t snap_prob_word(int32_t t, int guard_shift,
                                                  const Rom& rom = Rom()) {
  if (t <= SNAP_MIN) return 0;
  return exp2_frac_int(t & ((1 << T_FRAC) - 1), rom) >> guard_shift;
}

// exact float 2^-d (d >= 0) by exponent-field construction; +0.0 past range
__device__ __forceinline__ float snap_scale_f32(int32_t d) {
  int32_t e = 127 - d;
  e = e < 0 ? 0 : (e > 254 ? 254 : e);
  return __int_as_float(shl_wrap(e, 23));
}

}  // namespace unit
