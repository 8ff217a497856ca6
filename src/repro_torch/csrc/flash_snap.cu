// flash_snap: one-sweep blocked attention on the unit's snapped-max int
// recurrence (the dual-mode prefill).
//
// Replaces repro/kernels/flash_attention_int.py:flash_attention_pallas_int
// -- the pallas_call of _flash_snap_jit (:218), body _flash_snap_body
// (:139).  The body is the float forward's (flash_fwd_sm90.cuh) with the
// snapped int row state (flash_snap_sm90.cuh): m and the 16 buckets S are
// bitwise the reference's words for any tiling, acc differs from it only
// in f32 summation order.
//
// Bound on the H100: operations, as flash_fwd.cu (the 4h + 4 flops a
// visible pair), plus the int instructions the snapped recurrence adds a
// score (quantize, snap domain, the PWL exp2 word, depth, buckets), at the
// f32 rate; chip_smoke.py counts them from this entry's SASS.
//
// The entry launches, when causal, the V-sum pre-pass, then the main
// kernel (one call).  Tiles, ring depth, copy width and tile order are row
// 7's plan (tiling.flash_fwd_plan); the entry refuses any it
// does not instantiate, and 16-byte copies where h, hv or a base pointer
// is not a multiple of 16 bytes.  block_kv, the caller's tile, is checked
// as the reference checks it; the words do not depend on it.
#include "flash_snap_sm90.cuh"

using namespace ffwd;

// Shapes as in ffwd::Args; every tensor contiguous (q, k, v, vsum, out
// f32, q_pos int32, kv_valid uint8), h <= 192 and hv <= 128, 1 <= bkv <=
// 64, 0 <= guard_shift <= 31.  vsum: a (B, cdiv(T, 64), K, hv) f32
// scratch when causal.  word_m / word_s: both null, or the partial's (B,
// K, G, S) and (B, K, G, S, 16) int32 words, out then receiving the
// unnormalized acc.  (bq, bk, stages, vec, reverse) as flash_fwd_launch.
extern "C" int flash_snap_launch(const float* q, const float* k, const float* v,
                                 const int32_t* q_pos, const uint8_t* kv_valid, float* vsum,
                                 float* out, int32_t* word_m, int32_t* word_s, int batch,
                                 int S, int K, int G, int h, int hv, int T, int bkv,
                                 int causal, int guard_shift, int bq, int bk, int stages,
                                 int vec, int reverse, void* stream) {
  if (h < 1 || h > 192 || hv < 1 || hv > 128 || bkv < 1 || bkv > kBK || G < 1 || S < 1 ||
      T < 1 || K < 1 || batch < 1 || guard_shift < 0 || guard_shift > 31 ||
      (causal && vsum == nullptr) || (word_m == nullptr) != (word_s == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v,  q_pos, kv_valid, vsum,   out,     nullptr, nullptr, S,
               K, G, h,  hv,    T,        causal, reverse, word_m,  word_s,  guard_shift};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_cfg(a, bq, bk, stages, vec, [&](auto cfg) {
    using C = decltype(cfg);
    return launch<C, SnapRows<C>>(a, batch, st);
  });
}
