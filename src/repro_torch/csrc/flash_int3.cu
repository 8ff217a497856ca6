// flash_int3: three-sweep blocked attention on the unit's classic
// (unsnapped) int words -- the paper's Eq. 10, blocked.
//
// Replaces repro/kernels/flash_attention_int.py:flash_attention_pallas_int3
// -- the pallas_call of _flash_int_jit (:354), body _flash_int_body
// (:282).  The body is the float forward's (flash_fwd_sm90.cuh) with the
// classic int row state (flash_int3_sm90.cuh): the row max and the
// guard-shifted sum in K-only sweeps, then the probability words times V in
// the body's own sweep.  The words equal the whole-row softmax_int words
// bit for bit for any tiling; acc differs from the naive p V only in f32
// summation order.  guard_shift comes from the unpadded T, as the
// whole-row rule.
//
// Bound on the H100: operations, as flash_fwd.cu -- one q . k and one p . v
// a (q, key) pair (the 4h flops of the bound) -- plus the int instructions
// a score that the max, the sum and the emit take (quantize, the log2
// domain, two PWL exp2 words), at the f32 rate; chip_smoke.py counts them
// from this entry's SASS.  Where a q tile's words fit in shared memory the
// kernel computes one q . k a pair and reads K once; past that limit it
// recomputes the words in each of its three sweeps.
//
// Tiles, ring depth, copy width and the word cache are the plan's
// (tiling.flash_int3_plan): 64 q rows a block, 64-key tiles, three stages at
// head dims up to 64 and two up to 128.  The entry refuses any it does not
// instantiate, 16-byte copies where h, hv or a base pointer is not a
// multiple of 16 bytes, and the cache where it does not fit.  block_kv, the
// caller's tile, is checked as the reference checks it; the words do not
// depend on it (the mask is per key).
#include "flash_int3_sm90.cuh"

using namespace ffwd;

namespace {

constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use

template <class C, bool CACHE>
int go(const Args& a, int batch, cudaStream_t st) {
  using Rows = Int3Rows<C, CACHE>;
  if (smem_bytes<C, Rows>(a) > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  return launch<C, Rows>(a, batch, st);
}

template <class C>
int go_cache(const Args& a, int batch, int cache, cudaStream_t st) {
  return cache ? go<C, true>(a, batch, st) : go<C, false>(a, batch, st);
}

}  // namespace

// Shapes as in ffwd::Args; every tensor contiguous (q, k, v, out f32, q_pos
// int32, kv_valid uint8), h and hv <= 128, 1 <= bkv <= 64, 0 <= guard_shift
// <= 31.  (bq, bk, stages, vec): (64, 64, 3, *) where h, hv <= 64, else
// (64, 64, 2, *); vec 4 or 1.  cache: keep the words in shared memory.
extern "C" int flash_int3_launch(const float* q, const float* k, const float* v,
                                 const int32_t* q_pos, const uint8_t* kv_valid, float* out,
                                 int batch, int S, int K, int G, int h, int hv, int T,
                                 int bkv, int causal, int guard_shift, int bq, int bk,
                                 int stages, int vec, int cache, void* stream) {
  if (h < 1 || h > 128 || hv < 1 || hv > 128 || bkv < 1 || bkv > kBK || G < 1 || S < 1 ||
      T < 1 || K < 1 || batch < 1 || guard_shift < 0 || guard_shift > 31 || bq != 64 ||
      bk != kBK || (vec != 4 && vec != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v,  q_pos, kv_valid, nullptr, out,     nullptr, nullptr, S,
               K, G, h,  hv,    T,        causal,  0,       nullptr, nullptr, guard_shift};
  if (vec == 4 && !vec_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow = h <= 64 && hv <= 64;
  if (narrow && stages == 3)
    return vec == 4 ? go_cache<Cfg<64, 64, 3, 4>>(a, batch, cache, st)
                    : go_cache<Cfg<64, 64, 3, 1>>(a, batch, cache, st);
  if (!narrow && stages == 2)
    return vec == 4 ? go_cache<Cfg<128, 64, 2, 4>>(a, batch, cache, st)
                    : go_cache<Cfg<128, 64, 2, 1>>(a, batch, cache, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
