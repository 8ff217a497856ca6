// flash_fwd: blocked online-softmax attention forward, float.
//
// Replaces repro/kernels/flash_attention.py:flash_attention_pallas -- the
// pallas_call of _flash_fwd_call (:192), body _flash_body (:131).  The
// per-tile step is datapath.online_softmax_update, as in the reference, and
// the finish acc / max(l, 1e-30).  With stats requested it also writes the
// per-row (m, l) of the pre-scaled scores, laid out (B, K, G, S), the
// residuals of the reference's backward kernels.
//
// Bound on the H100: operations.  Causal attention over S queries does
// ~S^2/2 x (2h + 2hv) flops per head against S (h + hv) x 8 bytes of K/V
// and Q/O; at S = 4096, h = 64 that is ~500 flops a byte, far above the
// f32 CUDA-core balance (67 TFLOP/s / 3.35 TB/s = 20).  The body
// (flash_fwd_sm90.cuh) keeps full f32 FMAs on the CUDA cores.
//
// The entry is one call that launches, when causal, the V-sum pre-pass
// (the folded tail's sums at the kernel's tile width), then the main
// kernel.  The tiles, ring depth, copy width and tile order are the
// policy's (tiling.flash_fwd_plan); the entry refuses a (bq, bk, stages,
// vec) it does not instantiate, and 16-byte copies where h, hv or a base
// pointer is not a multiple of 16 bytes.  block_kv, the caller's tile, is
// checked as the reference checks it; the result depends on it only
// through f32 summation order.
#include "flash_fwd_sm90.cuh"

using namespace ffwd;

// Shapes as in ffwd::Args; every tensor contiguous f32 (q_pos int32,
// kv_valid uint8), h <= 192 and hv <= 128, 1 <= bkv <= 64.  vsum: a (B,
// cdiv(T, 64), K, hv) f32 scratch when causal.  stat_m / stat_l are both
// null or both (B, K, G, S) f32.  (bq, bk, stages, vec): (128, 64, 3, *)
// where h, hv <= 64, (64, 64, 2, *) where h, hv <= 128, (64, 64, 3, *)
// where 128 < h <= 192 (MLA's nope + rope; one operand a ring stage); vec
// 4 or 1.  reverse: walk q tiles from the last.
extern "C" int flash_fwd_launch(const float* q, const float* k, const float* v,
                                const int32_t* q_pos, const uint8_t* kv_valid, float* vsum,
                                float* out, float* stat_m, float* stat_l, int batch, int S,
                                int K, int G, int h, int hv, int T, int bkv, int causal,
                                int bq, int bk, int stages, int vec, int reverse,
                                void* stream) {
  if (h < 1 || h > 192 || hv < 1 || hv > 128 || bkv < 1 || bkv > kBK || G < 1 || S < 1 ||
      T < 1 || K < 1 || batch < 1 || (causal && vsum == nullptr) ||
      (stat_m == nullptr) != (stat_l == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k,  v,  q_pos, kv_valid, vsum,   out,     stat_m,  stat_l, S,
               K, G,  h,  hv,    T,        causal, reverse, nullptr, nullptr, 0};
  return with_cfg(a, bq, bk, stages, vec, [&](auto cfg) {
    using C = decltype(cfg);
    return launch<C, FloatRows<C>>(a, batch, static_cast<cudaStream_t>(stream));
  });
}
