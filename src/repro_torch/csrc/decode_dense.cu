// decode_dense, decode_dense_int: the split-KV s_q=1 decode over a
// contiguous cache, float and on the unit's snapped int recurrence.
//
// Replaces repro/kernels/flash_decode.py:flash_decode_pallas --
//   decode_dense      float: the pallas_call of _flash_decode_jit (:162);
//   decode_dense_int  int: the pallas_call of _flash_decode_int_jit (:283),
//                     body _decode_body_int (:185).
// Each block emits the partial state of one KV split -- (m, l, o*l) float,
// (m snapped, S[16] buckets, acc) int; the fold (online_softmax_merge_n /
// online_merge_n_int + the finish) runs outside, in PyTorch, as the
// reference runs it outside its kernel.  The body is decode_dense_sm90.cuh,
// one kernel with a row-state policy (FloatDec, SnapDec) and a KV-layout
// policy, here ContigKV (decode_paged.cu runs the same kernel through the
// block table).  Int: the score words are int_score_words' (mask to
// MASK_VALUE, then quantize) and the step is snap_tile_update, so m and S
// are bitwise the plain version's words at the same (splits, tile); acc
// differs only in f32 summation order.
//
// Bound on the H100: memory.  Every visited key's K and V rows are read
// once (h + hv floats a key and kv head) against 4 flops a key, head dim
// and GQA row, far below the card's ops-per-byte balance.
//
// The copy width is the policy's (tiling.decode_dense_vec); the entries
// refuse 16-byte copies where h, hv or the K / V base pointer is not a
// multiple of 16 bytes (q is read a float at a time), and shapes past what
// they instantiate (ddec::dispatch).  Any split count and tile width are
// taken (tiling.decode_dense_plan's on the paths).
#include "decode_dense_sm90.cuh"

using namespace ddec;

// Shapes as in ddec::Args; every tensor contiguous (q, k, v, part_acc f32;
// q_pos int32, kv_valid uint8), 1 <= G <= 8, h <= 192 and hv <= 128 (up to
// 128 both, or MLA's nope + rope against its v: the 192 class), 1 <= bkv <=
// 1024; vec 4 or 1.  Float: part_m, part_l f32 (B, splits, K, G).
extern "C" int decode_dense_launch(const float* q, const float* k, const float* v,
                                   const int32_t* q_pos, const uint8_t* kv_valid,
                                   float* part_m, float* part_l, float* part_acc, int batch,
                                   int t_kv, int kh, int g, int h, int hv, int bkv,
                                   int num_splits, int causal, int vec, void* stream) {
  const Args a{q, k, v, q_pos, kv_valid, part_m, part_l, part_acc,
               t_kv, kh, g, h, hv, bkv, num_splits, causal, 0, nullptr, 0, 0};
  return dispatch<FloatDec, ContigKV, true>(a, batch, vec, stream);
}

// Int: part_m int32 (B, splits, K, G), part_l the int32 buckets (B,
// splits, K, G, 16); 0 <= guard_shift <= 31.
extern "C" int decode_dense_int_launch(const float* q, const float* k, const float* v,
                                       const int32_t* q_pos, const uint8_t* kv_valid,
                                       int32_t* part_m, int32_t* part_l, float* part_acc,
                                       int batch, int t_kv, int kh, int g, int h, int hv,
                                       int bkv, int num_splits, int causal, int guard_shift,
                                       int vec, void* stream) {
  if (guard_shift < 0 || guard_shift > 31) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, q_pos, kv_valid, part_m, part_l, part_acc,
               t_kv, kh, g, h, hv, bkv, num_splits, causal, guard_shift, nullptr, 0, 0};
  return dispatch<SnapDec, ContigKV, true>(a, batch, vec, stream);
}
