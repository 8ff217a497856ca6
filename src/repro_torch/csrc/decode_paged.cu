// decode_paged, decode_paged_int: the split-KV s_q=1 decode over a paged
// cache (block tables), float and on the unit's snapped int recurrence.
//
// Replaces repro/kernels/flash_decode.py:flash_decode_paged --
//   decode_paged      float: the pallas_call of _flash_decode_paged_jit
//                     (:365), body _decode_body (:68);
//   decode_paged_int  int: the pallas_call of _flash_decode_paged_int_jit
//                     (:440), body _decode_body_int (:185).
// The reference's paged body is the contiguous sweep with the gather in
// its pipeline, and so is this one: decode_dense.cu's kernel
// (decode_dense_sm90.cuh) with the PagedKV layout, which reads each key's
// pool row through the table.  The tile is the page: a split takes its
// share of the row's live pages (dense_split_tiles), and every key of a
// live page is visited, so m and S are bitwise the plain version's words
// at the same splits and the partials' float parts differ only in f32
// order.  The fold of the splits runs outside, in PyTorch.
//
// Bound on the H100: memory, as decode_dense.cu (the K and V rows of each
// key the mask keeps, read once); the table adds 4 bytes a live page.  The entries refuse
// a table or pool past the kernel's int offsets, and what ddec::dispatch
// refuses.
#include "decode_dense_sm90.cuh"

using namespace ddec;

namespace {

// Whether the kernel's int offsets reach the table and the pool: at most
// 2^30 keys a row and 2^31 pool rows.
bool paged_fits(int n_pool, int bs, int nblk) {
  return n_pool >= 1 && bs >= 1 && nblk >= 1 &&
         static_cast<long long>(nblk) * bs <= (1LL << 30) &&
         static_cast<long long>(n_pool) * bs < (1LL << 31);
}

// A paged call's Args: the pools in place of k, v, T = nblk * bs.
Args paged_args(const float* q, const float* k_pool, const float* v_pool,
                const int32_t* tables, const int32_t* q_pos, const uint8_t* kv_valid,
                void* part_m, void* part_l, float* part_acc, int n_pool, int bs, int kh,
                int g, int h, int hv, int nblk, int num_splits, int causal, int guard_shift) {
  return Args{q, k_pool, v_pool, q_pos, kv_valid, part_m, part_l, part_acc, nblk * bs, kh, g,
              h, hv, bs, num_splits, causal, guard_shift, tables, nblk, n_pool};
}

}  // namespace

// k_pool (n_pool, bs, K, h), v_pool (n_pool, bs, K, hv), tables int32 (B,
// nblk), kv_valid uint8 (B, nblk * bs), q (B, K, G, h) pre-scaled, q_pos
// int32 (B,); every tensor contiguous; n_pool >= 1 (block 0 is the
// sentinel an entry outside the pool reads), 1 <= bs <= 1024, 1 <= G <= 8,
// h and hv <= 128; vec 4 or 1.  Float: part_m, part_l f32 (B, splits, K,
// G), part_acc f32 (B, splits, K, G, hv).
extern "C" int decode_paged_launch(const float* q, const float* k_pool, const float* v_pool,
                                   const int32_t* tables, const int32_t* q_pos,
                                   const uint8_t* kv_valid, float* part_m, float* part_l,
                                   float* part_acc, int batch, int n_pool, int bs, int kh,
                                   int g, int h, int hv, int nblk, int num_splits, int causal,
                                   int vec, void* stream) {
  if (!paged_fits(n_pool, bs, nblk)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = paged_args(q, k_pool, v_pool, tables, q_pos, kv_valid, part_m, part_l,
                            part_acc, n_pool, bs, kh, g, h, hv, nblk, num_splits, causal, 0);
  return dispatch<FloatDec, PagedKV>(a, batch, vec, stream);
}

// Int: part_m int32 (B, splits, K, G), part_l the int32 buckets (B,
// splits, K, G, 16); 0 <= guard_shift <= 31.
extern "C" int decode_paged_int_launch(const float* q, const float* k_pool,
                                       const float* v_pool, const int32_t* tables,
                                       const int32_t* q_pos, const uint8_t* kv_valid,
                                       int32_t* part_m, int32_t* part_l, float* part_acc,
                                       int batch, int n_pool, int bs, int kh, int g, int h,
                                       int hv, int nblk, int num_splits, int causal,
                                       int guard_shift, int vec, void* stream) {
  if (guard_shift < 0 || guard_shift > 31 || !paged_fits(n_pool, bs, nblk))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = paged_args(q, k_pool, v_pool, tables, q_pos, kv_valid, part_m, part_l,
                            part_acc, n_pool, bs, kh, g, h, hv, nblk, num_splits, causal,
                            guard_shift);
  return dispatch<SnapDec, PagedKV>(a, batch, vec, stream);
}
