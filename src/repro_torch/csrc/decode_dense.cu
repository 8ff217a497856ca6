// decode_dense: the float split-KV s_q=1 decode over a contiguous cache.
//
// Replaces repro/kernels/flash_decode.py:flash_decode_pallas, float -- the
// pallas_call of _flash_decode_jit (:162).  Each block emits the partial
// (m, l, o*l) state of one KV split; the fold (online_softmax_merge_n +
// finish) runs outside, in PyTorch, as the reference runs it outside its
// kernel.  The body is decode_dense_sm90.cuh.
//
// Bound on the H100: memory.  Every visited key's K and V rows are read
// once (h + hv floats a key and kv head) against 4 flops a key, head dim
// and GQA row, far below the card's ops-per-byte balance.
//
// The copy width is the policy's (tiling.decode_dense_vec); the entry
// refuses 16-byte copies where h, hv or the K / V base pointer is not a
// multiple of 16 bytes (q is read a float at a time).  Any split count and
// tile width are taken.
// The int decode and the paged ones (decode.cu) keep their own body and
// split rule.
#include "decode_dense_sm90.cuh"

namespace {

using namespace ddec;

template <class C>
int launch(const Args& a, int batch, cudaStream_t st) {
  const size_t smem = Smem<C>::BYTES;
  cudaError_t e = allow_smem(decode_kernel<C>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_kernel<C><<<dim3(a.splits, a.K, batch), C::W * 32, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes as in ddec::Args; every tensor contiguous f32 (q_pos int32,
// kv_valid uint8), 1 <= G <= 8, h and hv <= 128, 1 <= bkv <= 1024; vec 4
// or 1.
extern "C" int decode_dense_launch(const float* q, const float* k, const float* v,
                                   const int32_t* q_pos, const uint8_t* kv_valid,
                                   float* part_m, float* part_l, float* part_acc, int batch,
                                   int t_kv, int kh, int g, int h, int hv, int bkv,
                                   int num_splits, int causal, int vec, void* stream) {
  if (g < 1 || g > kMaxG || h < 1 || h > 128 || hv < 1 || hv > 128 || bkv < 1 ||
      bkv > 1024 || num_splits < 1 || t_kv < 1 || kh < 1 || batch < 1 ||
      (vec != 4 && vec != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4 && (h % 4 != 0 || hv % 4 != 0 || !aligned16(k) || !aligned16(v)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, q_pos, kv_valid, part_m, part_l, part_acc,
               t_kv, kh, g, h, hv, bkv, num_splits, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h <= 64 && hv <= 64)
    return vec == 4 ? launch<Cfg<64, 4>>(a, batch, st) : launch<Cfg<64, 1>>(a, batch, st);
  return vec == 4 ? launch<Cfg<128, 4>>(a, batch, st) : launch<Cfg<128, 1>>(a, batch, st);
}
