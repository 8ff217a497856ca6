// flash_bwd: the two backward kernels of blocked float attention.
//
// Replaces repro/kernels/flash_attention_bwd.py:flash_attention_bwd_pallas
// -- its dq pallas_call (:234, body _dq_body) and its dk/dv pallas_call
// (:266, body _dkdv_body), both on _tile_grads.  From the forward's saved
// per-row (m, l) each tile re-derives the forward's probabilities and
// takes Dao et al.'s recompute (flash_bwd_sm90.cuh, which holds the
// body); q is pre-scaled, so dq is the cotangent of the pre-scaled q.
//
// Bound on the H100: operations.  Per kept (q, k) pair dq does three
// h-deep products (Q K^T, dO V^T, dS K) and dk/dv four (those two, dS^T Q
// and p^T dO); at qwen1.5-0.5b's training shape (B 2, S = T = 4096, 16
// heads, h 64, causal) that is ~103 and ~137 GFLOP against ~0.1 GB of
// operands, ~1.5 and ~2.0 ms at 67 TFLOP/s of f32 on the CUDA cores.
//
// Each entry point is one call that launches two kernels: rows_kernel,
// the row-state pre-pass (and, for dk/dv, each q tile's largest q_pos and
// masked-tail vector), then the main kernel.  The tiles, ring depth and
// copy width are the policy's (tiling.flash_bwd_plan); an entry refuses a
// (bq, bk, stages, vec) it does not instantiate, and 16-byte copies where
// h, hv or a base pointer is not a multiple of 16 bytes.  block_kv, the
// forward's tile, is checked as the reference checks it; the backward's
// results do not depend on it (the mask is per key, and the skipped tiles'
// contributions are closed-form), up to f32 summation order.
#include "flash_bwd_sm90.cuh"

namespace {

using namespace fbwd;

int check_args(int h, int hv, int bkv, int G, int S, int T) {
  if (h < 1 || h > 128 || hv < 1 || hv > 128 || bkv < 1 || bkv > 64 || G < 1 || S < 1 ||
      T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

bool vec_ok(const Args& a) {
  return a.h % 4 == 0 && a.hv % 4 == 0 && aligned16(a.q) && aligned16(a.k) &&
         aligned16(a.v) && aligned16(a.o) && aligned16(a.dout) && aligned16(a.dq) &&
         aligned16(a.dk) && aligned16(a.dv);
}

// The pre-pass over tiles of bq rows, then the main kernel over n_tiles
// tiles of every (kv head, batch row).
template <typename Kernel>
int launch(Kernel kernel, size_t smem, int bq, int n_tiles, int batch, const Args& a,
           cudaStream_t st) {
  if (!aligned16(a.rows)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 pre(cdiv(a.S * a.G, bq), a.K, batch);
  rows_kernel<<<pre, kThreads, 0, st>>>(a, bq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<n_tiles * a.K * batch, kThreads, smem, st>>>(a, batch);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const float* q, const float* k, const float* v, const float* o,
               const float* dout, const float* m, const float* l, const int32_t* q_pos,
               const uint8_t* kv_valid, float* rows, int S, int K, int G, int h, int hv, int T,
               int causal, int reverse) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.o = o, a.dout = dout, a.m = m, a.l = l;
  a.q_pos = q_pos, a.kv_valid = kv_valid, a.rows = reinterpret_cast<float4*>(rows);
  a.S = S, a.K = K, a.G = G, a.h = h, a.hv = hv, a.T = T, a.causal = causal;
  a.reverse = reverse;
  return a;
}

}  // namespace

// Shapes as in fbwd::Args; every tensor contiguous f32 (q_pos int32,
// kv_valid uint8), h and hv <= 128, 1 <= bkv <= 64.  rows: a (B, K, S G,
// 4) f32 scratch.  (bq, bk, stages, vec): (128, 64, 3, *) where h, hv <=
// 64, else (64, 64, 2, *); vec 4 or 1.  reverse: walk q tiles from the last.
extern "C" int flash_bwd_dq_launch(const float* q, const float* k, const float* v,
                                   const float* o, const float* dout, const float* m,
                                   const float* l, const int32_t* q_pos,
                                   const uint8_t* kv_valid, float* rows, float* dq, int batch,
                                   int S, int K, int G, int h, int hv, int T, int bkv,
                                   int causal, int bq, int bk, int stages, int vec,
                                   int reverse, void* stream) {
  if (int e = check_args(h, hv, bkv, G, S, T)) return e;
  Args a = make_args(q, k, v, o, dout, m, l, q_pos, kv_valid, rows, S, K, G, h, hv, T, causal,
                     reverse);
  a.dq = dq;
  if (vec == 4 && !vec_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow = h <= 64 && hv <= 64;
  const auto go = [&](auto cfg) {
    using C = decltype(cfg);
    return launch(dq_kernel<C>, DqSmem<C>::BYTES, kPreRows, cdiv(S * G, C::BQ), batch, a, st);
  };
  if (narrow && bq == 128 && bk == 64 && stages == 3)
    return vec == 4 ? go(Cfg<64, 128, 64, 3, 4>{}) : go(Cfg<64, 128, 64, 3, 1>{});
  if (!narrow && bq == 64 && bk == 64 && stages == 2)
    return vec == 4 ? go(Cfg<128, 64, 64, 2, 4>{}) : go(Cfg<128, 64, 64, 2, 1>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// As flash_bwd_dq_launch; qmax (B, n_qt) int32 and tail (B, n_qt, K, hv)
// f32 scratch, n_qt = cdiv(S G, bq).  (bq, bk, stages, vec): (64, 128, 2,
// *) where h, hv <= 64, else (32, 64, 3, *).  reverse: walk key blocks
// from the last.
extern "C" int flash_bwd_dkdv_launch(const float* q, const float* k, const float* v,
                                     const float* o, const float* dout, const float* m,
                                     const float* l, const int32_t* q_pos,
                                     const uint8_t* kv_valid, float* rows, int32_t* qmax,
                                     float* tail, float* dk, float* dv, int batch, int S, int K,
                                     int G, int h, int hv, int T, int bkv, int causal, int bq,
                                     int bk, int stages, int vec, int reverse, void* stream) {
  if (int e = check_args(h, hv, bkv, G, S, T)) return e;
  if (qmax == nullptr || tail == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, o, dout, m, l, q_pos, kv_valid, rows, S, K, G, h, hv, T, causal,
                     reverse);
  a.qmax = qmax, a.tail = tail, a.dk = dk, a.dv = dv;
  if (vec == 4 && !vec_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow = h <= 64 && hv <= 64;
  const auto go = [&](auto cfg) {
    using C = decltype(cfg);
    a.n_qt = cdiv(S * G, C::BQ);
    return launch(dkdv_kernel<C>, DkdvSmem<C>::BYTES, C::BQ, cdiv(T, C::BK), batch, a, st);
  };
  if (narrow && bq == 64 && bk == 128 && stages == 2)
    return vec == 4 ? go(Cfg<64, 64, 128, 2, 4>{}) : go(Cfg<64, 64, 128, 2, 1>{});
  if (!narrow && bq == 32 && bk == 64 && stages == 3)
    return vec == 4 ? go(Cfg<128, 32, 64, 3, 4>{}) : go(Cfg<128, 32, 64, 3, 1>{});
  return static_cast<int>(cudaErrorInvalidValue);
}
