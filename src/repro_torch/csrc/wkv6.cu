// wkv6: RWKV-6's WKV recurrence over all the steps of a call, in one launch.
//
// Replaces the jax.lax.scan of repro/models/rwkv.py:rwkv_time_mix (the
// chunked_time_scan at :124, its step at :114-120).  The reference has no
// pallas_call here: XLA compiles the scan into one loop on the device.
// Eager PyTorch has no such loop, and a step loop would launch some eight
// small ops a step in each layer, so the whole scan is one kernel.
//
// Per (batch row b, head h), S the hd x hd f32 state, for each step t:
//   y_t[j]  = sum_k r_t[k] (S[k][j] + u[k] k_t[k] v_t[j])   (k in order)
//   S[k][j] = S[k][j] w_t[k] + k_t[k] v_t[j]
//
// Bound on the H100: a decode tick (B 4, H 32, hd 64, one step) reads and
// writes the 2.1 MB state (1.25 us at 3.35 TB/s); a batch-1 prefill of
// S steps moves 4 + 1 rows of H hd floats a step (S 1500 at d 2048: 61 MB,
// 18 us) against 7 hd^2 flops a step and head (1.2 GFLOP, 18 us at the
// f32 rate).  Neither is the floor of a prefill: its steps are sequential,
// and only B x H blocks (32 at batch 1) have work.
//
// Design:
// 1. One block per (b, h) of HD threads (HD a template parameter: 64 is
//    rwkv6's, 16 and 32 the reduced widths).  Thread j owns column j of S,
//    HD f32 in registers, read once from s0 and written once to s_out.
// 2. r, k, v, w of a tile of kTileSteps steps are staged in shared memory
//    (each a coalesced row of HD floats a step); the steps then run from
//    there, every thread reading the same k-th word (a broadcast).
// 3. Sums in a fixed order (k = 0..HD-1) and no atomics: a call repeats bit
//    for bit, and the arithmetic of a step does not depend on its place in
//    a tile, so S steps in one call equal S1 then S - S1 steps with the
//    carried state, bit for bit.  The state update is pinned to one rounded
//    product and one fused multiply-add, so that csrc/wkv6_bwd.cu, which
//    recomputes the states, gets the same bits.
// 4. A forward that trains passes ``bnd``: the state before every
//    scan::kChunk-th step and the final state, ceil(S / kChunk) + 1 of
//    them, the chunk boundaries of the reference's chunked_time_scan, for
//    the backward to recompute from.  Serving passes null: nothing more is
//    written.
// Inputs batch-major, as the model holds them: r, k, v, w, y (B, S, H, HD);
// u (H, HD); s0, s_out (B, H, HD, HD), row k column j at k HD + j; bnd
// (B, H, NB, HD, HD).
#include <cuda_runtime.h>

#include "scan_common.cuh"

namespace {

constexpr int kTileSteps = 32;

template <int HD>
__global__ void __launch_bounds__(HD)
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ s_out,
                float* __restrict__ bnd, int S, int H) {
  __shared__ float sr[kTileSteps][HD], sk[kTileSteps][HD];
  __shared__ float sv[kTileSteps][HD], sw[kTileSteps][HD];
  __shared__ float su[HD];
  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const long long step = static_cast<long long>(H) * HD;  // floats a step
  const long long base = (static_cast<long long>(b) * S * H + h) * HD + j;
  const long long sbase = (static_cast<long long>(b) * H + h) * HD * HD + j;
  const int nb = (S + scan::kChunk - 1) / scan::kChunk + 1;
  float* const bout = bnd == nullptr ? nullptr : bnd + (sbase - j) * nb + j;

  float st[HD];
#pragma unroll
  for (int kk = 0; kk < HD; ++kk) st[kk] = s0[sbase + kk * HD];
  su[j] = u[h * HD + j];

  for (int t0 = 0; t0 < S; t0 += kTileSteps) {
    const int n = min(kTileSteps, S - t0);
    if (bout != nullptr && t0 % scan::kChunk == 0) {
#pragma unroll
      for (int kk = 0; kk < HD; ++kk)
        bout[(static_cast<long long>(t0 / scan::kChunk) * HD + kk) * HD] = st[kk];
    }
    __syncthreads();  // the last tile's reads are done (and su is written)
    for (int t = 0; t < n; ++t) {
      const long long o = base + (t0 + t) * step;
      sr[t][j] = r[o];
      sk[t][j] = k[o];
      sv[t][j] = v[o];
      sw[t][j] = w[o];
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = sv[t][j];
      float acc = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD; ++kk) {
        const float kv = __fmul_rn(sk[t][kk], vj);
        acc += sr[t][kk] * (st[kk] + su[kk] * kv);
        st[kk] = __fmaf_rn(st[kk], sw[t][kk], kv);
      }
      y[base + (t0 + t) * step] = acc;
    }
  }
#pragma unroll
  for (int kk = 0; kk < HD; ++kk) s_out[sbase + kk * HD] = st[kk];
  if (bout != nullptr) {
#pragma unroll
    for (int kk = 0; kk < HD; ++kk)
      bout[(static_cast<long long>(nb - 1) * HD + kk) * HD] = st[kk];
  }
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_out, float* bnd,
           int B, int S, int H, cudaStream_t st) {
  wkv6_kernel<HD><<<dim3(H, B), HD, 0, st>>>(r, k, v, w, u, s0, y, s_out, bnd, S,
                                              H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All f32, contiguous; B, H >= 1, S >= 0 (S 0 copies s0 to s_out).  hd is
// 16, 32 or 64; anything else is refused.  bnd: null, or (B, H, ceil(S /
// 64) + 1, hd, hd) for the boundary states.
extern "C" int wkv6_launch(const float* r, const float* k, const float* v,
                           const float* w, const float* u, const float* s0, float* y,
                           float* s_out, float* bnd, int B, int S, int H, int hd,
                           void* stream) {
  if (B < 1 || S < 0 || H < 1 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(r, k, v, w, u, s0, y, s_out, bnd, B, S, H, st);
    case 32: return launch<32>(r, k, v, w, u, s0, y, s_out, bnd, B, S, H, st);
    case 64: return launch<64>(r, k, v, w, u, s0, y, s_out, bnd, B, S, H, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
