// wkv6_bwd: the backward of RWKV-6's WKV recurrence (csrc/wkv6.cu), in one
// launch a call.
//
// Replaces the gradient of the jax.lax.scan of repro/models/rwkv.py:
// rwkv_time_mix (jax.grad through the chunked_time_scan at :124,
// repro/models/scan_utils.py:17).  The reference has no pallas_call here:
// XLA differentiates the scan, saving the chunk-boundary states and
// recomputing each chunk's steps.  This kernel keeps that plan.
//
// With G = dL/dS_t, carried backwards from dS_S (the final state's incoming
// gradient), for each step t from S down to 1, per (b, h):
//   dr_t[k] = sum_j dy_t[j] (S_{t-1}[k,j] + u[k] k_t[k] v_t[j])
//   dw_t[k] = sum_j G[k,j] S_{t-1}[k,j]
//   dk_t[k] = sum_j (G[k,j] + u[k] r_t[k] dy_t[j]) v_t[j]
//   dv_t[j] = sum_k (G[k,j] + u[k] r_t[k] dy_t[j]) k_t[k]
//   du[k]  += r_t[k] k_t[k] sum_j dy_t[j] v_t[j]
//   G       = diag(w_t) G + r_t dy_t^T                         (dS_{t-1})
// and dS_0 is the last G.
//
// Bound on the H100 at rwkv6's training shape (B 2, S 2048, H 32, hd 64):
// it reads r, k, v, w, dy and writes dr, dk, dv, dw (9 rows of H hd floats
// a step) and reads the boundary states (338 MB, 101 us at 3.35 TB/s)
// against 18 hd^2 flops a step and head, the backward's 15 and one
// recompute of the state's 3 (9.7 GFLOP, 144 us at the f32 rate).  Neither
// is its floor: the steps are sequential, and only B x H = 64 blocks have
// work.
//
// Design:
// 1. One block per (b, h) of HD threads; thread k owns ROW k of S and of G
//    (the forward's threads own columns).  A step's state recompute
//    S[k][j] = S[k][j] w_t[k] + k_t[k] v_t[j] and the G update are both
//    row-local, and so are the three sums over j (dr, dw, dk): each thread
//    sums its row in a fixed order.  Only dv sums over rows, i.e. over
//    threads: one butterfly reduce-scatter a step in each warp
//    (scan::lane_reduce_scatter) and, at hd 64, the two warps' halves added
//    through shared memory, warp 0 then warp 1.  Columns would need three
//    such cross-thread sums a step instead of one.
// 2. Chunks of scan::kChunk = 64 steps are walked in reverse.  A chunk
//    starts from the forward's boundary state (``bnd``, csrc/wkv6.cu) and
//    recomputes its steps forward, keeping the state before every kSub-th
//    (8th) step in shared memory (8 x 16 KB at hd 64).  The reverse walk
//    then rebuilds S_{t-1} from the nearest such checkpoint, 3.5 steps of
//    one multiply and one fused multiply-add a word on average.  The decay
//    is never inverted: w = exp(-exp(.)) underflows towards 0, so S_{t-1} =
//    (S_t - k v^T) / w would blow up.  A chunk's 64 states (1 MB a (b, h))
//    held in a global scratch would move 32 KB a step through L2 or device
//    memory; the checkpoints stay on chip, and their re-recompute is cheap
//    FMAs.  The recompute uses the forward's pinned arithmetic (one rounded
//    product, one fused multiply-add), so it gets the forward's states bit
//    for bit.
// 3. r, k, v, w and dy of a chunk are staged in shared memory (coalesced
//    rows of HD floats a step); a thread reads its own row's words and
//    every thread the same v_t / dy_t words (broadcasts).
// 4. du sums over batch rows and time: each thread carries its u word's sum
//    over the steps, written as a (B, H, HD) partial, and a second small
//    kernel adds the partials over the batch rows in order (b = 0, 1, ...).
//    No atomics anywhere: a call repeats bit for bit.
// Shared memory at hd 64: 5 x 16 KB of inputs, 128 KB of checkpoints, 1 KB
// of dv halves (213.5 KB, one block an SM).
// Layouts as csrc/wkv6.cu: r, k, v, w, dy and dr, dk, dv, dw (B, S, H, HD);
// u, du (H, HD); bnd (B, H, NB, HD, HD), NB = ceil(S / 64) + 1; ds_in (the
// final state's gradient) and ds0 (B, H, HD, HD); du_part (B, H, HD).
#include <cuda_runtime.h>

#include "scan_common.cuh"

namespace {

using scan::kChunk;
using scan::kNSub;
using scan::kSub;

template <int HD>
struct Smem {
  float r[kChunk][HD], k[kChunk][HD], v[kChunk][HD], w[kChunk][HD];
  float dy[kChunk][HD];
  float4 ck[kNSub][HD / 4][HD];      // ck[c][q][row]: the row's words 4q..4q+3
  float dv[2][(HD + 31) / 32][HD];   // the warps' dv sums, two steps' buffers
};

template <int HD>
__device__ __forceinline__ void load_row(float (&x)[HD], const float* p) {
#pragma unroll
  for (int q = 0; q < HD / 4; ++q) {
    const float4 t = reinterpret_cast<const float4*>(p)[q];
    x[4 * q] = t.x, x[4 * q + 1] = t.y, x[4 * q + 2] = t.z, x[4 * q + 3] = t.w;
  }
}

template <int HD>
__device__ __forceinline__ void store_row(float* p, const float (&x)[HD]) {
#pragma unroll
  for (int q = 0; q < HD / 4; ++q)
    reinterpret_cast<float4*>(p)[q] =
        make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
}

// One forward step of the row: csrc/wkv6.cu's arithmetic, word for word.
template <int HD>
__device__ __forceinline__ void step_row(float (&s)[HD], float wk, float kk,
                                         const float* vrow) {
#pragma unroll
  for (int j = 0; j < HD; ++j) s[j] = __fmaf_rn(s[j], wk, __fmul_rn(kk, vrow[j]));
}

template <int HD>
__global__ void __launch_bounds__(HD)
    wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, const float* __restrict__ bnd,
                    const float* __restrict__ dy, const float* __restrict__ ds_in,
                    float* __restrict__ dr, float* __restrict__ dk,
                    float* __restrict__ dv, float* __restrict__ dw,
                    float* __restrict__ du_part, float* __restrict__ ds0, int S,
                    int H) {
  constexpr int LW = HD < 32 ? HD : 32;        // lanes a warp
  constexpr int NW = HD / LW;                  // warps a block
  constexpr int PER = HD / LW;                 // dv words a lane after the scatter
  constexpr unsigned kMask = HD < 32 ? (1u << HD) - 1u : 0xffffffffu;
  extern __shared__ float4 smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y, row = threadIdx.x;
  const int lane = row % LW, warp = row / LW;
  const int nb = (S + kChunk - 1) / kChunk + 1;
  const long long step = static_cast<long long>(H) * HD;  // floats a step
  const long long base = (static_cast<long long>(b) * S * H + h) * HD;
  const long long bh = static_cast<long long>(b) * H + h;
  const long long srow = bh * HD * HD + static_cast<long long>(row) * HD;
  const float* const brow = bnd + bh * nb * HD * HD + static_cast<long long>(row) * HD;

  float g[HD];
  load_row(g, ds_in + srow);
  const float uk = u[h * HD + row];
  float du_acc = 0.f;
  int buf = 0;
  for (int c = (S + kChunk - 1) / kChunk - 1; c >= 0; --c) {
    const int t0 = c * kChunk, n = min(kChunk, S - t0);
    __syncthreads();  // the last chunk's reads of the staged inputs are done
    for (int t = 0; t < n; ++t) {
      const long long o = base + (t0 + t) * step + row;
      sm.r[t][row] = r[o];
      sm.k[t][row] = k[o];
      sm.v[t][row] = v[o];
      sm.w[t][row] = w[o];
      sm.dy[t][row] = dy[o];
    }
    __syncthreads();

    // the chunk forward from its boundary state; a checkpoint every kSub steps
    float s[HD];
    load_row(s, brow + static_cast<long long>(c) * HD * HD);
    for (int t = 0; t < n; ++t) {
      if (t % kSub == 0) {
#pragma unroll
        for (int q = 0; q < HD / 4; ++q)
          sm.ck[t / kSub][q][row] =
              make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
      }
      step_row(s, sm.w[t][row], sm.k[t][row], sm.v[t]);
    }

    // the steps in reverse, each S_{t-1} rebuilt from its checkpoint
    for (int t = n - 1; t >= 0; --t) {
      const int c0 = t - t % kSub;
#pragma unroll
      for (int q = 0; q < HD / 4; ++q) {
        const float4 x = sm.ck[c0 / kSub][q][row];
        s[4 * q] = x.x, s[4 * q + 1] = x.y, s[4 * q + 2] = x.z, s[4 * q + 3] = x.w;
      }
      for (int p = c0; p < t; ++p) step_row(s, sm.w[p][row], sm.k[p][row], sm.v[p]);

      const float rk = sm.r[t][row], kk = sm.k[t][row], wk = sm.w[t][row];
      const float* const vt = sm.v[t];
      const float* const dyt = sm.dy[t];
      float a = 0.f, drs = 0.f, dws = 0.f, dks = 0.f;
#pragma unroll
      for (int j = 0; j < HD; ++j) {
        a = __fmaf_rn(dyt[j], vt[j], a);
        drs = __fmaf_rn(dyt[j], s[j], drs);
        dws = __fmaf_rn(g[j], s[j], dws);
        dks = __fmaf_rn(g[j], vt[j], dks);
      }
      const long long o = base + (t0 + t) * step;
      const float ua = uk * a;
      dr[o + row] = __fmaf_rn(ua, kk, drs);
      dk[o + row] = __fmaf_rn(ua, rk, dks);
      dw[o + row] = dws;
      du_acc = __fmaf_rn(rk * kk, a, du_acc);

      const float urk = uk * rk;
      float x[HD];
#pragma unroll
      for (int j = 0; j < HD; ++j) {
        x[j] = __fmaf_rn(urk, dyt[j], g[j]) * kk;
        g[j] = __fmaf_rn(wk, g[j], rk * dyt[j]);
      }
      scan::lane_reduce_scatter<HD, LW>(x, lane, kMask);
      if constexpr (NW == 1) {
        dv[o + lane] = x[0];
      } else {
#pragma unroll
        for (int i = 0; i < PER; ++i) sm.dv[buf][warp][lane * PER + i] = x[i];
        __syncthreads();
        float acc = sm.dv[buf][0][row];
#pragma unroll
        for (int wi = 1; wi < NW; ++wi) acc += sm.dv[buf][wi][row];
        dv[o + row] = acc;
        buf ^= 1;
      }
    }
  }
  store_row(ds0 + srow, g);
  du_part[bh * HD + row] = du_acc;
}

// du = the partials summed over the batch rows, b = 0, 1, ... in order.
__global__ void du_finish(const float* __restrict__ du_part, float* __restrict__ du,
                          int B, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = du_part[i];
  for (int b = 1; b < B; ++b) acc += du_part[static_cast<long long>(b) * n + i];
  du[i] = acc;
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* bnd, const float* dy, const float* ds_in,
           float* dr, float* dk, float* dv, float* dw, float* du, float* du_part,
           float* ds0, int B, int S, int H, cudaStream_t st) {
  const size_t smem = sizeof(Smem<HD>);
  cudaError_t err = scan::allow_smem(wkv6_bwd_kernel<HD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_kernel<HD><<<dim3(H, B), HD, smem, st>>>(
      r, k, v, w, u, bnd, dy, ds_in, dr, dk, dv, dw, du_part, ds0, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = H * HD;
  du_finish<<<(n + 255) / 256, 256, 0, st>>>(du_part, du, B, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All f32, contiguous; B, H >= 1, S >= 0; hd 16, 32 or 64, anything else is
// refused.  Writes dr, dk, dv, dw (B, S, H, hd), du (H, hd), ds0 (B, H, hd,
// hd); du_part (B, H, hd) is the caller's scratch.
extern "C" int wkv6_bwd_launch(const float* r, const float* k, const float* v,
                               const float* w, const float* u, const float* bnd,
                               const float* dy, const float* ds_in, float* dr,
                               float* dk, float* dv, float* dw, float* du,
                               float* du_part, float* ds0, int B, int S, int H,
                               int hd, void* stream) {
  if (B < 1 || S < 0 || H < 1 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(r, k, v, w, u, bnd, dy, ds_in, dr, dk, dv, dw, du, du_part,
                        ds0, B, S, H, st);
    case 32:
      return launch<32>(r, k, v, w, u, bnd, dy, ds_in, dr, dk, dv, dw, du, du_part,
                        ds0, B, S, H, st);
    case 64:
      return launch<64>(r, k, v, w, u, bnd, dy, ds_in, dr, dk, dv, dw, du, du_part,
                        ds0, B, S, H, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
