// selective_scan_bwd: the backward of Mamba-1's selective scan
// (csrc/selective_scan.cu), in one launch a call.
//
// Replaces the gradient of the jax.lax.scan of repro/models/mamba.py:
// _ssm_scan (jax.grad through the chunked_time_scan at :76,
// repro/models/scan_utils.py:17).  The reference has no pallas_call here:
// XLA differentiates the scan, saving the chunk-boundary states and
// recomputing each chunk's steps.  This kernel keeps that plan.
//
// With da = exp(dt_t[c] A[c,s]) and G = dL/dh_t, carried backwards from the
// final state's incoming gradient, for each step t from S down to 1, per
// (b, c):
//   G       += dy_t[c] C_t
//   dC_t[s]  = sum_c dy_t[c] h_t[c,s]
//   ddt_t[c] = sum_s G[s] (A[c,s] da[s] h_{t-1}[s] + x_t[c] B_t[s])
//   dx_t[c]  = dt_t[c] sum_s G[s] B_t[s]
//   dB_t[s]  = sum_c G[c,s] dt_t[c] x_t[c]
//   dA[c,s] += G[s] dt_t[c] da[s] h_{t-1}[s]
//   G        = G da                                      (dh_{t-1})
// and dh_0 is the last G.
//
// Bound on the H100 at jamba's training shape (B 1, S 2048, d_inner 8192,
// d_state 16): it reads xc, dt, dy and writes dxc, ddt (5 rows of d_inner
// floats a step) and reads the boundary states (355 MB, 106 us at 3.35
// TB/s) against 24 flops a channel and state word a step, the backward's 19
// with the exp as one and one recompute's 5 (6.4 GFLOP, 96 us at the f32
// rate).  Neither is its floor: the steps are sequential.
//
// Design:
// 1. One thread per (b, c), kThreads = 64 channels a block, grid B x
//    ceil(d_inner / 64) (128 blocks at jamba's shape); G, A's row and dA's
//    row, DS f32 each, in registers.
// 2. Chunks of scan::kChunk = 64 steps in reverse.  A chunk starts from the
//    forward's boundary state (``bnd``, csrc/selective_scan.cu) and
//    recomputes its steps, keeping the state before every kSub-th (8th)
//    step in shared memory; then each 8-step sub-chunk, in reverse, is
//    recomputed from its checkpoint into shared memory (its 9 states: the
//    step needs h_{t-1} and h_t) and walked backwards.  Two recomputes a
//    step, two exps; the decay is never divided out (da underflows towards
//    0 at large dt |A|).  The recompute uses the forward's pinned
//    arithmetic, so it gets the forward's states bit for bit.  A thread's
//    checkpoints and states are its own column of [.][DS][kThreads] arrays
//    (conflict-free).
// 3. dB and dC sum over the d_inner channels, i.e. over threads and
//    blocks: each step, one butterfly reduce-scatter of the 2 DS words in
//    each warp (scan::lane_reduce_scatter); a sub-chunk's warp sums are
//    added in warp order and written as per-block partials (B, S, n_blocks,
//    DS); a second small kernel adds the partials over the blocks in order.
//    dA sums over batch rows: per-row partials (B, d_inner, DS), added over
//    b in order by a third.  No atomics anywhere: a call repeats bit for
//    bit.
// 4. xc, dt and dy of a sub-chunk go to registers (8 coalesced loads a
//    stream); Bm and Cm of a chunk are staged in shared memory.
// Shared memory at d_state 16: 8 KB of Bm / Cm, 32 KB of checkpoints, 36 KB
// of sub-chunk states, 2 KB of warp sums (78 KB, two blocks an SM).
// Layouts as csrc/selective_scan.cu: xc, dt, dy, dxc, ddt (B, S, d_inner);
// A, dA (d_inner, DS); Bm, Cm, dBm, dCm (B, S, DS); bnd (B, NB, d_inner, DS);
// dh_in (the final state's gradient), dh0 (B, d_inner, DS); scratch: dA_part
// (B, d_inner, DS), dB_part, dC_part (B, S, n_blocks, DS).
#include <cuda_runtime.h>

#include "scan_common.cuh"

namespace {

using scan::kChunk;
using scan::kNSub;
using scan::kSub;

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;

template <int DS>
struct Smem {
  float b[kChunk][DS], c[kChunk][DS];
  float ck[kNSub][DS][kThreads];       // the state before every kSub-th step
  float hs[kSub + 1][DS][kThreads];    // a sub-chunk's states, before and after
  float red[kSub][kWarps][2 * DS];     // the warps' dB, dC sums of a sub-chunk
};

// One forward step of a channel: csrc/selective_scan.cu's arithmetic.
template <int DS>
__device__ __forceinline__ void step_channel(float (&h)[DS], const float (&a)[DS],
                                             float dtv, float xv, const float* brow) {
  const float dx = __fmul_rn(dtv, xv);
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    const float da = expf(__fmul_rn(dtv, a[s]));
    h[s] = __fmaf_rn(h[s], da, __fmul_rn(dx, brow[s]));
  }
}

template <int DS>
__global__ void __launch_bounds__(kThreads)
    selective_scan_bwd_kernel(const float* __restrict__ xc, const float* __restrict__ dt,
                              const float* __restrict__ A, const float* __restrict__ Bm,
                              const float* __restrict__ Cm,
                              const float* __restrict__ bnd,
                              const float* __restrict__ dy,
                              const float* __restrict__ dh_in,
                              float* __restrict__ dxc, float* __restrict__ ddt,
                              float* __restrict__ dA_part, float* __restrict__ dB_part,
                              float* __restrict__ dC_part, float* __restrict__ dh0,
                              int S, int di) {
  extern __shared__ float4 smem_raw[];
  Smem<DS>& sm = *reinterpret_cast<Smem<DS>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x, nblk = gridDim.x, b = blockIdx.y;
  const int c = blk * kThreads + tid;
  const bool live = c < di;
  const int nb = (S + kChunk - 1) / kChunk + 1;
  const long long xbase = static_cast<long long>(b) * S * di + c;
  const long long bbase = static_cast<long long>(b) * S * DS;
  const long long hbase = (static_cast<long long>(b) * di + c) * DS;
  const float* const brow = bnd + (static_cast<long long>(b) * nb * di + c) * DS;

  // a dead channel (c >= di) runs with zeros: its partials add nothing
  float a[DS], g[DS], da_acc[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    a[s] = live ? A[static_cast<long long>(c) * DS + s] : 0.f;
    g[s] = live ? dh_in[hbase + s] : 0.f;
    da_acc[s] = 0.f;
  }

  for (int ch = (S + kChunk - 1) / kChunk - 1; ch >= 0; --ch) {
    const int t0 = ch * kChunk, n = min(kChunk, S - t0);
    __syncthreads();  // the last chunk's reads of Bm / Cm are done
    for (int i = tid; i < n * DS; i += kThreads) {
      const long long o = bbase + static_cast<long long>(t0) * DS + i;
      sm.b[i / DS][i % DS] = Bm[o];
      sm.c[i / DS][i % DS] = Cm[o];
    }
    __syncthreads();

    // the chunk forward from its boundary state; a checkpoint every kSub steps
    float h[DS];
#pragma unroll
    for (int s = 0; s < DS; ++s)
      h[s] = live ? brow[static_cast<long long>(ch) * di * DS + s] : 0.f;
    for (int q0 = 0; q0 < n; q0 += kSub) {
      const int m = min(kSub, n - q0);
#pragma unroll
      for (int s = 0; s < DS; ++s) sm.ck[q0 / kSub][s][tid] = h[s];
      float xv[kSub], dtv[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const long long o = xbase + static_cast<long long>(t0 + q0 + i) * di;
        xv[i] = live && i < m ? xc[o] : 0.f;
        dtv[i] = live && i < m ? dt[o] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i)
        if (i < m) step_channel(h, a, dtv[i], xv[i], sm.b[q0 + i]);
    }

    // the sub-chunks in reverse
    for (int q0 = (n - 1) / kSub * kSub; q0 >= 0; q0 -= kSub) {
      const int m = min(kSub, n - q0);
      float xv[kSub], dtv[kSub], dyv[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const long long o = xbase + static_cast<long long>(t0 + q0 + i) * di;
        const bool in = live && i < m;
        xv[i] = in ? xc[o] : 0.f;
        dtv[i] = in ? dt[o] : 0.f;
        dyv[i] = in ? dy[o] : 0.f;
      }
#pragma unroll
      for (int s = 0; s < DS; ++s) {
        h[s] = sm.ck[q0 / kSub][s][tid];
        sm.hs[0][s][tid] = h[s];
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        if (i < m) {
          step_channel(h, a, dtv[i], xv[i], sm.b[q0 + i]);
#pragma unroll
          for (int s = 0; s < DS; ++s) sm.hs[i + 1][s][tid] = h[s];
        }
      }
#pragma unroll
      for (int i = kSub - 1; i >= 0; --i) {
        if (i >= m) continue;
        const float* const bt = sm.b[q0 + i];
        const float* const ct = sm.c[q0 + i];
        float part[2 * DS];                      // dB words, then dC words
        float dts = 0.f, dxs = 0.f;
        const float dxb = __fmul_rn(dtv[i], xv[i]);
#pragma unroll
        for (int s = 0; s < DS; ++s) {
          const float hprev = sm.hs[i][s][tid], hcur = sm.hs[i + 1][s][tid];
          g[s] = __fmaf_rn(dyv[i], ct[s], g[s]);
          part[DS + s] = dyv[i] * hcur;
          const float da = expf(__fmul_rn(dtv[i], a[s]));
          const float gdh = g[s] * da * hprev;   // G da h_{t-1}
          dts = __fmaf_rn(gdh, a[s], dts);
          dts = __fmaf_rn(g[s] * xv[i], bt[s], dts);
          dxs = __fmaf_rn(g[s], bt[s], dxs);
          part[s] = g[s] * dxb;
          da_acc[s] = __fmaf_rn(gdh, dtv[i], da_acc[s]);
          g[s] *= da;
        }
        if (live) {
          const long long o = xbase + static_cast<long long>(t0 + q0 + i) * di;
          ddt[o] = dts;
          dxc[o] = dtv[i] * dxs;
        }
        scan::lane_reduce_scatter<2 * DS, 32>(part, lane, 0xffffffffu);
        // lane l now holds word l / (32 / 2 DS) (DS 16: word l)
        constexpr int kRep = 32 / (2 * DS);
        if (lane % kRep == 0) sm.red[i][warp][lane / kRep] = part[0];
      }
      __syncthreads();
      for (int j = tid; j < m * 2 * DS; j += kThreads) {
        const int i = j / (2 * DS), word = j % (2 * DS);
        float acc = sm.red[i][0][word];
#pragma unroll
        for (int wi = 1; wi < kWarps; ++wi) acc += sm.red[i][wi][word];
        float* const out = word < DS ? dB_part : dC_part;
        out[((static_cast<long long>(b) * S + t0 + q0 + i) * nblk + blk) * DS
            + word % DS] = acc;
      }
      __syncthreads();  // the warp sums are read before the next sub-chunk
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      dh0[hbase + s] = g[s];
      dA_part[hbase + s] = da_acc[s];
    }
  }
}

// dB, dC (B, S, DS) = the per-block partials summed over the blocks in
// order; dA (di, DS) = the per-row partials summed over the rows in order.
__global__ void bc_finish(const float* __restrict__ dB_part,
                          const float* __restrict__ dC_part, float* __restrict__ dB,
                          float* __restrict__ dC, long long n_rows, int nblk, int ds) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_rows * ds) return;
  const long long row = i / ds, s = i % ds;
  const long long p = row * nblk * ds + s;
  float ab = dB_part[p], ac = dC_part[p];
  for (int k = 1; k < nblk; ++k) {
    ab += dB_part[p + static_cast<long long>(k) * ds];
    ac += dC_part[p + static_cast<long long>(k) * ds];
  }
  dB[i] = ab;
  dC[i] = ac;
}

__global__ void a_finish(const float* __restrict__ dA_part, float* __restrict__ dA,
                         int B, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = dA_part[i];
  for (int b = 1; b < B; ++b) acc += dA_part[b * n + i];
  dA[i] = acc;
}

template <int DS>
int launch(const float* xc, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* bnd, const float* dy, const float* dh_in,
           float* dxc, float* ddt, float* dA, float* dBm, float* dCm, float* dA_part,
           float* dB_part, float* dC_part, float* dh0, int B, int S, int di,
           cudaStream_t st) {
  const size_t smem = sizeof(Smem<DS>);
  cudaError_t err = scan::allow_smem(selective_scan_bwd_kernel<DS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblk = (di + kThreads - 1) / kThreads;
  selective_scan_bwd_kernel<DS><<<dim3(nblk, B), kThreads, smem, st>>>(
      xc, dt, A, Bm, Cm, bnd, dy, dh_in, dxc, ddt, dA_part, dB_part, dC_part, dh0,
      S, di);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(B) * S;
  if (rows > 0) {
    bc_finish<<<static_cast<unsigned>((rows * DS + 255) / 256), 256, 0, st>>>(
        dB_part, dC_part, dBm, dCm, rows, nblk, DS);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n = static_cast<long long>(di) * DS;
  a_finish<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(dA_part, dA, B, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All f32, contiguous; B, d_inner >= 1, S >= 0; ds 8 or 16, anything else
// is refused.  Writes dxc, ddt (B, S, di), dA (di, ds), dBm, dCm (B, S, ds),
// dh0 (B, di, ds); dA_part (B, di, ds) and dB_part, dC_part (B, S,
// ceil(di / 64), ds) are the caller's scratch.
extern "C" int selective_scan_bwd_launch(
    const float* xc, const float* dt, const float* A, const float* Bm, const float* Cm,
    const float* bnd, const float* dy, const float* dh_in, float* dxc, float* ddt,
    float* dA, float* dBm, float* dCm, float* dA_part, float* dB_part, float* dC_part,
    float* dh0, int B, int S, int di, int ds, void* stream) {
  if (B < 1 || B > 65535 || S < 0 || di < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ds) {
    case 8:
      return launch<8>(xc, dt, A, Bm, Cm, bnd, dy, dh_in, dxc, ddt, dA, dBm, dCm,
                       dA_part, dB_part, dC_part, dh0, B, S, di, st);
    case 16:
      return launch<16>(xc, dt, A, Bm, Cm, bnd, dy, dh_in, dxc, ddt, dA, dBm, dCm,
                        dA_part, dB_part, dC_part, dh0, B, S, di, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
