// selective_scan: Mamba-1's selective SSM scan over all the steps of a call,
// in one launch.
//
// Replaces the jax.lax.scan of repro/models/mamba.py:_ssm_scan (the
// chunked_time_scan at :76, its step at :64-70).  The reference has no
// pallas_call here: XLA compiles the scan into one loop on the device.
// Eager PyTorch has no such loop, and a step loop would launch some eight
// small ops a step in each layer, so the whole scan is one kernel.
//
// Per (batch row b, channel c), h the d_state f32 state, for each step t:
//   da   = expf(dt_t[c] A[c][s])                       (expf, not __expf)
//   h[s] = h[s] da + (dt_t[c] xc_t[c]) Bm_t[s]
//   y_t[c] = sum_s h[s] Cm_t[s]                        (s in order)
//
// Bound on the H100: a decode tick (B 4, d_inner 8192, d_state 16, one
// step) reads and writes the 2.1 MB state (1.25 us at 3.35 TB/s); a
// prefill of S steps moves 3 rows of d_inner floats a step (xc, dt, y) and
// 2 of d_state (S 1500 at d_inner 8192: 148 MB, 44 us) against ~8 flops a
// channel and state word a step.  A prefill's steps are sequential, so the
// byte bound is not its floor.
//
// Design:
// 1. One thread per (b, c), kThreads channels a block, grid B x
//    ceil(d_inner / kThreads); h and the channel's row of A, DS f32 each,
//    in registers (DS a template parameter: 16 is jamba's, 8 the reduced).
// 2. A tile of kTileSteps steps is staged in shared memory: Bm_t and Cm_t
//    (every channel of a row reads them), and the block's columns of xc
//    and dt (coalesced rows, so the step loop waits on no device load).
// 3. Sums in a fixed order (s = 0..DS-1) and no atomics: a call repeats bit
//    for bit, and a step's arithmetic does not depend on its place in a
//    tile, so S steps in one call equal S1 then S - S1 steps with the
//    carried state, bit for bit.
// D and the SiLU gate stay outside, in PyTorch, as the reference applies
// them after the scan.
// Inputs batch-major, as the model holds them: xc, dt, y (B, S, d_inner);
// A (d_inner, DS); Bm, Cm (B, S, DS); h0, h_out (B, d_inner, DS).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileSteps = 32;

template <int DS>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const float* __restrict__ xc, const float* __restrict__ dt,
                          const float* __restrict__ A, const float* __restrict__ Bm,
                          const float* __restrict__ Cm, const float* __restrict__ h0,
                          float* __restrict__ y, float* __restrict__ h_out, int S,
                          int di) {
  __shared__ float sb[kTileSteps][DS], sc[kTileSteps][DS];
  __shared__ float sx[kTileSteps][kThreads], sd[kTileSteps][kThreads];
  const int tid = threadIdx.x;
  const int c = blockIdx.x * kThreads + tid, b = blockIdx.y;
  const bool live = c < di;
  const long long xbase = static_cast<long long>(b) * S * di + c;
  const long long bbase = static_cast<long long>(b) * S * DS;
  const long long hbase = (static_cast<long long>(b) * di + c) * DS;

  float h[DS], a[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    h[s] = live ? h0[hbase + s] : 0.f;
    a[s] = live ? A[static_cast<long long>(c) * DS + s] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += kTileSteps) {
    const int n = min(kTileSteps, S - t0);
    __syncthreads();  // the last tile's reads are done
    for (int i = tid; i < n * DS; i += kThreads) {
      const long long o = bbase + static_cast<long long>(t0) * DS + i;
      sb[i / DS][i % DS] = Bm[o];
      sc[i / DS][i % DS] = Cm[o];
    }
    if (live) {
      for (int t = 0; t < n; ++t) {
        const long long o = xbase + static_cast<long long>(t0 + t) * di;
        sx[t][tid] = xc[o];
        sd[t][tid] = dt[o];
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < n; ++t) {
      const float dtv = sd[t][tid];
      const float dx = dtv * sx[t][tid];
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < DS; ++s) {
        const float da = expf(dtv * a[s]);
        h[s] = h[s] * da + dx * sb[t][s];
        acc += h[s] * sc[t][s];
      }
      y[xbase + static_cast<long long>(t0 + t) * di] = acc;
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < DS; ++s) h_out[hbase + s] = h[s];
  }
}

template <int DS>
int launch(const float* xc, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* h0, float* y, float* h_out, int B, int S,
           int di, cudaStream_t st) {
  const dim3 grid((di + kThreads - 1) / kThreads, B);
  selective_scan_kernel<DS><<<grid, kThreads, 0, st>>>(xc, dt, A, Bm, Cm, h0, y,
                                                       h_out, S, di);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All f32, contiguous; B, d_inner >= 1, S >= 0 (S 0 copies h0 to h_out).
// ds is 8 or 16; anything else is refused.
extern "C" int selective_scan_launch(const float* xc, const float* dt, const float* A,
                                     const float* Bm, const float* Cm, const float* h0,
                                     float* y, float* h_out, int B, int S, int di,
                                     int ds, void* stream) {
  if (B < 1 || B > 65535 || S < 0 || di < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ds) {
    case 8: return launch<8>(xc, dt, A, Bm, Cm, h0, y, h_out, B, S, di, st);
    case 16: return launch<16>(xc, dt, A, Bm, Cm, h0, y, h_out, B, S, di, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
