// flash_fwd: blocked online-softmax attention forward, float.
//
// Replaces repro/kernels/flash_attention.py:flash_attention_pallas -- the
// pallas_call of _flash_fwd_call (:192), body _flash_body (:131).  The
// per-tile step is datapath.online_softmax_update, as in the reference:
//   m' = max(m, max s);  p = 2^((s - m') log2 e);  c = 2^((m - m') log2 e)
//   l' = l c + sum p;    acc' = acc c + p @ V
// and the finish is acc / max(l, 1e-30).  With stats requested it also
// writes the per-row (m, l) of the pre-scaled scores, laid out (B, K, G,
// S), the residuals of the reference's backward kernels.
//
// Bound on the H100: operations.  Causal attention over S queries does
// ~S^2/2 x (2h + 2hv) flops per head against S (h + hv) x 8 bytes of K/V
// and Q/O; at S = 4096, h = 64 that is ~500 flops a byte, far above the
// f32 CUDA-core balance (67 TFLOP/s / 3.35 TB/s = 20).  This first
// version runs on CUDA-core f32 FMAs from shared memory (4 x 4 register
// tiles for Q K^T and P V); wgmma / TMA are later work.
//
// Grid, masking and the causal skip: see flash_tile.cuh.
#include "flash_tile.cuh"

namespace {

using namespace flash;

__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  const Smem sm = carve(smem, a.h, a.hv);
  const int qt = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  for (int r = tid; r < kBQ; r += kThreads) {
    sm.row_f[2 * r] = unit::MASK_VALUE;  // m
    sm.row_f[2 * r + 1] = 0.0f;          // l
  }
  const int32_t qmax = load_q_tile(a, sm, b, head, qt);
  const int n_tiles = tiles_to_visit(a, qmax);

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int key0 = jt * a.bkv;
    const int nk = min(a.bkv, a.T - key0);
    load_kv_tile(a, sm, b, head, key0, nk);
    __syncthreads();

    // ---- masked scores -> ps (phantoms -inf: no mass) ----
    {
      float s[4][4];
      int kind[4][4];
      score_tile(a, sm, key0, nk, s, kind);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          sm.ps[(ty * 4 + i) * (kBKV + 1) + tx + 16 * c] =
              kind[i][c] == kPhantom ? -INFINITY : s[i][c];
    }
    __syncthreads();

    // ---- online softmax update: 4 threads a row, 16 keys each ----
    {
      const int r = tid >> 2, quarter = tid & 3;
      float* prow = sm.ps + r * (kBKV + 1) + quarter * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, prow[j]);
      mx = quad_reduce(mx, MaxOp());
      const float m_old = sm.row_f[2 * r];
      const float m_new = fmaxf(m_old, mx);
      const bool live = row_live(a, sm, r, key0);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = live ? exp2f((prow[j] - m_new) * unit::LOG2E) : 0.0f;
        prow[j] = p;
        sum += p;
      }
      sum = quad_reduce(sum, SumOp());
      if (quarter == 0) {
        if (live) {
          const float corr = exp2f((m_old - m_new) * unit::LOG2E);
          sm.row_f[2 * r + 1] = sm.row_f[2 * r + 1] * corr + sum;
          sm.row_f[2 * r] = m_new;
          sm.row_c[r] = corr;
        } else {
          sm.row_c[r] = 1.0f;
        }
      }
    }
    __syncthreads();

    pv_update(a, sm, nk, acc);
    __syncthreads();
  }

  // ---- causal tail: n keys scoring MASK_VALUE, one update of n x mass ----
  if (a.causal) {
    int32_t* first = reinterpret_cast<int32_t*>(sm.ps);
    for (int r = tid; r < kBQ; r += kThreads) {
      const int32_t qp = sm.qpos[r];
      const int f = tail_start(a, qp);
      const int n = a.T - f * a.bkv;
      float p = 0.0f, corr = 1.0f;
      if (n > 0 && qp != kDeadRow) {
        const float m_old = sm.row_f[2 * r];
        const float m_new = fmaxf(m_old, unit::MASK_VALUE);
        p = exp2f((unit::MASK_VALUE - m_new) * unit::LOG2E);
        corr = exp2f((m_old - m_new) * unit::LOG2E);
        sm.row_f[2 * r + 1] = sm.row_f[2 * r + 1] * corr + static_cast<float>(n) * p;
        sm.row_f[2 * r] = m_new;
      }
      first[r * (kBKV + 1)] = f;
      sm.ps[r * (kBKV + 1) + 1] = p;
      sm.row_c[r] = corr;
    }
    __syncthreads();
    tail_acc_update(a, sm, b, head, acc);
  }

  // ---- finish: acc / max(l, 1e-30); the (m, l) stats on request ----
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    float* orow = out_row(a, b, head, qt, r);
    if (orow == nullptr) continue;
    const float l = fmaxf(sm.row_f[2 * r + 1], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < a.hv) orow[col] = acc[i][c] / l;
    }
    if (a.stat_m != nullptr && tx == 0) {
      const size_t si = stat_index(a, b, head, qt, r);
      static_cast<float*>(a.stat_m)[si] = sm.row_f[2 * r];
      static_cast<float*>(a.stat_l)[si] = sm.row_f[2 * r + 1];
    }
  }
}

}  // namespace

// Shapes as in flash::Args; every tensor contiguous, h and hv <= 128,
// 1 <= bkv <= 64; v_tail (B, cdiv(T, bkv) + 1, K, hv) f32 when causal.
// stat_m / stat_l are both null or both (B, K, G, S) f32.
extern "C" int flash_fwd_launch(const float* q, const float* k, const float* v,
                                const float* v_tail, const int32_t* q_pos,
                                const uint8_t* kv_valid,
                                float* out, float* stat_m, float* stat_l,
                                int batch, int S, int K, int G, int h, int hv,
                                int T, int bkv, int causal, void* stream) {
  if (h < 1 || h > kMaxHD || hv < 1 || hv > kMaxHD || bkv < 1 || bkv > kBKV ||
      G < 1 || S < 1 || T < 1 || (causal && v_tail == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, v_tail, q_pos, kv_valid, out, stat_m, stat_l,
               S, K, G, h, hv, T, bkv, causal, 0};
  const size_t smem = smem_bytes(h, hv);
  cudaError_t e = allow_smem(flash_fwd_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S * G + kBQ - 1) / kBQ, K, batch);
  flash_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
