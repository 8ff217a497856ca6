// Split-KV s_q=1 decode over a paged KV cache (block tables), float and
// the unit's snapped int recurrence.
//
// Replaces repro/kernels/flash_decode.py --
//   decode_paged      flash_decode_paged, float (_flash_decode_paged_jit,
//                     pallas_call at :365, body _decode_body :68);
//   decode_paged_int  flash_decode_paged, int (_flash_decode_paged_int_jit,
//                     pallas_call at :440, body _decode_body_int :185).
// (The contiguous decodes, flash_decode_pallas's, run on their own body:
// decode_dense.cu.)
// One kernel body, templated over the int/float state.  Each emits
// per-split partials; the split fold (online_softmax_merge_n /
// online_merge_n_int + online_finish_int) runs outside, in PyTorch, as
// the reference runs it outside its kernel.
//
// Bound on the H100: memory.  Every visited KV tile is read once
// (2 * tile * h * 4 bytes per (row, kv-head) and tile) against 4 flops per
// key and head dim, far below the card's ops-per-byte balance.
//
// Design: one block of 128 threads (4 warps) per (split, kv-head, batch
// row).  The TPU kernel's sequential kv-tile grid axis becomes a loop
// inside the block over the split's tiles; each iteration reads its table
// entry and fetches the K and V tile through it (the scalar-prefetch index
// map of the TPU kernel becomes pointer arithmetic here).
//   scores   a warp per key: lanes stride over the head dim (coalesced
//            256-byte rows), one warp-shuffle sum per GQA row;
//   state    a warp per GQA row: max, exponentials and sums over the tile;
//   acc      a thread per (row, value dim), looping over the tile's keys
//            (coalesced across the value dim).
// Causal tiles past a row's q_pos are skipped (the reference's per-row
// tile skip).  The splits cut the table into fixed ranges and the tiles
// past the table (the reference's phantom padding of a short last split)
// are not visited.  In the reference, skipped tiles score -inf (float) /
// PHANTOM_Q (int) and are exact no-ops, up to the exp(MASK_VALUE) mass of
// fully masked tiles that its decode also drops.  A split with no tile to
// visit writes the merge identity (MASK_VALUE, 0, 0) / (SNAP_MIN, 0, 0).
// A table entry outside the pool is read as the sentinel block 0, the
// convention the cache writes use for out-of-table positions.
//
// Int path: score words are int_score_words (mask to MASK_VALUE, then
// quantize) and the tile update is snap_tile_update, so m and the 16
// depth buckets S are bitwise the reference's words (int32 atomics and
// reductions are exact in any order); acc rescales by exact powers of two.
#include <cuda_runtime.h>

#include <cmath>

#include "block_reduce.cuh"
#include "unit.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kNB = unit::N_SNAP_BUCKETS;

struct DecodeArgs {
  const float* q;          // (B, K, G, h), pre-scaled
  const float* k_pool;     // (N, bs, K, h)
  const float* v_pool;     // (N, bs, K, hv)
  const int32_t* tables;   // (B, nblk)
  const int32_t* q_pos;    // (B,)
  const uint8_t* kv_valid; // (B, nblk * bs)
  void* part_m;            // (B, S, K, G) f32 | i32
  void* part_l;            // (B, S, K, G) f32 | (B, S, K, G, 16) i32
  float* part_acc;         // (B, S, K, G, hv)
  // n_pool blocks of bs keys, nblk table entries, t_kv = nblk * bs
  int n_pool, bs, kh, g, h, hv, nblk, num_splits, inner, causal, guard_shift;
  int t_kv;
};

template <bool kInt>
__global__ void __launch_bounds__(kThreads) decode_kernel(DecodeArgs a) {
  extern __shared__ float smem[];
  const int split = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int G = a.g, h = a.h, hv = a.hv, bs = a.bs;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  float* qs = smem;                         // G*h
  float* sc = qs + G * h;                   // G*bs: scores, then p / num
  float* acc = sc + G * bs;                 // G*hv
  float* rowf = acc + G * hv;               // G: m (float)
  float* rowl = rowf + G;                   // G: l (float)
  float* rowc = rowl + G;                   // G: this tile's correction
  int32_t* ti = reinterpret_cast<int32_t*>(rowc + G);  // G*bs int words
  int32_t* mi = ti + G * bs;                // G: snapped m
  int32_t* S = mi + G;                      // G*16 buckets
  int32_t* Sblk = S + G * kNB;              // G*16 tile buckets

  const float* qrow = a.q + (static_cast<size_t>(b) * a.kh + head) * G * h;
  for (int i = tid; i < G * h; i += kThreads) qs[i] = qrow[i];
  for (int i = tid; i < G * hv; i += kThreads) acc[i] = 0.0f;
  for (int i = tid; i < G; i += kThreads) {
    rowf[i] = unit::MASK_VALUE;
    rowl[i] = 0.0f;
    mi[i] = unit::SNAP_MIN;
  }
  for (int i = tid; i < G * kNB; i += kThreads) S[i] = 0;
  __syncthreads();

  const int qpos = a.q_pos[b];
  const int t_kv = a.t_kv;
  const int tile0 = split * a.inner, tile1 = min(tile0 + a.inner, a.nblk);
  for (int jt = tile0; jt < tile1; ++jt) {
    if (a.causal && jt * bs > qpos) break;  // later tiles start later still
    int blk = a.tables[static_cast<size_t>(b) * a.nblk + jt];
    if (blk < 0 || blk >= a.n_pool) blk = 0;
    const size_t base = static_cast<size_t>(blk) * bs;  // row of the tile's first key
    // The paged tables give t_kv = nblk * bs, so nk is always bs and the
    // phantom branch below never runs.  It is dead code kept on purpose:
    // removing it moved ptxas's schedule (row 3 +13%, row 4 -9% in one
    // paired run on the H100, PERF.md section 6).  Drop it when rows 3 / 4
    // are redesigned.
    const int nk = min(bs, t_kv - jt * bs);

    // ---- scores: one warp per key ----
    for (int j = warp; j < bs; j += kWarps) {
      if (j >= nk) {                       // dead: see nk above
        if (lane < G) {
          if (kInt) ti[lane * bs + j] = unit::SNAP_MIN;
          else sc[lane * bs + j] = -INFINITY;
        }
        continue;
      }
      const float* krow = a.k_pool + ((base + j) * a.kh + head) * h;
      float part[kMaxG];
#pragma unroll
      for (int gg = 0; gg < kMaxG; ++gg) part[gg] = 0.0f;
      for (int d = lane; d < h; d += 32) {
        const float kd = krow[d];
#pragma unroll
        for (int gg = 0; gg < kMaxG; ++gg)
          if (gg < G) part[gg] += qs[gg * h + d] * kd;
      }
      const int kv_pos = jt * bs + j;
      const bool valid = a.kv_valid[static_cast<size_t>(b) * t_kv + kv_pos] != 0 &&
                         (!a.causal || kv_pos <= qpos);
#pragma unroll
      for (int gg = 0; gg < kMaxG; ++gg) {
        if (gg >= G) break;
        const float s = warp_reduce(part[gg], SumOp());
        if (lane == 0) {
          const float sm = valid ? s : unit::MASK_VALUE;
          if (kInt)
            ti[gg * bs + j] = unit::to_snap_domain(unit::quantize(sm, unit::IN_FRAC));
          else
            sc[gg * bs + j] = sm;
        }
      }
    }
    __syncthreads();

    // ---- per-row state update: one warp per GQA row ----
    for (int gg = warp; gg < G; gg += kWarps) {
      if (kInt) {
        int32_t tmax = unit::SNAP_MIN;
        for (int j = lane; j < bs; j += 32) tmax = max(tmax, ti[gg * bs + j]);
        tmax = warp_reduce(tmax, MaxOp());
        const int32_t m_old = mi[gg];
        const int32_t m_new = max(m_old, unit::snap_max_int(tmax));
        const int32_t kc = (m_new - m_old) >> unit::T_FRAC;
        if (lane < kNB) Sblk[gg * kNB + lane] = 0;
        __syncwarp();
        for (int j = lane; j < bs; j += 32) {
          const int32_t t = ti[gg * bs + j];
          const int32_t p = unit::snap_prob_word(t, a.guard_shift);
          const int32_t d = (m_new >> unit::T_FRAC) - (t >> unit::T_FRAC);
          if (d >= 0 && d < kNB && p != 0) atomicAdd(&Sblk[gg * kNB + d], p);
          sc[gg * bs + j] = static_cast<float>(p) * unit::snap_scale_f32(d);
        }
        __syncwarp();
        int32_t slid = 0;
        if (lane < kNB) {
          const int src = lane - kc;
          slid = (kc < kNB && src >= 0) ? S[gg * kNB + src] : 0;
        }
        __syncwarp();
        if (lane < kNB) S[gg * kNB + lane] = slid + Sblk[gg * kNB + lane];
        if (lane == 0) {
          mi[gg] = m_new;
          rowc[gg] = unit::snap_scale_f32(kc);
        }
      } else {
        float mx = unit::MASK_VALUE;
        for (int j = lane; j < bs; j += 32) mx = fmaxf(mx, sc[gg * bs + j]);
        mx = warp_reduce(mx, MaxOp());
        const float m_old = rowf[gg];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.0f;
        for (int j = lane; j < bs; j += 32) {
          const float p = exp2f((sc[gg * bs + j] - m_new) * unit::LOG2E);
          sc[gg * bs + j] = p;
          sum += p;
        }
        sum = warp_reduce(sum, SumOp());
        if (lane == 0) {
          const float corr = exp2f((m_old - m_new) * unit::LOG2E);
          rowl[gg] = rowl[gg] * corr + sum;
          rowf[gg] = m_new;
          rowc[gg] = corr;
        }
      }
    }
    __syncthreads();

    // ---- acc <- acc * corr + p @ V: one thread per (row, value dim) ----
    for (int i = tid; i < G * hv; i += kThreads) {
      const int gg = i / hv, d = i - gg * hv;
      const float* vcol = a.v_pool + (base * a.kh + head) * hv + d;
      const size_t vstride = static_cast<size_t>(a.kh) * hv;
      const float* prow = sc + gg * bs;
      float dot = 0.0f;
      for (int j = 0; j < nk; ++j) dot += prow[j] * vcol[j * vstride];
      acc[i] = acc[i] * rowc[gg] + dot;
    }
    __syncthreads();
  }

  // ---- partial (m, l | S, acc) of this split ----
  const size_t row0 = ((static_cast<size_t>(b) * a.num_splits + split) * a.kh + head) * G;
  for (int gg = tid; gg < G; gg += kThreads) {
    if (kInt) {
      static_cast<int32_t*>(a.part_m)[row0 + gg] = mi[gg];
    } else {
      static_cast<float*>(a.part_m)[row0 + gg] = rowf[gg];
      static_cast<float*>(a.part_l)[row0 + gg] = rowl[gg];
    }
  }
  if (kInt)
    for (int i = tid; i < G * kNB; i += kThreads)
      static_cast<int32_t*>(a.part_l)[row0 * kNB + i] = S[i];
  for (int i = tid; i < G * hv; i += kThreads) a.part_acc[row0 * hv + i] = acc[i];
}

size_t smem_bytes(int G, int h, int hv, int bs) {
  return sizeof(float) * (static_cast<size_t>(G) * (h + bs + hv) + 3 * G) +
         sizeof(int32_t) * (static_cast<size_t>(G) * bs + G + 2 * G * kNB);
}

template <bool kInt>
int launch(const DecodeArgs& a, int batch, void* stream) {
  if (a.g < 1 || a.g > kMaxG || a.bs < 1 || a.num_splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(a.g, a.h, a.hv, a.bs);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_kernel<kInt>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(a.num_splits, a.kh, batch);
  decode_kernel<kInt><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes as in DecodeArgs; every tensor contiguous.  The float kernel
// writes part_m / part_l as float32 (B, S, K, G); the int kernel writes
// part_m int32 (B, S, K, G) and part_l as the int32 buckets (B, S, K, G, 16).
#define DECODE_PARAMS                                                          \
  const float *q, const float *k_pool, const float *v_pool,                   \
      const int32_t *tables, const int32_t *q_pos, const uint8_t *kv_valid,  \
      void *part_m, void *part_l, float *part_acc, int batch, int n_pool,      \
      int bs, int kh, int g, int h, int hv, int nblk, int num_splits,         \
      int inner, int causal, int guard_shift, void *stream
#define DECODE_ARGS                                                            \
  DecodeArgs{q, k_pool, v_pool, tables, q_pos, kv_valid, part_m, part_l,      \
             part_acc, n_pool, bs, kh, g, h, hv, nblk, num_splits, inner,     \
             causal, guard_shift, nblk * bs}

extern "C" int decode_paged_launch(DECODE_PARAMS) {
  return launch<false>(DECODE_ARGS, batch, stream);
}

extern "C" int decode_paged_int_launch(DECODE_PARAMS) {
  return launch<true>(DECODE_ARGS, batch, stream);
}
