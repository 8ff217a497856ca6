// The Hopper body of the blocked flash forward: flash_fwd.cu's main kernel
// (row 7, the float online softmax) and, through its row-state policy,
// flash_snap.cu's (row 8, the unit's snapped int recurrence,
// flash_snap_sm90.cuh); and their V-sum pre-pass.
//
//   m' = max(m, max s);  p = 2^((s - m') log2 e);  c = 2^((m - m') log2 e)
//   l' = l c + sum p;    acc' = acc c + p V;        out = acc / max(l, 1e-30)
//
// (datapath.online_softmax_update, as the reference's _flash_body.)  Rows
// are the flattened (query position, group) axis of one kv head, r = s G +
// g, so the G query heads that share a kv head share its K / V tiles.
//
// Bound: full float32 FMAs on the CUDA cores (the plain version's and the
// reference's contract).  What the design does about it (it mirrors
// flash_bwd_sm90.cuh's):
//
// 1. Tiles for the card.  A block holds BQ q rows (128 at head dims up to
//    64, else 64) and streams 64-key K / V tiles through an NS-stage
//    cp.async ring in dynamic shared memory; edges are zero-filled by the
//    copy's src-size, so nothing is padded in device memory.  At MLA's h
//    up to 192 (hv up to 128) a stage holds one operand, K(t) then V(t)
//    (Cfg::ALT): two stages of both would not fit beside Q and the p tile.  Copies move
//    16 bytes where h, hv and every base pointer allow it
//    (tiling.flash_fwd_plan), 4 bytes otherwise.
// 2. Scores and row state in registers.  Thread (ty, tx) computes the
//    scores of SR rows (frag_pos<SR, 16>(ty, .)) x 4 keys (tx + 16 c) from
//    float4 reads, rows padded to D + 4 floats, each score one FMA chain
//    over the head dim in index order.  The 16 threads of a row set are 16
//    lanes of one warp: they take the row max and sum with xor shuffles,
//    and each keeps the rows' state in registers (the policy's: m, l and
//    the correction here).
// 3. p through shared memory once.  p goes to a [key][row] tile as float4s
//    of four rows; the P V product reads it back into SR x 8 register tiles
//    on the SAME rows, split by key halves over two groups of 8 threads a
//    row set at head dims up to 64 (summed in group order at the end), so
//    the correction never leaves the registers.  Two barriers a tile.
// 4. Mask only where needed.  A thread applies the per-key mask on a tile
//    only when one of its keys is invalid, past T, or past the smallest
//    q_pos of its rows (causal); kv_valid of the next tile is read ahead.
// 5. Heavy tiles first.  The tile index is the slowest grid coordinate;
//    a causal grid walks its q tiles from the last.
// 6. The causal tail at the kernel's width.  A block stops after the tile
//    holding its largest q_pos; every key after it is past every row's
//    q_pos, so it scores MASK_VALUE for every row, and the n keys fold in
//    as one update with n times the mass and the sum of V over them.  The
//    pre-pass (vsum_kernel) writes, for every 64-key tile, the sum of V from
//    it to the end of its chunk of kChunk tiles; a block adds the chunk
//    starts that follow.  A row whose visible keys are all masked still
//    gets the tail's mass, as in the plain full sweep.
// 7. Same contract as the plain version: (B, K, G, S) m / l statistics on
//    request, dead rows past S G neither read nor written, any block_kv
//    the reference takes (the mask is per key, so the result depends on
//    the tiles only through f32 summation order).
//
// The per-tile row-state step, the tail's update and the finish are a
// policy's (Rows): FloatRows here, SnapRows in flash_snap_sm90.cuh,
// Int3Rows in flash_int3_sm90.cuh.  Everything else -- the Q load, the
// ring, score_tile, the mask, the p tile, the P V product, the pre-pass and
// the tile order -- is shared.  A policy may also ask (RowsBase's traits)
// for sweeps of K alone before the main one (PRE), a main sweep that
// streams V alone and computes no scores (SCORES false: its step makes p
// from words it kept), and every tile swept, causal or not, with no tail
// (FULL).
//
// No float atomics: two calls on the same inputs give the same bits.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "block_reduce.cuh"
#include "sm90_tile.cuh"
#include "unit.cuh"

namespace ffwd {

using namespace sm90;

constexpr int kThreads = 256;
constexpr int kBK = 64;      // keys of a streamed tile (tiling.FLASH_FWD_BK)
constexpr int kChunk = 16;   // tiles a pre-pass block sums
constexpr int kDeadRow = -2147483647 - 1;  // q_pos of rows past S G

struct Args {
  const float* q;           // (B, S, K, G, h), pre-scaled
  const float* k;           // (B, T, K, h)
  const float* v;           // (B, T, K, hv)
  const int32_t* q_pos;     // (B, S)
  const uint8_t* kv_valid;  // (B, T)
  float* vsum;              // (B, n_kt, K, hv), causal: chunk-local V suffix sums
  float* out;               // (B, S, K, G, hv)
  float* stat_m;            // (B, K, G, S) or null
  float* stat_l;            // (B, K, G, S) or null
  int S, K, G, h, hv, T, causal, reverse;
  int32_t* word_m;          // snap: (B, K, G, S) snapped m, or null
  int32_t* word_s;          // snap: (B, K, G, S, 16) buckets, or null
  int guard_shift;          // snap: 0-31
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// A tile shape.  D: the width class -- h and hv padded to 64 or 128, or
// 192: h up to 192 with hv up to 128 (MLA's nope + rope against its v).  The
// Q and K tiles are DK = D columns wide, the V tile and the output DV =
// min(D, 128).  BQ rows held, kBK keys a tile, NS ring stages, VEC floats a
// global copy.  Scores: thread (ty, tx) of TY x TX holds SR rows x SC keys.
// P V: the TX threads of a row set are NG key groups x PXN column groups of
// 8.  ALT (the 192 class): two K and V stages do not fit beside Q and the p
// tile (235 520 bytes at BQ 64), so each ring stage holds one operand and
// the tiles stream as K(0), V(0), K(1), V(1), ... through NS stages:
// V(t) lands while tile t's scores are computed, K(t + 1) while its P V is.
template <int D_, int BQ_, int NS_, int VEC_>
struct Cfg {
  static constexpr int D = D_, BQ = BQ_, BK = kBK, NS = NS_, VEC = VEC_;
  static constexpr int DK = D, DV = D < 128 ? D : 128;
  static constexpr bool ALT = DK != DV;
  static constexpr int LDK = DK + 4, LDV = DV + 4;  // row strides of Q / K and V
  static constexpr int TX = 16, TY = kThreads / TX, SR = BQ / TY, SC = BK / TX;
  static constexpr int PXN = DV / 8, NG = TX / PXN, KH = BK / NG;
  static constexpr int LDT = BQ + 4;  // row stride of the [key][row] p tile
  static_assert(SR == 4 || SR == 8, "four or eight rows a thread");
  static_assert(NG * PXN == TX && (NG == 1 || NG == 2), "P V groups");
  static_assert(VEC == 1 || VEC == 4, "4- or 16-byte copies");
  static_assert(!ALT || NS >= 3, "an operand a stage: K(t + 1) streams beside V(t)");
};

// Shared memory, in floats: Q [BQ][LDK]; the ring [NS][K [BK][LDK], V
// [BK][LDV]] (KV 2) or [NS][BK][LDK] (KV 1: one operand a stage -- a sweep
// of one operand, or the ALT stream); the p tile [BK][LDT]; the row-state
// policy's own words [EXTRA], then its bytes sized at the launch.  At the
// end the ring holds the second group's accumulator [BQ][LDV] and the p
// tile the tail's V sums [DV].
template <class C, int EXTRA = 0, int KV = 2>
struct Smem {
  static constexpr int Q = 0, RING = C::BQ * C::LDK;
  static constexpr int STAGE = KV == 2 ? C::BK * (C::LDK + C::LDV) : C::BK * C::LDK;
  static constexpr int P = RING + C::NS * STAGE, X = P + C::BK * C::LDT;
  static constexpr size_t BYTES = sizeof(float) * (X + EXTRA);
  static_assert(C::NS * STAGE >= C::BQ * C::LDV, "the ring holds a group's acc");
};

// The ring layout of row policy Rows on tile shape C: one operand a stage
// for a sweep of V alone (SCORES false) or the ALT stream.
template <class C, class Rows>
struct RingKV {
  static constexpr int value = Rows::SCORES && !C::ALT ? 2 : 1;
};

// Element offset of flattened row ``flat`` in a (B, S, K, G, width) tensor.
__device__ __forceinline__ long long row_offset(const Args& a, int b, int head, int flat,
                                                int width) {
  const int s = flat / a.G, g = flat - s * a.G;
  return (((static_cast<long long>(b) * a.S + s) * a.K + head) * a.G + g) * width;
}

// t[i][c] = sum over d < depth (in order) of Q[row i][d] * K[key c][d], row i
// = frag_pos<SR, TY>(ty, i), key c = tx + TX c; zero past depth up to a
// multiple of 4.
template <class C>
__device__ __forceinline__ void score_tile(const float* qs, const float* ks, int depth, int ty,
                                           int tx, float (&t)[C::SR][C::SC]) {
#pragma unroll
  for (int i = 0; i < C::SR; ++i)
#pragma unroll
    for (int c = 0; c < C::SC; ++c) t[i][c] = 0.0f;
  const int n4 = (depth + 3) >> 2;
#pragma unroll 4
  for (int d4 = 0; d4 < n4; ++d4) {
    float4 av[C::SR];
#pragma unroll
    for (int i = 0; i < C::SR; ++i)
      av[i] = *reinterpret_cast<const float4*>(qs + frag_pos<C::SR, C::TY>(ty, i) * C::LDK +
                                               4 * d4);
#pragma unroll
    for (int c = 0; c < C::SC; ++c) {
      const float4 bv = *reinterpret_cast<const float4*>(ks + (tx + C::TX * c) * C::LDK + 4 * d4);
#pragma unroll
      for (int i = 0; i < C::SR; ++i) {
        float x = t[i][c];
        x = fmaf(av[i].x, bv.x, x);
        x = fmaf(av[i].y, bv.y, x);
        x = fmaf(av[i].z, bv.z, x);
        t[i][c] = fmaf(av[i].w, bv.w, x);
      }
    }
  }
}

// Index of flattened row ``flat`` in the (B, K, G, S) row-statistic layout.
__device__ __forceinline__ size_t stat_index(const Args& a, int b, int head, int flat) {
  const int s = flat / a.G, g = flat - s * a.G;
  return ((static_cast<size_t>(b) * a.K + head) * a.G + g) * a.S + s;
}

// The 16 lanes of a row set combine their values.
template <typename T, typename Op>
__device__ __forceinline__ T row_reduce(T v, Op op) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The block's (q tile, kv head, batch row) from a 1-D grid whose tile index
// is the slowest coordinate, walked from the last tile when reverse.
__device__ __forceinline__ void block_coords(const Args& a, int n_tiles, int batch, int* tile,
                                             int* head, int* b) {
  const int per = a.K * batch, rank = blockIdx.x / per, rem = blockIdx.x - rank * per;
  *head = rem % a.K;
  *b = rem / a.K;
  *tile = a.reverse ? n_tiles - 1 - rank : rank;
}

// ---- the V-sum pre-pass -----------------------------------------------------

// One block per (chunk of kChunk tiles, kv head, batch row): for every tile
// of the chunk, the sum of V over its keys and those of the chunk's later
// tiles, tiles walked from the last.  Warp w sums keys w, w + 8, ... of a
// tile; the warps' sums are added in warp order.  (Static: each source that
// includes this header launches its own copy.)
static __global__ void __launch_bounds__(kThreads) vsum_kernel(Args a) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float part[kWarps][128];
  const int ch = blockIdx.x, head = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n_kt = cdiv(a.T, kBK), t0 = ch * kChunk, t1 = min(n_kt, t0 + kChunk);
  float run = 0.0f;  // thread c < hv: column c's sum from the current tile on
  for (int t = t1 - 1; t >= t0; --t) {
    const int key0 = t * kBK, nk = min(kBK, a.T - key0);
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kBK / kWarps; ++i) {
      const int j = warp + kWarps * i;
      if (j >= nk) break;
      const float* row = a.v + ((static_cast<size_t>(b) * a.T + key0 + j) * a.K + head) * a.hv;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (lane + 32 * u < a.hv) x[u] += row[lane + 32 * u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) part[warp][lane + 32 * u] = x[u];
    __syncthreads();
    if (tid < a.hv) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += part[w][tid];
      run += s;
      a.vsum[((static_cast<size_t>(b) * n_kt + t) * a.K + head) * a.hv + tid] = run;
    }
    __syncthreads();
  }
}

// ---- the row-state policies ------------------------------------------------

// The traits of a policy that takes the body's default sweep: no K-only
// pre-sweeps, scores in the main sweep, the causal skip and tail fold, no
// shared memory sized at the launch.
struct RowsBase {
  static constexpr int PRE = 0;
  static constexpr bool SCORES = true, FULL = false;
  static size_t dyn_bytes(const Args&) { return 0; }
};

// ---- the float row state (row 7) ------------------------------------------

// m, l of each of the thread's rows, in registers on every lane of the row
// set.  prepare: the block's shared words (before a barrier); init: the
// rows' state; step: key tile t's masked scores in, p out, acc rescaled; tail: n keys
// of MASK_VALUE whose V sums are tv, added by the lanes that ``add``;
// publish (every lane, before the key groups merge); den: the divisor of
// row i; stats: its statistics on request.
template <class C>
struct FloatRows : RowsBase {
  static constexpr int EXTRA = 0;  // shared-memory floats of its own
  float m[C::SR], l[C::SR];

  __device__ __forceinline__ void prepare(float*, int) {}

  __device__ __forceinline__ void init(const Args&, float*, int) {
#pragma unroll
    for (int i = 0; i < C::SR; ++i) {
      m[i] = unit::MASK_VALUE;
      l[i] = 0.0f;
    }
  }

  __device__ __forceinline__ void step(int, float (&s)[C::SR][C::SC], float (&acc)[C::SR][8]) {
#pragma unroll
    for (int i = 0; i < C::SR; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int c = 1; c < C::SC; ++c) mx = fmaxf(mx, s[i][c]);
      const float m_new = fmaxf(m[i], row_reduce(mx, MaxOp()));
      const float corr = exp2f((m[i] - m_new) * unit::LOG2E);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < C::SC; ++c) {
        s[i][c] = exp2f((s[i][c] - m_new) * unit::LOG2E);
        sum += s[i][c];
      }
      l[i] = l[i] * corr + row_reduce(sum, SumOp());
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= corr;
    }
  }

  __device__ __forceinline__ void tail(int n_tail, const float (&tv)[8], bool add,
                                       float (&acc)[C::SR][8]) {
#pragma unroll
    for (int i = 0; i < C::SR; ++i) {
      const float m_new = fmaxf(m[i], unit::MASK_VALUE);
      const float p = exp2f((unit::MASK_VALUE - m_new) * unit::LOG2E);
      const float corr = exp2f((m[i] - m_new) * unit::LOG2E);
      l[i] = l[i] * corr + static_cast<float>(n_tail) * p;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = acc[i][j] * corr + (add ? p * tv[j] : 0.0f);
    }
  }

  __device__ __forceinline__ void publish(const Args&, int, int, int, int, int) {}

  __device__ __forceinline__ float den(int i) const { return fmaxf(l[i], 1e-30f); }

  __device__ __forceinline__ void stats(const Args& a, int b, int head, int flat, int i,
                                        int px) const {
    if (a.stat_m != nullptr && px == 0) {
      const size_t si = stat_index(a, b, head, flat);
      a.stat_m[si] = m[i];
      a.stat_l[si] = l[i];
    }
  }
};

// ---- the forward ------------------------------------------------------------

// One block per (q tile of BQ rows, kv head, batch row): Q stays in shared
// memory, K / V tiles of kBK keys stream through the ring up to the causal
// end.  Per tile: every thread computes its rows x keys, masks them where
// needed, and the policy updates its rows' state, rescales its accumulators
// and leaves p in the scores; then each thread writes p and adds its key
// group's p V to its SR x 8 outputs.  A policy's pre-sweeps stream K alone
// through the same ring and hand it each tile's masked scores.
template <class C, class Rows>
__global__ void __launch_bounds__(kThreads, 1) fwd_kernel(Args a, int batch) {
  using L = Smem<C, Rows::EXTRA, RingKV<C, Rows>::value>;
  static_assert(!C::ALT || (Rows::SCORES && Rows::PRE == 0 && !Rows::FULL),
                "the ALT stream is the default sweep's");
  extern __shared__ __align__(16) float sm[];
  const int R = a.S * a.G, n_qt = cdiv(R, C::BQ), n_kt = cdiv(a.T, C::BK);
  int qt, head, b;
  block_coords(a, n_qt, batch, &qt, &head, &b);
  const int q0 = qt * C::BQ;
  const int tid = threadIdx.x, tx = tid % C::TX, ty = tid / C::TX;
  const int grp = tx / C::PXN, px = tx % C::PXN;

  copy_rows<C::BQ, C::DK, C::LDK, C::VEC, kThreads>(
      sm + L::Q, a.q, a.h,
      [&](int r) -> long long { return q0 + r < R ? row_offset(a, b, head, q0 + r, a.h) : -1; },
      tid);
  cp_commit();

  // the rows' q_pos; the block's largest is the causal end
  int32_t qp[C::SR];
  int32_t qmin = 2147483647, qmax = kDeadRow;
#pragma unroll
  for (int i = 0; i < C::SR; ++i) {
    const int flat = q0 + frag_pos<C::SR, C::TY>(ty, i);
    qp[i] = flat < R ? a.q_pos[static_cast<size_t>(b) * a.S + flat / a.G] : kDeadRow;
    qmin = min(qmin, qp[i]);
    qmax = max(qmax, qp[i]);
  }
  Rows rows;
  rows.prepare(sm + L::X, tid);
  __shared__ int32_t qmax_s;
  if (tid == 0) qmax_s = kDeadRow;
  __syncthreads();
  qmax = warp_reduce(qmax, MaxOp());
  if ((tid & 31) == 0) atomicMax(&qmax_s, qmax);
  __syncthreads();
  const int n_tiles =
      !a.causal || Rows::FULL ? n_kt : qmax_s < 0 ? 0 : min(n_kt, qmax_s / C::BK + 1);

  // K (when k) and V (when v) of tile t into its ring stage, K first
  const auto fetch_kv = [&](int t, bool k, bool v) {
    float* st = sm + L::RING + (t % C::NS) * L::STAGE;
    const int key0 = t * C::BK;
    const auto k_row = [&](int width) {
      return [&, width](int j) -> long long {
        return key0 + j < a.T
                   ? ((static_cast<long long>(b) * a.T + key0 + j) * a.K + head) * width
                   : -1;
      };
    };
    if (k) copy_rows<C::BK, C::DK, C::LDK, C::VEC, kThreads>(st, a.k, a.h, k_row(a.h), tid);
    if (v)
      copy_rows<C::BK, C::DV, C::LDV, C::VEC, kThreads>(st + (k ? C::BK * C::LDK : 0), a.v,
                                                       a.hv, k_row(a.hv), tid);
  };
  // the thread's keys of tile t that are valid and below T
  const uint8_t* vrow = a.kv_valid + static_cast<size_t>(b) * a.T;
  const auto valid_bits = [&](int t) {
    unsigned bits = 0;
#pragma unroll
    for (int c = 0; c < C::SC; ++c) {
      const int j = t * C::BK + tx + C::TX * c;
      if (j < a.T && vrow[j]) bits |= 1u << c;
    }
    return bits;
  };
  // the thread's masked scores of tile t, its K at ks
  const auto masked_scores = [&](int t, unsigned valid, const float* ks,
                                 float (&s)[C::SR][C::SC]) {
    const int key0 = t * C::BK;
    score_tile<C>(sm + L::Q, ks, a.h, ty, tx, s);
    const int klast = key0 + tx + C::TX * (C::SC - 1);  // the thread's last key
    if (klast >= a.T || valid != (1u << C::SC) - 1u || (a.causal && klast > qmin)) {
#pragma unroll
      for (int c = 0; c < C::SC; ++c) {
        const int j = key0 + tx + C::TX * c;
#pragma unroll
        for (int i = 0; i < C::SR; ++i) {
          if (j >= a.T)
            s[i][c] = -INFINITY;  // a phantom: no mass
          else if (!((valid >> c) & 1u) || (a.causal && j > qp[i]))
            s[i][c] = unit::MASK_VALUE;
        }
      }
    }
  };

  // the policy's sweeps of K alone: each tile's masked scores to rows.pre
  if constexpr (Rows::PRE > 0) {
    rows.pre_begin(a, sm + L::X, tid);
    for (int sweep = 0; sweep < Rows::PRE; ++sweep) {
#pragma unroll
      for (int s = 0; s < C::NS - 1; ++s) {
        if (s < n_tiles) fetch_kv(s, true, false);
        cp_commit();
      }
      unsigned vnext = n_tiles > 0 ? valid_bits(0) : 0u;
      for (int t = 0; t < n_tiles; ++t) {
        cp_wait<C::NS - 2>();
        __syncthreads();  // tile t landed; tile t - 1's slot is free
        if (t + C::NS - 1 < n_tiles) fetch_kv(t + C::NS - 1, true, false);
        cp_commit();
        const unsigned valid = vnext;
        if (t + 1 < n_tiles) vnext = valid_bits(t + 1);
        float s[C::SR][C::SC];
        masked_scores(t, valid, sm + L::RING + (t % C::NS) * L::STAGE, s);
        rows.pre(sweep, t, s);
      }
      cp_wait<0>();
      __syncthreads();  // the ring is free
      rows.pre_end(sweep);
    }
  }

  float acc[C::SR][8];
  float* pt = sm + L::P;
  if constexpr (C::ALT) {
    // the ALT stream: item 2t is K(t), item 2t + 1 is V(t), item i in stage
    // i % NS; NS - 1 items in flight ahead of the one consumed
    const int n_items = 2 * n_tiles;
    const auto fetch_item = [&](int i) {
      float* st = sm + L::RING + (i % C::NS) * L::STAGE;
      const int key0 = (i >> 1) * C::BK;
      const auto row = [&](int width) {
        return [&, width](int j) -> long long {
          return key0 + j < a.T
                     ? ((static_cast<long long>(b) * a.T + key0 + j) * a.K + head) * width
                     : -1;
        };
      };
      if (i & 1)
        copy_rows<C::BK, C::DV, C::LDV, C::VEC, kThreads>(st, a.v, a.hv, row(a.hv), tid);
      else
        copy_rows<C::BK, C::DK, C::LDK, C::VEC, kThreads>(st, a.k, a.h, row(a.h), tid);
    };
#pragma unroll
    for (int i = 0; i < C::NS - 1; ++i) {
      if (i < n_items) fetch_item(i);
      cp_commit();
    }
    unsigned valid_next = n_tiles > 0 ? valid_bits(0) : 0u;

    rows.init(a, sm + L::X, tid);
#pragma unroll
    for (int i = 0; i < C::SR; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int t = 0; t < n_tiles; ++t) {
      cp_wait<C::NS - 2>();
      __syncthreads();  // K(t) landed; V(t - 1)'s stage and the p tile are free
      if (2 * t + C::NS - 1 < n_items) fetch_item(2 * t + C::NS - 1);
      cp_commit();
      const unsigned valid = valid_next;
      if (t + 1 < n_tiles) valid_next = valid_bits(t + 1);

      float s[C::SR][C::SC];
      masked_scores(t, valid, sm + L::RING + ((2 * t) % C::NS) * L::STAGE, s);
      rows.step(t, s, acc);
#pragma unroll
      for (int c = 0; c < C::SC; ++c)
#pragma unroll
        for (int i4 = 0; i4 < C::SR; i4 += 4)
          *reinterpret_cast<float4*>(pt + (tx + C::TX * c) * C::LDT +
                                     frag_pos<C::SR, C::TY>(ty, i4)) =
              make_float4(s[i4][c], s[i4 + 1][c], s[i4 + 2][c], s[i4 + 3][c]);
      cp_wait<C::NS - 2>();
      __syncthreads();  // V(t) landed and p written; K(t)'s stage is free
      if (2 * t + C::NS < n_items) fetch_item(2 * t + C::NS);
      cp_commit();

      // acc += p V (one key group at DV 128)
      const float* vs = sm + L::RING + ((2 * t + 1) % C::NS) * L::STAGE;
#pragma unroll 8
      for (int j = grp * C::KH; j < (grp + 1) * C::KH; ++j) {
        float av[C::SR], bv[8];
        load_frag<C::SR, C::TY>(pt + j * C::LDT, ty, av);
        load_frag<8, C::PXN>(vs + j * C::LDV, px, bv);
#pragma unroll
        for (int i = 0; i < C::SR; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < C::NS - 1; ++s) {
      if (s < n_tiles) fetch_kv(s, Rows::SCORES, true);
      cp_commit();
    }
    unsigned valid_next = Rows::SCORES && n_tiles > 0 ? valid_bits(0) : 0u;

    rows.init(a, sm + L::X, tid);
#pragma unroll
    for (int i = 0; i < C::SR; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int t = 0; t < n_tiles; ++t) {
      cp_wait<C::NS - 2>();
      __syncthreads();  // tile t landed; tile t - 1's slot and the p tile are free
      if (t + C::NS - 1 < n_tiles) fetch_kv(t + C::NS - 1, Rows::SCORES, true);
      cp_commit();
      const unsigned valid = valid_next;
      if (Rows::SCORES && t + 1 < n_tiles) valid_next = valid_bits(t + 1);
      const float* ks = sm + L::RING + (t % C::NS) * L::STAGE;
      const float* vs = Rows::SCORES ? ks + C::BK * C::LDK : ks;

      float s[C::SR][C::SC];
      if constexpr (Rows::SCORES) masked_scores(t, valid, ks, s);
      rows.step(t, s, acc);
#pragma unroll
      for (int c = 0; c < C::SC; ++c)
#pragma unroll
        for (int i4 = 0; i4 < C::SR; i4 += 4)
          *reinterpret_cast<float4*>(pt + (tx + C::TX * c) * C::LDT +
                                     frag_pos<C::SR, C::TY>(ty, i4)) =
              make_float4(s[i4][c], s[i4 + 1][c], s[i4 + 2][c], s[i4 + 3][c]);
      __syncthreads();  // p written

      // acc += p V over the thread's key group
#pragma unroll 8
      for (int j = grp * C::KH; j < (grp + 1) * C::KH; ++j) {
        float av[C::SR], bv[8];
        load_frag<C::SR, C::TY>(pt + j * C::LDT, ty, av);
        load_frag<8, C::PXN>(vs + j * C::LDV, px, bv);
#pragma unroll
        for (int i = 0; i < C::SR; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring and the p tile are free

  // the causal tail: keys [n_tiles kBK, T) score MASK_VALUE in every row
  const int n_tail = a.causal && !Rows::FULL ? a.T - n_tiles * C::BK : 0;
  if constexpr (!Rows::FULL) if (n_tail > 0) {
    float* tail = pt;
    for (int c = tid; c < C::DV; c += kThreads) {
      float x = 0.0f;
      if (c < a.hv) {
        const size_t step = static_cast<size_t>(a.K) * a.hv;
        const float* vs0 = a.vsum + static_cast<size_t>(b) * n_kt * step + head * a.hv + c;
        x = vs0[n_tiles * step];
        for (int t = (n_tiles / kChunk + 1) * kChunk; t < n_kt; t += kChunk) x += vs0[t * step];
      }
      tail[c] = x;
    }
    __syncthreads();
    float tv[8];
    load_frag<8, C::PXN>(tail, px, tv);
    rows.tail(n_tail, tv, grp == 0, acc);
  }
  rows.publish(a, b, head, q0, ty, tx);

  // the key groups' sums, in group order
  if constexpr (C::NG == 2) {
    float* part = sm + L::RING;
    if (grp == 1) {
#pragma unroll
      for (int i = 0; i < C::SR; ++i) {
        float* row = part + frag_pos<C::SR, C::TY>(ty, i) * C::LDV;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          *reinterpret_cast<float4*>(row + (j * C::PXN + px) * 4) =
              make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
      }
    }
    __syncthreads();
    if (grp == 1) return;
#pragma unroll
    for (int i = 0; i < C::SR; ++i) {
      float other[8];
      load_frag<8, C::PXN>(part + frag_pos<C::SR, C::TY>(ty, i) * C::LDV, px, other);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += other[j];
    }
  }

  // finish: acc over the policy's divisor; its statistics on request
#pragma unroll
  for (int i = 0; i < C::SR; ++i) {
    const int flat = q0 + frag_pos<C::SR, C::TY>(ty, i);
    if (flat >= R) continue;
    const float den = rows.den(i);
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = acc[i][j] / den;
    store_frag<8, C::PXN, C::VEC>(a.out + row_offset(a, b, head, flat, a.hv), px, o, a.hv);
    rows.stats(a, b, head, flat, i, px);
  }
}

// ---- the launch -------------------------------------------------------------

inline bool vec_ok(const Args& a) {
  return a.h % 4 == 0 && a.hv % 4 == 0 && aligned16(a.q) && aligned16(a.k) &&
         aligned16(a.v) && aligned16(a.out);
}

// The V-sum pre-pass (causal), then the main kernel with the row policy Rows.
template <class C, class Rows>
size_t smem_bytes(const Args& a) {
  return Smem<C, Rows::EXTRA, RingKV<C, Rows>::value>::BYTES + Rows::dyn_bytes(a);
}

template <class C, class Rows>
int launch(const Args& a, int batch, cudaStream_t st) {
  if (a.causal && !Rows::FULL) {
    vsum_kernel<<<dim3(cdiv(cdiv(a.T, kBK), kChunk), a.K, batch), kThreads, 0, st>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t smem = smem_bytes<C, Rows>(a);
  cudaError_t e = allow_smem(fwd_kernel<C, Rows>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fwd_kernel<C, Rows><<<cdiv(a.S * a.G, C::BQ) * a.K * batch, kThreads, smem, st>>>(a, batch);
  return static_cast<int>(cudaGetLastError());
}

// go(Cfg) for the tile shape the plan names -- (128, 64, 3, vec) where h, hv
// <= 64, (64, 64, 2, vec) where h, hv <= 128, the ALT stream (64, 64, 3,
// vec) where 128 < h <= 192 and hv <= 128 -- or cudaErrorInvalidValue for
// any other (bq, bk, stages, vec), for head dims past those, and for 16-byte
// copies on unaligned shapes.
template <class Go>
int with_cfg(const Args& a, int bq, int bk, int stages, int vec, Go go) {
  if (bk != kBK || (vec != 4 && vec != 1) || (vec == 4 && !vec_ok(a)) || a.h < 1 ||
      a.hv < 1 || a.hv > 128 || a.h > 192)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool narrow = a.h <= 64 && a.hv <= 64, wide = a.h > 128;
  if (narrow && bq == 128 && stages == 3)
    return vec == 4 ? go(Cfg<64, 128, 3, 4>{}) : go(Cfg<64, 128, 3, 1>{});
  if (!narrow && !wide && bq == 64 && stages == 2)
    return vec == 4 ? go(Cfg<128, 64, 2, 4>{}) : go(Cfg<128, 64, 2, 1>{});
  if (wide && bq == 64 && stages == 3)
    return vec == 4 ? go(Cfg<192, 64, 3, 4>{}) : go(Cfg<192, 64, 3, 1>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ffwd
