// The Hopper body of the split-KV s_q=1 decode: decode_dense.cu's kernels
// over a contiguous cache (rows 5, 6) and decode_paged.cu's over a paged
// one through its block table (rows 3, 4), float and the unit's snapped
// int recurrence, one kernel through two policies: a row-state policy (FloatDec, SnapDec) and a
// KV-layout policy (ContigKV, PagedKV: which pool row holds key j of batch
// row b).  Each block writes the partial state of one KV split of one
// (batch row, kv head) -- (m, l, acc) float, (m snapped, S[16] buckets,
// acc) int; the fold of the splits runs outside, in PyTorch, as the
// reference runs it outside its kernel.
//
// Keys: the split covers the tiles of bkv keys (paged: the pages) that
// dense_split_tiles gives it -- its share of the row's LIVE tiles (up to
// the tile holding q_pos when causal) -- up to T.  A key that kv_valid
// marks invalid, or (causal) that lies past q_pos, scores MASK_VALUE and
// carries mass as in the plain version; keys past T are not visited; a
// split with no tile writes the merge identity ((MASK_VALUE, 0, 0) float,
// (SNAP_MIN, 0, 0) int).  kv_valid and the causal test read the LOGICAL
// position j; only the K / V address goes through the layout.
//
// Bound: the K / V bytes (4 flops a key and head dim against 8 bytes).
// What the design does about it:
//
// 1. Wide loads, many in flight.  Every warp streams its own keys through
//    its own NS-stage cp.async ring in dynamic shared memory, KW keys of K
//    and V a stage, 16-byte copies where h, hv and the K / V base pointers
//    allow it (tiling.decode_dense_vec), 4-byte ones otherwise; edges are
//    zero-filled by the copy's src-size.  Two blocks fit an SM.  Paged,
//    lane j < KW resolves key j of a step through the table once (a page
//    row is a multiple of h floats, so 16-byte copies stay aligned), and
//    the copies take each key's row from its lane by a shuffle; a step may
//    span two pages, since a page may hold fewer keys than a step.
// 2. Keys split across warps.  The W warps of a block take W runs of the
//    split's keys, each a multiple of KW keys long.
// 3. One K / V read serves every GQA row.  In the score step LPK lanes share
//    a key, each reading DK / LPK of its head dims as float4s (rows padded
//    by 4 LPK floats, so the reads fall in distinct banks) and dotting them
//    with every row's q from shared memory; LPK - 1 shuffles finish a dot.
//    At MLA's h 192 / hv 128 a key's 192 dims are 12 float4s on each of its
//    4 lanes, the V rows 128 wide (Cfg's 192 class).
// 4. No block barrier in the key loop.  Each warp keeps its own online
//    state (the policy's, on every lane; acc with the value columns spread
//    over the lanes, D / 32 a lane), synchronised by __syncwarp: p passes
//    through a per-warp buffer once a step.
//      float  m, l in registers;
//      int    the snapped m of each GQA row in registers, and lane b < 16
//             holds bucket b of each row (G <= 8 registers); the slide is
//             one shuffle, and a step's words go to a per-warp [G][16]
//             tile by shared int32 atomics, read back by the owning lanes.
//             The PWL exp2 lookup reads the ROM from shared memory.
// 5. Fixed row loops.  The key loop runs GT GQA rows, G rounded up to 1,
//    2, 4 or 8 (one instantiation each), so its row loops unroll with no
//    exit and the rows' dependent chains (the dot, its shuffles, the row
//    step) interleave; the padded rows have zero q and are not stored.
// 6. Fixed-order merge.  At the end each warp writes its state into its
//    own ring, and after the one block barrier every (row, column) folds
//    the warps' states in warp order into the split's partial.  The int
//    words merge exactly in any order (monoid), so m and S are the plain
//    version's sequential words; acc rescales by exact powers of two.
//
// No float atomics: two calls on the same inputs give the same bits.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sm90_tile.cuh"
#include "unit.cuh"

namespace ddec {

using namespace sm90;

constexpr int kMaxG = 8;   // GQA rows a kv head the kernel holds

struct Args {
  const float* q;           // (B, K, G, h), pre-scaled
  const float* k;           // contiguous (B, T, K, h) | paged (n_pool, bkv, K, h)
  const float* v;           // contiguous (B, T, K, hv) | paged (n_pool, bkv, K, hv)
  const int32_t* q_pos;     // (B,)
  const uint8_t* kv_valid;  // (B, T)
  void* part_m;             // (B, splits, K, G): f32 | int32 snapped m
  void* part_l;             // f32 (B, splits, K, G) | int32 (B, splits, K, G, 16)
  float* part_acc;          // (B, splits, K, G, hv)
  int T, K, G, h, hv, bkv, splits, causal;
  int guard_shift;          // int: 0-31
  const int32_t* tables;    // paged: (B, nblk) pool blocks of bkv keys, T = nblk bkv
  int nblk, n_pool;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// A block shape.  D: the width class -- h and hv padded to 64 or 128, or
// 192: h up to 192 with hv up to 128 (MLA's nope + rope against its v).  K
// rows are DK = D floats, V rows and the output DV = min(D, 128).  VEC
// floats a global copy; GT GQA rows in the key loop (G rounded up to 1, 2,
// 4 or 8: the rows past G have zero q and are never stored), so its row
// loops have a fixed trip count and the rows' dependent chains (dot,
// shuffles, exp2) interleave; W warps and NS ring stages at every D (two
// blocks fit an SM).  Score step: LPK lanes a key (DV / 32, so that a step's
// KW keys match the P V columns a lane), each dotting DK / LPK head dims;
// P V: CPL value columns a lane.
template <int D_, int VEC_, int GT_>
struct Cfg {
  static constexpr int D = D_, W = 4, NS = 2, VEC = VEC_, GT = GT_;
  static constexpr int DK = D, DV = D < 128 ? D : 128;
  static constexpr int LPK = DV / 32, KW = 32 / LPK, CPL = DV / 32;
  static constexpr int LDK = DK + 4 * LPK, LDV = DV + 4 * LPK;  // = 4 LPK (mod 32)
  static constexpr int STAGE = KW * (LDK + LDV);  // K [KW][LDK], V [KW][LDV] floats
  static_assert(D == 64 || D == 128 || D == 192, "head dims up to 64, 128 or 192 / 128");
  static_assert(DK % (4 * LPK) == 0, "whole float4s a lane");
  static_assert(VEC == 1 || VEC == 4, "4- or 16-byte copies");
  static_assert(GT == 1 || GT == 2 || GT == 4 || GT == kMaxG, "GQA rows 1, 2, 4 or 8");
};

// Shared memory, in floats: q [kMaxG][DK]; the policy's block words [BX];
// per warp: the ring [NS][STAGE], p [kMaxG][KW] and the policy's warp words
// [WX].  At the end a warp's ring holds its acc [kMaxG][DV], then the
// policy's state (STATE words).
template <class C, class Rows>
struct Smem {
  static constexpr int Q = 0, X = kMaxG * C::DK, RING = X + Rows::BX;
  static constexpr int P = C::NS * C::STAGE, W0 = P + kMaxG * C::KW;
  static constexpr int WARP = W0 + Rows::WX;
  static constexpr size_t BYTES = sizeof(float) * (RING + C::W * WARP);
  static_assert(C::NS * C::STAGE >= kMaxG * C::DV + Rows::STATE, "the ring holds the state");
};

// A KV-layout policy (ContigKV, PagedKV): resolve the step's keys [key0,
// r1) once a step, on every lane, before the step's copies; off(j) is
// the offset of the step's key key0 + j in K (width h) or V (width hv) at
// kv head ``head``, or -1 past the run, asked once for each copy and the
// same on every lane.
//
// Contiguous: key j of batch row b is row b T + j.
template <class C>
struct ContigKV {
  __device__ __forceinline__ void resolve(const Args&, int, int, int, int) {}
  __device__ __forceinline__ long long off(const Args& a, int b, int head, int key0, int r1,
                                           int j, int width) const {
    return key0 + j < r1 ? ((static_cast<long long>(b) * a.T + key0 + j) * a.K + head) * width
                         : -1;
  }
};

// Paged: key j of batch row b is row blk bkv + j % bkv of the pool, blk =
// tables[b, j / bkv]; an entry outside [0, n_pool) reads the sentinel
// block 0.  Lane j < KW resolves the step's key j once; the copies take
// it by a shuffle, so the table is read and divided by once a key and step.
template <class C>
struct PagedKV {
  int mine;  // the pool row of the step's key lane, -1 past the run

  __device__ __forceinline__ void resolve(const Args& a, int b, int key0, int r1, int lane) {
    const int j = key0 + lane;
    mine = -1;
    if (lane < C::KW && j < r1) {
      const int page = j / a.bkv;
      int blk = a.tables[static_cast<size_t>(b) * a.nblk + page];
      if (blk < 0 || blk >= a.n_pool) blk = 0;
      mine = blk * a.bkv + (j - page * a.bkv);
    }
  }
  __device__ __forceinline__ long long off(const Args& a, int, int head, int, int, int j,
                                           int width) const {
    const int r = __shfl_sync(0xffffffffu, mine, j);
    return r < 0 ? -1 : (static_cast<long long>(r) * a.K + head) * width;
  }
};

// A row-state policy (FloatDec, SnapDec): prepare the block's shared words
// (every thread, before a barrier); init the state; step row g at the
// step's keys (p of the lane's key out, acc rescaled); end_step after the
// step's __syncwarp; store row g's state after its acc; merge the warps'
// states into the split's partial.
//
// The float online softmax's state (row 5): m, l of each GQA row in
// registers on every lane.
template <class C>
struct FloatDec {
  static constexpr int BX = 0, WX = 0, STATE = 2 * kMaxG;
  float m[kMaxG], l[kMaxG];

  __device__ __forceinline__ void prepare(float*, float*, int) {}

  __device__ __forceinline__ void init(const Args&, float*, float*, int) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      m[g] = unit::MASK_VALUE;
      l[g] = 0.0f;
    }
  }

  // Row g at the step's keys, s the lane's key's masked score: p of that
  // key, acc rescaled.
  __device__ __forceinline__ float step(int g, float s, float (&acc)[C::CPL]) {
    float mx = s;
#pragma unroll
    for (int o = C::LPK; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m[g], mx);
    const float corr = exp2f((m[g] - m_new) * unit::LOG2E);
    const float p = exp2f((s - m_new) * unit::LOG2E);
    float sum = p;
#pragma unroll
    for (int o = C::LPK; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    l[g] = l[g] * corr + sum;
    m[g] = m_new;
#pragma unroll
    for (int c = 0; c < C::CPL; ++c) acc[c] *= corr;
    return p;
  }

  __device__ __forceinline__ void end_step() {}

  // row g's m, l after the warp's acc: st[g], st[kMaxG + g]
  __device__ __forceinline__ void store(float* st, int g, int lane) const {
    if (lane == 0) {
      st[g] = m[g];
      st[kMaxG + g] = l[g];
    }
  }

  // The warps' states (warp w's acc at ws(w), its state at ws(w) + kMaxG DV)
  // folded in warp order into the split's partial rows row0 + g.
  template <class WS>
  __device__ static void merge(const Args& a, WS ws, size_t row0, int tid, int nt) {
    const int G = a.G;
    for (int i = tid; i < G * a.hv; i += nt) {
      const int g = i / a.hv, c = i - g * a.hv;
      float m_all = -INFINITY;
#pragma unroll
      for (int w = 0; w < C::W; ++w) m_all = fmaxf(m_all, ws(w)[kMaxG * C::DV + g]);
      float l_all = 0.0f, acc_all = 0.0f;
#pragma unroll
      for (int w = 0; w < C::W; ++w) {
        const float* st = ws(w);
        const float sc = exp2f((st[kMaxG * C::DV + g] - m_all) * unit::LOG2E);
        l_all += st[kMaxG * C::DV + kMaxG + g] * sc;
        acc_all += st[g * C::DV + c] * sc;
      }
      a.part_acc[(row0 + g) * a.hv + c] = acc_all;
      if (c == 0) {
        static_cast<float*>(a.part_m)[row0 + g] = m_all;
        static_cast<float*>(a.part_l)[row0 + g] = l_all;
      }
    }
  }
};

// The unit's snapped int state (row 6): the snapped m of each GQA row on
// every lane, bucket b of each row on lane b < 16.  Per step and row, in
// the reference's order: t = to_snap_domain(quantize(s)) (keys past the
// run SNAP_MIN), m' = max(m, snap_max_int(max t)), k = (m' - m) >> T_FRAC,
// p = snap_prob_word(t, guard), d = (m' >> T_FRAC) - (t >> T_FRAC);
// S' = slide(S, k) + the step's per-depth sums of p; acc = acc 2^-k +
// (p 2^-d) V.
template <class C>
struct SnapDec {
  static constexpr int kNB = unit::N_SNAP_BUCKETS;
  // block: the ROM's 16 pairs; warp: the step's [kMaxG][16] bucket tile;
  // state: m [kMaxG], then S [kMaxG][16]
  static constexpr int BX = 32, WX = kMaxG * kNB, STATE = kMaxG * (1 + kNB);
  int32_t m[kMaxG], S[kMaxG];
  int32_t* wb;
  unit::RomTable rom;
  int guard, part, bucket;

  // the ROM's pairs; this warp's bucket tile zeroed
  __device__ __forceinline__ void prepare(float* bx, float* wx, int tid) {
    if (tid < 16) unit::rom_fill(reinterpret_cast<int2*>(bx), tid);
    for (int j = tid & 31; j < WX; j += 32) reinterpret_cast<int32_t*>(wx)[j] = 0;
  }

  __device__ __forceinline__ void init(const Args& a, float* bx, float* wx, int lane) {
    rom.tab = reinterpret_cast<const int2*>(bx);
    wb = reinterpret_cast<int32_t*>(wx);
    guard = a.guard_shift;
    part = lane % C::LPK;
    bucket = lane & (kNB - 1);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      m[g] = unit::SNAP_MIN;
      S[g] = 0;
    }
  }

  __device__ __forceinline__ float step(int g, float s, float (&acc)[C::CPL]) {
    const int32_t t = s == -INFINITY ? unit::SNAP_MIN
                                     : unit::to_snap_domain(unit::quantize(s, unit::IN_FRAC));
    int32_t mx = t;
#pragma unroll
    for (int o = C::LPK; o < 32; o <<= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const int32_t m_new = max(m[g], unit::snap_max_int(mx));
    const int32_t k = (m_new - m[g]) >> unit::T_FRAC;
    m[g] = m_new;
    const int32_t p = unit::snap_prob_word(t, guard, rom);
    const int32_t d = (m_new >> unit::T_FRAC) - (t >> unit::T_FRAC);
    if (part == 0 && p != 0 && d < kNB) atomicAdd(wb + g * kNB + d, p);
    // S'[b] = S[b - k], zero where b < k (lanes past 16 carry copies)
    const int32_t v = __shfl_sync(0xffffffffu, S[g], bucket >= k ? bucket - k : bucket, kNB);
    S[g] = bucket >= k ? v : 0;
    const float corr = unit::snap_scale_f32(k);
#pragma unroll
    for (int c = 0; c < C::CPL; ++c) acc[c] *= corr;
    return static_cast<float>(p) * unit::snap_scale_f32(d);
  }

  // After the step's __syncwarp: the owning lanes take the step's sums
  // (the next step's adds follow the next __syncwarp).
  __device__ __forceinline__ void end_step() {
#pragma unroll
    for (int g = 0; g < C::GT; ++g) {
      if ((threadIdx.x & 31) < kNB) {
        int32_t* w = wb + g * kNB + bucket;
        S[g] += *w;
        *w = 0;
      }
    }
  }

  // row g's m, then its buckets, after the warp's acc
  __device__ __forceinline__ void store(float* st, int g, int lane) const {
    int32_t* sti = reinterpret_cast<int32_t*>(st);
    if (lane == 0) sti[g] = m[g];
    if (lane < kNB) sti[kMaxG + g * kNB + lane] = S[g];
  }

  template <class WS>
  __device__ static void merge(const Args& a, WS ws, size_t row0, int tid, int nt) {
    const int G = a.G;
    const auto m_of = [&](int w, int g) {
      return reinterpret_cast<const int32_t*>(ws(w) + kMaxG * C::DV)[g];
    };
    const auto m_all = [&](int g) {
      int32_t x = unit::SNAP_MIN;
#pragma unroll
      for (int w = 0; w < C::W; ++w) x = max(x, m_of(w, g));
      return x;
    };
    for (int i = tid; i < G * a.hv; i += nt) {
      const int g = i / a.hv, c = i - g * a.hv;
      const int32_t mg = m_all(g);
      float acc_all = 0.0f;
#pragma unroll
      for (int w = 0; w < C::W; ++w)
        acc_all += ws(w)[g * C::DV + c] * unit::snap_scale_f32((mg - m_of(w, g)) >> unit::T_FRAC);
      a.part_acc[(row0 + g) * a.hv + c] = acc_all;
      if (c == 0) static_cast<int32_t*>(a.part_m)[row0 + g] = mg;
    }
    for (int i = tid; i < G * kNB; i += nt) {
      const int g = i / kNB, d = i - g * kNB;
      const int32_t mg = m_all(g);
      int32_t x = 0;
#pragma unroll
      for (int w = 0; w < C::W; ++w) {
        const int32_t k = (mg - m_of(w, g)) >> unit::T_FRAC;
        const int32_t* sw = reinterpret_cast<const int32_t*>(ws(w) + kMaxG * C::DV + kMaxG);
        x += d >= k ? sw[g * kNB + d - k] : 0;
      }
      static_cast<int32_t*>(a.part_l)[(row0 + g) * kNB + d] = x;
    }
  }
};

template <class C, class Rows, class KV>
__global__ void __launch_bounds__(C::W * 32) decode_kernel(Args a) {
  using L = Smem<C, Rows>;
  constexpr int kThreads = C::W * 32;
  extern __shared__ __align__(16) float sm[];
  const int split = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kk = lane / C::LPK, part = lane % C::LPK;  // score step: key, dims
  const int G = a.G;

  const float* qrow = a.q + (static_cast<size_t>(b) * a.K + head) * G * a.h;
  for (int i = threadIdx.x; i < kMaxG * C::DK; i += kThreads) {
    const int g = i / C::DK, d = i - g * C::DK;
    sm[L::Q + i] = g < G && d < a.h ? qrow[g * a.h + d] : 0.0f;
  }
  Rows rows;
  rows.prepare(sm + L::X, sm + L::RING + warp * L::WARP + L::W0, threadIdx.x);
  __syncthreads();

  // the split's keys [k0, k1), the warp's run [r0, r1) of them
  const int qpos = a.q_pos[b];
  const int nblk = cdiv(a.T, a.bkv);
  const int live = !a.causal ? nblk : qpos < 0 ? 0 : min(nblk, qpos / a.bkv + 1);
  const int inner = cdiv(live, a.splits);
  const int tile0 = min(split * inner, live), tile1 = min(tile0 + inner, live);
  const int k0 = tile0 * a.bkv, k1 = min(tile1 * a.bkv, a.T);
  const int run = cdiv(cdiv(k1 - k0, C::W), C::KW) * C::KW;
  const int r0 = min(k0 + warp * run, k1), r1 = min(r0 + run, k1);
  const int steps = cdiv(r1 - r0, C::KW);

  float* ring = sm + L::RING + warp * L::WARP;
  float* pb = ring + L::P;
  KV layout;
  const auto fetch = [&](int st) {
    float* dst = ring + (st % C::NS) * C::STAGE;
    const int key0 = r0 + st * C::KW;
    layout.resolve(a, b, key0, r1, lane);
    const auto k_row = [&](int width) {
      return [&, width](int j) -> long long { return layout.off(a, b, head, key0, r1, j, width); };
    };
    copy_rows<C::KW, C::DK, C::LDK, C::VEC, 32>(dst, a.k, a.h, k_row(a.h), lane);
    copy_rows<C::KW, C::DV, C::LDV, C::VEC, 32>(dst + C::KW * C::LDK, a.v, a.hv, k_row(a.hv),
                                               lane);
  };
#pragma unroll
  for (int s = 0; s < C::NS - 1; ++s) {
    if (s < steps) fetch(s);
    cp_commit();
  }
  // the lane's key of step st: 1 live, 0 masked (MASK_VALUE), -1 past the run
  const uint8_t* vrow = a.kv_valid + static_cast<size_t>(b) * a.T;
  const auto key_kind = [&](int st) {
    const int j = r0 + st * C::KW + kk;
    if (j >= r1) return -1;
    return vrow[j] && !(a.causal && j > qpos) ? 1 : 0;
  };
  int kind_next = steps > 0 ? key_kind(0) : -1;

  rows.init(a, sm + L::X, ring + L::W0, lane);
  float acc[kMaxG][C::CPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int c = 0; c < C::CPL; ++c) acc[g][c] = 0.0f;
  for (int st = 0; st < steps; ++st) {
    cp_wait<C::NS - 2>();
    __syncwarp();  // step st landed; step st - 1's slot and p are free
    if (st + C::NS - 1 < steps) fetch(st + C::NS - 1);
    cp_commit();
    const int kind = kind_next;
    if (st + 1 < steps) kind_next = key_kind(st + 1);
    const float* ks = ring + (st % C::NS) * C::STAGE;
    const float* vs = ks + C::KW * C::LDK;

    float4 kv[C::DK / (4 * C::LPK)];
#pragma unroll
    for (int i = 0; i < C::DK / (4 * C::LPK); ++i)
      kv[i] = *reinterpret_cast<const float4*>(ks + kk * C::LDK + 4 * (C::LPK * i + part));
#pragma unroll
    for (int g = 0; g < C::GT; ++g) {
      const float* qg = sm + L::Q + g * C::DK;
      float x = 0.0f;
#pragma unroll
      for (int i = 0; i < C::DK / (4 * C::LPK); ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qg + 4 * (C::LPK * i + part));
        x = fmaf(qv.x, kv[i].x, x);
        x = fmaf(qv.y, kv[i].y, x);
        x = fmaf(qv.z, kv[i].z, x);
        x = fmaf(qv.w, kv[i].w, x);
      }
#pragma unroll
      for (int o = 1; o < C::LPK; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      const float s = kind > 0 ? x : kind == 0 ? unit::MASK_VALUE : -INFINITY;
      const float p = rows.step(g, s, acc[g]);
      if (part == 0) pb[g * C::KW + kk] = p;
    }
    __syncwarp();  // p written
    rows.end_step();

    // acc += p V: the lane's CPL value columns, four keys at a time
#pragma unroll
    for (int j4 = 0; j4 < C::KW; j4 += 4) {
      float pv[C::GT][4];
#pragma unroll
      for (int g = 0; g < C::GT; ++g) {
        const float4 t = *reinterpret_cast<const float4*>(pb + g * C::KW + j4);
        pv[g][0] = t.x, pv[g][1] = t.y, pv[g][2] = t.z, pv[g][3] = t.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[C::CPL];
        const float* vr = vs + (j4 + jj) * C::LDV + lane * C::CPL;
        if constexpr (C::CPL == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vr);
          vv[0] = t.x, vv[1] = t.y, vv[2] = t.z, vv[3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(vr);
          vv[0] = t.x, vv[1] = t.y;
        }
#pragma unroll
        for (int g = 0; g < C::GT; ++g) {
#pragma unroll
          for (int c = 0; c < C::CPL; ++c) acc[g][c] = fmaf(pv[g][jj], vv[c], acc[g][c]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncwarp();  // the warp's ring is free

  float* st = ring;  // acc [kMaxG][DV], then the policy's state
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int c = 0; c < C::CPL; ++c) st[g * C::DV + lane * C::CPL + c] = acc[g][c];
    rows.store(st + kMaxG * C::DV, g, lane);
  }
  __syncthreads();  // every warp's state written

  const size_t row0 = ((static_cast<size_t>(b) * a.splits + split) * a.K + head) * G;
  Rows::merge(a, [&](int w) -> const float* { return sm + L::RING + w * L::WARP; }, row0,
              threadIdx.x, kThreads);
}

// The kernel with the row policy Rows and the layout KV, one block a
// (split, kv head, batch row).
template <class C, class Rows, class KV>
int launch(const Args& a, int batch, cudaStream_t st) {
  const size_t smem = Smem<C, Rows>::BYTES;
  cudaError_t e = allow_smem(decode_kernel<C, Rows, KV>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_kernel<C, Rows, KV><<<dim3(a.splits, a.K, batch), C::W * 32, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <template <class> class Rows, template <class> class KV, int D, int VEC, int GT>
int launch_cfg(const Args& a, int batch, cudaStream_t st) {
  using C = Cfg<D, VEC, GT>;
  return launch<C, Rows<C>, KV<C>>(a, batch, st);
}

template <template <class> class Rows, template <class> class KV, int D, int VEC>
int launch_rows(const Args& a, int batch, cudaStream_t st) {
  if (a.G <= 1) return launch_cfg<Rows, KV, D, VEC, 1>(a, batch, st);
  if (a.G <= 2) return launch_cfg<Rows, KV, D, VEC, 2>(a, batch, st);
  if (a.G <= 4) return launch_cfg<Rows, KV, D, VEC, 4>(a, batch, st);
  return launch_cfg<Rows, KV, D, VEC, kMaxG>(a, batch, st);
}

// An entry's launch: the instantiation for a's shape (D by h and hv, GT by
// G, the copy width vec), after refusing what none instantiates -- G
// outside 1..8, hv outside 1..128, h outside 1..128 (or, with WIDE, 1..192:
// the 192 class, for MLA's nope + rope), 16-byte copies (vec 4) where h, hv
// or the K / V base pointer is off 16 bytes.
template <template <class> class Rows, template <class> class KV, bool WIDE = false>
int dispatch(const Args& a, int batch, int vec, void* stream) {
  if (a.G < 1 || a.G > kMaxG || a.h < 1 || a.h > (WIDE ? 192 : 128) || a.hv < 1 ||
      a.hv > 128 || a.bkv < 1 || a.bkv > 1024 || a.splits < 1 || a.T < 1 || a.K < 1 ||
      batch < 1 || (vec != 4 && vec != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4 && (a.h % 4 != 0 || a.hv % 4 != 0 || !aligned16(a.k) || !aligned16(a.v)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.h <= 64 && a.hv <= 64)
    return vec == 4 ? launch_rows<Rows, KV, 64, 4>(a, batch, st)
                    : launch_rows<Rows, KV, 64, 1>(a, batch, st);
  if constexpr (WIDE) {
    if (a.h > 128)
      return vec == 4 ? launch_rows<Rows, KV, 192, 4>(a, batch, st)
                      : launch_rows<Rows, KV, 192, 1>(a, batch, st);
  }
  return vec == 4 ? launch_rows<Rows, KV, 128, 4>(a, batch, st)
                  : launch_rows<Rows, KV, 128, 1>(a, batch, st);
}

}  // namespace ddec
