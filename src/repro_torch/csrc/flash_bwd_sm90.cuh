// The Hopper body of the flash backward: flash_bwd.cu's dq (row 10) and
// dk/dv (row 11) kernels and their row-state pre-pass.
//
//   p  = 2^((s - m) log2 e) * (1 / max(l, 1e-30))   (the forward's p / l)
//   D  = rowsum(dO * O)
//   dS = p (dO V^T - D), zero where the score is MASK_VALUE or a phantom
//   dQ = dS K       dK = dS^T Q       dV = p^T dO
//
// Rows are the flattened (query position, group) axis of one kv head, r =
// s G + g, so the G query heads that share a kv head share its K / V.
//
// Bound: full float32 FMAs on the CUDA cores (the plain version's and the
// reference's contract).  What the design does about it:
//
// 1. Row state once per row.  rows_kernel writes (m, 1 / max(l, 1e-30), D,
//    q_pos) of every row into a (B, K, S G) float4 scratch before the main
//    kernel, so no inner loop reads O or m / l; for dk/dv it also writes
//    each q tile's largest q_pos and its masked-tail vector, the sum over
//    its rows of exp2((MASK_VALUE - m) log2 e) / l * dO.
// 2. A skipped q tile is a vector sum.  A causal dk/dv block adds the tail
//    vector of every q tile that lies wholly before its keys (it would see
//    each of them masked, and a masked key's p still reaches dV) to every
//    key's dV, and never loads that tile.  The mask is per key, so the
//    result does not depend on the tiles, up to f32 summation order.
// 3. Tiles for the card.  dq holds BQ rows (128 at head dims up to 64) and
//    streams 64-key tiles; dk/dv holds BK keys (128 up to 64) and streams
//    q tiles of BQ rows.  In the score step each thread computes S = Q K^T
//    and dP = dO V^T for the same rows x 4 keys and turns them into p and
//    dS in registers, so the exp2 and mask work is spread over all 256
//    threads and needs no exchange; one barrier later the threads split
//    into two groups of 128: dk/dv's first group takes dV += p^T dO and
//    the second dK += dS^T Q, dq's groups the two key halves of dQ += dS
//    K, summed in group order at the end.  Two barriers a tile.
// 4. Register tiles read as float4s.  The score step reads rows four head
//    dims at a time (8 rows x 4 keys a thread at head dims up to 64);
//    every gradient product is 8 x 8 outputs a thread from two float4
//    reads of each operand a step: 4 FMAs a shared-memory word.  Rows are
//    padded to D + 4 floats, so a warp's float4 reads of neighbouring rows
//    fall in distinct banks.
// 5. A cp.async ring.  The streamed operand (dq: K and V tiles; dk/dv: Q,
//    dO and row-state tiles) lands in an NS-stage ring in dynamic shared
//    memory; edges are zero-filled by the copy's src-size, so nothing is
//    padded in device memory.  Copies move 16 bytes where h, hv and every
//    base pointer allow it (tiling.flash_bwd_plan), 4 bytes otherwise.
// 6. Heavy blocks first.  The tile index is the slowest grid coordinate; a
//    causal dq grid walks its q tiles from the last (those visit the most
//    keys), a dk/dv grid its key blocks from the first.
// 7. Two-level sums in dk/dv: each q tile's contribution is summed in
//    registers, then added to the running dK / dV in tile order.
//
// No float atomics: two calls on the same inputs give the same bits.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "block_reduce.cuh"
#include "sm90_tile.cuh"
#include "unit.cuh"

namespace fbwd {

using namespace sm90;

constexpr int kThreads = 256;    // two groups of kGroup in the gradient products
constexpr int kGroup = 128;
constexpr int kDeadRow = -2147483647 - 1;  // largest q_pos of no row
constexpr int kWindow = 1024;    // q tiles a dk/dv block lists at a time
constexpr int kPreRows = 64;     // most rows of a pre-pass block

struct Args {
  const float* q;           // (B, S, K, G, h), pre-scaled
  const float* k;           // (B, T, K, h)
  const float* v;           // (B, T, K, hv)
  const float* o;           // (B, S, K, G, hv)
  const float* dout;        // (B, S, K, G, hv)
  const float* m;           // (B, K, G, S)
  const float* l;           // (B, K, G, S)
  const int32_t* q_pos;     // (B, S)
  const uint8_t* kv_valid;  // (B, T)
  float4* rows;             // (B, K, S G): m, 1 / max(l, 1e-30), D, q_pos bits
  int32_t* qmax;            // (B, n_qt): each dk/dv q tile's largest q_pos
  float* tail;              // (B, n_qt, K, hv): each dk/dv q tile's tail vector
  float* dq;                // (B, S, K, G, h)
  float* dk;                // (B, T, K, h)
  float* dv;                // (B, T, K, hv)
  int S, K, G, h, hv, T, causal, n_qt, reverse;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// A tile shape.  D: h and hv padded to 64 or 128.  BQ rows x BK keys a
// step (dq holds BQ rows, dk/dv BK keys); NS ring stages; VEC floats a
// global copy.  Score step: a thread holds SR rows (ty + TY i) x SC keys
// (tx + TX c) of both S and dP.  Gradient products: each group of kGroup
// threads, 8 x 8 outputs a thread, PY groups of eight rows (dq) or keys
// (dk/dv) x PX groups of eight columns.
template <int D_, int BQ_, int BK_, int NS_, int VEC_>
struct Cfg {
  static constexpr int D = D_, BQ = BQ_, BK = BK_, NS = NS_, VEC = VEC_;
  static constexpr int LD = D + 4;       // row stride of Q, dO, K, V tiles
  static constexpr int SC = 4, TX = BK / SC, TY = kThreads / TX, SR = BQ / TY;
  static constexpr int PX = D / 8, PY = kGroup / PX;
  static_assert(TX * TY == kThreads && SR * TY == BQ, "score tile");
  static_assert(VEC == 1 || VEC == 4, "4- or 16-byte copies");
  static_assert((BQ * D / VEC) % kThreads == 0 && (BK * D / VEC) % kThreads == 0,
                "whole copy rounds");
};

// dq's shared memory, in floats: Q, dO [BQ][LD], the row state [BQ]
// (float4), the ring [NS][K, V][BK][LD], the dS tile transposed
// [BK][BQ + 4].  At the end the ring holds group 1's dQ [BQ][LD].
template <class C>
struct DqSmem {
  static constexpr int LDT = C::BQ + 4;
  static constexpr int Q = 0, DO = C::BQ * C::LD, RS = 2 * C::BQ * C::LD;
  static constexpr int RING = RS + 4 * C::BQ, STAGE = 2 * C::BK * C::LD;
  static constexpr int T = RING + C::NS * STAGE;
  static constexpr size_t BYTES = sizeof(float) * (T + C::BK * LDT);
  static_assert(C::NS * STAGE >= C::BQ * C::LD, "the ring holds dQ at the end");
};

// dk/dv's shared memory, in floats: K, V [BK][LD]; the ring [NS][Q, dO
// [BQ][LD], row state [BQ] float4]; p and dS [BQ][BK + 4]; the tail
// partials [kThreads / D][D]; the q-tile list [kWindow + 1] (int32).
template <class C>
struct DkdvSmem {
  static constexpr int LDP = C::BK + 4;
  static constexpr int K = 0, V = C::BK * C::LD, RING = 2 * C::BK * C::LD;
  static constexpr int STAGE = 2 * C::BQ * C::LD + 4 * C::BQ;
  static constexpr int P = RING + C::NS * STAGE, DS = P + C::BQ * LDP;
  static constexpr int TAILP = DS + C::BQ * LDP, LIST = TAILP + kThreads;
  static constexpr size_t BYTES = sizeof(float) * (LIST + kWindow + 1);
};

// ROWS rows of D columns into dst (row stride C::LD): row r from src +
// off(r), columns past ``width`` and rows with off(r) < 0 as zeros.
template <class C, int ROWS, class Off>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int width, Off off) {
  sm90::copy_rows<ROWS, C::D, C::LD, C::VEC, kThreads>(dst, src, width, off, threadIdx.x);
}

// ---- index helpers ----------------------------------------------------------

// Element offset of flattened row ``flat`` in a (B, S, K, G, width) tensor.
__device__ __forceinline__ long long row_offset(const Args& a, int b, int head, int flat,
                                                int width) {
  const int s = flat / a.G, g = flat - s * a.G;
  return ((((static_cast<long long>(b) * a.S + s) * a.K + head) * a.G + g) * width);
}

// ---- the products -----------------------------------------------------------

// t[i][c] = sum over d < depth (in order) of A[ty + TY i][d] * B[tx + TX c][d];
// A and B row-major with stride C::LD, zero past depth up to a multiple of 4.
template <class C>
__device__ __forceinline__ void score_tile(const float* A, const float* B, int depth, int ty,
                                           int tx, float (&t)[C::SR][C::SC]) {
#pragma unroll
  for (int i = 0; i < C::SR; ++i)
#pragma unroll
    for (int c = 0; c < C::SC; ++c) t[i][c] = 0.0f;
  const int n4 = (depth + 3) >> 2;
#pragma unroll 8
  for (int d4 = 0; d4 < n4; ++d4) {
    float4 av[C::SR];
#pragma unroll
    for (int i = 0; i < C::SR; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + (ty + C::TY * i) * C::LD + 4 * d4);
#pragma unroll
    for (int c = 0; c < C::SC; ++c) {
      const float4 bv = *reinterpret_cast<const float4*>(B + (tx + C::TX * c) * C::LD + 4 * d4);
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

// acc[i][j] += sum over r < n (in order) of A[r][frag_pos<8, PY>(py, i)] *
// B[r][frag_pos<8, PX>(px, j)].
template <int PY, int PX>
__device__ __forceinline__ void outer_acc(const float* A, int lda, const float* B, int ldb, int n,
                                          int py, int px, float (&acc)[8][8]) {
#pragma unroll 8
  for (int r = 0; r < n; ++r) {
    float av[8], bv[8];
    load_frag<8, PY>(A + r * lda, py, av);
    load_frag<8, PX>(B + r * ldb, px, bv);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&x)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) x[i][j] = 0.0f;
}

// p of one score: a live key's, a masked key's (score MASK_VALUE), 0 past T.
__device__ __forceinline__ float prob(float s, bool in, bool live, float m, float inv_l) {
  if (!in) return 0.0f;
  return exp2f(((live ? s : unit::MASK_VALUE) - m) * unit::LOG2E) * inv_l;
}

// The block's (tile, kv head, batch row) from a 1-D grid whose tile index
// is the slowest coordinate, walked from the last tile when reverse.
__device__ __forceinline__ void block_coords(const Args& a, int n_tiles, int batch, int* tile,
                                             int* head, int* b) {
  const int per = a.K * batch, rank = blockIdx.x / per, rem = blockIdx.x - rank * per;
  *head = rem % a.K;
  *b = rem / a.K;
  *tile = a.reverse ? n_tiles - 1 - rank : rank;
}

// ---- the row-state pre-pass -------------------------------------------------

// One block per (tile of bq <= kPreRows rows, kv head, batch row): each
// row's state (one warp a row; D as a lane-strided warp sum) and, when
// a.tail is set, the tile's masked-tail vector (rows in order) and, from
// head 0, its largest q_pos.
__global__ void __launch_bounds__(kThreads) rows_kernel(Args a, int bq) {
  __shared__ float pt[kPreRows];
  __shared__ int32_t qp_s[kPreRows];
  const int qt = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = a.S * a.G, n = min(bq, R - qt * bq);
  for (int r = warp; r < n; r += kThreads / 32) {
    const int flat = qt * bq + r, s = flat / a.G, g = flat - s * a.G;
    const long long off = row_offset(a, b, head, flat, a.hv);
    float d = 0.0f;
    for (int c = lane; c < a.hv; c += 32) d += a.dout[off + c] * a.o[off + c];
    d = warp_reduce(d, SumOp());
    const size_t si = ((static_cast<size_t>(b) * a.K + head) * a.G + g) * a.S + s;
    const float m = a.m[si], inv_l = 1.0f / fmaxf(a.l[si], 1e-30f);
    const int32_t qp = a.q_pos[static_cast<size_t>(b) * a.S + s];
    if (lane == 0) {
      a.rows[(static_cast<size_t>(b) * a.K + head) * R + flat] =
          make_float4(m, inv_l, d, __int_as_float(qp));
      pt[r] = prob(0.0f, true, false, m, inv_l);
      qp_s[r] = qp;
    }
  }
  if (a.tail == nullptr) return;
  __syncthreads();
  for (int c = threadIdx.x; c < a.hv; c += kThreads) {
    float acc = 0.0f;
    for (int r = 0; r < n; ++r)
      acc += pt[r] * a.dout[row_offset(a, b, head, qt * bq + r, a.hv) + c];
    a.tail[((static_cast<size_t>(b) * a.n_qt + qt) * a.K + head) * a.hv + c] = acc;
  }
  if (head == 0 && threadIdx.x == 0) {
    int32_t mx = kDeadRow;
    for (int r = 0; r < n; ++r) mx = max(mx, qp_s[r]);
    a.qmax[static_cast<size_t>(b) * a.n_qt + qt] = mx;
  }
}

// ---- dq ---------------------------------------------------------------------

// One block per (q tile of BQ rows, kv head, batch row): Q, dO and the row
// state stay in shared memory; K / V tiles of BK keys stream through the
// ring up to the causal end.  Per tile: every thread computes S and dP of
// its rows x keys and writes dS into the tile transposed ([key][row]); then
// each group adds its key half of dS K to its dQ registers.
template <class C>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(Args a, int batch) {
  using L = DqSmem<C>;
  static_assert(8 * C::PY == C::BQ, "dQ rows");
  extern __shared__ __align__(16) float sm[];
  const int R = a.S * a.G, n_qt = cdiv(R, C::BQ), n_kt = cdiv(a.T, C::BK);
  int qt, head, b;
  block_coords(a, n_qt, batch, &qt, &head, &b);
  const int q0 = qt * C::BQ;
  const bool grp = threadIdx.x >= kGroup;
  const int u = threadIdx.x & (kGroup - 1);
  const float4* rs = reinterpret_cast<const float4*>(sm + L::RS);

  const auto q_row = [&](int width) {
    return [&, width](int r) -> long long {
      return q0 + r < R ? row_offset(a, b, head, q0 + r, width) : -1;
    };
  };
  copy_rows<C, C::BQ>(sm + L::Q, a.q, a.h, q_row(a.h));
  copy_rows<C, C::BQ>(sm + L::DO, a.dout, a.hv, q_row(a.hv));
  const int tid = threadIdx.x;
  if (tid < C::BQ) {
    const bool ok = q0 + tid < R;
    cp_async<4>(sm + L::RS + 4 * tid,
                ok ? reinterpret_cast<const float*>(
                         a.rows + (static_cast<size_t>(b) * a.K + head) * R + q0 + tid)
                   : a.q,
                ok);
  }
  cp_commit();

  // the causal end: the tile holding the block's largest q_pos
  __shared__ int qmax_s;
  if (tid == 0) qmax_s = kDeadRow;
  __syncthreads();
  if (tid < C::BQ && q0 + tid < R)
    atomicMax(&qmax_s, a.q_pos[static_cast<size_t>(b) * a.S + (q0 + tid) / a.G]);
  __syncthreads();
  const int n_tiles = !a.causal ? n_kt : qmax_s < 0 ? 0 : min(n_kt, qmax_s / C::BK + 1);

  const auto fetch = [&](int t) {
    float* st = sm + L::RING + (t % C::NS) * L::STAGE;
    const int key0 = t * C::BK;
    const auto k_row = [&](int width) {
      return [&, width](int j) -> long long {
        return key0 + j < a.T
                   ? ((static_cast<long long>(b) * a.T + key0 + j) * a.K + head) * width
                   : -1;
      };
    };
    copy_rows<C, C::BK>(st, a.k, a.h, k_row(a.h));
    copy_rows<C, C::BK>(st + C::BK * C::LD, a.v, a.hv, k_row(a.hv));
  };
#pragma unroll
  for (int s = 0; s < C::NS - 1; ++s) {
    if (s < n_tiles) fetch(s);
    cp_commit();
  }

  const int tx = tid % C::TX, ty = tid / C::TX;  // score step
  const int px = u % C::PX, py = u / C::PX;      // dQ product
  float* tt = sm + L::T;
  float acc[8][8];
  zero(acc);
  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<C::NS - 2>();
    __syncthreads();  // tile t landed; tile t - 1's slot and the dS tile are free
    if (t + C::NS - 1 < n_tiles) fetch(t + C::NS - 1);
    cp_commit();
    const float* ks = sm + L::RING + (t % C::NS) * L::STAGE;
    const float* vs = ks + C::BK * C::LD;
    const int key0 = t * C::BK, nk = min(C::BK, a.T - key0);
    unsigned valid = 0;
#pragma unroll
    for (int c = 0; c < C::SC; ++c) {
      const int j = tx + C::TX * c;
      if (j < nk && a.kv_valid[static_cast<size_t>(b) * a.T + key0 + j]) valid |= 1u << c;
    }
    float sc[C::SR][C::SC], dpv[C::SR][C::SC];
    score_tile<C>(sm + L::Q, ks, a.h, ty, tx, sc);
    score_tile<C>(sm + L::DO, vs, a.hv, ty, tx, dpv);
#pragma unroll
    for (int i = 0; i < C::SR; ++i) {
      const int r = ty + C::TY * i;
      const float4 st = rs[r];
      const int32_t qp = __float_as_int(st.w);
#pragma unroll
      for (int c = 0; c < C::SC; ++c) {
        const int j = tx + C::TX * c;
        const bool live = ((valid >> c) & 1u) && !(a.causal && key0 + j > qp);
        tt[j * L::LDT + r] =
            live ? prob(sc[i][c], true, true, st.x, st.y) * (dpv[i][c] - st.z) : 0.0f;
      }
    }
    __syncthreads();  // dS written
    const int j0 = grp ? C::BK / 2 : 0;
    outer_acc<C::PY, C::PX>(tt + j0 * L::LDT, L::LDT, ks + j0 * C::LD, C::LD, C::BK / 2, py, px,
                            acc);
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free

  float* part = sm + L::RING;   // group 1's dQ [BQ][LD]
  if (grp) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* row = part + frag_pos<8, C::PY>(py, i) * C::LD;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<float4*>(row + (j * C::PX + px) * 4) =
            make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
    }
  }
  __syncthreads();
  if (grp) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = frag_pos<8, C::PY>(py, i);
    if (q0 + r >= R) continue;
    float other[8];
    load_frag<8, C::PX>(part + r * C::LD, px, other);
#pragma unroll
    for (int j = 0; j < 8; ++j) other[j] = acc[i][j] + other[j];
    store_frag<8, C::PX, C::VEC>(a.dq + row_offset(a, b, head, q0 + r, a.h), px, other, a.h);
  }
}

// ---- dk / dv ----------------------------------------------------------------

// One block per (key block of BK keys, kv head, batch row): K and V stay in
// shared memory, dV (group 0) and dK (group 1) in registers.  The block
// lists the q tiles it visits (causal: those whose largest q_pos reaches
// its first key), kWindow tiles at a time, and streams their Q, dO and row
// state through the ring; the tail vectors of the others are summed in
// tile order and added to every key's dV.  Per tile: every thread
// computes S and dP of its rows x keys and writes p and dS; then group 0
// sums p^T dO into a tile partial and group 1 dS^T Q, and each adds its
// partial to its running sum.
template <class C>
__global__ void __launch_bounds__(kThreads, 1) dkdv_kernel(Args a, int batch) {
  using L = DkdvSmem<C>;
  static_assert(8 * C::PY == C::BK, "dK / dV keys");
  extern __shared__ __align__(16) float sm[];
  const int R = a.S * a.G, n_kt = cdiv(a.T, C::BK);
  int kt, head, b;
  block_coords(a, n_kt, batch, &kt, &head, &b);
  const int key0 = kt * C::BK, nk = min(C::BK, a.T - key0);
  const bool grp = threadIdx.x >= kGroup;
  const int tid = threadIdx.x, u = tid & (kGroup - 1);
  int32_t* list = reinterpret_cast<int32_t*>(sm + L::LIST);

  const auto k_row = [&](int width) {
    return [&, width](int j) -> long long {
      return j < nk ? ((static_cast<long long>(b) * a.T + key0 + j) * a.K + head) * width : -1;
    };
  };
  copy_rows<C, C::BK>(sm + L::K, a.k, a.h, k_row(a.h));
  copy_rows<C, C::BK>(sm + L::V, a.v, a.hv, k_row(a.hv));
  cp_commit();

  // the skipped q tiles' tail vectors: kThreads / D lanes a column, lane x
  // over tiles x, x + lanes, ..., summed in lane order at the end
  {
    constexpr int kLanes = kThreads / C::D;
    const int c = tid % C::D, lane = tid / C::D;
    float part = 0.0f;
    if (a.causal && c < a.hv) {
      const int32_t* qm = a.qmax + static_cast<size_t>(b) * a.n_qt;
      const float* tv = a.tail + (static_cast<size_t>(b) * a.n_qt * a.K + head) * a.hv + c;
#pragma unroll 4
      for (int t = lane; t < a.n_qt; t += kLanes) {
        const float x = tv[static_cast<size_t>(t) * a.K * a.hv];
        part += qm[t] < key0 ? x : 0.0f;
      }
    }
    sm[L::TAILP + lane * C::D + c] = part;
  }

  const int tx = tid % C::TX, ty = tid / C::TX;  // score step
  const int px = u % C::PX, py = u / C::PX;      // dK / dV products
  unsigned kbits = 0;   // the thread's keys that are valid and below T
#pragma unroll
  for (int c = 0; c < C::SC; ++c) {
    const int j = tx + C::TX * c;
    if (j < nk && a.kv_valid[static_cast<size_t>(b) * a.T + key0 + j]) kbits |= 1u << c;
  }
  float* ps = sm + L::P;
  float* dss = sm + L::DS;
  float run[8][8];
  zero(run);
  for (int w0 = 0; w0 < a.n_qt; w0 += kWindow) {
    __syncthreads();  // the last window's list is no longer read
    if (tid < 32) {
      const int lane = tid, w1 = min(a.n_qt, w0 + kWindow);
      int n = 0;
      for (int base = w0; base < w1; base += 32) {
        const int t = base + lane;
        const bool visit =
            t < w1 && (!a.causal || a.qmax[static_cast<size_t>(b) * a.n_qt + t] >= key0);
        const unsigned mask = __ballot_sync(0xffffffffu, visit);
        if (visit) list[n + __popc(mask & ((1u << lane) - 1u))] = t;
        n += __popc(mask);
      }
      if (lane == 0) list[kWindow] = n;
    }
    __syncthreads();
    const int n_visit = list[kWindow];

    const auto fetch = [&](int v) {
      float* st = sm + L::RING + (v % C::NS) * L::STAGE;
      const int r0 = list[v] * C::BQ;
      const auto q_row = [&](int width) {
        return [&, width](int r) -> long long {
          return r0 + r < R ? row_offset(a, b, head, r0 + r, width) : -1;
        };
      };
      copy_rows<C, C::BQ>(st, a.q, a.h, q_row(a.h));
      copy_rows<C, C::BQ>(st + C::BQ * C::LD, a.dout, a.hv, q_row(a.hv));
      if (tid < C::BQ) {
        const bool ok = r0 + tid < R;
        cp_async<4>(st + 2 * C::BQ * C::LD + 4 * tid,
                    ok ? reinterpret_cast<const float*>(
                             a.rows + (static_cast<size_t>(b) * a.K + head) * R + r0 + tid)
                       : a.q,
                    ok);
      }
    };
#pragma unroll
    for (int s = 0; s < C::NS - 1; ++s) {
      if (s < n_visit) fetch(s);
      cp_commit();
    }
    for (int v = 0; v < n_visit; ++v) {
      cp_wait<C::NS - 2>();
      __syncthreads();  // tile v landed; tile v - 1's slot, p and dS are free
      if (v + C::NS - 1 < n_visit) fetch(v + C::NS - 1);
      cp_commit();
      const float* qs = sm + L::RING + (v % C::NS) * L::STAGE;
      const float* dos = qs + C::BQ * C::LD;
      const float4* rs = reinterpret_cast<const float4*>(dos + C::BQ * C::LD);
      float sc[C::SR][C::SC], dpv[C::SR][C::SC];
      score_tile<C>(qs, sm + L::K, a.h, ty, tx, sc);
      score_tile<C>(dos, sm + L::V, a.hv, ty, tx, dpv);
#pragma unroll
      for (int i = 0; i < C::SR; ++i) {
        const int r = ty + C::TY * i;
        const float4 st = rs[r];
        const int32_t qp = __float_as_int(st.w);
#pragma unroll
        for (int c = 0; c < C::SC; ++c) {
          const int j = tx + C::TX * c;
          const bool live = ((kbits >> c) & 1u) && !(a.causal && key0 + j > qp);
          const float p = prob(sc[i][c], j < nk, live, st.x, st.y);
          ps[r * L::LDP + j] = p;
          dss[r * L::LDP + j] = live ? p * (dpv[i][c] - st.z) : 0.0f;
        }
      }
      __syncthreads();  // p and dS written
      float part[8][8];
      zero(part);
      outer_acc<C::PY, C::PX>(grp ? dss : ps, L::LDP, grp ? qs : dos, C::LD, C::BQ, py, px, part);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) run[i][j] += part[i][j];
    }
    cp_wait<0>();
  }
  __syncthreads();  // the tail partials are written

  float tail[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = frag_pos<8, C::PX>(px, j);
    float t = 0.0f;
    if (!grp)
#pragma unroll
      for (int lane = 0; lane < kThreads / C::D; ++lane) t += sm[L::TAILP + lane * C::D + c];
    tail[j] = t;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j = frag_pos<8, C::PY>(py, i);
    if (j >= nk) continue;
    const size_t row = (static_cast<size_t>(b) * a.T + key0 + j) * a.K + head;
    if (grp) {
      store_frag<8, C::PX, C::VEC>(a.dk + row * a.h, px, run[i], a.h);
    } else {
      float out[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) out[c] = run[i][c] + tail[c];
      store_frag<8, C::PX, C::VEC>(a.dv + row * a.hv, px, out, a.hv);
    }
  }
}

}  // namespace fbwd
