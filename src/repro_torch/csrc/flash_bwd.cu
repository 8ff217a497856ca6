// flash_bwd: the two backward kernels of blocked float attention.
//
// Replaces repro/kernels/flash_attention_bwd.py:flash_attention_bwd_pallas
// -- its dq pallas_call (:234, body _dq_body) and its dk/dv pallas_call
// (:266, body _dkdv_body), both on _tile_grads.  From the forward's saved
// per-row (m, l) each tile re-derives the forward's probabilities and
// takes Dao et al.'s recompute:
//   p  = 2^((s - m) log2 e) / max(l, 1e-30)        (the forward's p / l)
//   D  = rowsum(dO * O)
//   dS = p (dO V^T - D), zero where the score is MASK_VALUE or a phantom
//   dQ = dS K       dK = dS^T Q       dV = p^T dO
// q is pre-scaled, so dq is the cotangent of the pre-scaled q.
//
// Bound on the H100: operations.  Per kept (q, k) pair dq does three
// h-deep products (Q K^T, dO V^T, dS K) and dk/dv four (those two, dS^T Q
// and p^T dO); at qwen1.5-0.5b's training shape (B 2, S = T = 4096, 16
// heads, h 64, causal) that is ~103 and ~137 GFLOP against ~0.1 GB of
// operands, ~1.5 and ~2.0 ms at 67 TFLOP/s.  This first version runs on
// CUDA-core f32 FMAs from shared memory (4 x 4 register tiles per
// product, as flash_fwd.cu); wgmma / TMA are later work.
//
// Grids, on flash_tile.cuh's tiles, masking and score tile:
//  * dq: one block per (q tile, kv head, batch row), as the forward.  It
//    loads its q and dO tiles and the rows' (m, l) once, computes D from
//    O and dO once, and streams the kv tiles the forward visits (the
//    causal skip: past them every key is masked, so dS is 0).
//  * dk/dv: one block per (kv tile, kv head, batch row).  It keeps its K
//    and V tiles and the dK / dV accumulators (4 keys x up to 8 columns
//    a thread) on chip and streams every q tile of the flattened (query,
//    group) axis, so the G groups of a kv head are summed inside the
//    block, as the TPU kernel sums them in VMEM: no float atomics, and a
//    run gives the same bits every time.  Causal: a q tile whose largest
//    q_pos lies before the kv tile sees every key of it masked, so it
//    adds no dK, but each of its rows still sends
//    exp(MASK_VALUE - m) / l * dO to every key's dV -- one vector for
//    the whole kv tile.  The block sums those vectors (each thread its
//    rows and columns, in shared memory) instead of the (q, k) products,
//    and adds the sum to every key at the end: the dV twin of the
//    forward's folded V tail.
//
// Shared memory: Q, dO, K, V tiles padded to h + 1 / hv + 1 words a row
// (the dO V^T product reads V along the row), the dS tile (and for dk/dv
// the p tile and 16 partial tail rows), per-row m, l, D.  At h = hv =
// 128 that is ~150 KB (dq) and ~175 KB (dk/dv); allow_smem raises the
// dynamic limit past 48 KB.
#include "flash_tile.cuh"

namespace {

using namespace flash;

struct Saved {
  const float* o;       // (B, S, K, G, hv)
  const float* dout;    // (B, S, K, G, hv)
  const float* m;       // (B, K, G, S)
  const float* l;       // (B, K, G, S)
  float* dq;            // (B, S, K, G, h)
  float* dk;            // (B, T, K, h)
  float* dv;            // (B, T, K, hv)
};

struct BwdSmem {
  float* qs;      // kBQ x (h + 1)
  float* ks;      // kBKV x (h + 1)
  float* vs;      // kBKV x (hv + 1)
  float* dos;     // kBQ x (hv + 1)
  float* dss;     // kBQ x (kBKV + 1): dS
  float* ps;      // kBQ x (kBKV + 1): p (dk/dv only)
  float* tail;    // 16 x hv: masked-tail dV partials, a row a ty (dk/dv only)
  float* row_m;   // kBQ
  float* row_l;   // kBQ: max(l, 1e-30)
  float* row_d;   // kBQ: D
  int32_t* qpos;  // kBQ
  int32_t* kval;  // kBKV
  Smem tile;      // the view flash_tile.cuh's loaders and score_tile read
};

constexpr int kTailRows = kThreads / 16;   // one partial row per ty

inline size_t bwd_smem_bytes(int h, int hv, bool dkdv) {
  const size_t tile = static_cast<size_t>(kBQ) * (kBKV + 1);
  return sizeof(float) * (static_cast<size_t>(kBQ + kBKV) * (h + 1) +
                          static_cast<size_t>(kBQ + kBKV) * (hv + 1) +
                          (dkdv ? 2 * tile + kTailRows * hv : tile) + 3 * kBQ) +
         sizeof(int32_t) * (kBQ + kBKV);
}

__device__ inline BwdSmem carve_bwd(float* base, int h, int hv, bool dkdv) {
  BwdSmem s;
  s.qs = base;
  s.ks = s.qs + kBQ * (h + 1);
  s.vs = s.ks + kBKV * (h + 1);
  s.dos = s.vs + kBKV * (hv + 1);
  s.dss = s.dos + kBQ * (hv + 1);
  s.ps = dkdv ? s.dss + kBQ * (kBKV + 1) : nullptr;
  s.tail = dkdv ? s.ps + kBQ * (kBKV + 1) : nullptr;
  s.row_m = dkdv ? s.tail + kTailRows * hv : s.dss + kBQ * (kBKV + 1);
  s.row_l = s.row_m + kBQ;
  s.row_d = s.row_l + kBQ;
  s.qpos = reinterpret_cast<int32_t*>(s.row_d + kBQ);
  s.kval = s.qpos + kBQ;
  s.tile = Smem{};
  s.tile.qs = s.qs;
  s.tile.ks = s.ks;
  s.tile.qpos = s.qpos;
  s.tile.kval = s.kval;
  return s;
}

// Offset of tile row r's (B, S, K, G, hv) row, or -1 past S * G.
__device__ inline long long out_offset(const Args& a, int b, int head, int qt, int r,
                                       int width) {
  int s, g;
  if (!row_coords(a, qt, r, &s, &g)) return -1;
  return ((((static_cast<long long>(b) * a.S + s) * a.K + head) * a.G + g) * width);
}

// The dO tile and each row's m, l and D = rowsum(dO * O) (4 threads a
// row); rows past S * G read dO = 0, m = 0, l = 1.
__device__ inline void load_row_state(const Args& a, const Saved& w,
                                      const BwdSmem& sm, int b, int head, int qt) {
  const int hv = a.hv;
  for (int i = threadIdx.x; i < kBQ * hv; i += kThreads) {
    const int r = i / hv, d = i - r * hv;
    const long long off = out_offset(a, b, head, qt, r, hv);
    sm.dos[r * (hv + 1) + d] = off >= 0 ? w.dout[off + d] : 0.0f;
  }
  const int r = threadIdx.x >> 2, quarter = threadIdx.x & 3;
  const long long off = out_offset(a, b, head, qt, r, hv);
  float acc = 0.0f;
  if (off >= 0)
    for (int d = quarter; d < hv; d += 4) acc += w.dout[off + d] * w.o[off + d];
  acc = quad_reduce(acc, SumOp());
  if (quarter == 0) {
    sm.row_d[r] = acc;
    if (off >= 0) {
      const size_t si = stat_index(a, b, head, qt, r);
      sm.row_m[r] = w.m[si];
      sm.row_l[r] = fmaxf(w.l[si], 1e-30f);
    } else {
      sm.row_m[r] = 0.0f;
      sm.row_l[r] = 1.0f;
    }
  }
}

// A causally skipped q tile (every key of the kv tile lies past each of
// its rows' q_pos): each row's exp(MASK_VALUE - m) / l * dO, the p of a
// masked key as tile_p_ds computes it, added to this thread's partial
// row of sm.tail (rows 4 ty + i, columns tx, tx + 16, ...).
__device__ inline void add_masked_tail(const Args& a, const Saved& w,
                                       const BwdSmem& sm, int b, int head, int qt) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const long long off = out_offset(a, b, head, qt, r, a.hv);
    if (off < 0) continue;
    const size_t si = stat_index(a, b, head, qt, r);
    const float p = exp2f((unit::MASK_VALUE - w.m[si]) * unit::LOG2E) /
                    fmaxf(w.l[si], 1e-30f);
    for (int col = tx; col < a.hv; col += 16) sm.tail[ty * a.hv + col] += p * w.dout[off + col];
  }
}

// Keys [key0, key0 + nk): K (stride h + 1), V (stride hv + 1), validity;
// the rest of the tile reads as zeros.
__device__ inline void load_kv_bwd(const Args& a, const BwdSmem& sm, int b, int head,
                                   int key0, int nk) {
  const int h = a.h, hv = a.hv;
  for (int i = threadIdx.x; i < kBKV * h; i += kThreads) {
    const int j = i / h, d = i - j * h;
    sm.ks[j * (h + 1) + d] =
        j < nk ? a.k[((static_cast<size_t>(b) * a.T + key0 + j) * a.K + head) * h + d]
               : 0.0f;
  }
  for (int i = threadIdx.x; i < kBKV * hv; i += kThreads) {
    const int j = i / hv, d = i - j * hv;
    sm.vs[j * (hv + 1) + d] =
        j < nk ? a.v[((static_cast<size_t>(b) * a.T + key0 + j) * a.K + head) * hv + d]
               : 0.0f;
  }
  for (int j = threadIdx.x; j < kBKV; j += kThreads)
    sm.kval[j] = j < nk ? a.kv_valid[static_cast<size_t>(b) * a.T + key0 + j] : 0;
}

// p and dS of this thread's 4 rows x 4 keys (rows 4 ty + i, keys tx + 16 c),
// from the masked score tile and dP = dO V^T, written to the shared dS
// tile (and the p tile when the block has one).
__device__ inline void tile_p_ds(const Args& a, const BwdSmem& sm, int key0, int nk) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4];
  int kind[4][4];
  score_tile(a, sm.tile, key0, nk, s, kind);
  const int hv = a.hv;
  float dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dp[i][c] = 0.0f;
  for (int d = 0; d < hv; ++d) {
    float ov[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ov[i] = sm.dos[(ty * 4 + i) * (hv + 1) + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) vv[c] = sm.vs[(tx + 16 * c) * (hv + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) dp[i][c] += ov[i] * vv[c];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const float m = sm.row_m[r], l = sm.row_l[r], dd = sm.row_d[r];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float p = kind[i][c] != kPhantom ? exp2f((s[i][c] - m) * unit::LOG2E) / l
                                              : 0.0f;
      const int e = r * (kBKV + 1) + tx + 16 * c;
      if (sm.ps != nullptr) sm.ps[e] = p;
      sm.dss[e] = kind[i][c] == kLive ? p * (dp[i][c] - dd) : 0.0f;
    }
  }
}

// kC: the value columns a thread holds (tx + 16 c, c < kC): 4 where h
// and hv are at most 64, 8 up to 128, so h 64 keeps no idle accumulators.
template <int kC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a, Saved w) {
  extern __shared__ float smem[];
  const BwdSmem sm = carve_bwd(smem, a.h, a.hv, false);
  const int qt = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = a.h;

  load_row_state(a, w, sm, b, head, qt);
  const int32_t qmax = load_q_tile(a, sm.tile, b, head, qt);  // syncs
  const int n_tiles = tiles_to_visit(a, qmax);

  float acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.0f;

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int key0 = jt * a.bkv;
    const int nk = min(a.bkv, a.T - key0);
    load_kv_bwd(a, sm, b, head, key0, nk);
    __syncthreads();
    tile_p_ds(a, sm, key0, nk);
    __syncthreads();
    // dQ += dS K: rows 4 ty + i, columns tx + 16 c
    for (int j = 0; j < nk; ++j) {
      float dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = sm.dss[(ty * 4 + i) * (kBKV + 1) + j];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int col = tx + 16 * c;
        if (col < h) {
          const float kv = sm.ks[j * (h + 1) + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] += dr[i] * kv;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long off = out_offset(a, b, head, qt, ty * 4 + i, h);
    if (off < 0) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = tx + 16 * c;
      if (col < h) w.dq[off + col] = acc[i][c];
    }
  }
}

template <int kC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Args a, Saved w) {
  extern __shared__ float smem[];
  const BwdSmem sm = carve_bwd(smem, a.h, a.hv, true);
  const int jt = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = a.h, hv = a.hv;
  const int key0 = jt * a.bkv;
  const int nk = min(a.bkv, a.T - key0);
  const int n_qt = (a.S * a.G + kBQ - 1) / kBQ;

  load_kv_bwd(a, sm, b, head, key0, nk);
  for (int i = threadIdx.x; i < kTailRows * hv; i += kThreads) sm.tail[i] = 0.0f;

  float acc_k[4][kC], acc_v[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc_k[i][c] = acc_v[i][c] = 0.0f;

  for (int qt = 0; qt < n_qt; ++qt) {
    const int32_t qmax = load_q_tile(a, sm.tile, b, head, qt);  // syncs
    if (a.causal && qmax < key0) {
      add_masked_tail(a, w, sm, b, head, qt);
      __syncthreads();  // q_pos is rewritten next
      continue;
    }
    load_row_state(a, w, sm, b, head, qt);
    __syncthreads();
    tile_p_ds(a, sm, key0, nk);
    __syncthreads();
    // dV += p^T dO, dK += dS^T Q: keys 4 ty + i, columns tx + 16 c
    for (int r = 0; r < kBQ; ++r) {
      float pr[4], dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = sm.ps[r * (kBKV + 1) + ty * 4 + i];
        dr[i] = sm.dss[r * (kBKV + 1) + ty * 4 + i];
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int col = tx + 16 * c;
        if (col < hv) {
          const float ov = sm.dos[r * (hv + 1) + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc_v[i][c] += pr[i] * ov;
        }
        if (col < h) {
          const float qv = sm.qs[r * (h + 1) + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc_k[i][c] += dr[i] * qv;
        }
      }
    }
    __syncthreads();
  }

  // every key of the tile takes the skipped rows' summed masked tail
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int col = tx + 16 * c;
    if (col >= hv) continue;
    float t = 0.0f;
    for (int y = 0; y < kTailRows; ++y) t += sm.tail[y * hv + col];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_v[i][c] += t;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = ty * 4 + i;
    if (j >= nk) continue;
    const size_t row = (static_cast<size_t>(b) * a.T + key0 + j) * a.K + head;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = tx + 16 * c;
      if (col < h) w.dk[row * h + col] = acc_k[i][c];
      if (col < hv) w.dv[row * hv + col] = acc_v[i][c];
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, void* stream, const Args& a,
           const Saved& w) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a, w);
  return static_cast<int>(cudaGetLastError());
}

int check_args(int h, int hv, int bkv, int G, int S, int T) {
  if (h < 1 || h > kMaxHD || hv < 1 || hv > kMaxHD || bkv < 1 || bkv > kBKV ||
      G < 1 || S < 1 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// Shapes as in flash::Args and Saved; every tensor contiguous f32 (q_pos
// int32, kv_valid uint8), h and hv <= 128, 1 <= bkv <= 64, bkv the
// forward's.
extern "C" int flash_bwd_dq_launch(const float* q, const float* k, const float* v,
                                   const float* o, const float* dout, const float* m,
                                   const float* l, const int32_t* q_pos,
                                   const uint8_t* kv_valid, float* dq, int batch,
                                   int S, int K, int G, int h, int hv, int T, int bkv,
                                   int causal, void* stream) {
  if (int e = check_args(h, hv, bkv, G, S, T)) return e;
  const Args a{q, k, v, nullptr, q_pos, kv_valid, nullptr, nullptr, nullptr,
               S, K, G, h, hv, T, bkv, causal, 0};
  const Saved w{o, dout, m, l, dq, nullptr, nullptr};
  const size_t smem = bwd_smem_bytes(h, hv, false);
  const dim3 grid((S * G + kBQ - 1) / kBQ, K, batch);
  if (h <= 64 && hv <= 64) return launch(flash_bwd_dq_kernel<4>, grid, smem, stream, a, w);
  return launch(flash_bwd_dq_kernel<kCols>, grid, smem, stream, a, w);
}

extern "C" int flash_bwd_dkdv_launch(const float* q, const float* k, const float* v,
                                     const float* o, const float* dout, const float* m,
                                     const float* l, const int32_t* q_pos,
                                     const uint8_t* kv_valid,
                                     float* dk, float* dv, int batch, int S, int K,
                                     int G, int h, int hv, int T, int bkv, int causal,
                                     void* stream) {
  if (int e = check_args(h, hv, bkv, G, S, T)) return e;
  const Args a{q, k, v, nullptr, q_pos, kv_valid, nullptr, nullptr, nullptr,
               S, K, G, h, hv, T, bkv, causal, 0};
  const Saved w{o, dout, m, l, nullptr, dk, dv};
  const size_t smem = bwd_smem_bytes(h, hv, true);
  const dim3 grid((T + bkv - 1) / bkv, K, batch);
  if (h <= 64 && hv <= 64) return launch(flash_bwd_dkdv_kernel<4>, grid, smem, stream, a, w);
  return launch(flash_bwd_dkdv_kernel<kCols>, grid, smem, stream, a, w);
}
