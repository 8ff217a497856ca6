// The blocked-attention tile machinery of flash_int3.cu (row 9, the unit's
// classic words in three sweeps): the grid, the shared-memory layout, the
// tile loads, the masked score tile and the P @ V update.  (The float and
// snapped int forwards, flash_fwd.cu and flash_snap.cu, run on their own
// body, flash_fwd_sm90.cuh.)
//
// Grid: one block of 256 threads per (q tile, kv head, batch row).  A q
// tile is kBQ = 64 rows of the flattened (query position, GQA group)
// axis, so the G query heads that share a kv head share its K/V tiles.
// The TPU kernel's sequential kv-tile grid axis becomes a loop inside
// the block; K, V, Q and the score tile live in shared memory, the
// (rows x hv) accumulator in registers (4 rows x up to 8 value columns a
// thread).
//
// Masking is the reference's masked_score_block: a key that kv_valid
// marks invalid, or (causal) lies past the row's q_pos, scores the
// finite MASK_VALUE and carries mass exactly as in naive attention; a
// key at or past T (the ragged edge of the last tile) is a phantom and
// carries none.  The kernel never pads in device memory: it reads
// phantoms as zeros and marks them itself.  Every kv tile is swept,
// causal or not.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "block_reduce.cuh"
#include "unit.cuh"

namespace flash {

constexpr int kThreads = 256;
constexpr int kBQ = 64;        // rows of a q tile (tiling.ATTN_BLOCK_Q)
constexpr int kBKV = 64;       // most keys of a kv tile (tiling.ATTN_BLOCK_KV)
constexpr int kMaxHD = 128;    // head dims (h and hv) the kernels take
constexpr int kCols = kMaxHD / 16;  // value columns a thread accumulates
constexpr int kDeadRow = -2147483647 - 1;  // q_pos of rows past S * G

struct Args {
  const float* q;           // (B, S, K, G, h), pre-scaled
  const float* k;           // (B, T, K, h)
  const float* v;           // (B, T, K, hv)
  const int32_t* q_pos;     // (B, S)
  const uint8_t* kv_valid;  // (B, T)
  float* out;               // (B, S, K, G, hv)
  int S, K, G, h, hv, T, bkv, causal, guard_shift;
};

// Shared memory of one block; the score tile doubles as p / numerators.
struct Smem {
  float* qs;      // kBQ x (h + 1)
  float* ks;      // kBKV x (h + 1)
  float* vs;      // kBKV x hv
  float* ps;      // kBQ x (kBKV + 1): scores, then p
  int32_t* qpos;  // kBQ
  int32_t* kval;  // kBKV
  float* row_c;   // kBQ: this tile's accumulator scale
};

__host__ __device__ inline size_t smem_bytes(int h, int hv) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (h + 1) +
                          static_cast<size_t>(kBKV) * (h + 1) +
                          static_cast<size_t>(kBKV) * hv + kBQ * (kBKV + 1) +
                          kBQ) +
         sizeof(int32_t) * (kBQ + kBKV);
}

__device__ inline Smem carve(float* base, int h, int hv) {
  Smem s;
  s.qs = base;
  s.ks = s.qs + kBQ * (h + 1);
  s.vs = s.ks + kBKV * (h + 1);
  s.ps = s.vs + kBKV * hv;
  s.row_c = s.ps + kBQ * (kBKV + 1);
  s.qpos = reinterpret_cast<int32_t*>(s.row_c + kBQ);
  s.kval = s.qpos + kBQ;
  return s;
}

// Row r of the tile -> (query position, group); false past S * G.
__device__ inline bool row_coords(const Args& a, int qt, int r, int* s, int* g) {
  const int flat = qt * kBQ + r;
  *s = flat / a.G;
  *g = flat - *s * a.G;
  return flat < a.S * a.G;
}

// Load the q tile and each row's q_pos; returns the tile's largest q_pos
// (kDeadRow when every row is past S * G).
__device__ inline int32_t load_q_tile(const Args& a, const Smem& sm, int b,
                                      int head, int qt) {
  const int h = a.h;
  for (int i = threadIdx.x; i < kBQ * h; i += kThreads) {
    const int r = i / h, d = i - r * h;
    int s, g;
    const bool ok = row_coords(a, qt, r, &s, &g);
    sm.qs[r * (h + 1) + d] =
        ok ? a.q[((static_cast<size_t>(b) * a.S + s) * a.K + head) * a.G * h +
                 static_cast<size_t>(g) * h + d]
           : 0.0f;
  }
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    int s, g;
    sm.qpos[r] = row_coords(a, qt, r, &s, &g)
                     ? a.q_pos[static_cast<size_t>(b) * a.S + s]
                     : kDeadRow;
  }
  __syncthreads();
  int32_t mx = kDeadRow;
  for (int r = 0; r < kBQ; ++r) mx = max(mx, sm.qpos[r]);  // smem broadcast
  return mx;
}

// Keys [key0, key0 + nk) of this (b, head) into shared memory; the rest
// of the tile reads as zeros.  With load_v false only K and the validity
// words are loaded (the max and sum sweeps read no V).
__device__ inline void load_kv_tile(const Args& a, const Smem& sm, int b,
                                    int head, int key0, int nk,
                                    bool load_v = true) {
  const int h = a.h, hv = a.hv;
  for (int i = threadIdx.x; i < kBKV * h; i += kThreads) {
    const int j = i / h, d = i - j * h;
    sm.ks[j * (h + 1) + d] =
        j < nk ? a.k[((static_cast<size_t>(b) * a.T + key0 + j) * a.K + head) * h + d]
               : 0.0f;
  }
  for (int i = threadIdx.x; load_v && i < kBKV * hv; i += kThreads) {
    const int j = i / hv, d = i - j * hv;
    sm.vs[i] =
        j < nk ? a.v[((static_cast<size_t>(b) * a.T + key0 + j) * a.K + head) * hv + d]
               : 0.0f;
  }
  for (int j = threadIdx.x; j < kBKV; j += kThreads)
    sm.kval[j] = j < nk ? a.kv_valid[static_cast<size_t>(b) * a.T + key0 + j] : 0;
}

enum KeyKind { kLive = 0, kMasked = 1, kPhantom = 2 };

// The masked score tile, in registers: thread (ty, tx) of a 16 x 16
// layout holds rows 4 ty + i and keys tx + 16 c.  Each score is the dot
// product over the head dim in index order (q already scaled, as the
// naive path's q * scale before the dot); masked keys score MASK_VALUE.
__device__ inline void score_tile(const Args& a, const Smem& sm, int key0,
                                  int nk, float s[4][4], int kind[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = a.h;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
  for (int d = 0; d < h; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = sm.qs[(ty * 4 + i) * (h + 1) + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) kv[c] = sm.ks[(tx + 16 * c) * (h + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] += qv[i] * kv[c];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int32_t qp = sm.qpos[ty * 4 + i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      if (j >= nk) {
        kind[i][c] = kPhantom;
      } else if (sm.kval[j] == 0 || (a.causal && key0 + j > qp)) {
        kind[i][c] = kMasked;
        s[i][c] = unit::MASK_VALUE;
      } else {
        kind[i][c] = kLive;
      }
    }
  }
}

// acc <- acc * row_c + ps @ V for this thread's rows 4 ty + i and value
// columns tx + 16 c.
__device__ inline void pv_update(const Args& a, const Smem& sm, int nk,
                                 float acc[4][kCols]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int hv = a.hv;
  float dot[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dot[i][c] = 0.0f;
  for (int j = 0; j < nk; ++j) {
    float pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pr[i] = sm.ps[(ty * 4 + i) * (kBKV + 1) + j];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < hv) {
        const float vv = sm.vs[j * hv + col];
#pragma unroll
        for (int i = 0; i < 4; ++i) dot[i][c] += pr[i] * vv;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float corr = sm.row_c[ty * 4 + i];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = acc[i][c] * corr + dot[i][c];
  }
}

// Out row pointer of tile row r, or null past S * G.
__device__ inline float* out_row(const Args& a, int b, int head, int qt, int r) {
  int s, g;
  if (!row_coords(a, qt, r, &s, &g)) return nullptr;
  return a.out + (((static_cast<size_t>(b) * a.S + s) * a.K + head) * a.G + g) * a.hv;
}

// Set the dynamic shared-memory limit when a launch needs more than 48 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace flash
