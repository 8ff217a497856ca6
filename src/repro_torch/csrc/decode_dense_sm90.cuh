// The Hopper body of the float split-KV decode over a contiguous cache:
// decode_dense.cu's kernel (row 5).  Each block writes the partial state
// (m, l, acc) of one KV split of one (batch row, kv head); the fold of the
// splits runs outside, in PyTorch, as the reference runs it outside its
// kernel.
//
// Keys: the split covers the tiles of bkv keys that dense_split_tiles
// gives it -- its share of the row's LIVE tiles (up to the tile holding
// q_pos when causal) -- up to T.  A key that kv_valid marks invalid, or
// (causal) that lies past q_pos, scores MASK_VALUE and carries mass as in
// the plain version; keys past T are not visited; a split with no tile
// writes the merge identity (MASK_VALUE, 0, 0).
//
// Bound: the K / V bytes (4 flops a key and head dim against 8 bytes).
// What the design does about it:
//
// 1. Wide loads, many in flight.  Every warp streams its own keys through
//    its own NS-stage cp.async ring in dynamic shared memory, KW keys of K
//    and V a stage, 16-byte copies where h, hv and the K / V base pointers
//    allow it (tiling.decode_dense_vec), 4-byte ones otherwise; edges are
//    zero-filled by the copy's src-size.  Two blocks fit an SM.
// 2. Keys split across warps.  The W warps of a block take W runs of the
//    split's keys, each a multiple of KW keys long.
// 3. One K / V read serves every GQA row.  In the score step LPK lanes share
//    a key, each reading D / LPK of its head dims as float4s (rows padded to
//    D + D / 8 floats, so the reads fall in distinct banks) and dotting them
//    with every row's q from shared memory; LPK - 1 shuffles finish a dot.
// 4. No block barrier in the key loop.  Each warp keeps its own online
//    state (m, l in registers on every lane, acc with the value columns
//    spread over the lanes, D / 32 a lane), synchronised by __syncwarp: p
//    passes through a per-warp buffer once a step.
// 5. Fixed-order merge.  At the end each warp writes its state into its
//    own ring, and after the one block barrier every (row, column) folds
//    the warps' states in warp order into the split's partial.
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
  const float* k;           // (B, T, K, h)
  const float* v;           // (B, T, K, hv)
  const int32_t* q_pos;     // (B,)
  const uint8_t* kv_valid;  // (B, T)
  float* part_m;            // (B, splits, K, G)
  float* part_l;            // (B, splits, K, G)
  float* part_acc;          // (B, splits, K, G, hv)
  int T, K, G, h, hv, bkv, splits, causal;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// A block shape.  D: h and hv padded to 64 or 128; VEC floats a global
// copy; W warps and NS ring stages at every D (two blocks fit an SM).
// Score step: LPK lanes a key, KW keys a step.  P V: CPL value columns a
// lane.
template <int D_, int VEC_>
struct Cfg {
  static constexpr int D = D_, W = 4, NS = 2, VEC = VEC_;
  static constexpr int LPK = D / 32, KW = 32 / LPK, CPL = D / 32;
  static constexpr int LD = D + D / 8;       // LD = 4 LPK (mod 32)
  static constexpr int STAGE = 2 * KW * LD;  // K, V [KW][LD] floats
  static_assert(D == 64 || D == 128, "head dims up to 64 or 128");
  static_assert(VEC == 1 || VEC == 4, "4- or 16-byte copies");
};

// Shared memory, in floats: q [kMaxG][D]; per warp: the ring [NS][STAGE]
// and p [kMaxG][KW].  At the end a warp's ring holds its acc [kMaxG][D],
// then m, l [kMaxG].
template <class C>
struct Smem {
  static constexpr int Q = 0, RING = kMaxG * C::D;
  static constexpr int P = C::NS * C::STAGE, WARP = P + kMaxG * C::KW;
  static constexpr size_t BYTES = sizeof(float) * (RING + C::W * WARP);
  static_assert(C::NS * C::STAGE >= kMaxG * (C::D + 2), "the ring holds the state");
};

template <class C>
__global__ void __launch_bounds__(C::W * 32) decode_kernel(Args a) {
  using L = Smem<C>;
  constexpr int kThreads = C::W * 32;
  extern __shared__ __align__(16) float sm[];
  const int split = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kk = lane / C::LPK, part = lane % C::LPK;  // score step: key, dims
  const int G = a.G;

  const float* qrow = a.q + (static_cast<size_t>(b) * a.K + head) * G * a.h;
  for (int i = threadIdx.x; i < kMaxG * C::D; i += kThreads) {
    const int g = i / C::D, d = i - g * C::D;
    sm[L::Q + i] = g < G && d < a.h ? qrow[g * a.h + d] : 0.0f;
  }
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
  const auto fetch = [&](int st) {
    float* dst = ring + (st % C::NS) * C::STAGE;
    const int key0 = r0 + st * C::KW;
    const auto k_row = [&](int width) {
      return [&, width](int j) -> long long {
        return key0 + j < r1
                   ? ((static_cast<long long>(b) * a.T + key0 + j) * a.K + head) * width
                   : -1;
      };
    };
    copy_rows<C::KW, C::D, C::LD, C::VEC, 32>(dst, a.k, a.h, k_row(a.h), lane);
    copy_rows<C::KW, C::D, C::LD, C::VEC, 32>(dst + C::KW * C::LD, a.v, a.hv, k_row(a.hv),
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

  float m[kMaxG], l[kMaxG], acc[kMaxG][C::CPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = unit::MASK_VALUE;
    l[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < C::CPL; ++c) acc[g][c] = 0.0f;
  }
  for (int st = 0; st < steps; ++st) {
    cp_wait<C::NS - 2>();
    __syncwarp();  // step st landed; step st - 1's slot and p are free
    if (st + C::NS - 1 < steps) fetch(st + C::NS - 1);
    cp_commit();
    const int kind = kind_next;
    if (st + 1 < steps) kind_next = key_kind(st + 1);
    const float* ks = ring + (st % C::NS) * C::STAGE;
    const float* vs = ks + C::KW * C::LD;

    float4 kv[C::D / (4 * C::LPK)];
#pragma unroll
    for (int i = 0; i < C::D / (4 * C::LPK); ++i)
      kv[i] = *reinterpret_cast<const float4*>(ks + kk * C::LD + 4 * (C::LPK * i + part));
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      const float* qg = sm + L::Q + g * C::D;
      float x = 0.0f;
#pragma unroll
      for (int i = 0; i < C::D / (4 * C::LPK); ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qg + 4 * (C::LPK * i + part));
        x = fmaf(qv.x, kv[i].x, x);
        x = fmaf(qv.y, kv[i].y, x);
        x = fmaf(qv.z, kv[i].z, x);
        x = fmaf(qv.w, kv[i].w, x);
      }
#pragma unroll
      for (int o = 1; o < C::LPK; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      const float s = kind > 0 ? x : kind == 0 ? unit::MASK_VALUE : -INFINITY;
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
      for (int c = 0; c < C::CPL; ++c) acc[g][c] *= corr;
      if (part == 0) pb[g * C::KW + kk] = p;
    }
    __syncwarp();  // p written

    // acc += p V: the lane's CPL value columns, four keys at a time
#pragma unroll
    for (int j4 = 0; j4 < C::KW; j4 += 4) {
      float pv[kMaxG][4];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const float4 t = *reinterpret_cast<const float4*>(pb + g * C::KW + j4);
        pv[g][0] = t.x, pv[g][1] = t.y, pv[g][2] = t.z, pv[g][3] = t.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[C::CPL];
        const float* vr = vs + (j4 + jj) * C::LD + lane * C::CPL;
        if constexpr (C::CPL == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vr);
          vv[0] = t.x, vv[1] = t.y, vv[2] = t.z, vv[3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(vr);
          vv[0] = t.x, vv[1] = t.y;
        }
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g >= G) break;
#pragma unroll
          for (int c = 0; c < C::CPL; ++c) acc[g][c] = fmaf(pv[g][jj], vv[c], acc[g][c]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncwarp();  // the warp's ring is free

  float* st = ring;  // acc [kMaxG][D], then m, l [kMaxG]
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int c = 0; c < C::CPL; ++c) st[g * C::D + lane * C::CPL + c] = acc[g][c];
    if (lane == 0) {
      st[kMaxG * C::D + g] = m[g];
      st[kMaxG * C::D + kMaxG + g] = l[g];
    }
  }
  __syncthreads();  // every warp's state written

  const size_t row0 = ((static_cast<size_t>(b) * a.splits + split) * a.K + head) * G;
  for (int i = threadIdx.x; i < G * a.hv; i += kThreads) {
    const int g = i / a.hv, c = i - g * a.hv;
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < C::W; ++w)
      m_all = fmaxf(m_all, sm[L::RING + w * L::WARP + kMaxG * C::D + g]);
    float l_all = 0.0f, acc_all = 0.0f;
#pragma unroll
    for (int w = 0; w < C::W; ++w) {
      const float* ws = sm + L::RING + w * L::WARP;
      const float sc = exp2f((ws[kMaxG * C::D + g] - m_all) * unit::LOG2E);
      l_all += ws[kMaxG * C::D + kMaxG + g] * sc;
      acc_all += ws[g * C::D + c] * sc;
    }
    a.part_acc[(row0 + g) * a.hv + c] = acc_all;
    if (c == 0) {
      a.part_m[row0 + g] = m_all;
      a.part_l[row0 + g] = l_all;
    }
  }
}

}  // namespace ddec
