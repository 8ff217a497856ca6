// cp.async copies and register-tile fragments shared by the Hopper bodies:
// norm_gemm_sm90.cuh (rows 12, 13, 15, 16), flash_bwd_sm90.cuh (rows 10, 11),
// flash_fwd_sm90.cuh (rows 7, 8) and decode_dense_sm90.cuh (rows 3-6).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace sm90 {

// ---- cp.async: global -> shared without registers --------------------------

// VEC floats from src to dst, or VEC zeros when !ok (src is then not read).
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? VEC * 4 : 0;
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS rows of D columns into dst (row stride LD), shared by NT threads of
// index ``tid``, VEC floats a copy: row r from src + off(r), columns at or
// past ``width`` and rows with off(r) < 0 as zeros.
template <int ROWS, int D, int LD, int VEC, int NT, class Off>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int width, Off off,
                                          int tid) {
  constexpr int CH = D / VEC, N = ROWS * CH;
  static_assert(N % NT == 0, "whole copy rounds");
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += NT) {
    const int i = i0 + tid, r = i / CH, c = (i % CH) * VEC;
    const long long o = off(r);
    const bool ok = o >= 0 && c < width;
    cp_async<VEC>(dst + r * LD + c, ok ? src + o + c : src, ok);
  }
}

// ---- a thread's positions in the tile --------------------------------------

// The i-th of a thread's T positions along an axis split over NT threads:
// groups of four side by side, group j at (j * NT + idx) * 4, so a warp's
// float4 reads are consecutive; T == 2 is one float2 at idx * 2.
template <int T, int NT>
__device__ __forceinline__ int frag_pos(int idx, int i) {
  if constexpr (T >= 4) return ((i / 4) * NT + idx) * 4 + i % 4;
  return idx * T + i;
}

template <int T, int NT>
__device__ __forceinline__ void load_frag(const float* p, int idx, float (&v)[T]) {
  if constexpr (T >= 4) {
#pragma unroll
    for (int j = 0; j < T / 4; ++j) {
      const float4 t = *reinterpret_cast<const float4*>(p + (j * NT + idx) * 4);
      v[4 * j] = t.x, v[4 * j + 1] = t.y, v[4 * j + 2] = t.z, v[4 * j + 3] = t.w;
    }
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p + idx * 2);
    v[0] = t.x, v[1] = t.y;
  }
}

// Store a thread's TN values of one output row (``row`` at the tile's first
// column); columns at or past ``n`` (relative to the tile) are not stored.
// With 16-byte copies every width is a multiple of four, so a group is
// all in or all out and goes as one vector store.
template <int TN, int TX, int VEC>
__device__ __forceinline__ void store_frag(float* row, int tx, const float (&v)[TN], int n) {
  if constexpr (VEC == 4 && TN >= 4) {
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const int c = frag_pos<TN, TX>(tx, j);
      if (c < n)
        *reinterpret_cast<float4*>(row + c) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  } else if constexpr (VEC == 4) {
    const int c = frag_pos<TN, TX>(tx, 0);
    if (c < n) *reinterpret_cast<float2*>(row + c) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = frag_pos<TN, TX>(tx, j);
      if (c < n) row[c] = v[j];
    }
  }
}

// Load a thread's TN values of one row of a global (M, n) tensor, the
// positions store_frag writes; columns at or past ``n`` read as zeros.
template <int TN, int TX, int VEC>
__device__ __forceinline__ void load_row_frag(const float* row, int tx, float (&v)[TN], int n) {
  if constexpr (VEC == 4 && TN >= 4) {
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const int c = frag_pos<TN, TX>(tx, j);
      const float4 t = c < n ? *reinterpret_cast<const float4*>(row + c)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[j] = t.x, v[j + 1] = t.y, v[j + 2] = t.z, v[j + 3] = t.w;
    }
  } else if constexpr (VEC == 4) {
    const int c = frag_pos<TN, TX>(tx, 0);
    const float2 t = c < n ? *reinterpret_cast<const float2*>(row + c) : make_float2(0.0f, 0.0f);
    v[0] = t.x, v[1] = t.y;
  } else {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = frag_pos<TN, TX>(tx, j);
      v[j] = c < n ? row[c] : 0.0f;
    }
  }
}

// Set the dynamic shared-memory limit when a launch needs more than 48 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Whether p is 16-byte aligned (null counts as aligned: it is never read).
inline bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

}  // namespace sm90
