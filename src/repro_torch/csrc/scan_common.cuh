// What the recurrence kernels share (csrc/wkv6.cu, csrc/selective_scan.cu
// and their backward kernels csrc/wkv6_bwd.cu, csrc/selective_scan_bwd.cu).
#pragma once

#include <cuda_runtime.h>

namespace scan {

// The chunk of the reference's chunked_time_scan (repro/models/scan_utils.py):
// a forward that trains writes the state before every kChunk-th step and the
// final state (ceil(S / kChunk) + 1 states), the backward recomputes each
// chunk's steps from them.  kernels/recurrence.py's SCAN_CHUNK matches it.
constexpr int kChunk = 64;
// Inside a chunk the backward keeps the state before every kSub-th step.
constexpr int kSub = 8;
constexpr int kNSub = kChunk / kSub;

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

// Reduce-scatter over a group of LW lanes (LW a power of two up to 32, its
// lanes in ``mask``): each lane brings N values (N a power of two); the sums
// over the group come back spread over the lanes, each sum taken in a fixed
// order (one butterfly of __shfl_xor_sync), so a call repeats bit for bit.
// Afterwards, with P = max(N / LW, 1):
//   N >= LW: lane l holds in x[0 .. P-1] the sums of indices l * P + i;
//   N <  LW: x[0] holds the sum of index l / (LW / N), the same bits on the
//            LW / N lanes that share it.
// Stage ST pairs the lanes l and l ^ (LW >> (ST + 1)); while a lane still
// holds n >= 2 values it keeps one half and adds its partner's copy of that
// half, then both halves' owners add the last value.  The stages recurse at
// compile time, so every index is a constant and x stays in registers.
template <int N, int LW, int ST = 0>
__device__ __forceinline__ void lane_reduce_scatter(float (&x)[N], int lane,
                                                    unsigned mask) {
  if constexpr (ST < ilog2(LW)) {
    constexpr int m = LW >> (ST + 1);
    constexpr int n = N >> ST;
    if constexpr (n >= 2) {
      const bool up = (lane & m) != 0;
#pragma unroll
      for (int i = 0; i < n / 2; ++i) {
        const float send = up ? x[i] : x[i + n / 2];
        const float keep = up ? x[i + n / 2] : x[i];
        x[i] = keep + __shfl_xor_sync(mask, send, m);
      }
    } else {
      x[0] += __shfl_xor_sync(mask, x[0], m);
    }
    lane_reduce_scatter<N, LW, ST + 1>(x, lane, mask);
  }
}

// Set a kernel's dynamic shared-memory limit when it needs more than 48 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace scan
