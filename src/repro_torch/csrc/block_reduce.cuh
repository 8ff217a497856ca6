// Warp and block reductions shared by the port's kernels.
#pragma once

struct MaxOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a > b ? a : b; }
};

struct SumOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};

template <typename T, typename Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Reduce over the whole block (blockDim.x a multiple of 32, at most 1024);
// every thread gets the result.  ``smem`` holds 32 elements.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T identity, T* smem) {
  v = warp_reduce(v, op);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  __syncthreads();  // smem may still be read from a previous reduction
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < n_warps ? smem[lane] : identity;
    v = warp_reduce(v, op);
    if (lane == 0) smem[0] = v;
  }
  __syncthreads();
  return smem[0];
}
