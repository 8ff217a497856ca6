// softmax_rows: row softmax through the dual-mode unit.
//
// Replaces repro/kernels/dualmode_softmax.py:softmax_pallas (pallas_call
// at :82).  precision=int: quantize to S5.10, softmax_int (Eq. 10 in the
// log2 domain), dequantize at 2^-14.  precision=float: datapath.row_softmax.
//
// Bound on the H100: memory for the float mode (8 bytes per element
// against two exp2f); the int mode runs a few dozen int32 instructions an
// element, and Hopper issues int32 at half its f32 rate, so its body is
// near issue-bound at the bert shape (PERF.md counts them).
//
// Design (kernels/tiling.softmax_rows_plan picks the scheme and its
// template arguments; this file instantiates exactly those):
//  * held rows: a warp holds a row (n <= 1024, 8 rows a 256-thread block)
//    or a 256-thread block does (n <= 8192).  Each thread reads WORDS
//    words once into registers -- 16-byte loads where n % 4 == 0 and both
//    pointers are on 16 bytes, 4-byte loads otherwise, the ragged edge
//    masked -- and writes each output once.  The int mode quantizes each
//    word once, reduces the max, turns the held words into log2-domain
//    words once, sums exp2_int(t) >> guard_shift, then emits
//    exp2_int(t - log2 s); the float mode runs the same skeleton on
//    exp2f((x - m) log2 e - log2 s).  A warp row reduces by xor shuffles
//    only; a block row adds one shared-memory exchange a reduction (every
//    thread folds the 8 warps' partials in warp order: one barrier).
//  * streamed rows (longer): three strided sweeps of 256 threads (max,
//    guard-shifted sum, emit) that re-read the row, with the same
//    one-barrier reductions.
// The int PWL lookups read a shared-memory copy of the ROM (unit::RomTable).
// The int max and sum are exact in any order, so the words are bitwise
// softmax_int's; the float sum's order is fixed (a thread's words in
// order, the xor butterfly, the warps in order), so two calls give the
// same bits.  guard_shift comes from the caller, from the UNPADDED row
// length n.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "block_reduce.cuh"
#include "unit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The reduction of a row over the R threads that share it: xor shuffles in
// the warp; for a block row (R = kThreads) then one exchange through
// ``xchg`` (kWarps slots, used by this reduction only), every thread
// folding the warps' partials in warp order.
template <int R, typename T, typename Op>
__device__ __forceinline__ T row_reduce(T v, Op op, T* xchg) {
  v = warp_reduce(v, op);
  if (R == 32) return v;
  if ((threadIdx.x & 31) == 0) xchg[threadIdx.x >> 5] = v;
  __syncthreads();
  v = xchg[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = op(v, xchg[w]);
  return v;
}

__device__ __forceinline__ void rom_setup(int2* rom) {
  if (threadIdx.x < 16) unit::rom_fill(rom, threadIdx.x);
  __syncthreads();
}

// A thread's WORDS words of its row, VEC at a time: word j * VEC + c is
// element VEC * (j * R + lane) + c (neighbouring lanes, neighbouring VEC
// groups).  With VEC = 4, n % 4 == 0, so a group is wholly in or out.
template <int R, int WORDS, int VEC>
struct Slice {
  static constexpr int kGroups = WORDS / VEC;
  static_assert(WORDS % VEC == 0, "a thread holds whole groups");

  __device__ static int first(int j, int lane) { return VEC * (j * R + lane); }

  __device__ static void load(const float* __restrict__ src, int n, int lane,
                              float pad, float (&v)[WORDS]) {
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int e = first(j, lane);
      if (VEC == 4) {
        const float4 f = e < n ? __ldg(reinterpret_cast<const float4*>(src + e))
                               : make_float4(pad, pad, pad, pad);
        v[4 * j] = f.x, v[4 * j + 1] = f.y, v[4 * j + 2] = f.z, v[4 * j + 3] = f.w;
      } else {
        v[j] = e < n ? __ldg(src + e) : pad;
      }
    }
  }

  __device__ static void store(float* __restrict__ dst, int n, int lane,
                               const float (&v)[WORDS]) {
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int e = first(j, lane);
      if (e >= n) continue;
      if (VEC == 4)
        *reinterpret_cast<float4*>(dst + e) =
            make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
      else
        dst[e] = v[j];
    }
  }

  __device__ static bool valid(int i, int n, int lane) {
    return first(i / VEC, lane) + i % VEC < n;
  }
};

template <bool kInt, int R, int WORDS, int VEC>
__global__ void __launch_bounds__(kThreads)
softmax_held_kernel(const float* __restrict__ x, float* __restrict__ y,
                    int rows, int n, int guard_shift) {
  using S = Slice<R, WORDS, VEC>;
  __shared__ int2 rom_tab[16];
  __shared__ int32_t xi[2][kWarps];
  __shared__ float xf[2][kWarps];
  if (kInt) rom_setup(rom_tab);
  const unit::RomTable rom{rom_tab};
  const int lane = R == 32 ? (threadIdx.x & 31) : threadIdx.x;
  const int row = R == 32 ? blockIdx.x * kWarps + (threadIdx.x >> 5)
                          : blockIdx.x;
  if (row >= rows) return;  // whole warps of a warp-row block; no barrier after
  const float* src = x + static_cast<size_t>(row) * n;
  float* dst = y + static_cast<size_t>(row) * n;

  float v[WORDS];
  if (kInt) {
    S::load(src, n, lane, 0.0f, v);
    int32_t w[WORDS];
    int32_t m = unit::IN_MIN;
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      w[i] = S::valid(i, n, lane) ? unit::quantize(v[i], unit::IN_FRAC)
                                  : unit::IN_MIN;
      m = max(m, w[i]);
    }
    m = row_reduce<R>(m, MaxOp(), xi[0]);
    int32_t s = 0;
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      w[i] = unit::to_log2_domain(w[i] - m, unit::IN_FRAC);
      if (S::valid(i, n, lane)) s += unit::exp2_int(w[i], rom) >> guard_shift;
    }
    s = row_reduce<R>(s, SumOp(), xi[1]);
    s = s < 1 ? 1 : s;
    const int32_t log2s = unit::log2_int(s, unit::EXP_FRAC - guard_shift, rom);
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      const int32_t d = w[i] - log2s;
      v[i] = unit::dequantize(unit::exp2_int(d < 0 ? d : 0, rom),
                              unit::EXP_FRAC);
    }
  } else {
    S::load(src, n, lane, -INFINITY, v);
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < WORDS; ++i) m = fmaxf(m, v[i]);
    m = row_reduce<R>(m, MaxOp(), xf[0]);
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      v[i] = (v[i] - m) * unit::LOG2E;
      if (S::valid(i, n, lane)) s += exp2f(v[i]);
    }
    s = row_reduce<R>(s, SumOp(), xf[1]);
    const float log2s = log2f(s);
#pragma unroll
    for (int i = 0; i < WORDS; ++i) v[i] = exp2f(v[i] - log2s);
  }
  S::store(dst, n, lane, v);
}

template <bool kInt>
__global__ void __launch_bounds__(kThreads)
softmax_stream_kernel(const float* __restrict__ x, float* __restrict__ y,
                      int n, int guard_shift) {
  __shared__ int2 rom_tab[16];
  __shared__ int32_t xi[2][kWarps];
  __shared__ float xf[2][kWarps];
  const float* row = x + static_cast<size_t>(blockIdx.x) * n;
  float* out = y + static_cast<size_t>(blockIdx.x) * n;
  if (kInt) {
    rom_setup(rom_tab);
    const unit::RomTable rom{rom_tab};
    int32_t m = unit::IN_MIN;
    for (int i = threadIdx.x; i < n; i += kThreads)
      m = max(m, unit::quantize(row[i], unit::IN_FRAC));
    m = row_reduce<kThreads>(m, MaxOp(), xi[0]);
    int32_t s = 0;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int32_t t = unit::to_log2_domain(
          unit::quantize(row[i], unit::IN_FRAC) - m, unit::IN_FRAC);
      s += unit::exp2_int(t, rom) >> guard_shift;
    }
    s = row_reduce<kThreads>(s, SumOp(), xi[1]);
    s = s < 1 ? 1 : s;
    const int32_t log2s = unit::log2_int(s, unit::EXP_FRAC - guard_shift, rom);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int32_t t = unit::to_log2_domain(
          unit::quantize(row[i], unit::IN_FRAC) - m, unit::IN_FRAC);
      const int32_t d = t - log2s;
      out[i] = unit::dequantize(unit::exp2_int(d < 0 ? d : 0, rom),
                                unit::EXP_FRAC);
    }
  } else {
    float m = -INFINITY;
    for (int i = threadIdx.x; i < n; i += kThreads) m = fmaxf(m, row[i]);
    m = row_reduce<kThreads>(m, MaxOp(), xf[0]);
    float s = 0.0f;
    for (int i = threadIdx.x; i < n; i += kThreads)
      s += exp2f((row[i] - m) * unit::LOG2E);
    s = row_reduce<kThreads>(s, SumOp(), xf[1]);
    const float log2s = log2f(s);
    for (int i = threadIdx.x; i < n; i += kThreads)
      out[i] = exp2f((row[i] - m) * unit::LOG2E - log2s);
  }
}

template <int R, int WORDS, int VEC>
int launch_held(const float* x, float* y, int rows, int n, bool int_mode,
                int guard_shift, cudaStream_t st) {
  const int blocks = R == 32 ? (rows + kWarps - 1) / kWarps : rows;
  if (int_mode)
    softmax_held_kernel<true, R, WORDS, VEC>
        <<<blocks, kThreads, 0, st>>>(x, y, rows, n, guard_shift);
  else
    softmax_held_kernel<false, R, WORDS, VEC>
        <<<blocks, kThreads, 0, st>>>(x, y, rows, n, guard_shift);
  return static_cast<int>(cudaGetLastError());
}

template <int R, int VEC>
int launch_words(int words, const float* x, float* y, int rows, int n,
                 bool int_mode, int guard_shift, cudaStream_t st) {
  const int refused = static_cast<int>(cudaErrorInvalidValue);
  switch (words) {
#define REPRO_HELD(W)                                                        \
  case W:                                                                    \
    if constexpr (W % VEC == 0 && (R == 32 || W >= 8))                       \
      return launch_held<R, W, VEC>(x, y, rows, n, int_mode, guard_shift, st); \
    return refused;
    REPRO_HELD(1)
    REPRO_HELD(2)
    REPRO_HELD(4)
    REPRO_HELD(8)
    REPRO_HELD(16)
    REPRO_HELD(32)
#undef REPRO_HELD
    default:
      return refused;
  }
}

}  // namespace

// x, y: (rows, n) float32, contiguous.  precision: 1 = int, 0 = float.
// (row_threads, words, vec) from tiling.softmax_rows_plan: (32 | 256,
// words, 1 | 4) holds a row; words 0 streams it (row_threads 256, vec 1).
// Anything else, and 16-byte loads on an n or a pointer off 16 bytes, is
// refused (cudaErrorInvalidValue) before any launch.
extern "C" int softmax_rows_launch(const float* x, float* y, int rows, int n,
                                   int precision, int guard_shift,
                                   int row_threads, int words, int vec,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int refused = static_cast<int>(cudaErrorInvalidValue);
  const bool int_mode = precision == 1;
  if (vec == 4 && (n % 4 != 0 || ((reinterpret_cast<uintptr_t>(x) |
                                   reinterpret_cast<uintptr_t>(y)) & 15)))
    return refused;
  if (words == 0) {
    if (row_threads != kThreads || vec != 1) return refused;
    if (int_mode)
      softmax_stream_kernel<true><<<rows, kThreads, 0, st>>>(x, y, n, guard_shift);
    else
      softmax_stream_kernel<false><<<rows, kThreads, 0, st>>>(x, y, n, guard_shift);
    return static_cast<int>(cudaGetLastError());
  }
  if (row_threads == 32 && vec == 1)
    return launch_words<32, 1>(words, x, y, rows, n, int_mode, guard_shift, st);
  if (row_threads == 32 && vec == 4)
    return launch_words<32, 4>(words, x, y, rows, n, int_mode, guard_shift, st);
  if (row_threads == kThreads && vec == 1)
    return launch_words<kThreads, 1>(words, x, y, rows, n, int_mode,
                                     guard_shift, st);
  if (row_threads == kThreads && vec == 4)
    return launch_words<kThreads, 4>(words, x, y, rows, n, int_mode,
                                     guard_shift, st);
  return refused;
}
