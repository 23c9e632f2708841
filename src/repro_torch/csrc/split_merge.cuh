// The merge pass of split-KV attention, shared by the port's split-KV
// kernels (csrc/paged_chunk.cu for the paged chunk attention and the
// one-token paged decode, csrc/decode_ring.cu), which all launch it through
// launch_merge().  Every csrc/*.cu that includes it still builds into a
// library of its own (kernels/_build.py hashes the header into each
// library's name).
//
// A split kernel leaves, for each query row and split s, the split's
// softmax state: part_ml [rows, n_splits, 2] holds (m_s, l_s), part_acc
// [rows, n_splits, D] the unnormalised sum acc_s.  The merge writes
//
//   out[row] = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30),
//   w_s = exp(m_s - max over live splits of m),
//
// rounded to the output's type once.  A split with l = 0 saw no visible
// key: it weighs 0 and its acc is never read (the split kernel may not have
// written it).  A row with no live split gets zeros.
//
// What bounds it: bytes, and at small B * H the number of blocks.  The
// partials are rows * n_splits * (D + 2) floats, written by the split
// kernel just before (so mostly still in L2); each is read once.  The
// merge before this one ran one block a row whose threads each walked
// every split twice and took one expf per (split, d): B * H = 16 blocks at
// one qwen3 sequence, each walking 64 to 256 splits in series.  Here:
//
//   * the per-row terms once per split: warp 0 of a block reads the row's
//     (m, l) with its 32 lanes together, takes m_max (fmaxf, exact in any
//     order), stores each w_s (0 where l = 0) in shared memory and sums
//     den = sum_s w_s l_s, lane by lane in split order, then over the lanes
//     by a fixed xor-shuffle tree;
//   * acc in parallel: the block's threads are kGroups = 16 groups of
//     kLanes lanes; group g sums splits g, g + 16, g + 32, ... in that
//     order, each lane 4 floats of D with 16-byte loads, skipping w_s = 0;
//     the 16 group sums are then added in group order;
//   * enough blocks: a block covers a slice of 4 * kLanes floats of one
//     row's D, kLanes = 8 (128 threads) where that gives at least
//     kMinBlocks blocks, else 2 (32 threads): 16 rows of D = 128 (one
//     qwen3 sequence) run 256 blocks of one warp, not 16 of 128 threads;
//   * few splits (n_splits <= 32: every serving step of qwen3, 8 splits
//     a row at 128 to 1024 rows): one warp a row instead
//     (merge_splits_rows_kernel), lane s holding split s's terms and each
//     lane 4 columns, with no shared memory and no barrier, where slices
//     of 32 columns would launch four blocks of 128 threads a row, half of
//     them idle; each split's sum is loaded as soon as its l is known,
//     under the weights' arithmetic.
//
// Which kernel runs depends on n_splits alone, and the order of every sum
// on n_splits alone, never on kLanes, the slice or the rows launched (D
// enters only as the columns' own addresses), so a row's output is
// bitwise the same at any batch, and B1's rows at any chunk length.  The
// warp-a-row kernel sums in the sliced kernel's order too, so one plain
// emulation (tests/_torch_split.py) stands for both.
//
// Programmatic dependent launch: launch_merge() launches the merge with
// cudaLaunchAttributeProgrammaticStreamSerialization, and every split
// kernel issues griddepcontrol.launch_dependents once its partials are
// written (Split<T>::attend in csrc/split_attention.cuh; a block that exits
// early counts as issued), so the merge's blocks are scheduled while the
// split kernel drains.  The merge executes griddepcontrol.wait before it
// reads anything, which waits for the whole split grid and its writes.
// chip_smoke.wrapper_ab timed it alone (the attribute set to 0 in one tree,
// both trees in one process, NVIDIA H100 80GB HBM3 at 700.00 W, bf16): B1
// at qwen3's T = 8 serving shape 1.2 to 1.4 us faster in three calls, and
// every B1, B3 and B4 shape alike, for +0.7 to +2.0 us of host time a
// call.  The profiler counts a dependent merge's wait as its own time.
//
// The choice of kernel and width was timed against simpler ones, the
// same way (bf16, qwen3's heads, B3 at one sequence of 16 rows): slices
// of 32 columns alone left B3 at 32768 tokens 1.6 us slower (0.0749
// against 0.0733 ms, readings 0.0728-0.0740 and 0.0746-0.0754) and at
// 8192 0.3 us, so the 8-column slices stay; 16-column slices were never
// reached by a timed shape and went; a warp a row taken only from 264
// rows on was 0.3-0.5 us slower at 128 rows (B1 at T = 1 0.0175 against
// 0.0170, B3 at B = 8 0.0171 against 0.0167, B4 0.0160 against 0.0157)
// and at one 2048-token sequence (0.0158 against 0.0154), and equal
// elsewhere, so it takes every launch of at most 32 splits.  With both,
// the timer reads: B1 0.0167 ms at T = 8, 0.0170 at T = 1, 0.0447 at 128
// rows and 0.0776 at 256; B3 0.0167 at B = 8, 0.0320 at one 8192-token
// sequence and 0.0734 at 32768; B4 0.0157 at qwen3's decode shape and
// 0.0206 at recurrentgemma's C = 2048.  Tried and left out: slices alone
// at many rows (B1 at 128 and 256 rows 17-19 % slower: 16,384 and 32,768
// blocks, half their threads idle); the
// warp-a-row merge loading a split only once its weight had been
// shuffled to it (0.87 ms per 10 serving steps, B1 1.2 us slower at T =
// 8); the sliced merge's loads predicated rather than branched, or a
// group's first 4 loaded before the weights (no shape moved by more than
// 0.5 us).  PERF.md has each reading against the merge before it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx_sm90.cuh"

namespace {
namespace split_merge {

constexpr int kGroups = 16;    // split groups of a block: g takes s = g mod 16
constexpr int kMinBlocks = 264;  // two blocks for each of the H100's 132 SMs
// the weights w_s of one row in shared memory (32 KB; ops.MERGE_MAX_SPLITS)
constexpr int kMaxSplits = 8192;

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v);
template <>
__device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float4 fma4(float w, float4 x, float4 a) {
  return make_float4(fmaf(w, x.x, a.x), fmaf(w, x.y, a.y), fmaf(w, x.z, a.z),
                     fmaf(w, x.w, a.w));
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 div4(float4 o, float den) {
  const float d = fmaxf(den, 1e-30f);
  return make_float4(o.x / d, o.y / d, o.z / d, o.w / d);
}

// One block per (row, slice of 4 * kLanes columns of D): blockIdx.x = row *
// slices + slice.  D must be a multiple of 4 and the tensors 16-byte
// aligned (the wrappers check).
template <typename T, int kLanes>
__global__ void __launch_bounds__(kGroups* kLanes)
merge_splits_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml, T* __restrict__ out,
                    int n_splits, int D, int slices) {
  extern __shared__ float ws[];  // [n_splits]
  __shared__ float4 red[kGroups][kLanes];
  __shared__ float den_s;
  griddep_wait();  // the split kernel's partials are complete and visible

  const int64_t row = blockIdx.x / slices;
  const int slice = blockIdx.x - static_cast<int>(row) * slices;
  const int tid = threadIdx.x;
  if (tid < 32) {
    const float2* ml = reinterpret_cast<const float2*>(part_ml) +
                       row * n_splits;
    float m_max = -INFINITY;
    for (int s = tid; s < n_splits; s += 32) {
      const float2 v = ml[s];
      if (v.y > 0.f) m_max = fmaxf(m_max, v.x);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m_max = fmaxf(m_max, __shfl_xor_sync(0xffffffffu, m_max, o));
    float den = 0.f;
    for (int s = tid; s < n_splits; s += 32) {
      const float2 v = ml[s];
      const float w = v.y > 0.f ? expf(v.x - m_max) : 0.f;
      ws[s] = w;
      den = fmaf(w, v.y, den);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, o);
    if (tid == 0) den_s = den;
  }
  __syncthreads();

  const int g = tid / kLanes, c = tid - g * kLanes;
  const int col = (slice * kLanes + c) * 4;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < D) {
    const float* acc = part_acc + row * n_splits * D + col;
#pragma unroll 4
    for (int s = g; s < n_splits; s += kGroups) {
      const float w = ws[s];
      if (w != 0.f) {
        const float4 x = *reinterpret_cast<const float4*>(
            acc + static_cast<int64_t>(s) * D);
        a = fma4(w, x, a);
      }
    }
  }
  red[g][c] = a;
  __syncthreads();
  if (tid < kLanes && col < D) {
    float4 o = red[0][c];
#pragma unroll
    for (int i = 1; i < kGroups; ++i) o = add4(o, red[i][c]);
    store4<T>(out + row * D + col, div4(o, den_s));
  }
}

// The same merge, one warp a row (kWarps rows a block), for n_splits <=
// 32: lane s holds split s's (m, l) and weight, and each lane sums its 4
// columns (and the 4 columns 128, 256, ... past them) group by group in
// the order of merge_splits_kernel; the weights reach the other lanes by
// shuffles, with no shared memory and no block barrier.
constexpr int kWarps = 4;

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
merge_splits_rows_kernel(const float* __restrict__ part_acc,
                         const float* __restrict__ part_ml,
                         T* __restrict__ out, int rows, int n_splits,
                         int D) {
  griddep_wait();  // the split kernel's partials are complete and visible
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform
  const float2 v = lane < n_splits
                       ? reinterpret_cast<const float2*>(part_ml)[
                             row * n_splits + lane]
                       : make_float2(-INFINITY, 0.f);
  float m_max = v.y > 0.f ? v.x : -INFINITY;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m_max = fmaxf(m_max, __shfl_xor_sync(0xffffffffu, m_max, o));
  const float w = v.y > 0.f ? expf(v.x - m_max) : 0.f;
  float den = lane < n_splits ? fmaf(w, v.y, 0.f) : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    den += __shfl_xor_sync(0xffffffffu, den, o);

  // Each split's sum is loaded as soon as its l is known (a split with
  // l = 0 is not read and counts 0), so the loads overlap the weights'
  // max, exponentials and shuffles.  A split with l > 0 whose weight
  // underflows to 0 adds fma(0, x, a) = a: the same bits as
  // merge_splits_kernel, which skips it.
  const float* acc = part_acc + row * n_splits * D;
  for (int base = 0; base < D; base += 128) {  // warp-uniform
    const int col = base + 4 * lane;
    float4 a[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {  // splits 0..15, each a group's first
      const bool live = __shfl_sync(0xffffffffu, v.y, g) > 0.f && col < D;
      a[g] = live ? *reinterpret_cast<const float4*>(
                        acc + static_cast<int64_t>(g) * D + col)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      a[g] = fma4(__shfl_sync(0xffffffffu, w, g), a[g],
                  make_float4(0.f, 0.f, 0.f, 0.f));
    if (n_splits > kGroups) {  // warp-uniform: splits 16..31, the seconds
      float4 x[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int s = g + kGroups;
        const bool live = __shfl_sync(0xffffffffu, v.y, s) > 0.f && col < D;
        x[g] = live ? *reinterpret_cast<const float4*>(
                          acc + static_cast<int64_t>(s) * D + col)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
        a[g] = fma4(__shfl_sync(0xffffffffu, w, g + kGroups), x[g], a[g]);
    }
    float4 o = a[0];
#pragma unroll
    for (int g = 1; g < kGroups; ++g) o = add4(o, a[g]);
    if (col < D) store4<T>(out + row * D + col, div4(o, den));
  }
}

// A launch of `kernel` as a programmatic dependent of the kernel before it
// on `stream`.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), unsigned blocks,
                             unsigned threads, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T, int kLanes>
cudaError_t launch_lanes(const float* part_acc, const float* part_ml, T* out,
                         int rows, int n_splits, int D, cudaStream_t stream) {
  const int slices = (D + 4 * kLanes - 1) / (4 * kLanes);
  return launch_dependent(merge_splits_kernel<T, kLanes>,
                          static_cast<unsigned>(rows) * slices,
                          kGroups * kLanes,
                          sizeof(float) * static_cast<size_t>(n_splits),
                          stream, part_acc, part_ml, out, n_splits, D,
                          slices);
}

// Launch the merge of `rows` query rows (row i of the partials is row i of
// out [rows, D]) on `stream`, right after the split kernel that wrote the
// partials.  Returns the launch's error.
template <typename T>
cudaError_t launch_merge(const float* part_acc, const float* part_ml, T* out,
                         int rows, int n_splits, int D, cudaStream_t stream) {
  if (n_splits > kMaxSplits) return cudaErrorInvalidValue;
  const int64_t r = rows;
  if (n_splits <= 32)
    return launch_dependent(merge_splits_rows_kernel<T>,
                            static_cast<unsigned>((r + kWarps - 1) / kWarps),
                            32 * kWarps, 0, stream, part_acc, part_ml, out,
                            rows, n_splits, D);
  if (r * ((D + 31) / 32) >= kMinBlocks)
    return launch_lanes<T, 8>(part_acc, part_ml, out, rows, n_splits, D,
                              stream);
  return launch_lanes<T, 2>(part_acc, part_ml, out, rows, n_splits, D,
                            stream);
}

}  // namespace split_merge
}  // namespace
