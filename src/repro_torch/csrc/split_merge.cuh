// The merge pass of split-KV attention, shared by the port's split-KV
// kernels (csrc/paged_decode.cu, csrc/decode_ring.cu, csrc/paged_chunk.cu).
// Every csrc/*.cu that includes it still builds into a library of its own
// (kernels/_build.py hashes the header into each library's name).

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {
namespace split_merge {

constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The merge pass of split softmax attention, for any kernel that leaves
// per-split partial states: one block per query row.  part_ml [rows,
// n_splits, 2] holds each split's (m, l), part_acc [rows, n_splits, D] its
// unnormalised sum; out[row] = sum_s w_s acc_s / sum_s w_s l_s with w_s =
// exp(m_s - max m).  Splits with l = 0 saw no visible token and are passed
// over (their acc is never read); a row with none gets zeros.  The splits
// are walked in index order, so a row's output depends on its own
// partials only.
template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_splits_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml, T* __restrict__ out,
                    int n_splits, int D) {
  const int64_t row = blockIdx.x;
  const float* ml = part_ml + row * n_splits * 2;
  const float* acc = part_acc + row * n_splits * D;
  float m_max = -INFINITY;
  for (int s = 0; s < n_splits; ++s)
    if (ml[2 * s + 1] > 0.f) m_max = fmaxf(m_max, ml[2 * s]);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float num = 0.f, den = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_splits; ++s) {
      const float l = ml[2 * s + 1];
      if (l > 0.f) {
        const float w = expf(ml[2 * s] - m_max);
        num += w * acc[static_cast<int64_t>(s) * D + d];
        den += w * l;
      }
    }
    out[row * D + d] = from_f<T>(num / fmaxf(den, 1e-30f));
  }
}

}  // namespace split_merge
}  // namespace
