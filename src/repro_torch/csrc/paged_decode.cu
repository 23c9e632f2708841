// Split-KV paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode` (`_paged_kernel`) of
// src/repro/kernels/paged_attention/paged_attention.py: one-token attention
// straight over the paged KV pool, through each sequence's page table.
//
//   q          [B, H, D]               bf16 or f32, H = Hkv * n_rep
//   k/v pages  [n_pages, P, Hkv, D]    same type as q
//   page_table [B, max_pages] int32    -1 = no page (skipped, never read)
//   lengths    [B] int32               tokens visible to each sequence
//   out        [B, H, D]               q's type
//
// Query head h * n_rep + r reads kv head h.  Token j of sequence b lives at
// slot j % P of pool page page_table[b][j / P]; tokens j < lengths[b] are
// visible.  Scores, softmax state and P.V are f32, as on the TPU, with one
// rounding to q's type at the end.
//
// What bounds it on the H100: bytes.  A sequence's K and V are read once,
// 4 * len * Hkv * D bytes in bf16, against 4 * n_rep * len * Hkv * D flops:
// n_rep flops per byte, far below the card's ~295 bf16 flops per byte.  The
// TPU kernel walks each (b, kv head)'s pages in order on one core; one block
// per (b, kv head) on the H100 gives B * Hkv = 64 blocks at the serving
// batch for 132 SMs, and one block walking a long context alone.  So every
// page of the table is a split of its own (split-KV): one block per (table
// entry j, kv head h, sequence b) copies the page's K and V rows of head h
// into shared memory (16-byte cp.async copies, all in flight at once),
// computes its n_rep query rows' scores, and leaves an unnormalised partial
// state, the row max m, the sum l of exp(s - m) and acc = sum exp(s - m) *
// v, in f32 scratch.  A second launch, `merge_splits_kernel`, combines each
// query row's splits, weighting split j by exp(m_j - max_j m_j).  A split
// that holds no visible token (a -1 entry, or a page wholly at or past
// lengths[b]) exits at once with l = 0, and the merge passes over it: it
// weighs 0 whatever its page holds.  Tokens past lengths[b] in the last
// page are never copied.
//
// Inside a block: a warp takes one staged key at a time, its lanes along D,
// and reduces the n_rep dot products with shuffles; one warp per row takes
// the page's max and exponentials; each thread then accumulates P.V for
// (row, d) pairs.  Tensor cores, TMA and a persistent merge are later work.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// The kernel's dynamic shared memory limit is set to the card's per-block
// limit (227 KB on an H100), the same value on every call, not to the
// launch's own size: a caller on another thread (one engine per pump
// thread) would otherwise lower it under a launch that needs more, which
// then fails as an invalid argument.
constexpr int kMaxDynamicSmem = 232448;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One block per (table entry j, kv head h, sequence b).  Writes, for each
// of the group's n_rep query rows (row = b * H + h * n_rep + r), the
// partial state of split j: part_ml[row][j] = (m, l) and
// part_acc[row][j][:] = acc.  D * sizeof(T) must be a multiple of 16 and
// the page tensors 16-byte aligned (checked by the Python wrapper).
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages,
                          const int* __restrict__ page_table,
                          const int* __restrict__ lengths,
                          float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int Hkv, int n_rep,
                          int D, int P, int max_pages, float scale) {
  const int j = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H = Hkv * n_rep;
  const int64_t row0 = static_cast<int64_t>(b) * H + h * n_rep;

  // visible tokens of this page (the table holds max_pages * P tokens)
  const int len = min(lengths[b], max_pages * P);
  const int n_tok = max(0, min(P, len - j * P));
  const int page = page_table[static_cast<int64_t>(b) * max_pages + j];
  if (n_tok == 0 || page < 0) {  // block-uniform: nothing visible, weight 0
    for (int r = tid; r < n_rep; r += kThreads) {
      part_ml[((row0 + r) * max_pages + j) * 2] = -INFINITY;
      part_ml[((row0 + r) * max_pages + j) * 2 + 1] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);              // [P, D]
  T* vs = ks + static_cast<int64_t>(P) * D;            // [P, D]
  float* qs = reinterpret_cast<float*>(vs + static_cast<int64_t>(P) * D);
  float* ss = qs + n_rep * D;                          // [n_rep, P]
  float* stat = ss + n_rep * P;                        // [n_rep, 2] (m, l)

  // copy the visible rows of kv head h, 16 bytes per copy, all in flight
  const int64_t tok_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t base = (static_cast<int64_t>(page) * P * Hkv + h) * D;
  const int vpr = D * static_cast<int>(sizeof(T)) / 16;  // copies per row
  for (int i = tid; i < n_tok * vpr; i += kThreads) {
    const int t = i / vpr, c = i % vpr;
    __pipeline_memcpy_async(reinterpret_cast<uint4*>(ks + t * D) + c,
                            reinterpret_cast<const uint4*>(
                                k_pages + base + t * tok_stride) + c, 16);
    __pipeline_memcpy_async(reinterpret_cast<uint4*>(vs + t * D) + c,
                            reinterpret_cast<const uint4*>(
                                v_pages + base + t * tok_stride) + c, 16);
  }
  __pipeline_commit();
  for (int i = tid; i < n_rep * D; i += kThreads)
    qs[i] = to_f(q[row0 * D + i]);
  __pipeline_wait_prior(0);
  __syncthreads();

  // scores: one warp per key, lanes along D, n_rep shuffle reductions
  for (int t = warp; t < n_tok; t += kWarps) {
    const T* kt = ks + t * D;
    for (int r = 0; r < n_rep; ++r) {
      const float* qr = qs + r * D;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += qr[d] * to_f(kt[d]);
      dot = warp_sum(dot);
      if (lane == 0) ss[r * P + t] = dot * scale;
    }
  }
  __syncthreads();

  // the page's softmax state, one warp per row
  for (int r = warp; r < n_rep; r += kWarps) {
    float* sr = ss + r * P;
    float mx = -INFINITY;
    for (int t = lane; t < n_tok; t += 32) mx = fmaxf(mx, sr[t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < n_tok; t += 32) {
      const float p = expf(sr[t] - mx);
      sr[t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      stat[2 * r] = mx;
      stat[2 * r + 1] = sum;
    }
  }
  __syncthreads();

  // acc[r][d] = sum_t p[r][t] * v[t][d]
  for (int i = tid; i < n_rep * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const float* pr = ss + r * P;
    float a = 0.f;
    for (int t = 0; t < n_tok; ++t) a += pr[t] * to_f(vs[t * D + d]);
    part_acc[((row0 + r) * max_pages + j) * D + d] = a;
  }
  for (int r = tid; r < n_rep; r += kThreads) {
    part_ml[((row0 + r) * max_pages + j) * 2] = stat[2 * r];
    part_ml[((row0 + r) * max_pages + j) * 2 + 1] = stat[2 * r + 1];
  }
}

// The merge pass of split softmax attention, for any kernel that leaves
// per-split partial states: one block per query row.  part_ml [rows,
// n_splits, 2] holds each split's (m, l), part_acc [rows, n_splits, D] its
// unnormalised sum; out[row] = sum_s w_s acc_s / sum_s w_s l_s with w_s =
// exp(m_s - max m).  Splits with l = 0 saw no visible token and are passed
// over (their acc is never read); a row with none gets zeros.
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pt,
           const void* lengths, float* part_acc, float* part_ml, void* out,
           int B, int Hkv, int n_rep, int D, int P, int max_pages,
           float scale, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(T) * static_cast<size_t>(P) * D +
                      sizeof(float) * (static_cast<size_t>(n_rep) * D +
                                       static_cast<size_t>(n_rep) * P +
                                       2 * static_cast<size_t>(n_rep));
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_split_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_split_kernel<T><<<dim3(max_pages, Hkv, B), kThreads, smem,
                                 stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pt),
      static_cast<const int*>(lengths), part_acc, part_ml, Hkv, n_rep, D, P,
      max_pages, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_splits_kernel<T><<<B * Hkv * n_rep, kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), max_pages, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part_acc [B*H, max_pages, D] and part_ml [B*H, max_pages, 2] are f32
// scratch the caller allocates.  Returns the CUDA error code of the
// launches (0 = both launched).
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* part_acc,
    void* part_ml, void* out, int B, int Hkv, int n_rep, int D, int P,
    int max_pages, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(part_acc);
  float* ml = static_cast<float*>(part_ml);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, lengths,
                                 acc, ml, out, B, Hkv, n_rep, D, P,
                                 max_pages, scale, s);
  return launch<float>(q, k_pages, v_pages, page_table, lengths, acc, ml,
                       out, B, Hkv, n_rep, D, P, max_pages, scale, s);
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
