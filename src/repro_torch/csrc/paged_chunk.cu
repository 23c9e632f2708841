// Paged chunk attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_chunk` (`_paged_chunk_kernel`) of
// src/repro/kernels/paged_attention/paged_attention.py: T-token chunk
// attention straight over the paged KV pool, the attention of every decode
// and chunked-prefill step of the serving engine.
//
//   q          [B, T, H, D]            bf16 or f32
//   k/v pages  [n_pages, P, Hkv, D]    same type as q
//   page_table [B, max_pages] int32    -1 = no page (skipped)
//   pos        [B] int32               first chunk position of each sequence
//   out        [B, T, H, D]
//
// The GQA group is folded into R = T * n_rep query rows per (b, kv-head);
// row r is chunk token t = r / n_rep of query head h * n_rep + r % n_rep and
// attends pool tokens tok <= pos[b] + t.  The chunk's own K/V is already in
// the pages (write-then-attend).  Softmax state (m, l, acc) is f32 and P.V
// stays in f32, as on the TPU; out = acc / max(l, 1e-30).  Rows with no
// visible token return garbage, as on the TPU; the engine never reads them.
//
// What bounds it on the H100: bytes.  Each (b, kv-head) reads its pages of
// K and V once, ~4 * ctx * D bytes, against 4 * R * ctx * D flops: at R <= 16
// that is at most 8 flops per byte, far below the card's ~295 bf16 flops per
// byte.  The design therefore reads every K/V byte from device memory once:
// one block per (b, kv-head) walks that sequence's pages in order, stages
// each [P, D] page tile of K and V in shared memory with 16-byte loads, and
// lets all R query rows of the group use the staged tile.  Only the pages
// up to ceil((pos + T) / P) are visited; the page table entry is read in the
// block (the TPU's scalar prefetch).  A later version overlaps the next
// page's loads with this page's math and splits long contexts across blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
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

// One 16-byte load of VEC consecutive elements, widened to f32 in shared
// memory.  Callers guarantee 16-byte alignment (D % VEC == 0 and aligned
// base pointers, checked by the Python wrapper).
template <typename T>
__device__ __forceinline__ void load_vec(float* dst, const T* src) {
  constexpr int VEC = 16 / sizeof(T);
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < VEC; ++e) dst[e] = to_f(vals[e]);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages,
                   const int* __restrict__ page_table,
                   const int* __restrict__ pos, T* __restrict__ out, int Tq,
                   int Hkv, int n_rep, int D, int P, int max_pages,
                   float scale) {
  constexpr int VEC = 16 / sizeof(T);
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int R = Tq * n_rep;
  const int H = Hkv * n_rep;
  const int ds = D + 1;  // odd row stride: column reads hit distinct banks

  extern __shared__ float smem[];
  float* qs = smem;            // [R, ds]
  float* ks = qs + R * ds;     // [P, ds]
  float* vs = ks + P * ds;     // [P, D]
  float* ss = vs + P * D;      // [R, P] scores, then probabilities
  float* acc = ss + R * P;     // [R, D]
  float* m = acc + R * D;      // [R]
  float* l = m + R;            // [R]
  float* alpha = l + R;        // [R]

  const int vpr = D / VEC;  // vectors per row
  for (int i = tid; i < R * vpr; i += kThreads) {
    const int r = i / vpr, c = (i % vpr) * VEC;
    const int t = r / n_rep, head = h * n_rep + r % n_rep;
    load_vec(qs + r * ds + c, q + ((static_cast<int64_t>(b) * Tq + t) * H + head) * D + c);
  }
  for (int i = tid; i < R * D; i += kThreads) acc[i] = 0.f;
  for (int r = tid; r < R; r += kThreads) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  const int p0 = pos[b];
  const int n_visit = min(max_pages, (p0 + Tq + P - 1) / P);
  const int64_t tok_stride = static_cast<int64_t>(Hkv) * D;
  for (int j = 0; j < n_visit; ++j) {
    const int page = page_table[static_cast<int64_t>(b) * max_pages + j];
    if (page < 0) continue;  // block-uniform
    __syncthreads();         // the previous page's tiles are consumed
    const int64_t base = (static_cast<int64_t>(page) * P * Hkv + h) * D;
    for (int i = tid; i < P * vpr; i += kThreads) {
      const int t = i / vpr, c = (i % vpr) * VEC;
      load_vec(ks + t * ds + c, k_pages + base + t * tok_stride + c);
      load_vec(vs + t * D + c, v_pages + base + t * tok_stride + c);
    }
    __syncthreads();

    // scores: s[r][t] = (q_r . k_t) * scale, masked per row by position
    for (int i = tid; i < R * P; i += kThreads) {
      const int r = i / P, t = i % P;
      const float* qr = qs + r * ds;
      const float* kt = ks + t * ds;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qr[d] * kt[d];
      const int tok = j * P + t;
      const int qpos = p0 + r / n_rep;
      ss[i] = tok <= qpos ? s * scale : kNegInf;
    }
    __syncthreads();

    // online softmax update, one warp per row
    for (int r = warp; r < R; r += kWarps) {
      float* sr = ss + r * P;
      float mx = kNegInf;
      for (int t = lane; t < P; t += 32) mx = fmaxf(mx, sr[t]);
      mx = warp_max(mx);
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < P; t += 32) {
        const float p = expf(sr[t] - m_new);
        sr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[r] = a;
        l[r] = a * l[r] + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v, all in f32
    for (int i = tid; i < R * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const float* pr = ss + r * P;
      float a = acc[i] * alpha[r];
      for (int t = 0; t < P; ++t) a += pr[t] * vs[t * D + d];
      acc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = r / n_rep, head = h * n_rep + r % n_rep;
    out[((static_cast<int64_t>(b) * Tq + t) * H + head) * D + d] =
        from_f<T>(acc[i] / fmaxf(l[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pt,
           const void* pos, void* out, int B, int Tq, int Hkv, int n_rep,
           int D, int P, int max_pages, float scale, cudaStream_t stream) {
  const int R = Tq * n_rep;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(R) * (D + 1) + static_cast<size_t>(P) * (D + 1) +
       static_cast<size_t>(P) * D + static_cast<size_t>(R) * P +
       static_cast<size_t>(R) * D + 3 * static_cast<size_t>(R));
  cudaError_t err = cudaFuncSetAttribute(
      paged_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_chunk_kernel<T><<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pt),
      static_cast<const int*>(pos), static_cast<T*>(out), Tq, Hkv, n_rep, D,
      P, max_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the CUDA error code of the launch (0 = launched).
extern "C" int paged_chunk_attention(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* page_table, const void* pos,
                                     void* out, int B, int Tq, int Hkv,
                                     int n_rep, int D, int P, int max_pages,
                                     float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, pos, out,
                                 B, Tq, Hkv, n_rep, D, P, max_pages, scale,
                                 s);
  return launch<float>(q, k_pages, v_pages, page_table, pos, out, B, Tq, Hkv,
                       n_rep, D, P, max_pages, scale, s);
}

extern "C" const char* paged_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
