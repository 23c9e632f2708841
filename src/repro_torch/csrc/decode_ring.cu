// Ring decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `decode_ring` (`_ring_kernel`) of
// src/repro/kernels/paged_attention/paged_attention.py: one-token attention
// over the model's dense per-slot cache, the attention of every layer of
// `decode_step` (`layers.decode_attention`).
//
//   q        [B, 1, H, D]     bf16 or f32, H = Hkv * n_rep
//   cache_k  [B, C, Hkv, D]   same type as q
//   cache_v  [B, C, Hkv, D]
//   pos      [B] int32        position of each sequence's new token (>= 0)
//   out      [B, 1, H, D]
//
// Query head h * n_rep + r reads kv head h (the reference's `qg` grouping).
// Without a window, slots <= pos are visible (pos >= C is legal: the cache
// write clamps to slot C-1 and then every slot is visible).  With a window
// the cache is a ring, slot = position % C, and a slot is visible when its
// age (pos % C - slot) % C is below min(window, pos + 1).  Softmax state
// (m, l, acc) is f32 and P.V stays in f32, as on the TPU; out = acc /
// max(l, 1e-30).  A row with no visible slot (pos < 0) returns zeros.
//
// What bounds it on the H100: bytes.  Each (b, kv-head) reads the K and V
// of its visible slots once, 4 * n_vis * D bytes in bf16, against
// 4 * n_rep * n_vis * D flops: n_rep flops per byte, far below the card's
// ~295 bf16 flops per byte.  So every visible K/V byte is read from device
// memory once: one block per (b, kv-head) stages [64, D] tiles of K and V in
// shared memory with 16-byte loads, and the n_rep query rows of the group
// share each staged tile.  The TPU kernel walks all C/BK blocks and masks
// the invisible ones (an artefact of its grid); this block visits only the
// visible slots, which form at most two contiguous runs of the ring.  A
// later version overlaps the next tile's loads with this tile's math and
// splits long caches across blocks (B * Hkv = 64 blocks leave half the SMs
// idle at the serving batch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The kernel's dynamic shared memory limit is set to the card's per-block
// limit (227 KB on an H100), the same value on every call, not to the
// launch's own size: a caller on another thread (one engine per pump
// thread) would otherwise lower it under a launch that needs more, which
// then fails as an invalid argument.
constexpr int kMaxDynamicSmem = 232448;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockK = 64;  // slots per staged tile (ops.RING_BLOCK_K)

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
decode_ring_kernel(const T* __restrict__ q, const T* __restrict__ cache_k,
                   const T* __restrict__ cache_v, const int* __restrict__ pos,
                   T* __restrict__ out, int C, int Hkv, int n_rep, int D,
                   int window, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int R = n_rep;
  const int H = Hkv * n_rep;
  const int ds = D + 1;  // odd row stride: column reads hit distinct banks

  extern __shared__ float smem[];
  float* qs = smem;               // [R, ds]
  float* ks = qs + R * ds;        // [kBlockK, ds]
  float* vs = ks + kBlockK * ds;  // [kBlockK, D]
  float* ss = vs + kBlockK * D;   // [R, kBlockK] scores, then probabilities
  float* acc = ss + R * kBlockK;  // [R, D]
  float* m = acc + R * D;         // [R]
  float* l = m + R;               // [R]
  float* alpha = l + R;           // [R]

  const int vpr = D / VEC;  // vectors per row
  const int64_t q_row0 = static_cast<int64_t>(b) * H + h * n_rep;
  for (int i = tid; i < R * vpr; i += kThreads) {
    const int r = i / vpr, c = (i % vpr) * VEC;
    load_vec(qs + r * ds + c, q + (q_row0 + r) * D + c);
  }
  for (int i = tid; i < R * D; i += kThreads) acc[i] = 0.f;
  for (int r = tid; r < R; r += kThreads) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  // The visible slots as at most two runs [lo0, hi0) and [lo1, hi1).
  const int p = pos[b];
  int lo0 = 0, hi0 = 0, lo1 = 0, hi1 = 0;
  if (window < 0) {
    hi0 = p < 0 ? 0 : min(p, C - 1) + 1;
  } else if (p >= 0) {
    const int n = min(min(window, p + 1), C);  // visible ages 0 .. n-1
    const int newest = p % C;
    const int start = newest - n + 1;
    if (start >= 0) {
      lo0 = start;
      hi0 = newest + 1;
    } else {  // the run wraps past slot 0
      hi0 = newest + 1;
      lo1 = C + start;
      hi1 = C;
    }
  }

  const int64_t tok_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t base_bh = (static_cast<int64_t>(b) * C * Hkv + h) * D;
  for (int run = 0; run < 2; ++run) {
    const int lo = run == 0 ? lo0 : lo1;
    const int hi = run == 0 ? hi0 : hi1;
    for (int t0 = lo; t0 < hi; t0 += kBlockK) {
      const int nt = min(kBlockK, hi - t0);
      __syncthreads();  // the previous tile is consumed (and q is staged)
      for (int i = tid; i < nt * vpr; i += kThreads) {
        const int t = i / vpr, c = (i % vpr) * VEC;
        const int64_t off = base_bh + (t0 + t) * tok_stride + c;
        load_vec(ks + t * ds + c, cache_k + off);
        load_vec(vs + t * D + c, cache_v + off);
      }
      __syncthreads();

      // scores: s[r][t] = (q_r . k_t) * scale; every staged slot is visible
      for (int i = tid; i < R * nt; i += kThreads) {
        const int r = i / nt, t = i % nt;
        const float* qr = qs + r * ds;
        const float* kt = ks + t * ds;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s += qr[d] * kt[d];
        ss[r * kBlockK + t] = s * scale;
      }
      __syncthreads();

      // online softmax update, one warp per row
      for (int r = warp; r < R; r += kWarps) {
        float* sr = ss + r * kBlockK;
        float mx = kNegInf;
        for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, sr[t]);
        mx = warp_max(mx);
        const float m_prev = m[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int t = lane; t < nt; t += 32) {
          const float e = expf(sr[t] - m_new);
          sr[t] = e;
          sum += e;
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
        const float* pr = ss + r * kBlockK;
        float a = acc[i] * alpha[r];
        for (int t = 0; t < nt; ++t) a += pr[t] * vs[t * D + d];
        acc[i] = a;
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    out[(q_row0 + r) * D + d] = from_f<T>(acc[i] / fmaxf(l[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, int B, int C, int Hkv, int n_rep, int D, int window,
           float scale, cudaStream_t stream) {
  const size_t R = static_cast<size_t>(n_rep);
  const size_t smem = sizeof(float) *
      (R * (D + 1) + static_cast<size_t>(kBlockK) * (D + 1) +
       static_cast<size_t>(kBlockK) * D + R * kBlockK + R * D + 3 * R);
  cudaError_t err = cudaFuncSetAttribute(
      decode_ring_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynamicSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_ring_kernel<T><<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos),
      static_cast<T*>(out), C, Hkv, n_rep, D, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window < 0 means no window.  Returns the CUDA error code of the launch
// (0 = launched).
extern "C" int decode_ring_attention(const void* q, const void* cache_k,
                                     const void* cache_v, const void* pos,
                                     void* out, int B, int C, int Hkv,
                                     int n_rep, int D, int window,
                                     float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, cache_k, cache_v, pos, out, B, C, Hkv,
                                 n_rep, D, window, scale, s);
  return launch<float>(q, cache_k, cache_v, pos, out, B, C, Hkv, n_rep, D,
                       window, scale, s);
}

extern "C" const char* decode_ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
