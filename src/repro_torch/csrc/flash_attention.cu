// Forward flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_bhsd` (`_flash_kernel`) of
// src/repro/kernels/flash_attention/flash_attention.py: causal or
// sliding-window forward attention over [BH, S, D] with GQA already
// expanded by the caller; the engine's monolithic bucket prefill.
//
//   q      [BH, Sq, D]   bf16 or f32
//   k, v   [BH, Skv, D]  same type as q
//   out    [BH, Sq, D]
//
// Query row i may attend key j iff j < Skv, (not causal or j <= i) and
// (no window or j > i - window).  Softmax state (m, l, acc) is f32; the
// probabilities are rounded to the input type before P.V (the bf16 product
// the XLA path computes), while l sums them unrounded; out = acc / max(l,
// 1e-30).  Tiles wholly above the diagonal or left of the window are
// skipped.  Sq and Skv need not be multiples of the tile: the ragged edge is
// masked by position and its loads are zero-filled.
//
// What bounds it on the H100: bytes, at the prefill shapes.  Causal
// attention over [BH, S, D] moves 4 * BH * S * D * 2 bytes (q, k, v in,
// out back) and does 4 * D * BH * S * (S + 1) / 2 flops, about S / 4 flops
// per byte against the card's ~295 bf16 flops per byte: below S ~ 1180 the
// bytes lead.  At BH = 16, D = 128: S = 512 is 8.4 MB (2.5 us at 3.35 TB/s)
// against 1.08 GFLOP (1.09 us at 989 TFLOP/s); S = 1024 is 16.8 MB (5.0 us)
// against 4.3 GFLOP (4.35 us).  Neither bound sets today's time: this first
// version computes with f32 FMAs on the CUDA cores, not the tensor cores,
// and its inner loops read shared memory twice per FMA, which is what holds
// it at ~0.34 ms for S = 512 (chip_smoke.py on an H100 80GB HBM3 at 700 W).
// Its design keeps every tile in shared memory (one block per (bh, 64-row
// q-tile), a loop over kv-tiles in the block in place of the TPU's
// sequential grid axis) so that each q/k/v byte is read from device memory
// once per block.  The tensor-core version (mma/wgmma on bf16 tiles) is
// later work.
//
// Tiles by head dim.  The tiles live in f32 shared memory, BQ x (D+1) for
// q, BK x (D+1) for k, BK x D for v, BQ x BK scores, BQ x D for the
// accumulator: for D <= 128 the kv-tile is 64 rows (at most 165,632 bytes),
// for 128 < D <= 256 (RecurrentGemma's 256) it is 32 rows, 205,952 bytes at
// D = 256 where 64 rows would need 279,808, past the 232,448 a block may
// use.  The D <= 128 instantiation is the one this kernel always had, so
// those calls compute exactly what they did.

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
constexpr int BQ = 64;        // query rows per block, every head dim
constexpr int kMaxHeadDim = 256;

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

// Rows [row0, row0 + rows) of a [S, D] matrix into f32 shared memory with
// row stride `stride`; rows at or past S are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* src, int row0, int rows,
                                          int S, int D, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  const int vpr = D / VEC;
  for (int i = tid; i < rows * vpr; i += kThreads) {
    const int r = i / vpr, c = (i % vpr) * VEC;
    float* d = dst + r * stride + c;
    if (row0 + r < S) {
      uint4 raw = *reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(row0 + r) * D + c);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) d[e] = to_f(vals[e]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) d[e] = 0.f;
    }
  }
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

template <typename T, int BK>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
             int D, float scale, int causal, int window) {
  const int bh = blockIdx.x;
  const int q_start = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ds = D + 1;  // odd row stride: column reads hit distinct banks

  extern __shared__ float smem[];
  float* qs = smem;            // [BQ, ds]
  float* ks = qs + BQ * ds;    // [BK, ds]
  float* vs = ks + BK * ds;    // [BK, D]
  float* ss = vs + BK * D;     // [BQ, BK]
  float* acc = ss + BQ * BK;   // [BQ, D]
  float* m = acc + BQ * D;     // [BQ]
  float* l = m + BQ;           // [BQ]
  float* alpha = l + BQ;       // [BQ]

  const T* qb = q + static_cast<int64_t>(bh) * Sq * D;
  const T* kb = k + static_cast<int64_t>(bh) * Skv * D;
  const T* vb = v + static_cast<int64_t>(bh) * Skv * D;
  load_tile(qs, ds, qb, q_start, BQ, Sq, D, tid);
  for (int i = tid; i < BQ * D; i += kThreads) acc[i] = 0.f;
  for (int r = tid; r < BQ; r += kThreads) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  const int n_kt = (Skv + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_start = kt * BK;
    if (causal && k_start > q_start + BQ - 1) break;  // above the diagonal
    if (window > 0 && k_start + BK - 1 < q_start - window + 1) continue;
    __syncthreads();  // the previous tiles are consumed
    load_tile(ks, ds, kb, k_start, BK, Skv, D, tid);
    load_tile(vs, D, vb, k_start, BK, Skv, D, tid);
    __syncthreads();

    for (int i = tid; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const float* qr = qs + r * ds;
      const float* kc = ks + c * ds;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qr[d] * kc[d];
      const int qpos = q_start + r, kpos = k_start + c;
      const bool ok = kpos < Skv && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      ss[i] = ok ? s * scale : kNegInf;
    }
    __syncthreads();

    for (int r = warp; r < BQ; r += kWarps) {
      float* sr = ss + r * BK;
      float mx = kNegInf;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, sr[c]);
      mx = warp_max(mx);
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float p = expf(sr[c] - m_new);
        sum += p;
        sr[c] = to_f(from_f<T>(p));  // p in v's type before P.V
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

    for (int i = tid; i < BQ * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const float* pr = ss + r * BK;
      float a = acc[i] * alpha[r];
      for (int c = 0; c < BK; ++c) a += pr[c] * vs[c * D + d];
      acc[i] = a;
    }
  }
  __syncthreads();

  T* ob = out + static_cast<int64_t>(bh) * Sq * D;
  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (q_start + r < Sq)
      ob[static_cast<int64_t>(q_start + r) * D + d] =
          from_f<T>(acc[i] / fmaxf(l[r], 1e-30f));
  }
}

template <typename T, int BK>
int launch_tiles(const void* q, const void* k, const void* v, void* out,
                 int BH, int Sq, int Skv, int D, float scale, int causal,
                 int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(BQ) * (D + 1) + static_cast<size_t>(BK) * (D + 1) +
       static_cast<size_t>(BK) * D + static_cast<size_t>(BQ) * BK +
       static_cast<size_t>(BQ) * D + 3 * static_cast<size_t>(BQ));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynamicSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (Sq + BQ - 1) / BQ);
  flash_kernel<T, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, D, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

// The kv-tile from the head dim (see "Tiles by head dim" above).
template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Sq, int Skv, int D, float scale, int causal, int window,
           cudaStream_t stream) {
  if (D > kMaxHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 128)
    return launch_tiles<T, 64>(q, k, v, out, BH, Sq, Skv, D, scale, causal,
                               window, stream);
  return launch_tiles<T, 32>(q, k, v, out, BH, Sq, Skv, D, scale, causal,
                             window, stream);
}

}  // namespace

// window <= 0 means no window.  Returns the CUDA error code of the launch
// (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int BH, int Sq,
                                   int Skv, int D, float scale, int causal,
                                   int window, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, BH, Sq, Skv, D, scale, causal,
                                 window, s);
  return launch<float>(q, k, v, out, BH, Sq, Skv, D, scale, causal, window,
                       s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
