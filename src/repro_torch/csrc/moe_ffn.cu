// Grouped expert FFN (SwiGLU) for Hopper (sm_90a).
//
// Replaces the TPU kernel `moe_ffn` (`_moe_ffn_kernel`) of
// src/repro/kernels/moe_ffn/moe_ffn.py: for every expert e over its block
// of C token rows,
//
//   out[e] = (silu(x[e] @ w_gate[e]) * (x[e] @ w_up[e])) @ w_down[e]
//
//   x       [E, C, D]  bf16 or f32, rows contiguous; the expert stride is
//                      C * D, or 0 when one [C, D] block is shared by every
//                      expert (the dropless MoE passes it so, uncopied)
//   w_gate  [E, D, F]  same type, contiguous
//   w_up    [E, D, F]
//   w_down  [E, F, D]
//   out     [E, C, D]  contiguous, same type
//
// All three products are f32 multiply-adds on the CUDA cores, h = silu(g) *
// u stays f32 (in shared memory), and the output is rounded to the input
// type once, as in the TPU kernel and the plain version (`ref.py`).
//
// Design.  One block per (expert, tile of kBC = 16 rows), 256 threads, in
// two phases; F and D may be any multiple of the 16-byte vector width.
//   1. h[16, F] in f32 shared memory.  F in tiles of kBF = 256 columns, one
//      per thread: the thread keeps its column of g and of u for all 16
//      rows in registers.  D runs in sub-tiles of kBK = 16: the x, w_gate
//      and w_up sub-tiles are staged in shared memory as f32 (x
//      transposed, so the 16 rows of one d are 4 broadcast reads), the next
//      sub-tile's 16-byte loads already in flight (held in registers) while
//      this one is multiplied: 32 multiply-adds per 6 shared-memory reads.
//   2. out[16, D] = h @ w_down, D in chunks of 1024 columns: each thread
//      owns 4 columns of all 16 rows in registers and reads its w_down
//      columns straight from device memory, each element once per block;
//      the 16 h values of a column of h are one broadcast shared-memory
//      read.
// The TPU kernel keeps a [BC, D] accumulator resident across a sequential
// grid axis over F; here the loop over F runs inside the block instead, and
// h (16 * F * 4 bytes: 32 KB at F = 512) is what stays on chip.
//
// Batch invariance.  Every element of g and u is one chain of fmaf over d
// = 0 .. D-1 in order, every output element one chain over f = 0 .. F-1 in
// order; the tile sizes are constants (never chosen from C), nothing is
// split across blocks and no atomics are used.  So a token's output row is
// bitwise the same whatever C is and wherever the row sits in the block,
// which the serving invariants (chunked == sequential prefill, paged ==
// dense plane) rely on.  Rows past C are computed as zeros and not stored.
//
// What bounds it on the H100: bytes at serving sizes.  Each launch must read
// every expert's three weight matrices (3 * E * D * F elements: 100.7 MB in
// bf16 at granite-moe-1b-a400m's E = 32, D = 1024, F = 512, 30 us at 3.35
// TB/s) against 6 * E * C * D * F flops (6.4 GFLOP at C = 64, 6.5 us on the
// tensor cores).  This first version multiplies on the CUDA cores in f32
// (67 TFLOP/s peak) and a block reads its expert's weights itself, so at
// C = 64 the multiply-adds set its time; and at decode (C = 8) only E = 32
// blocks run on 132 SMs.  wgmma on bf16 tiles, TMA loads and a routed
// grouped GEMM over only the chosen (token, expert) rows are later work.

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

constexpr int kThreads = 256;
constexpr int kBC = 16;    // rows per block (ops.MOE_BLOCK_ROWS)
constexpr int kBF = 256;   // F columns per phase-1 tile: one per thread
constexpr int kBK = 16;    // D rows per staged sub-tile
constexpr int kCols = 4;   // phase-2 output columns per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Widen one raw 16-byte vector of T into VEC f32 values in shared memory
// (16-byte stores; dst is 16-byte aligned).
template <typename T>
__device__ __forceinline__ void store_vec(float* dst, const uint4& raw) {
  constexpr int VEC = 16 / sizeof(T);
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < VEC; e += 4)
    *reinterpret_cast<float4*>(dst + e) =
        make_float4(to_f(v[e]), to_f(v[e + 1]), to_f(v[e + 2]), to_f(v[e + 3]));
}

// Four consecutive T values, widened (8-byte load for bf16, 16 for f32).
__device__ __forceinline__ void load4(float* w, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}
__device__ __forceinline__ void load4(float* w, const __nv_bfloat16* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = __bfloat162float(v[j]);
}

__device__ __forceinline__ void store4(float* dst, const float* a) {
  *reinterpret_cast<float4*>(dst) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* a) {
  uint2 raw;
  __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = __float2bfloat16(a[j]);
  *reinterpret_cast<uint2*>(dst) = raw;
}

// The raw loads of one D sub-tile: x [kBC, kBK], w_gate and w_up [kBK, kBF].
template <typename T>
struct SubTile {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int kXVec = kBC * kBK / VEC;              // 32 or 64
  static constexpr int kWVec = kBK * kBF / VEC / kThreads;   // 2 or 4
  uint4 x;
  uint4 wg[kWVec];
  uint4 wu[kWVec];

  // Zero-filled past C rows, D and F (D and F are multiples of VEC, so a
  // vector lies wholly inside or wholly outside).
  __device__ __forceinline__ void load(const T* xb, const T* wgb,
                                       const T* wub, int rows, int D, int F,
                                       int k0, int f0, int tid) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    x = zero;
    if (tid < kXVec) {
      const int r = tid / (kBK / VEC), k = (tid % (kBK / VEC)) * VEC;
      if (r < rows && k0 + k < D)
        x = *reinterpret_cast<const uint4*>(xb + static_cast<int64_t>(r) * D
                                            + k0 + k);
    }
#pragma unroll
    for (int i = 0; i < kWVec; ++i) {
      const int v = tid + i * kThreads;
      const int k = v / (kBF / VEC), f = (v % (kBF / VEC)) * VEC;
      wg[i] = zero;
      wu[i] = zero;
      if (k0 + k < D && f0 + f < F) {
        const int64_t off = static_cast<int64_t>(k0 + k) * F + f0 + f;
        wg[i] = *reinterpret_cast<const uint4*>(wgb + off);
        wu[i] = *reinterpret_cast<const uint4*>(wub + off);
      }
    }
  }

  // Widen into shared memory as f32; x goes in transposed ([kBK, kBC]), so
  // that the 16 rows of one k are four broadcast 16-byte reads.
  __device__ __forceinline__ void stage(float* xs, float* wgs, float* wus,
                                        int tid) const {
    if (tid < kXVec) {
      const int r = tid / (kBK / VEC), k = (tid % (kBK / VEC)) * VEC;
      const T* vals = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int e = 0; e < VEC; ++e) xs[(k + e) * kBC + r] = to_f(vals[e]);
    }
#pragma unroll
    for (int i = 0; i < kWVec; ++i) {
      const int v = tid + i * kThreads;
      const int k = v / (kBF / VEC), f = (v % (kBF / VEC)) * VEC;
      store_vec<T>(wgs + k * kBF + f, wg[i]);
      store_vec<T>(wus + k * kBF + f, wu[i]);
    }
  }
};

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_ffn_kernel(const T* __restrict__ x, const T* __restrict__ w_gate,
               const T* __restrict__ w_up, const T* __restrict__ w_down,
               T* __restrict__ out, int C, int D, int F,
               int64_t x_expert_stride) {
  const int e = blockIdx.y;
  const int c0 = blockIdx.x * kBC;
  const int rows = min(kBC, C - c0);
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* hs = smem;                  // [F, kBC]: h transposed
  float* xs = hs + F * kBC;          // [kBK, kBC]: x transposed
  float* wgs = xs + kBK * kBC;       // [kBK, kBF]
  float* wus = wgs + kBK * kBF;      // [kBK, kBF]

  const T* xb = x + e * x_expert_stride + static_cast<int64_t>(c0) * D;
  const T* wgb = w_gate + static_cast<int64_t>(e) * D * F;
  const T* wub = w_up + static_cast<int64_t>(e) * D * F;
  const T* wdb = w_down + static_cast<int64_t>(e) * F * D;

  // ---- phase 1: h = silu(x @ w_gate) * (x @ w_up), [kBC, F] in f32; this
  // thread computes column f0 + tid of g and u for all 16 rows
  SubTile<T> next;
  for (int f0 = 0; f0 < F; f0 += kBF) {
    float g[kBC], u[kBC];
#pragma unroll
    for (int i = 0; i < kBC; ++i) g[i] = u[i] = 0.f;
    next.load(xb, wgb, wub, rows, D, F, 0, f0, tid);
    for (int k0 = 0; k0 < D; k0 += kBK) {
      __syncthreads();  // the previous sub-tile is consumed
      next.stage(xs, wgs, wus, tid);
      __syncthreads();
      if (k0 + kBK < D) next.load(xb, wgb, wub, rows, D, F, k0 + kBK, f0, tid);
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4* x4 = reinterpret_cast<const float4*>(xs + k * kBC);
        const float wg = wgs[k * kBF + tid];
        const float wu = wus[k * kBF + tid];
#pragma unroll
        for (int q = 0; q < kBC / 4; ++q) {
          const float4 xv = x4[q];
          g[4 * q + 0] = fmaf(xv.x, wg, g[4 * q + 0]);
          g[4 * q + 1] = fmaf(xv.y, wg, g[4 * q + 1]);
          g[4 * q + 2] = fmaf(xv.z, wg, g[4 * q + 2]);
          g[4 * q + 3] = fmaf(xv.w, wg, g[4 * q + 3]);
          u[4 * q + 0] = fmaf(xv.x, wu, u[4 * q + 0]);
          u[4 * q + 1] = fmaf(xv.y, wu, u[4 * q + 1]);
          u[4 * q + 2] = fmaf(xv.z, wu, u[4 * q + 2]);
          u[4 * q + 3] = fmaf(xv.w, wu, u[4 * q + 3]);
        }
      }
    }
    const int f = f0 + tid;
    if (f < F) {
      float4* h4 = reinterpret_cast<float4*>(hs + f * kBC);
#pragma unroll
      for (int q = 0; q < kBC / 4; ++q)
        h4[q] = make_float4(silu_mul(g[4 * q + 0], u[4 * q + 0]),
                            silu_mul(g[4 * q + 1], u[4 * q + 1]),
                            silu_mul(g[4 * q + 2], u[4 * q + 2]),
                            silu_mul(g[4 * q + 3], u[4 * q + 3]));
    }
  }
  __syncthreads();  // h is complete

  // ---- phase 2: out = h @ w_down, [kBC, D]
  for (int d0 = 0; d0 < D; d0 += kThreads * kCols) {
    const int col = d0 + tid * kCols;
    if (col >= D) continue;  // D % kCols == 0: all four columns are in
    float acc[kBC][kCols];
#pragma unroll
    for (int i = 0; i < kBC; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int f = 0; f < F; ++f) {
      float w[kCols];
      load4(w, wdb + static_cast<int64_t>(f) * D + col);
      const float4* h4 = reinterpret_cast<const float4*>(hs + f * kBC);
#pragma unroll
      for (int q = 0; q < kBC / 4; ++q) {
        const float4 hv = h4[q];
        const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            acc[4 * q + i][j] = fmaf(hr[i], w[j], acc[4 * q + i][j]);
      }
    }
    T* ob = out + (static_cast<int64_t>(e) * C + c0) * D + col;
#pragma unroll
    for (int i = 0; i < kBC; ++i)
      if (i < rows) store4(ob + static_cast<int64_t>(i) * D, acc[i]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wg, const void* wu,
                   const void* wd, void* out, int E, int C, int D, int F,
                   int64_t x_expert_stride, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(F) * kBC
                                       + kBK * kBC + 2 * kBK * kBF);
  if (smem > 48 * 1024) {  // above 48 KB only when asked for (per device)
    const cudaError_t err = cudaFuncSetAttribute(
        moe_ffn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxDynamicSmem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((C + kBC - 1) / kBC, E);
  moe_ffn_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd),
      static_cast<T*>(out), C, D, F, x_expert_stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); the launch is asynchronous on
// `stream`.  The Python wrapper has checked shapes, strides, alignment and
// the shared-memory budget.
int moe_ffn_forward(const void* x, const void* w_gate, const void* w_up,
                    const void* w_down, void* out, int E, int C, int D, int F,
                    long long x_expert_stride, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(launch<__nv_bfloat16>(
        x, w_gate, w_up, w_down, out, E, C, D, F, x_expert_stride, s));
  return static_cast<int>(launch<float>(x, w_gate, w_up, w_down, out, E, C,
                                        D, F, x_expert_stride, s));
}

const char* moe_ffn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
