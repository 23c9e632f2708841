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
//   h       [E, C, F]  f32 scratch of the bf16 path (allocated by the caller)
//
// The three products accumulate in f32, h = silu(g) * u stays f32, and the
// output is rounded to the input type once, as in the TPU kernel and the
// plain version (`ref.py`).  D and F may be any multiple of the 16-byte
// vector width.
//
// What bounds it on the H100: bytes at serving sizes.  Each call must read
// every expert's three weight matrices (3 * E * D * F elements: 100.7 MB in
// bf16 at granite-moe-1b-a400m's E = 32, D = 1024, F = 512, 30 us at 3.35
// TB/s) against 6 * E * C * D * F flops (6.4 GFLOP at C = 64, 6.5 us on the
// tensor cores).
//
// bf16: the tensor cores, two launches (`tc::`).
//   1. `moe_gate_up_kernel`: one block per (64-column F tile, 64-row C tile,
//      expert), 4 warps as 2 x 2 tiles of 32 x 32; at E = 32, F = 512 that
//      is 256 blocks at C = 64 and at C = 8.  x and the w_gate / w_up
//      column tiles go through 3 stages of bf16 shared memory, 16-byte
//      cp.async copies of the next two k-chunks of 64 in flight while one
//      is multiplied; g and u are mma.sync.m16n8k16 (f32 accumulators), h =
//      silu(g) * u is formed in f32 in registers and written to the f32
//      scratch h (4 MB at C = 64, which the 50 MB L2 holds for launch 2).
//   2. `moe_down_kernel`: one block per (128-column D tile, 64-row C tile,
//      expert) reducing over all of F; h is staged as f32 and split in
//      registers into bf16 hi + lo = h - hi, two mma per k-step into one
//      f32 accumulator (h kept to ~2^-16 of itself; no TF32), w_down staged
//      in bf16.
//   Rows are padded by 16 bytes in shared memory, so the ldmatrix reads
//   have no bank conflicts; a warp whose 16-row tiles hold no row of the
//   block (decode's C = 8) skips their products.
//
// f32: the CUDA cores (`moe_ffn_kernel<float>`), the port's precision
// witness (no tensor cores, no TF32): one block per (expert, 16 rows), 256
// threads, every product an fmaf chain, h [16, F] in f32 shared memory (so
// F is bounded by the block's shared memory), w_down read by columns from
// device memory.
//
// Batch invariance.  The tile shapes are constants, never chosen from C;
// nothing is split across blocks and no atomics are used; each element of
// g, u and out is one chain of k-steps in a fixed order (mma k-steps on the
// bf16 path, fmaf on the f32 one).  So a token's output row is bitwise the
// same whatever C is and wherever the row sits in the block, which the
// serving invariants (chunked == sequential prefill, paged == dense plane,
// prefix hit == cold prefill) rely on.  Rows past C are zero-filled and
// not stored.
//
// Measured with chip_smoke.py's guarded, L2-flushed timer on an NVIDIA
// H100 80GB HBM3 at 700 W, bf16, granite's E = 32, D = 1024, F = 512:
// 0.0702 ms at C = 64 (3 x torch.bmm + silu 0.0665, bound 0.0313) and
// 0.0601 at C = 8.  In granite's served steps launch 1 takes 36.8 us a
// call (its 64 MiB of weights at ~1.8 TB/s) and launch 2 24.1 us (32 MiB
// at ~1.4 TB/s): neither streams at the card's 3.35 TB/s with two blocks
// of 4 warps per SM.  ptxas: 106 and 128 registers, no
// spill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx_sm90.cuh"

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

// Four consecutive f32 values (one 16-byte load).
__device__ __forceinline__ void load4(float* w, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

__device__ __forceinline__ void store4(float* dst, const float* a) {
  *reinterpret_cast<float4*>(dst) = make_float4(a[0], a[1], a[2], a[3]);
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

// ------------------------------------------------------------------------
// bf16: the tensor-core path, two launches.
namespace tc {

constexpr int kThreads = 128;   // 4 warps as 2 x 2 over the output tile
constexpr int kStages = 3;      // k-chunks staged
constexpr int BM = 64;          // token rows per block, every C
constexpr int BK = 64;          // reduction depth of one k-chunk

// gate/up: a block computes h [BM, BN1] for one expert; a warp 32 rows x
// 32 columns of g and of u
constexpr int BN1 = 64;
constexpr int XS = BK + 8;      // bf16 per staged x row (16 bytes of pad)
constexpr int WS1 = BN1 + 8;    // bf16 per staged w_gate / w_up row
constexpr int kStage1 = 2 * (BM * XS + 2 * BK * WS1);   // bytes
constexpr int kSmem1 = kStages * kStage1;
// down: a block computes out [BM, BN2] for one expert over all of F; a
// warp 32 rows x 64 columns
constexpr int BN2 = 128;
constexpr int HS = BK + 8;      // f32 per staged h row
constexpr int WS2 = BN2 + 8;    // bf16 per staged w_down row
constexpr int kStage2 = 4 * BM * HS + 2 * BK * WS2;
constexpr int kSmem2 = kStages * kStage2;

// Lane offsets of the ldmatrix addresses.  A (row major, not transposed):
// row l % 16, column 8 * (l / 16).  B from a [k, n] row-major tile
// (transposed): row (l % 8) + 8 * ((l / 8) % 2), column 8 * (l / 16); the
// four registers are then (b0, b1) of n-tile 0 and of n-tile 1.
struct Lanes {
  int a_row, a_col, b_row, b_col;
  __device__ __forceinline__ explicit Lanes(int lane)
      : a_row(lane & 15), a_col((lane >> 4) << 3),
        b_row((lane & 7) + (((lane >> 3) & 1) << 3)),
        b_col((lane >> 4) << 3) {}
};

// 1. h = silu(x @ w_gate) * (x @ w_up) for rows [c0, c0 + 64) and columns
// [f0, f0 + 64) of expert e, into h [E, C, F] (f32).
__global__ void __launch_bounds__(kThreads)
moe_gate_up_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w_gate,
                   const __nv_bfloat16* __restrict__ w_up,
                   float* __restrict__ h, int C, int D, int F,
                   int64_t x_expert_stride) {
  const int f0 = blockIdx.x * BN1, c0 = blockIdx.y * BM, e = blockIdx.z;
  const int rows = min(BM, C - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
  const Lanes ln(lane);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const __nv_bfloat16* xb =
      x + e * x_expert_stride + static_cast<int64_t>(c0) * D;
  const __nv_bfloat16* wgb = w_gate + static_cast<int64_t>(e) * D * F;
  const __nv_bfloat16* wub = w_up + static_cast<int64_t>(e) * D * F;

  auto x_s = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + s * kStage1);
  };
  auto wg_s = [&](int s) { return x_s(s) + BM * XS; };
  auto wu_s = [&](int s) { return x_s(s) + BM * XS + BK * WS1; };

  // k-chunk kc (D rows kc*BK ..) into stage s: x [BM, BK], w [BK, BN1];
  // zero-filled past C rows, D and F
  auto load = [&](int kc, int s) {
    const int d0 = kc * BK;
#pragma unroll
    for (int j = 0; j < BM * BK / 8 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = r < rows && d0 + c < D;
      cp_async16(x_s(s) + r * XS + c,
                 ok ? xb + static_cast<int64_t>(r) * D + d0 + c : xb, ok);
    }
#pragma unroll
    for (int j = 0; j < BK * BN1 / 8 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (BN1 / 8), c = (i % (BN1 / 8)) * 8;
      const bool ok = d0 + r < D && f0 + c < F;
      const int64_t off = static_cast<int64_t>(d0 + r) * F + f0 + c;
      cp_async16(wg_s(s) + r * WS1 + c, ok ? wgb + off : wgb, ok);
      cp_async16(wu_s(s) + r * WS1 + c, ok ? wub + off : wub, ok);
    }
  };

  // the warp's m-tiles that hold rows of the block (warp-uniform)
  const bool live[2] = {wm < rows, wm + 16 < rows};
  float gacc[2][4][4], uacc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) gacc[mi][nt][i] = uacc[mi][nt][i] = 0.f;

  const int n_kc = (D + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kc) load(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < n_kc; ++kc) {
    cp_async_wait<kStages - 2>();  // chunk kc has landed
    __syncthreads();               // and every warp is done with kc - 1
    if (kc + kStages - 1 < n_kc)
      load(kc + kStages - 1, (kc + kStages - 1) % kStages);
    cp_async_commit();
    const int s = kc % kStages;
    if (!live[0]) continue;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        if (live[mi])
          ldmatrix_x4(a[mi], x_s(s) + (wm + mi * 16 + ln.a_row) * XS +
                                 ks * 16 + ln.a_col);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bg[4], bu[4];
        const int off = (ks * 16 + ln.b_row) * WS1 + wn + np * 16 + ln.b_col;
        ldmatrix_x4_trans(bg, wg_s(s) + off);
        ldmatrix_x4_trans(bu, wu_s(s) + off);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (!live[mi]) continue;
          mma_bf16(gacc[mi][2 * np], a[mi], bg[0], bg[1]);
          mma_bf16(gacc[mi][2 * np + 1], a[mi], bg[2], bg[3]);
          mma_bf16(uacc[mi][2 * np], a[mi], bu[0], bu[1]);
          mma_bf16(uacc[mi][2 * np + 1], a[mi], bu[2], bu[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* hb = h + (static_cast<int64_t>(e) * C + c0) * F;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int f = f0 + wn + nt * 8 + 2 * t;
      if (f >= F) continue;  // F is even: f + 1 < F too
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm + mi * 16 + g + half * 8;
        if (r < rows)
          *reinterpret_cast<float2*>(hb + static_cast<int64_t>(r) * F + f) =
              make_float2(
                  silu_mul(gacc[mi][nt][2 * half], uacc[mi][nt][2 * half]),
                  silu_mul(gacc[mi][nt][2 * half + 1],
                           uacc[mi][nt][2 * half + 1]));
      }
    }
  }
}

// 2. out = h @ w_down for rows [c0, c0 + 64) and columns [d0, d0 + 128) of
// expert e, over all of F in this block.  h is read as f32 and split in
// registers into bf16 hi + lo (h - hi), two products per k-step into one
// f32 accumulator: h is carried to ~2^-16 of itself, without TF32.
__global__ void __launch_bounds__(kThreads)
moe_down_kernel(const float* __restrict__ h,
                const __nv_bfloat16* __restrict__ w_down,
                __nv_bfloat16* __restrict__ out, int C, int D, int F) {
  const int d0 = blockIdx.x * BN2, c0 = blockIdx.y * BM, e = blockIdx.z;
  const int rows = min(BM, C - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int g = lane >> 2, t = lane & 3;
  const Lanes ln(lane);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const float* hb = h + (static_cast<int64_t>(e) * C + c0) * F;
  const __nv_bfloat16* wdb = w_down + static_cast<int64_t>(e) * F * D;

  auto h_s = [&](int s) {
    return reinterpret_cast<float*>(smem_raw + s * kStage2);
  };
  auto w_s = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + s * kStage2 +
                                            4 * BM * HS);
  };

  // k-chunk kc (F rows kc*BK ..) into stage s: h [BM, BK] f32, w_down
  // [BK, BN2]; zero-filled past C rows, F and D
  auto load = [&](int kc, int s) {
    const int f0 = kc * BK;
#pragma unroll
    for (int j = 0; j < BM * BK / 4 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
      const bool ok = r < rows && f0 + c < F;
      cp_async16(h_s(s) + r * HS + c,
                 ok ? hb + static_cast<int64_t>(r) * F + f0 + c : hb, ok);
    }
#pragma unroll
    for (int j = 0; j < BK * BN2 / 8 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (BN2 / 8), c = (i % (BN2 / 8)) * 8;
      const bool ok = f0 + r < F && d0 + c < D;
      cp_async16(w_s(s) + r * WS2 + c,
                 ok ? wdb + static_cast<int64_t>(f0 + r) * D + d0 + c : wdb,
                 ok);
    }
  };

  const bool live[2] = {wm < rows, wm + 16 < rows};
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][nt][i] = 0.f;

  const int n_kc = (F + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kc) load(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < n_kc; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kc + kStages - 1 < n_kc)
      load(kc + kStages - 1, (kc + kStages - 1) % kStages);
    cp_async_commit();
    const int s = kc % kStages;
    if (!live[0]) continue;
    const float* hs = h_s(s);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      // A fragments of h: (row g, k 2t..2t+1), (g + 8, 2t), (g, 2t + 8),
      // (g + 8, 2t + 8), each split into hi and lo
      uint32_t hi[2][4], lo[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (!live[mi]) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = wm + mi * 16 + g + (i & 1) * 8;
          const int c = ks * 16 + (i >> 1) * 8 + 2 * t;
          const float2 hv = *reinterpret_cast<const float2*>(hs + r * HS + c);
          split(hv.x, hv.y, hi[mi][i], lo[mi][i]);
        }
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, w_s(s) + (ks * 16 + ln.b_row) * WS2 + wn +
                                 np * 16 + ln.b_col);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (!live[mi]) continue;
          mma_bf16(acc[mi][2 * np], hi[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * np], lo[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * np + 1], hi[mi], b[2], b[3]);
          mma_bf16(acc[mi][2 * np + 1], lo[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* ob = out + (static_cast<int64_t>(e) * C + c0) * D;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int d = d0 + wn + nt * 8 + 2 * t;
      if (d >= D) continue;  // D is even: d + 1 < D too
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm + mi * 16 + g + half * 8;
        if (r < rows)
          *reinterpret_cast<__nv_bfloat162*>(
              ob + static_cast<int64_t>(r) * D + d) =
              __floats2bfloat162_rn(acc[mi][nt][2 * half],
                                    acc[mi][nt][2 * half + 1]);
      }
    }
  }
}

cudaError_t launch(const void* x, const void* wg, const void* wu,
                   const void* wd, void* out, float* h, int E, int C, int D,
                   int F, int64_t x_expert_stride, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      moe_gate_up_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynamicSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(moe_down_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxDynamicSmem);
  if (err != cudaSuccess) return err;
  const int row_tiles = (C + BM - 1) / BM;
  moe_gate_up_kernel<<<dim3((F + BN1 - 1) / BN1, row_tiles, E), kThreads,
                       kSmem1, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wg),
      static_cast<const __nv_bfloat16*>(wu), h, C, D, F, x_expert_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_down_kernel<<<dim3((D + BN2 - 1) / BN2, row_tiles, E), kThreads,
                    kSmem2, stream>>>(
      h, static_cast<const __nv_bfloat16*>(wd),
      static_cast<__nv_bfloat16*>(out), C, D, F);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); the launches are asynchronous on
// `stream`.  The Python wrapper has checked shapes, strides, alignment and
// the shared-memory budget; h is used by the bf16 path only.
int moe_ffn_forward(const void* x, const void* w_gate, const void* w_up,
                    const void* w_down, void* out, void* h, int E, int C,
                    int D, int F, long long x_expert_stride, int is_bf16,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(tc::launch(x, w_gate, w_up, w_down, out,
                                       static_cast<float*>(h), E, C, D, F,
                                       x_expert_stride, s));
  return static_cast<int>(launch<float>(x, w_gate, w_up, w_down, out, E, C,
                                        D, F, x_expert_stride, s));
}

const char* moe_ffn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
