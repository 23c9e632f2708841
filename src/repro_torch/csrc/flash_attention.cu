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
// masked by position and its loads are zero-filled.  A row's keys are
// visited in a fixed order of fixed tiles, and no key range is split
// across blocks, so under a causal mask a row's output does not depend on
// how long the launch's sequence is.
//
// What bounds it on the H100: bytes, at the prefill shapes.  Causal
// attention over [BH, S, D] moves 4 * BH * S * D * 2 bytes (q, k, v in,
// out back) and does 4 * D * BH * S * (S + 1) / 2 flops, about S / 4 flops
// per byte against the card's ~295 bf16 flops per byte: below S ~ 1180 the
// bytes lead.  At BH = 16, D = 128: S = 512 is 8.4 MB (2.5 us at 3.35 TB/s)
// against 1.08 GFLOP (1.09 us at 989 TFLOP/s).
//
// bf16: the tensor cores (`tc::flash_tc_kernel`), FlashAttention-2's
// forward.  One block of 4 warps per (bh, 64-row q-tile), 16 query rows a
// warp; BH = 16, S = 512 is 128 blocks on the 132 SMs.  K and V tiles of 64
// keys (32 at D = 256) are staged in bf16 shared memory by 16-byte
// cp.async, two stages,
// the next tile's copies in flight while this one is computed; rows are
// padded by 16 bytes so that ldmatrix reads them without bank conflicts.
// S = Q.K^T and O += P.V are mma.sync.m16n8k16 (bf16 in, f32 accumulate);
// the online softmax runs on the score fragments in registers (the row max
// over the quad of lanes that holds a row), and P is rounded to bf16 in
// registers and used as the A operand of P.V without a trip through shared
// memory.  Head dims are tiled at 64, 128 or 256 (the narrowest that holds
// D; columns past D are zero-filled, so any multiple of 8 works).  Q's
// fragments stay in registers up to 128; at 256 (RecurrentGemma) the
// output alone takes 128 f32 registers a thread, so Q is re-read from
// shared memory (ldmatrix) at every k-step.
//
// f32: the CUDA cores (`flash_kernel<float, BK>`), the port's precision
// witness (no tensor cores, no TF32): every tile widened to f32 in
// shared memory, one thread per score and per output element, 256 threads
// a block; kv-tiles of 64 keys up to D = 128 and of 32 above (205,952
// bytes at D = 256).
//
// Measured with chip_smoke.py's guarded, L2-flushed timer on an NVIDIA
// H100 80GB HBM3 at 700 W, bf16, BH = 16, S = 512: 0.0265 ms at D = 128
// causal (SDPA 0.0176, bound 0.0025); at D = 256, 0.0403 ms with a 2048
// window and 0.0245 with 128 (SDPA 0.0518 and 0.0508).  ptxas: 234
// registers at d-tile 128, 255 at 256, no spill.  What holds D = 128 at
// 10x its bound: the last causal q-tile walks all 8 kv-tiles on one block
// of 4 warps (one warp per SM sub-partition), so mma.sync and ldmatrix
// latencies are hidden only by the warp's own instruction-level
// parallelism.

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

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int BQ = 64;        // query rows per block, every head dim
constexpr int kMaxHeadDim = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// f32: the kv-tile from the head dim (see "f32" above).
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

// ------------------------------------------------------------------------
// bf16: the tensor-core path.
namespace tc {

constexpr int kThreads = 128;       // 4 warps, 16 query rows each
constexpr int BQ = 64;              // query rows per block

// Tiles for head dims up to DMAX: every staged row is DMAX bf16 wide (the
// columns at and past D zero-filled), plus 8 of padding, so that the 8 rows
// one ldmatrix reads start 16 bytes apart in the bank space.  Q stays in
// registers up to DMAX = 128; at 256 its fragments would take 64 more
// registers beside the 128 of the output, so it is re-read from shared
// memory at every k-step, and the kv-tile is 32 keys (64 spill).
template <int DMAX>
struct Tiles {
  static constexpr int BK = DMAX <= 128 ? 64 : 32;  // keys per kv-tile
  static constexpr int kStride = DMAX + 8;        // bf16 per staged row
  static constexpr int kKSteps = DMAX / 16;       // k-steps of Q.K^T
  static constexpr int kDTiles = DMAX / 8;        // n-tiles of P.V
  static constexpr bool kQInRegs = DMAX <= 128;
  // q [BQ] + two stages of k [BK] and v [BK], rows of kStride
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * (BQ + 4 * BK) * kStride;
};

// Rows [row0, row0 + ROWS) of a [S, D] bf16 matrix into shared memory
// with row stride DMAX + 8, 16-byte copies in flight; rows at or past S
// and columns at or past D are zero-filled.
template <int DMAX, int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int S, int D, int tid) {
  constexpr int kChunks = DMAX / 8;               // 16-byte chunks per row
  static_assert(ROWS * kChunks % kThreads == 0, "whole passes");
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = row0 + r < S && c < D;
    cp_async16(dst + r * Tiles<DMAX>::kStride + c,
               ok ? src + static_cast<int64_t>(row0 + r) * D + c : src, ok);
  }
}

// One block per (bh, 64-row q-tile), the heaviest q-tiles (the last, under
// a causal mask) first; warp w owns query rows 16w .. 16w + 15.  The kv
// tiles of a row are visited in a fixed order from its q-tile's first
// visible tile, the next tile's K and V copied while this one is computed.
template <int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, int Sq, int Skv, int D,
                float scale, int causal, int window) {
  using T = Tiles<DMAX>;
  constexpr int ST = T::kStride, BK = T::BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kvs = qs + BQ * ST;  // stage s: k at 2s*BK rows, v after

  const int bh = blockIdx.x;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // fragment row and column pair
  const float scale_log2 = scale * 1.4426950408889634f;

  const __nv_bfloat16* qb = q + static_cast<int64_t>(bh) * Sq * D;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(bh) * Skv * D;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(bh) * Skv * D;

  // the kv-tiles this q-tile can see: up to the diagonal's, from the tile
  // holding the window's first key of the tile's first row
  const int n_kt = (Skv + BK - 1) / BK;
  const int kt_end = causal ? min(n_kt, (q_start + BQ - 1) / BK + 1) : n_kt;
  int kt_begin = 0;
  if (window > 0 && q_start - window + 1 > 0)
    kt_begin = (q_start - window + 1) / BK;

  load_rows<DMAX, BQ>(qs, qb, q_start, Sq, D, tid);
  cp_async_commit();
  if (kt_begin < kt_end) {
    load_rows<DMAX, BK>(kvs, kb, kt_begin * BK, Skv, D, tid);
    load_rows<DMAX, BK>(kvs + BK * ST, vb, kt_begin * BK, Skv, D, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();  // q has landed; the first kv-tile may still fly
  __syncthreads();

  // A-fragment addresses: lane l reads row (l % 16), column 8 * (l / 16)
  const uint32_t q_frag = smem_addr(qs + (warp * 16 + (lane & 15)) * ST +
                                    ((lane >> 4) << 3));
  uint32_t qf[T::kQInRegs ? T::kKSteps : 1][4];
  if constexpr (T::kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < T::kKSteps; ++kk)
      ldmatrix_x4(qf[kk], q_frag + kk * 32);
  }
  // B-fragment rows: K (not transposed) and V (transposed)
  const int k_row = ((lane >> 4) << 3) + (lane & 7);
  const int k_col = ((lane >> 3) & 1) << 3;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_col = (lane >> 4) << 3;

  float o[T::kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < T::kDTiles; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  // rows g and g + 8 of the warp: running max (log2 units) and this
  // thread's share of the running sum (its columns; summed over the quad
  // at the end)
  float m_row[2] = {kNegInf, kNegInf}, l_row[2] = {0.f, 0.f};
  const int qpos0 = q_start + warp * 16 + g;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      __nv_bfloat16* nxt = kvs + (stage ^ 1) * 2 * BK * ST;
      load_rows<DMAX, BK>(nxt, kb, (kt + 1) * BK, Skv, D, tid);
      load_rows<DMAX, BK>(nxt + BK * ST, vb, (kt + 1) * BK, Skv, D, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const __nv_bfloat16* ks = kvs + stage * 2 * BK * ST;
    const __nv_bfloat16* vs = ks + BK * ST;

    // S = Q . K^T for the warp's 16 rows x BK keys, f32
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < T::kKSteps; ++kk) {
      uint32_t a[4];
      if constexpr (T::kQInRegs) {
        a[0] = qf[kk][0];
        a[1] = qf[kk][1];
        a[2] = qf[kk][2];
        a[3] = qf[kk][3];
      } else {
        ldmatrix_x4(a, q_frag + kk * 32);
      }
#pragma unroll
      for (int nt = 0; nt < BK / 8; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(ks + (nt * 8 + k_row) * ST + kk * 16 +
                                 k_col));
        mma_bf16(s[nt], a, b[0], b[1]);
        mma_bf16(s[nt + 1], a, b[2], b[3]);
      }
    }

    // scale (to log2 units) and mask; only a tile on the diagonal, the
    // window's edge or the ragged end of the keys has masked entries
    const int k_start = kt * BK;
    const bool edge = k_start + BK > Skv ||
                      (causal && k_start + BK - 1 > q_start) ||
                      (window > 0 && k_start < q_start + BQ - window);
    float mx[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (edge) {
          const int qpos = qpos0 + (e >> 1) * 8;
          const int kpos = k_start + nt * 8 + 2 * t + (e & 1);
          const bool ok = kpos < Skv && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          x = ok ? x : kNegInf;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    // online softmax: the row max over the quad that holds the row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float alpha[2] = {exp2f(m_row[0] - mx[0]), exp2f(m_row[1] - mx[1])};
    m_row[0] = mx[0];
    m_row[1] = mx[1];
    // p in f32 into l; p rounded to bf16, in registers, as P.V's A operand
    uint32_t pf[BK / 16][4];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float p0 = exp2f(s[nt][0] - mx[0]), p1 = exp2f(s[nt][1] - mx[0]);
      const float p2 = exp2f(s[nt][2] - mx[1]), p3 = exp2f(s[nt][3] - mx[1]);
      psum[0] += p0 + p1;
      psum[1] += p2 + p3;
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);   // row g
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);   // row g + 8
    }
    l_row[0] = l_row[0] * alpha[0] + psum[0];
    l_row[1] = l_row[1] * alpha[1] + psum[1];
#pragma unroll
    for (int dt = 0; dt < T::kDTiles; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P . V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int dt = 0; dt < T::kDTiles; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_addr(vs + (kk * 16 + v_row) * ST +
                                       dt * 8 + v_col));
        mma_bf16(o[dt], pf[kk], b[0], b[1]);
        mma_bf16(o[dt + 1], pf[kk], b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  // out = O / max(l, 1e-30), staged through the warp's own q rows so that
  // the stores to device memory are 16-byte and row-contiguous
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_row[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    den[r] = fmaxf(l, 1e-30f);
  }
  __syncwarp();  // the warp's q fragments are read before its rows are reused
  __nv_bfloat16* os = qs + warp * 16 * ST;
#pragma unroll
  for (int dt = 0; dt < T::kDTiles; ++dt) {
    *reinterpret_cast<uint32_t*>(os + g * ST + dt * 8 + 2 * t) =
        pack_bf16(o[dt][0] / den[0], o[dt][1] / den[0]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * ST + dt * 8 + 2 * t) =
        pack_bf16(o[dt][2] / den[1], o[dt][3] / den[1]);
  }
  __syncwarp();
  __nv_bfloat16* ob = out + static_cast<int64_t>(bh) * Sq * D;
  constexpr int kChunks = DMAX / 8;
#pragma unroll
  for (int j = 0; j < 16 * kChunks / 32; ++j) {
    const int i = lane + j * 32;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int qpos = q_start + warp * 16 + r;
    if (qpos < Sq && c < D)
      *reinterpret_cast<uint4*>(ob + static_cast<int64_t>(qpos) * D + c) =
          *reinterpret_cast<const uint4*>(os + r * ST + c);
  }
}

template <int DMAX>
int launch_dmax(const void* q, const void* k, const void* v, void* out,
                int BH, int Sq, int Skv, int D, float scale, int causal,
                int window, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynamicSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (Sq + BQ - 1) / BQ);
  flash_tc_kernel<DMAX><<<grid, kThreads, Tiles<DMAX>::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Sq, Skv, D, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// The narrowest tile that holds the head dim.
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Sq, int Skv, int D, float scale, int causal, int window,
           cudaStream_t stream) {
  if (D <= 64)
    return launch_dmax<64>(q, k, v, out, BH, Sq, Skv, D, scale, causal,
                           window, stream);
  if (D <= 128)
    return launch_dmax<128>(q, k, v, out, BH, Sq, Skv, D, scale, causal,
                            window, stream);
  if (D <= kMaxHeadDim)
    return launch_dmax<256>(q, k, v, out, BH, Sq, Skv, D, scale, causal,
                            window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

}  // namespace

// window <= 0 means no window.  Returns the CUDA error code of the launch
// (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int BH, int Sq,
                                   int Skv, int D, float scale, int causal,
                                   int window, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return tc::launch(q, k, v, out, BH, Sq, Skv, D, scale, causal, window,
                      s);
  return launch<float>(q, k, v, out, BH, Sq, Skv, D, scale, causal, window,
                       s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
