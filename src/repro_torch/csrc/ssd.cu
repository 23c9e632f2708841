// Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_chunk_scan` (`_ssd_kernel`) of
// src/repro/kernels/ssd/ssd.py: the state-space dual form of one Mamba2
// layer, which the model's prefill runs as `ssm.ssd_chunked`.
//
//   x     [B, S, H, P]   bf16 or f32; strides (x_sb, x_ss, P, 1)
//   dt    [B, S, H]      f32, contiguous (softplus'd step sizes, > 0)
//   A     [H]            f32 (positive decay rates)
//   Bm    [B, S, N]      x's type; strides (b_sb, b_ss, 1), shared by heads
//   Cm    [B, S, N]      x's type; strides (c_sb, c_ss, 1)
//   init  [B, H, P, N]   f32 contiguous, or null (a zero state)
//   y     [B, S, H, P]   x's type, contiguous
//   final [B, H, P, N]   f32 contiguous (the reference's cache layout)
//   ws    f32 scratch of ssd_workspace_floats() floats (the caller's)
//
// The sequence runs in chunks of Q steps (the last one may be shorter:
// the reference pads it with identity steps, dt = 0, which change
// nothing, so every launch simply stops at S).  With cum_i the running sum
// of -dt_j A over the chunk and S_in the state entering it:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i . S_in
//   S_out = exp(cum_last) S_in + S_c,
//   S_c   = sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// exp(cum_i - cum_j) is formed only for j <= i, where it is <= 1, and the
// entries above the diagonal are set to exactly 0 (not multiplied by a
// mask): the TPU kernel exponentiates the whole square and masks
// afterwards, which here would turn an inf above the diagonal times a zero
// score into NaN.
//
// Design: the chunk-parallel decomposition (the plain version's, and that
// of Mamba2's published GPU kernels), four launches on the caller's stream:
//   1. `ssd_cb_kernel`: C.B^T once per (b, chunk), shared by every head, in
//      64 x 64 tiles of its lower triangle, into an f32 scratch
//      [B, nc, QK, QK] (QK = Q rounded up to 16).
//   2. `ssd_state_kernel`, one block per (b, chunk, head, 64 columns of P,
//      64 columns of N): cum by a block-wide scan (written to scratch for
//      launches 3 and 4), then S_c = (w x)^T B, a [P, Q] . [Q, N] product,
//      w_j = exp(cum_last - cum_j) dt_j, into an f32 scratch
//      [B, nc, H, P, N].  The first 128 steps' operands are a cp.async
//      group of their own, multiplied while the rest land.
//   3. `ssd_pass_kernel`: the short sequential pass over the chunks, one
//      thread per (b, h, p, n): S_in(c + 1) = exp(cum_last) S_in(c) + S_c,
//      from init_state or zeros, four chunks' loads in flight at a time.
//      The last state is `final`; S_in(c) replaces S_c in the scratch
//      (f32), or is written as its bf16 halves hi and lo = S_in - hi
//      (bf16), the operands launch 4's tensor cores take.
//   4. `ssd_out_kernel`, one block of 4 warps per (b, chunk, head, 64
//      columns of P, 64 rows of the chunk), the heaviest row tiles first:
//      y = exp(cum_i) C_i . S_in + (CB o L) . (dt x).  C and S_in land
//      first and the inter-chunk product runs while the 64-column chunks
//      of CB and of x go through two cp.async stages; each warp forms its
//      16 rows of the decayed scores M'_ij = CB_ij exp(cum_i - cum_j) dt_j
//      in registers.  108 KB of shared memory: two blocks an SM.
// Rows are staged with 16-byte cp.async copies, zero-filled past S, P and
// N; a strided or unaligned row falls back to element copies.  No product
// branches on P, N or the diagonal: the zeros stand in, so each warp's
// loads, splits and mma of successive tiles interleave.
//
// bf16: the products run on the tensor cores (mma.sync.m16n8k16, bf16 in,
// f32 accumulate).  x, B and C enter as they are.  Every f32 operand enters
// split into bf16 hi + lo = v - hi, two mma per k-step into one f32
// accumulator (kept to ~2^-16 of itself; no TF32): the decayed w x of the
// chunk state, S_in of the inter-chunk term, and the decayed scores M' of
// the intra-chunk term (which the plain version rounds to bf16 once; here
// it keeps f32 accuracy for ~2x the intra product's mma).  y is rounded
// once.
// f32: the same launches and staging, the products as fmaf chains on the
// CUDA cores and every exp by expf (bf16 takes the fast __expf): the port's
// precision witness.
//
// Batch invariance: nothing depends on B; a row's blocks read only its own
// row, in a fixed order, so row b of a batched launch equals, bitwise, the
// same row launched alone.
//
// What bounds it on the H100: bytes, at mamba2-130m's H = 24, P = 64,
// N = 128, Q = 256 (B = 1, S = 512: 4.2 MB of inputs and outputs, 1.3 us
// at 3.35 TB/s, against ~1 GFLOP, 1 us on the tensor cores).  Four
// dependent launches and their scratch (3.6 MB at B = 1, S = 512, in the
// 50 MB L2) cost a few microseconds each.
//
// Measured with chip_smoke.py's guarded, L2-flushed timer on an NVIDIA
// H100 80GB HBM3 at 700 W, bf16: 0.042 ms at B = 1, S = 512 (the plain
// version 0.29), 0.058 at S = 1024, 0.149 at B = 8; f32 0.086 at B = 1.
// That is 33x the byte bound at B = 1: every block loads its tiles in one
// burst and then runs chains of dependent loads, splits and mma with two
// blocks of 4 warps an SM; launch 4 is ~18 us of the 42.  ptxas: 50, 62,
// 22 and 126 registers for launches 1-4, no spill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx_sm90.cuh"

namespace {

// Every kernel's dynamic shared memory limit is set to the card's
// per-block limit (227 KB on an H100), the same value on every call, not to
// the launch's own size: a caller on another thread (one engine per pump
// thread) would otherwise lower it under a launch that needs more, which
// then fails as an invalid argument.
constexpr int kMaxDynamicSmem = 232448;

constexpr int kThreads = 256;     // 8 warps: launches 1, 2 and 3
constexpr int kOutThreads = 128;  // 4 warps: launch 4
constexpr int kTile = 64;  // rows of a score or y tile; columns of P or N
constexpr int kHalf = 128;        // steps of launch 2's first copy group

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The launch's sizes, passed by value to every kernel.
struct Dims {
  int B, S, H, P, N, Q;
  int nc;      // chunks
  int QK;      // Q rounded up to 16: the k extent of the intra product
  int NK;      // N rounded up to 16: the k extent of C.B^T and C.S_in
  int ptiles;  // blocks along P
  int ntiles;  // launch 2's blocks along N
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
  int vec;     // x, Bm and Cm rows take 16-byte copies
  int vec_st;  // the state scratch's rows take 16-byte copies
};

// Shared-memory row strides, in elements.  bf16 rows are padded by 16
// bytes so that the 8 rows one ldmatrix reads start 16 bytes apart in the
// bank space; f32 rows read as float2 fragments (CB, bf16 path) are padded
// to 8 mod 32 floats, rows read as float4 (f32 path) to 4 mod 32.  S_in's
// region is [64][s] f32, which on the bf16 path holds its hi and lo halves
// as two bf16 tiles of [64][n].
template <typename T>
struct Strides {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int kX = kTile + kPad;  // 64 columns of x or B (T)
  static constexpr int kM = kTile + 8;     // 64 columns of CB (f32)
  __host__ __device__ static int n(const Dims& d) { return d.NK + kPad; }
  __host__ __device__ static int s(const Dims& d) {
    return d.NK + (kBf16 ? 8 : 4);
  }
  // bytes of dynamic shared memory of launches 1, 2 and 4
  __host__ __device__ static size_t smem_cb(const Dims& d) {
    return sizeof(T) * 2 * kTile * n(d);
  }
  __host__ __device__ static size_t smem_state(const Dims& d) {
    return sizeof(T) * 2 * d.QK * kX + 4 * (d.QK + 8);
  }
  // launch 4: two stages of CB [64][kM] f32 and x [64][kX], then C, S_in,
  // (cum, dt) pairs and exp(cum) of the tile's rows
  static constexpr size_t kOutStage = 4 * kTile * kM + sizeof(T) * kTile * kX;
  __host__ __device__ static size_t smem_out(const Dims& d) {
    return 2 * kOutStage + sizeof(T) * kTile * n(d) +
           4 * (kTile * s(d) + 2 * (d.QK + kTile) + kTile);
  }
};

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// exp on the path of type T: float32, the precision witness, takes expf
// (within 2 ulp); bf16 the fast __expf (within 2 + 1.2 |x| ulp, far inside
// the bf16 rounding of its operands).
template <typename T>
__device__ __forceinline__ float exp_t(float x) {
  if constexpr (sizeof(T) == 2) return __expf(x);
  else return expf(x);
}

// Stage rows [0, rows) x columns [0, cols) of a T matrix at src (row
// stride ld) into dst (row stride sld), zero at and past row n_rows and
// column n_cols, by the block's NT threads.  cols is a multiple of 16
// bytes.  With vec, 16-byte cp.async copies (src and its row stride
// 16-byte aligned): a copy that starts before n_cols is whole, so where
// n_cols is no multiple of 16 bytes the columns after it up to the next
// multiple are read, not zeroed (only CB takes that, and its readers set
// those scores to 0 themselves).  Without vec, element by element.
template <int NT, typename T>
__device__ __forceinline__ void stage(T* dst, int sld, const T* src,
                                      long long ld, int rows, int cols,
                                      int n_rows, int n_cols, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (cols == 0) return;  // N = 0: nothing to stage
  if (vec) {
    const int per_row = cols / V;
    if (NT % per_row == 0) {
      // each thread keeps one column, so no division per copy
      const int c = (threadIdx.x % per_row) * V;
      for (int r = threadIdx.x / per_row; r < rows; r += NT / per_row) {
        const bool ok = r < n_rows && c < n_cols;
        cp_async16(dst + r * sld + c, ok ? src + r * ld + c : src, ok);
      }
      return;
    }
    for (int i = threadIdx.x; i < rows * per_row; i += NT) {
      const int r = i / per_row, c = (i % per_row) * V;
      const bool ok = r < n_rows && c < n_cols;
      cp_async16(dst + r * sld + c, ok ? src + r * ld + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += NT) {
      const int r = i / cols, c = i % cols;
      dst[r * sld + c] =
          r < n_rows && c < n_cols ? src[r * ld + c] : from_f<T>(0.f);
    }
  }
}

// Lane offsets of the ldmatrix addresses (g = lane / 4, t = lane % 4 own
// the fragments).  A from a row-major [m, k] tile: row l % 16, column
// 8 (l / 16).  A from a [k, m] tile (transposed): row (l % 8) + 8 (l / 16),
// column 8 ((l / 8) % 2).  B from a [k, n] row-major tile (transposed): row
// (l % 8) + 8 ((l / 8) % 2), column 8 (l / 16).  B from an [n, k] tile:
// row (l % 8) + 8 (l / 16), column 8 ((l / 8) % 2).  With B, the four
// registers are (b0, b1) of n-tile 0 and of n-tile 1.
struct Lanes {
  int g, t, a_row, a_col, b_row, b_col;
  __device__ __forceinline__ explicit Lanes(int lane)
      : g(lane >> 2), t(lane & 3), a_row(lane & 15),
        a_col((lane >> 4) << 3),
        b_row((lane & 7) + (((lane >> 3) & 1) << 3)),
        b_col((lane >> 4) << 3) {}
  // the transposed-A and [n, k]-B offsets are the B and A ones swapped
  __device__ __forceinline__ int t_row() const { return b_col + (b_row & 7); }
  __device__ __forceinline__ int t_col() const { return b_row & 8; }
};

// ---------------------------------------------------------------- launch 1
// CB[b, c, i, j] = C_i . B_j for one 64 x 64 tile (ti, tj <= ti) of the
// chunk's lower triangle; rows and columns at and past Qc are not stored.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(Dims d, const T* __restrict__ Cm, const T* __restrict__ Bm,
              float* __restrict__ cb) {
  using St = Strides<T>;
  const int nt = (d.Q + kTile - 1) / kTile;
  const int ntri = nt * (nt + 1) / 2;
  const int tile = blockIdx.x % ntri;
  const int bc = blockIdx.x / ntri;
  const int c = bc % d.nc, b = bc / d.nc;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
  const int tj = tile - ti * (ti + 1) / 2;
  const int s0 = c * d.Q, Qc = min(d.Q, d.S - s0);
  const int i0 = ti * kTile, j0 = tj * kTile;
  if (i0 >= Qc) return;
  const int ri = min(kTile, Qc - i0), rj = min(kTile, Qc - j0);
  const int NLD = St::n(d);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Cs = reinterpret_cast<T*>(smem_raw);
  T* Bs = Cs + kTile * NLD;
  stage<kThreads>(Cs, NLD, Cm + b * d.c_sb + (s0 + i0) * d.c_ss, d.c_ss,
                  kTile, d.NK, ri, d.N, d.vec);
  stage<kThreads>(Bs, NLD, Bm + b * d.b_sb + (s0 + j0) * d.b_ss, d.b_ss,
                  kTile, d.NK, rj, d.N, d.vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float* out = cb + (static_cast<long long>(bc) * d.QK + i0) * d.QK + j0;
  const int tid = threadIdx.x;
  if constexpr (St::kBf16) {
    const int lane = tid & 31, warp = tid >> 5;
    const int wm = (warp & 3) * 16, wn = (warp >> 2) * 32;
    const Lanes ln(lane);
    if (wm >= ri || wn >= rj) return;
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int ks = 0; ks < d.NK / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, Cs + (wm + ln.a_row) * NLD + ks * 16 + ln.a_col);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bb[4];
        ldmatrix_x4(bb, Bs + (wn + np * 16 + ln.t_row()) * NLD + ks * 16 +
                            ln.t_col());
        mma_bf16(acc[2 * np], a, bb[0], bb[1]);
        mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = wn + n * 8 + 2 * ln.t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = wm + ln.g + 8 * half;
        if (i >= ri) continue;
        if (j < rj) out[i * d.QK + j] = acc[n][2 * half];
        if (j + 1 < rj) out[i * d.QK + j + 1] = acc[n][2 * half + 1];
      }
    }
  } else {
    // rows ty + 16 r, columns tx + 16 q; four k at a time
    const int ty = tid >> 4, tx = tid & 15;
    float acc[4][4] = {};
    for (int k = 0; k < d.NK; k += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        cv[r] = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(Cs) + (ty + 16 * r) * NLD + k);
        bv[r] = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(Bs) + (tx + 16 * r) * NLD + k);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[r][q] = fmaf(cv[r].x, bv[q].x, acc[r][q]);
          acc[r][q] = fmaf(cv[r].y, bv[q].y, acc[r][q]);
          acc[r][q] = fmaf(cv[r].z, bv[q].z, acc[r][q]);
          acc[r][q] = fmaf(cv[r].w, bv[q].w, acc[r][q]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (ty + 16 * r < ri && tx + 16 * q < rj)
          out[(ty + 16 * r) * d.QK + tx + 16 * q] = acc[r][q];
  }
}

// ---------------------------------------------------------------- launch 2
// cum of (b, chunk, head), and S_c = sum_j w_j x_j B_j^T for 64 columns of
// P and 64 of N, w_j = exp(cum_last - cum_j) dt_j.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(Dims d, const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 float* __restrict__ cum, float* __restrict__ st) {
  using St = Strides<T>;
  constexpr int XLD = St::kX;
  int blk = blockIdx.x;
  const int nt = blk % d.ntiles;
  blk /= d.ntiles;
  const int pt = blk % d.ptiles;
  blk /= d.ptiles;
  const int h = blk % d.H;
  const int bc = blk / d.H;
  const int c = bc % d.nc, b = bc / d.nc;
  const int s0 = c * d.Q, Qc = min(d.Q, d.S - s0);
  const int p0 = pt * kTile, pw = min(kTile, d.P - p0);
  const int n0 = nt * kTile, nw = min(kTile, d.NK - n0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Xs = reinterpret_cast<T*>(smem_raw);
  T* Bs = Xs + d.QK * XLD;
  float* w = reinterpret_cast<float*>(Bs + d.QK * XLD);
  float* wsum = w + d.QK;
  const T* xg = x + b * d.x_sb + s0 * d.x_ss +
                static_cast<long long>(h) * d.P + p0;
  const T* bg = Bm + b * d.b_sb + s0 * d.b_ss + n0;
  // two copy groups: steps [0, kHalf) and the rest
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int r0 = g * kHalf, rows = g ? d.QK - kHalf : min(d.QK, kHalf);
    if (rows > 0) {
      stage<kThreads>(Xs + r0 * XLD, XLD, xg + r0 * d.x_ss, d.x_ss, rows,
                      kTile, Qc - r0, pw, d.vec);
      stage<kThreads>(Bs + r0 * XLD, XLD, bg + r0 * d.b_ss, d.b_ss, rows,
                      kTile, Qc - r0, d.N - n0, d.vec);
    }
    cp_async_commit();
  }

  // cum: a block-wide inclusive scan of -dt_j A, one step per thread,
  // while the copies land
  float dtj = 0.f, v = 0.f;
  if (tid < Qc) {
    dtj = dt[(static_cast<long long>(b) * d.S + s0 + tid) * d.H + h];
    v = -dtj * A[h];
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  for (int k = 0; k < warp; ++k) v += wsum[k];
  if (tid < d.QK) w[tid] = v;
  __syncthreads();
  const float last = w[Qc - 1];
  __syncthreads();
  if (tid < Qc && pt == 0 && nt == 0)
    cum[(static_cast<long long>(bc) * d.H + h) * d.QK + tid] = v;
  if (tid < d.QK) w[tid] = tid < Qc ? exp_t<T>(last - v) * dtj : 0.f;

  float* out = st + ((static_cast<long long>(bc) * d.H + h) * d.P + p0) *
                        d.N + n0;
  const int kq = round_up(Qc, 16);
  if constexpr (St::kBf16) {
    // a warp: 16 rows of P x 32 columns of N
    const int wm = (warp & 3) * 16, wn = (warp >> 2) * 32;
    const Lanes ln(lane);
    const bool live = wm < pw && wn < nw;
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      if (g == 0) cp_async_wait<1>();
      else cp_async_wait<0>();
      __syncthreads();
      const int k1 = live ? (g ? kq : min(kq, kHalf)) : 0;
#pragma unroll 4
      for (int ks = g * kHalf / 16; ks < k1 / 16; ++ks) {
        // A = (w x)^T: register q holds rows wm + g + 8 (q % 2), k pair
        // 16 ks + 8 (q / 2) + 2t
        uint32_t xr[4], hi[4], lo[4];
        ldmatrix_x4_trans(xr, Xs + (ks * 16 + ln.t_row()) * XLD + wm +
                                  ln.t_col());
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = ks * 16 + (q >> 1) * 8 + 2 * ln.t;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xr[q]));
          split(xv.x * w[k], xv.y * w[k + 1], hi[q], lo[q]);
        }
        // columns past N are zeros in Bs: no branch, so the tiles'
        // loads and splits interleave
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, Bs + (ks * 16 + ln.b_row) * XLD + wn +
                                    np * 16 + ln.b_col);
          mma_bf16(acc[2 * np], hi, bb[0], bb[1]);
          mma_bf16(acc[2 * np], lo, bb[0], bb[1]);
          mma_bf16(acc[2 * np + 1], hi, bb[2], bb[3]);
          mma_bf16(acc[2 * np + 1], lo, bb[2], bb[3]);
        }
      }
    }
    if (!live) return;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = wn + n * 8 + 2 * ln.t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = wm + ln.g + 8 * half;
        if (p >= pw) continue;
        if (n0 + col < d.N) out[p * d.N + col] = acc[n][2 * half];
        if (n0 + col + 1 < d.N) out[p * d.N + col + 1] = acc[n][2 * half + 1];
      }
    }
  } else {
    // rows 4 ty .. 4 ty + 3 of P, columns 4 tx .. 4 tx + 3 of N
    const int ty = tid >> 4, tx = tid & 15;
    const float* xs = reinterpret_cast<const float*>(Xs);
    const float* bs = reinterpret_cast<const float*>(Bs);
    float acc[4][4] = {};
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      if (g == 0) cp_async_wait<1>();
      else cp_async_wait<0>();
      __syncthreads();
      const int j1 = g ? Qc : min(Qc, kHalf);
      for (int j = g * kHalf; j < j1; ++j) {
        const float wj = w[j];
        const float4 xv =
            *reinterpret_cast<const float4*>(xs + j * XLD + 4 * ty);
        const float4 bv =
            *reinterpret_cast<const float4*>(bs + j * XLD + 4 * tx);
        const float u[4] = {xv.x * wj, xv.y * wj, xv.z * wj, xv.w * wj};
        const float bn[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(u[r], bn[q], acc[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = 4 * ty + r;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (p < pw && n0 + 4 * tx + q < d.N)
          out[p * d.N + 4 * tx + q] = acc[r][q];
    }
  }
}

// ---------------------------------------------------------------- launch 3
// The states entering each chunk and the final state: one thread per
// (b, h, p, n), sequential over the chunks, the loads of four chunks issued
// before their stores.  f32: S_in replaces S_c in place.  bf16: S_in is
// written split, as the bf16 pairs hi and lo = S_in - hi that launch 4's
// tensor-core product takes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_pass_kernel(Dims d, const float* __restrict__ cum,
                const float* __restrict__ init_state, float* st,
                T* __restrict__ sin_hi, T* __restrict__ sin_lo,
                float* __restrict__ final_state) {
  constexpr int kAhead = 4;
  const long long PN = static_cast<long long>(d.P) * d.N;
  const int eblocks = static_cast<int>((PN + kThreads - 1) / kThreads);
  const int bh = blockIdx.x / eblocks;
  const long long e =
      static_cast<long long>(blockIdx.x % eblocks) * kThreads + threadIdx.x;
  if (e >= PN) return;
  const int b = bh / d.H, h = bh % d.H;
  float s = init_state != nullptr ? init_state[bh * PN + e] : 0.f;
  for (int c0 = 0; c0 < d.nc; c0 += kAhead) {
    float decay[kAhead], sc[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c0 + k;
      if (c >= d.nc) break;
      const long long row = static_cast<long long>(b * d.nc + c) * d.H + h;
      decay[k] = exp_t<T>(cum[row * d.QK + min(d.Q, d.S - c * d.Q) - 1]);
      sc[k] = st[row * PN + e];
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c0 + k;
      if (c >= d.nc) break;
      const long long row = static_cast<long long>(b * d.nc + c) * d.H + h;
      if constexpr (Strides<T>::kBf16) {
        const __nv_bfloat16 hi = __float2bfloat16(s);
        sin_hi[row * PN + e] = hi;
        sin_lo[row * PN + e] = __float2bfloat16(s - __bfloat162float(hi));
      } else {
        st[row * PN + e] = s;
      }
      s = fmaf(decay[k], s, sc[k]);
    }
  }
  final_state[bh * PN + e] = s;
}

// ---------------------------------------------------------------- launch 4
// y for 64 rows (i0 ..) of one (b, chunk, head) and 64 columns of P:
// exp(cum_i) C_i . S_in + sum_{j <= i} M'_ij x_j, the columns j in chunks
// of 64 through two stages.
template <typename T>
__global__ void __launch_bounds__(kOutThreads, 2)
ssd_out_kernel(Dims d, const T* __restrict__ x, const float* __restrict__ dt,
               const T* __restrict__ Cm, const float* __restrict__ cb,
               const float* __restrict__ cum, const float* __restrict__ st,
               const T* __restrict__ sin_hi, const T* __restrict__ sin_lo,
               T* __restrict__ y) {
  using St = Strides<T>;
  constexpr int XLD = St::kX, MLD = St::kM;
  const int nrt = (d.Q + kTile - 1) / kTile;
  int blk = blockIdx.x;
  const int rt = nrt - 1 - blk % nrt;  // the longest rows first
  blk /= nrt;
  const int pt = blk % d.ptiles;
  blk /= d.ptiles;
  const int h = blk % d.H;
  const int bc = blk / d.H;
  const int c = bc % d.nc, b = bc / d.nc;
  const int s0 = c * d.Q, Qc = min(d.Q, d.S - s0);
  const int i0 = rt * kTile;
  if (i0 >= Qc) return;
  const int ri = min(kTile, Qc - i0);       // rows of the tile
  const int kv = min(i0 + kTile, Qc);       // columns j it reaches
  const int nk = (kv + kTile - 1) / kTile;  // chunks of 64 columns
  const int p0 = pt * kTile, pw = min(kTile, d.P - p0);
  const int NLD = St::n(d), SLD = St::s(d);
  const long long hrow = static_cast<long long>(bc) * d.H + h;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Cs = reinterpret_cast<T*>(smem_raw + 2 * St::kOutStage);
  // S_in [64][SLD] f32, or (bf16) its hi and lo halves, [64][NLD] each
  float* Ss = reinterpret_cast<float*>(Cs + kTile * NLD);
  T* Shi = reinterpret_cast<T*>(Ss);
  T* Slo = Shi + kTile * NLD;
  // (cum_j, dt_j) pairs, 64 past QK so a chunk never reads out of bounds
  float2* cd_s = reinterpret_cast<float2*>(Ss + kTile * SLD);
  float* ecum = reinterpret_cast<float*>(cd_s + d.QK + kTile);
  auto Mc = [&](int s) {
    return reinterpret_cast<float*>(smem_raw + s * St::kOutStage);
  };
  auto Xc = [&](int s) {
    return reinterpret_cast<T*>(smem_raw + s * St::kOutStage +
                                4 * kTile * MLD);
  };
  const float* cbg = cb + (static_cast<long long>(bc) * d.QK + i0) * d.QK;
  const T* xg = x + b * d.x_sb + s0 * d.x_ss +
                static_cast<long long>(h) * d.P + p0;
  // chunk kc (columns j = 64 kc ..) of CB's rows and x's rows into stage s
  auto load = [&](int kc, int s) {
    const int j0 = kc * kTile;
    stage<kOutThreads>(Mc(s), MLD, cbg + j0, d.QK, kTile, kTile, ri,
                       kv - j0, true);
    stage<kOutThreads>(Xc(s), XLD, xg + j0 * d.x_ss, d.x_ss, kTile, kTile,
                       kv - j0, pw, d.vec);
  };

  // cum and dt of the chunk's steps, loaded while the copies are issued
  // (Q <= 256: two a thread)
  float cum_r[2], dt_r[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int j = tid + k * kOutThreads;
    if (j < kv) {
      cum_r[k] = cum[hrow * d.QK + j];
      dt_r[k] = dt[(static_cast<long long>(b) * d.S + s0 + j) * d.H + h];
    }
  }
  stage<kOutThreads>(Cs, NLD, Cm + b * d.c_sb + (s0 + i0) * d.c_ss, d.c_ss,
                     kTile, d.NK, ri, d.N, d.vec);
  const long long srow = (hrow * d.P + p0) * d.N;
  if constexpr (St::kBf16) {
    stage<kOutThreads>(Shi, NLD, sin_hi + srow, d.N, kTile, d.NK, pw, d.N,
                       d.vec_st);
    stage<kOutThreads>(Slo, NLD, sin_lo + srow, d.N, kTile, d.NK, pw, d.N,
                       d.vec_st);
  } else {
    stage<kOutThreads>(Ss, SLD, st + srow, d.N, kTile, d.NK, pw, d.N,
                       d.vec_st);
  }
  cp_async_commit();
  load(0, 0);
  cp_async_commit();
  if (nk > 1) load(1, 1);
  cp_async_commit();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int j = tid + k * kOutThreads;
    if (j < kv) cd_s[j] = make_float2(cum_r[k], dt_r[k]);
  }
  __syncthreads();
  if (tid < kTile) ecum[tid] = tid < ri ? exp_t<T>(cd_s[i0 + tid].x) : 0.f;
  cp_async_wait<2>();  // C and S_in have landed
  __syncthreads();

  T* yb = y + ((static_cast<long long>(b) * d.S + s0 + i0) * d.H + h) * d.P +
          p0;
  const long long yrow = static_cast<long long>(d.H) * d.P;
  if constexpr (St::kBf16) {
    // a warp: 16 rows x the 64 columns of P
    const int lane = tid & 31, warp = tid >> 5;
    const int wm = warp * 16;
    const Lanes ln(lane);
    const bool live = wm < ri;
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    // inter-chunk: C (bf16) . S_in^T, S_in as its hi and lo halves.  The
    // columns past P are zeros in shared memory: no branch, so the tiles'
    // loads interleave.
    for (int ks = 0; live && ks < d.NK / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, Cs + (wm + ln.a_row) * NLD + ks * 16 + ln.a_col);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int off = (np * 16 + ln.t_row()) * NLD + ks * 16 + ln.t_col();
        uint32_t bh[4], bl[4];
        ldmatrix_x4(bh, Shi + off);
        ldmatrix_x4(bl, Slo + off);
        mma_bf16(acc[2 * np], a, bh[0], bh[1]);
        mma_bf16(acc[2 * np], a, bl[0], bl[1]);
        mma_bf16(acc[2 * np + 1], a, bh[2], bh[3]);
        mma_bf16(acc[2 * np + 1], a, bl[2], bl[3]);
      }
    }
    // the rows' decay from the chunk's start
    const int r0 = wm + ln.g, r1 = r0 + 8;
    const float e0 = ecum[r0], e1 = ecum[r1];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= e0;
      acc[n][1] *= e0;
      acc[n][2] *= e1;
      acc[n][3] *= e1;
    }
    // intra-chunk: M' (split hi + lo) . x over the chunks the warp's rows
    // reach, every k-step of a chunk unrolled and unbranched (M' is 0 past
    // the diagonal, x past S), so one k-step's scores are formed while the
    // last one's products run; rows past the tile take no cum
    const float c0 = r0 < ri ? cd_s[i0 + r0].x : 0.f;
    const float c1 = r1 < ri ? cd_s[i0 + r1].x : 0.f;
    const int jw = i0 + wm + 16;  // the warp's rows reach j < jw
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait<1>();
      __syncthreads();
      const float* ms = Mc(kc & 1);
      const T* xs = Xc(kc & 1);
      const int j0 = kc * kTile;
      if (live && j0 < jw) {
#pragma unroll
        for (int ks = 0; ks < kTile / 16; ++ks) {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = (q & 1) ? r1 : r0;
            const int jl = ks * 16 + (q >> 1) * 8 + 2 * ln.t;
            const int i = i0 + r, j = j0 + jl;
            const float ci = (q & 1) ? c1 : c0;
            const float2 cv =
                *reinterpret_cast<const float2*>(ms + r * MLD + jl);
            // (cum_j, dt_j, cum_j+1, dt_j+1)
            const float4 cd = *reinterpret_cast<const float4*>(cd_s + j);
            const float m0 =
                j <= i && r < ri ? cv.x * __expf(ci - cd.x) * cd.y : 0.f;
            const float m1 =
                j + 1 <= i && r < ri ? cv.y * __expf(ci - cd.z) * cd.w : 0.f;
            split(m0, m1, hi[q], lo[q]);
          }
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t bb[4];
            ldmatrix_x4_trans(bb, xs + (ks * 16 + ln.b_row) * XLD +
                                      np * 16 + ln.b_col);
            mma_bf16(acc[2 * np], hi, bb[0], bb[1]);
            mma_bf16(acc[2 * np], lo, bb[0], bb[1]);
            mma_bf16(acc[2 * np + 1], hi, bb[2], bb[3]);
            mma_bf16(acc[2 * np + 1], lo, bb[2], bb[3]);
          }
        }
      }
      __syncthreads();  // every warp is done with this stage
      if (kc + 2 < nk) load(kc + 2, kc & 1);
      cp_async_commit();
    }
    if (!live) return;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int p = n * 8 + 2 * ln.t;
      if (p >= pw) break;
      if (r0 < ri)
        *reinterpret_cast<__nv_bfloat162*>(yb + r0 * yrow + p) =
            __floats2bfloat162_rn(acc[n][0], acc[n][1]);
      if (r1 < ri)
        *reinterpret_cast<__nv_bfloat162*>(yb + r1 * yrow + p) =
            __floats2bfloat162_rn(acc[n][2], acc[n][3]);
    }
  } else {
    // rows ty + 8 r, columns tx + 16 q of P
    const int ty = tid >> 4, tx = tid & 15;
    const float* cs = reinterpret_cast<const float*>(Cs);
    float acc[8][4] = {};
    for (int k = 0; k < d.NK; k += 4) {
      float4 cv[8], sv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        cv[r] = *reinterpret_cast<const float4*>(cs + (ty + 8 * r) * NLD + k);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sv[q] = *reinterpret_cast<const float4*>(Ss + (tx + 16 * q) * SLD + k);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[r][q] = fmaf(cv[r].x, sv[q].x, acc[r][q]);
          acc[r][q] = fmaf(cv[r].y, sv[q].y, acc[r][q]);
          acc[r][q] = fmaf(cv[r].z, sv[q].z, acc[r][q]);
          acc[r][q] = fmaf(cv[r].w, sv[q].w, acc[r][q]);
        }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float er = ecum[ty + 8 * r];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] *= er;
    }
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait<1>();
      __syncthreads();
      float* ms = Mc(kc & 1);
      const float* xs = reinterpret_cast<const float*>(Xc(kc & 1));
      const int j0 = kc * kTile;
      // the chunk's decayed scores, in place
      for (int e = tid; e < kTile * kTile; e += kOutThreads) {
        const int r = e / kTile, jl = e % kTile, i = i0 + r, j = j0 + jl;
        float* m = ms + r * MLD + jl;
        *m = j <= i && r < ri
                 ? *m * expf(cd_s[i].x - cd_s[j].x) * cd_s[j].y
                 : 0.f;
      }
      __syncthreads();
      for (int jl = 0; jl < kTile; jl += 4) {
        float4 mv[8];
        float xv[4][4];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          mv[r] = *reinterpret_cast<const float4*>(ms + (ty + 8 * r) * MLD +
                                                   jl);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            xv[u][q] = xs[(jl + u) * XLD + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[r][q] = fmaf(mv[r].x, xv[0][q], acc[r][q]);
            acc[r][q] = fmaf(mv[r].y, xv[1][q], acc[r][q]);
            acc[r][q] = fmaf(mv[r].z, xv[2][q], acc[r][q]);
            acc[r][q] = fmaf(mv[r].w, xv[3][q], acc[r][q]);
          }
      }
      __syncthreads();  // every thread is done with this stage
      if (kc + 2 < nk) load(kc + 2, kc & 1);
      cp_async_commit();
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (ty + 8 * r < ri && tx + 16 * q < pw)
          yb[(ty + 8 * r) * yrow + tx + 16 * q] = acc[r][q];
  }
}

Dims make_dims(int B, int S, int H, int P, int N, int Q) {
  Dims d{};
  d.B = B;
  d.S = S;
  d.H = H;
  d.P = P;
  d.N = N;
  d.Q = Q;
  d.nc = Q > 0 ? (S + Q - 1) / Q : 0;
  d.QK = round_up(Q, 16);
  d.NK = round_up(N, 16);
  d.ptiles = (P + kTile - 1) / kTile;
  d.ntiles = d.NK > kTile ? (d.NK + kTile - 1) / kTile : 1;
  return d;
}

// Floats of each scratch part, rounded up to 64 (256 bytes): CB, cum, the
// chunk states, and (bf16 only) the split entering states, as many bf16
// pairs as the chunk states have floats.
long long part(long long n) { return (n + 63) / 64 * 64; }
long long cb_floats(const Dims& d) {
  return part(static_cast<long long>(d.B) * d.nc * d.QK * d.QK);
}
long long cum_floats(const Dims& d) {
  return part(static_cast<long long>(d.B) * d.nc * d.H * d.QK);
}
long long st_floats(const Dims& d) {
  return part(static_cast<long long>(d.B) * d.nc * d.H * d.P * d.N);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename K>
cudaError_t allow_smem(K* kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* init_state,
                   void* y, void* final_state, float* ws, Dims d,
                   cudaStream_t stream) {
  using St = Strides<T>;
  constexpr long long V = 16 / sizeof(T);
  d.vec = aligned16(x) && aligned16(Bm) && aligned16(Cm) && d.x_sb % V == 0 &&
          d.x_ss % V == 0 && d.b_sb % V == 0 && d.b_ss % V == 0 &&
          d.c_sb % V == 0 && d.c_ss % V == 0 && d.N % V == 0;
  d.vec_st = d.N % V == 0;
  cudaError_t err;
  if ((err = allow_smem(ssd_cb_kernel<T>)) != cudaSuccess ||
      (err = allow_smem(ssd_state_kernel<T>)) != cudaSuccess ||
      (err = allow_smem(ssd_pass_kernel<T>)) != cudaSuccess ||
      (err = allow_smem(ssd_out_kernel<T>)) != cudaSuccess)
    return err;
  float* cb = ws;
  float* cum = cb + cb_floats(d);
  float* st = cum + cum_floats(d);
  // (bf16) S_in's split halves after the chunk states; f32 has none
  T* sin_hi = St::kBf16 ? reinterpret_cast<T*>(st + st_floats(d)) : nullptr;
  T* sin_lo = St::kBf16 ? sin_hi + static_cast<long long>(d.B) * d.nc * d.H *
                                       d.P * d.N
                        : nullptr;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const float* dtf = static_cast<const float*>(dt);
  if (d.nc > 0) {
    const int nt = (d.Q + kTile - 1) / kTile;
    ssd_cb_kernel<T><<<d.B * d.nc * (nt * (nt + 1) / 2), kThreads,
                       St::smem_cb(d), stream>>>(d, ct, bt, cb);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ssd_state_kernel<T><<<d.B * d.nc * d.H * d.ptiles * d.ntiles, kThreads,
                          St::smem_state(d), stream>>>(
        d, xt, dtf, static_cast<const float*>(A), bt, cum, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long PN = static_cast<long long>(d.P) * d.N;
  if (PN > 0) {
    const int eblocks = static_cast<int>((PN + kThreads - 1) / kThreads);
    ssd_pass_kernel<T><<<d.B * d.H * eblocks, kThreads, 0, stream>>>(
        d, cum, static_cast<const float*>(init_state), st, sin_hi, sin_lo,
        static_cast<float*>(final_state));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (d.nc > 0) {
    const int nrt = (d.Q + kTile - 1) / kTile;
    ssd_out_kernel<T><<<d.B * d.nc * d.H * d.ptiles * nrt, kOutThreads,
                        St::smem_out(d), stream>>>(d, xt, dtf, ct, cb, cum,
                                                   st, sin_hi, sin_lo,
                                                   static_cast<T*>(y));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Floats of scratch the launch needs (the caller allocates it).
extern "C" long long ssd_workspace_floats(int B, int S, int H, int P, int N,
                                          int Q, int is_bf16) {
  const Dims d = make_dims(B, S, H, P, N, Q);
  return cb_floats(d) + cum_floats(d) + (is_bf16 ? 2 : 1) * st_floats(d);
}

// Q <= 256 (cum's scan runs one step per thread), N <= 128, P % 16 == 0;
// the wrapper checks them.  init_state may be null; ws holds
// ssd_workspace_floats() floats.  Returns the CUDA error code of the
// launches (0 = launched).
extern "C" int ssd_chunk_scan_fwd(const void* x, const void* dt,
                                  const void* A, const void* Bm,
                                  const void* Cm, const void* init_state,
                                  void* y, void* final_state, void* ws,
                                  int B, int S, int H, int P, int N, int Q,
                                  long long x_sb, long long x_ss,
                                  long long b_sb, long long b_ss,
                                  long long c_sb, long long c_ss,
                                  int is_bf16, void* stream) {
  Dims d = make_dims(B, S, H, P, N, Q);
  d.x_sb = x_sb;
  d.x_ss = x_ss;
  d.b_sb = b_sb;
  d.b_ss = b_ss;
  d.c_sb = c_sb;
  d.c_ss = c_ss;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (is_bf16)
    return static_cast<int>(launch<__nv_bfloat16>(
        x, dt, A, Bm, Cm, init_state, y, final_state, w, d, s));
  return static_cast<int>(launch<float>(x, dt, A, Bm, Cm, init_state, y,
                                        final_state, w, d, s));
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
