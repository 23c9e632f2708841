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
//
// The sequence runs in chunks of Q steps (the last one may be shorter:
// the reference pads it with identity steps, dt = 0, which change
// nothing, so the block simply stops at S).  With cum_i the running sum of
// -dt_j A over the chunk, S_in the state entering it:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i . S_in
//   S_out = exp(cum_last) S_in + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// All arithmetic is f32; y is rounded once.  exp(cum_i - cum_j) is formed
// only for j <= i, where it is <= 1: the TPU kernel exponentiates the whole
// square and masks afterwards, which here would turn an inf above the
// diagonal times a zero score into NaN.
//
// Design.  One block per (b, h, 16 columns of P): the columns of y and of
// the state are independent, so P = 64 gives 4 blocks per head (96 at
// B = 1 for mamba2-130m) at the price of recomputing C.B^T in each.  The
// TPU's sequential chunk grid axis becomes a loop inside the block, with
// the state's [N, 16] columns in shared memory.  Per chunk the block
// stages B^T [N, Q] and dt.x [Q, 16] in f32, then walks the Q x Q score
// matrix in tiles of 32 rows (a whole f32 tile is 256 KB at Q = 256, past
// what a block may hold): C.B^T by 4 x 4 register tiles over N (skipping
// tiles above the diagonal), the decay, then the tile's y rows.  The state
// update follows the last tile.  Shared memory: 209 KB at Q = 256, N = 128.
//
// What bounds it on the H100: operations.  Q = 256, N = 128 is ~9 M f32
// multiply-adds per (head, chunk) on the CUDA cores against a few MB of
// traffic.  Later versions: tensor cores (mma / wgmma) for C.B^T and the
// two [Q x Q] . [Q x P] products, TMA loads, and computing C.B^T once per
// (b, chunk) for all heads instead of once per block.

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
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 16;     // columns of P per block (ops.SSD_COLS)
constexpr int kTile = 32;     // score-matrix rows per tile
constexpr int kMaxN = 128;    // state width cap (ops.SSD_MAX_STATE)
constexpr int kRowsPer = kMaxN / (kThreads / kCols);  // state rows a thread updates

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

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// Floats of shared memory for chunk length Q and state width N (must match
// ops._smem_bytes): B^T [N][Q4 + 4], C^T tile [N][32], scores [32][Q4 + 1],
// dt.x [Q4][16], state [N][16], cum [Q4], w [Q4], warp sums [8].
__host__ __device__ __forceinline__ int smem_floats(int Q, int N) {
  const int Q4 = round4(Q);
  return N * (Q4 + 4) + N * kTile + kTile * (Q4 + 1) + Q4 * kCols +
         N * kCols + 2 * Q4 + kWarps;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ init_state,
    T* __restrict__ y, float* __restrict__ final_state, int S, int H, int P,
    int N, int Q, long long x_sb, long long x_ss, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss) {
  extern __shared__ float4 smem4[];
  const int Q4 = round4(Q);
  const int QP = Q4 + 4;      // B^T row stride (16-byte rows, 4 banks apart)
  const int GS = Q4 + 1;      // score row stride (1 bank apart)
  float* BsT = reinterpret_cast<float*>(smem4);
  float* CsT = BsT + N * QP;
  float* G = CsT + N * kTile;
  float* xdt = G + kTile * GS;
  float* st = xdt + Q4 * kCols;
  float* cum = st + N * kCols;
  float* w = cum + Q4;
  float* wsum = w + Q4;

  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int p0 = g * kCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float a_h = A[h];
  const T* xb = x + b * x_sb + static_cast<long long>(h) * P + p0;
  const T* Bb = Bm + b * b_sb;
  const T* Cb = Cm + b * c_sb;
  const float* dtb = dt + static_cast<long long>(b) * S * H + h;
  const long long yrow = static_cast<long long>(H) * P;
  T* yb = y + static_cast<long long>(b) * S * yrow +
          static_cast<long long>(h) * P + p0;
  const long long sbase = (static_cast<long long>(b) * H + h) * P + p0;

  for (int i = tid; i < N * kCols; i += kThreads) {
    const int n = i % N, p = i / N;
    st[n * kCols + p] =
        init_state ? init_state[(sbase + p) * N + n] : 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += Q) {
    const int Qc = min(Q, S - s0);

    // 1. dt and the running log decay cum (block-wide inclusive scan)
    float dtj = 0.f, v = 0.f;
    if (tid < Qc) {
      dtj = dtb[static_cast<long long>(s0 + tid) * H];
      v = -dtj * a_h;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    for (int k = 0; k < warp; ++k) v += wsum[k];
    if (tid < Q4) {
      cum[tid] = v;
      w[tid] = dtj;
    }
    __syncthreads();

    // 2. stage B^T and dt.x of the chunk in f32, zeros past Qc
    for (int i = tid; i < Q4 * N; i += kThreads) {
      const int j = i / N, n = i % N;
      BsT[n * QP + j] =
          j < Qc ? to_f(Bb[static_cast<long long>(s0 + j) * b_ss + n]) : 0.f;
    }
    for (int i = tid; i < Q4 * kCols; i += kThreads) {
      const int j = i / kCols, p = i % kCols;
      xdt[i] = j < Qc
                   ? w[j] * to_f(xb[static_cast<long long>(s0 + j) * x_ss + p])
                   : 0.f;
    }
    __syncthreads();

    // 3. the score matrix in tiles of kTile rows, each followed by its y
    for (int i0 = 0; i0 < Qc; i0 += kTile) {
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int r = i / N, n = i % N;
        CsT[n * kTile + r] =
            i0 + r < Qc
                ? to_f(Cb[static_cast<long long>(s0 + i0 + r) * c_ss + n])
                : 0.f;
      }
      __syncthreads();

      // scores of rows i0.. and columns j < jn, 4 x 4 per thread
      const int jn = min(i0 + kTile, Qc);
      const int nj4 = (jn + 3) / 4;
      for (int m = tid; m < (kTile / 4) * nj4; m += kThreads) {
        const int r0 = 4 * (m / nj4), j0 = 4 * (m % nj4);
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
        if (j0 <= i0 + r0 + 3) {  // the tile reaches the diagonal
#pragma unroll 4
          for (int n = 0; n < N; ++n) {
            const float4 cv =
                *reinterpret_cast<const float4*>(CsT + n * kTile + r0);
            const float4 bv = *reinterpret_cast<const float4*>(BsT + n * QP + j0);
            const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
            const float bc[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[r][c] = fmaf(cr[r], bc[c], acc[r][c]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + r0 + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + c;
            float gij = 0.f;   // rows past Qc read no cum
            if (j <= i && i < Qc) gij = acc[r][c] * expf(cum[i] - cum[j]);
            G[(r0 + r) * GS + j] = gij;
          }
        }
      }
      __syncthreads();

      // y rows of the tile: the intra-chunk sum over j <= i, plus the
      // entering state's contribution
      for (int o = tid; o < kTile * kCols; o += kThreads) {
        const int r = o / kCols, p = o % kCols, i = i0 + r;
        if (i >= Qc) continue;
        float yi = 0.f;
        for (int j = 0; j <= i; ++j)
          yi = fmaf(G[r * GS + j], xdt[j * kCols + p], yi);
        float ye = 0.f;
        for (int n = 0; n < N; ++n)
          ye = fmaf(CsT[n * kTile + r], st[n * kCols + p], ye);
        yb[static_cast<long long>(s0 + i) * yrow + p] =
            from_f<T>(yi + ye * expf(cum[i]));
      }
      __syncthreads();
    }

    // 4. the state leaving the chunk
    const float total = cum[Qc - 1];
    if (tid < Qc) w[tid] = expf(total - cum[tid]);
    __syncthreads();
    {
      const int p = tid % kCols, n0 = tid / kCols;
      constexpr int kStride = kThreads / kCols;
      float acc[kRowsPer];
#pragma unroll
      for (int k = 0; k < kRowsPer; ++k) acc[k] = 0.f;
      for (int j = 0; j < Qc; ++j) {
        const float u = w[j] * xdt[j * kCols + p];
#pragma unroll
        for (int k = 0; k < kRowsPer; ++k) {
          const int n = n0 + k * kStride;
          if (n < N) acc[k] = fmaf(u, BsT[n * QP + j], acc[k]);
        }
      }
      const float decay = expf(total);
#pragma unroll
      for (int k = 0; k < kRowsPer; ++k) {
        const int n = n0 + k * kStride;
        if (n < N) st[n * kCols + p] = fmaf(st[n * kCols + p], decay, acc[k]);
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < N * kCols; i += kThreads) {
    const int n = i % N, p = i / N;
    final_state[(sbase + p) * N + n] = st[n * kCols + p];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* init_state, void* y,
           void* final_state, int B, int S, int H, int P, int N, int Q,
           long long x_sb, long long x_ss, long long b_sb, long long b_ss,
           long long c_sb, long long c_ss, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(smem_floats(Q, N));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynamicSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_scan_kernel<T><<<dim3(P / kCols, H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(init_state),
      static_cast<T*>(y), static_cast<float*>(final_state), S, H, P, N, Q,
      x_sb, x_ss, b_sb, b_ss, c_sb, c_ss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Q <= 256 (the scan runs one step per thread), N <= 128, P % 16 == 0;
// the wrapper checks them.  init_state may be null.  Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int ssd_chunk_scan_fwd(const void* x, const void* dt,
                                  const void* A, const void* Bm,
                                  const void* Cm, const void* init_state,
                                  void* y, void* final_state, int B, int S,
                                  int H, int P, int N, int Q, long long x_sb,
                                  long long x_ss, long long b_sb,
                                  long long b_ss, long long c_sb,
                                  long long c_ss, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, init_state, y,
                                 final_state, B, S, H, P, N, Q, x_sb, x_ss,
                                 b_sb, b_ss, c_sb, c_ss, s);
  return launch<float>(x, dt, A, Bm, Cm, init_state, y, final_state, B, S,
                       H, P, N, Q, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, s);
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
