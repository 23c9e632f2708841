// The split block of split-KV attention, shared by the port's split-KV
// kernels over fixed splits of their keys (csrc/decode_ring.cu,
// csrc/paged_chunk.cu).  A kernel's block owns one split of kSplit key
// columns and a group of query rows that share one kv head; it fills, in
// shared memory, the element offset of each column's K/V row (or -1 for a
// column no row of the block may see), and calls attend(), which
//
//   * stages the split's K and V rows with 16-byte cp.async, zero-filling
//     without reading the -1 columns, a short last split and, in bf16, the
//     columns past D (so a key never written, NaN or not, never reaches
//     P.V);
//   * walks the rows in m-tiles of 16, staging one tile of q at a time (so
//     shared memory does not grow with the rows), and for each row of the
//     tile writes its partial softmax state over the split: m = the row max,
//     l = sum exp(s - m) and acc = sum exp(s - m) v, to f32 scratch
//     part_ml [rows, n_splits, 2] and part_acc [rows, n_splits, D];
//   * masks column c of row r to -inf unless off[c] >= 0 and c <=
//     rows.last(r).  A row that sees no column of the split (or a padding
//     row of the last m-tile) writes (m = -inf, l = 0) and computes no
//     exp(-inf - (-inf)): its max is replaced by 0 in the exponent, so every
//     p is exp(-inf) = 0.  The merge (csrc/split_merge.cuh) passes over it;
//   * issues griddepcontrol.launch_dependents once the block's partials
//     are written, so the merge, launched as a programmatic dependent,
//     may be scheduled early (it waits for the whole grid before reading).
//
// A kernel's Rows type maps its rows to memory:
//   int n;                                   rows of the block
//   __device__ int64_t row(int r) const;     index of row r in q [.., D],
//                                            the partials and the output
//   __device__ int last(int r) const;        last split column row r sees
//
// Each row's scores, softmax and P.V depend on its own q row and the
// split's columns only, in a fixed order, never on the other rows of its
// tile or on which tile it falls in, so a row's partials are bitwise the
// same whatever rows it is launched with.
//
// bf16 (Split<__nv_bfloat16>, 128 columns): the tensor cores.  The m-tile's
// rows are the m dimension of mma.sync.m16n8k16 (bf16 in, f32 accumulate);
// D is zero-padded to a multiple of 16 in shared memory.  Each of the 4
// warps takes a quarter of the split's columns for S = Q.K^T (ldmatrix
// fragments of Q and K); the scores, scaled and masked, go through shared
// memory, where the 8 lanes of a group share a row and take its max and
// exponentials in f32, 16 columns a lane in registers, reduced over the
// group by shuffles.  P enters P.V as bf16 hi + lo (two mma, P kept to
// ~2^-16 of itself), V through ldmatrix.trans, each warp owning 16-column
// slices of D.
//
// One q tile: loading the next m-tile's q under this tile's math (a second
// q tile) was timed with chip_smoke.wrapper_ab on an NVIDIA H100 80GB HBM3
// at 700.00 W, bf16, the paged chunk kernel at B = 8, 4 kv heads of 16,
// D = 128, P = 64: 0.0447 against 0.0464 ms at 128 rows, 0.0783 against
// 0.0806 at 256, the same at 16 rows and fewer (one m-tile, where it never
// runs) and for the ring kernel; 2-4 % at the most, so it was left out.
//
// f32 (Split<float>, 64 columns): the CUDA cores, no TF32, the precision
// witness: a warp per column reduces the tile's 16 dot products along D, a
// warp per row takes its softmax, a thread per (row, column of D) sums P.V
// in column order.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "ptx_sm90.cuh"

namespace {
namespace split_attn {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;  // rows of an m-tile

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

// Over the 8 lanes l ^ 1, l ^ 2, l ^ 4 of a lane's group of 8.
__device__ __forceinline__ float group8_max(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group8_sum(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A split no row of the block sees: weight 0 in the merge, acc never read.
template <class Rows>
__device__ __forceinline__ void write_empty(const Rows& rows, float* part_ml,
                                            int n_splits, int j) {
  for (int r = threadIdx.x; r < rows.n; r += kThreads) {
    float* ml = part_ml + (rows.row(r) * n_splits + j) * 2;
    ml[0] = -INFINITY;
    ml[1] = 0.f;
  }
}

template <typename T>
struct Split;

// ------------------------------------------------------------------------
// bf16: the tensor cores.
template <>
struct Split<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kSplit = 128;  // key columns of a split
  static constexpr int kKeysPerWarp = kSplit / kWarps;
  static constexpr int kSStride = kSplit + 8;  // f32 a row of the scores
  static constexpr int kPStride = kSplit + 8;  // bf16 a row of P hi / lo

  __host__ __device__ static int padded(int x) { return (x + 15) & ~15; }

  // Dynamic shared memory of one block (ops._split_smem_bytes): the
  // columns' offsets [kSplit] int64, then one q tile [16, ST], K and V
  // [kSplit, ST] in bf16 with ST = padded(D) + 8 (rows padded by 16 bytes
  // so that ldmatrix reads them without bank conflicts), one m-tile's
  // scores [16, kSStride] in f32, P hi and P lo [16, kPStride] in bf16.
  static size_t smem_bytes(int D) {
    const size_t st = padded(D) + 8;
    return sizeof(int64_t) * kSplit +
           sizeof(T) * (kRows + 2 * kSplit) * st +
           sizeof(float) * kRows * kSStride +
           2 * sizeof(T) * kRows * kPStride;
  }

  template <class Rows>
  static __device__ __forceinline__ void attend(
      unsigned char* smem, const T* __restrict__ q, const T* __restrict__ k,
      const T* __restrict__ v, const Rows& rows, float* __restrict__ part_acc,
      float* __restrict__ part_ml, int n_splits, int j, int D, float scale) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
    const int DP = padded(D), ST = DP + 8;
    const int64_t* off = reinterpret_cast<const int64_t*>(smem);
    T* qs = reinterpret_cast<T*>(smem + sizeof(int64_t) * kSplit);
    T* ks = qs + kRows * ST;
    T* vs = ks + kSplit * ST;
    float* ss = reinterpret_cast<float*>(vs + kSplit * ST);
    T* ph = reinterpret_cast<T*>(ss + kRows * kSStride);
    T* pl = ph + kRows * kPStride;

    // the split's K/V rows, 16-byte copies all in flight
    const int cpr = DP / 8;  // 16-byte chunks per staged row
    for (int i = tid; i < kSplit * cpr; i += kThreads) {
      const int r = i / cpr, c = (i % cpr) * 8;
      const int64_t o = off[r];
      const bool ok = o >= 0 && c < D;
      cp_async16(ks + r * ST + c, k + (ok ? o + c : 0), ok);
      cp_async16(vs + r * ST + c, v + (ok ? o + c : 0), ok);
    }

    // fragment addresses: A rows (l % 16), column 8 * (l / 16); B rows of K
    // (not transposed) and of V (transposed), as in the flash kernel
    const int a_row = lane & 15, a_col = (lane >> 4) << 3;
    const int k_row = ((lane >> 4) << 3) + (lane & 7);
    const int k_col = ((lane >> 3) & 1) << 3;
    const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
    const int v_col = (lane >> 4) << 3;
    const int key0 = warp * kKeysPerWarp;

    const uint32_t q_frag = smem_addr(qs + a_row * ST + a_col);

    for (int m0 = 0; m0 < rows.n; m0 += kRows) {
      // the m-tile's q rows (padding rows and columns zero-filled); the
      // first time, they land with the K/V copies
      for (int i = tid; i < kRows * cpr; i += kThreads) {
        const int r = i / cpr, c = (i % cpr) * 8;
        const bool ok = m0 + r < rows.n && c < D;
        cp_async16(qs + r * ST + c, q + (ok ? rows.row(m0 + r) * D + c : 0),
                   ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      // S = Q . K^T: the m-tile's 16 rows x the warp's columns, f32
      float s[kKeysPerWarp / 8][4];
#pragma unroll
      for (int nt = 0; nt < kKeysPerWarp / 8; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, q_frag + kk * 32);
#pragma unroll
        for (int nt = 0; nt < kKeysPerWarp / 8; nt += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, smem_addr(ks + (key0 + nt * 8 + k_row) * ST +
                                    kk * 16 + k_col));
          mma_bf16(s[nt], a, bk[0], bk[1]);
          mma_bf16(s[nt + 1], a, bk[2], bk[3]);
        }
      }

      // scaled, masked to -inf where the row may not see the column, into
      // shared memory; padding rows see nothing
      const int last0 = m0 + g < rows.n ? rows.last(m0 + g) : -1;
      const int last1 = m0 + g + 8 < rows.n ? rows.last(m0 + g + 8) : -1;
#pragma unroll
      for (int nt = 0; nt < kKeysPerWarp / 8; ++nt) {
        const int col = key0 + nt * 8 + 2 * t;
        const bool in0 = off[col] >= 0, in1 = off[col + 1] >= 0;
        *reinterpret_cast<float2*>(ss + g * kSStride + col) = make_float2(
            in0 && col <= last0 ? s[nt][0] * scale : -INFINITY,
            in1 && col + 1 <= last0 ? s[nt][1] * scale : -INFINITY);
        *reinterpret_cast<float2*>(ss + (g + 8) * kSStride + col) =
            make_float2(in0 && col <= last1 ? s[nt][2] * scale : -INFINITY,
                        in1 && col + 1 <= last1 ? s[nt][3] * scale
                                                : -INFINITY);
      }
      __syncthreads();

      // the split's softmax state: the 8 lanes of a group share a row,
      // each 4-column quad c = 32 i + 4 (lane % 8) of it, in registers; P
      // split into bf16 hi + lo.  A row that sees no column keeps
      // m = -inf and gets p = 0.
      {
        const int r = tid >> 3, c0 = (tid & 7) * 4;
        const float* sr = ss + r * kSStride;
        float x[kSplit / 8];
#pragma unroll
        for (int i = 0; i < kSplit / 32; ++i) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(sr + 32 * i + c0);
          x[4 * i] = v4.x;
          x[4 * i + 1] = v4.y;
          x[4 * i + 2] = v4.z;
          x[4 * i + 3] = v4.w;
        }
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < kSplit / 8; ++i) mx = fmaxf(mx, x[i]);
        mx = group8_max(mx);
        const float base = mx == -INFINITY ? 0.f : mx;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < kSplit / 32; ++i) {
          const float p0 = expf(x[4 * i] - base);
          const float p1 = expf(x[4 * i + 1] - base);
          const float p2 = expf(x[4 * i + 2] - base);
          const float p3 = expf(x[4 * i + 3] - base);
          sum += (p0 + p1) + (p2 + p3);
          uint32_t hi0, lo0, hi1, lo1;
          split(p0, p1, hi0, lo0);
          split(p2, p3, hi1, lo1);
          const int c = r * kPStride + 32 * i + c0;
          *reinterpret_cast<uint2*>(ph + c) = make_uint2(hi0, hi1);
          *reinterpret_cast<uint2*>(pl + c) = make_uint2(lo0, lo1);
        }
        sum = group8_sum(sum);
        if ((tid & 7) == 0 && m0 + r < rows.n) {
          float* ml = part_ml + (rows.row(m0 + r) * n_splits + j) * 2;
          ml[0] = mx;
          ml[1] = sum;
        }
      }
      __syncthreads();

      // acc = P . V: warp w owns 16-column slices w, w + 4, ... of D
      uint32_t ah[kSplit / 16][4], al[kSplit / 16][4];
#pragma unroll
      for (int kk = 0; kk < kSplit / 16; ++kk) {
        ldmatrix_x4(ah[kk],
                    smem_addr(ph + a_row * kPStride + kk * 16 + a_col));
        ldmatrix_x4(al[kk],
                    smem_addr(pl + a_row * kPStride + kk * 16 + a_col));
      }
      const int64_t row_g = m0 + g < rows.n ? rows.row(m0 + g) : -1;
      const int64_t row_g8 = m0 + g + 8 < rows.n ? rows.row(m0 + g + 8) : -1;
      for (int dp = warp; dp < DP / 16; dp += kWarps) {
        float o[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kSplit / 16; ++kk) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, smem_addr(vs + (kk * 16 + v_row) * ST +
                                          dp * 16 + v_col));
          mma_bf16(o[0], ah[kk], bv[0], bv[1]);
          mma_bf16(o[1], ah[kk], bv[2], bv[3]);
          mma_bf16(o[0], al[kk], bv[0], bv[1]);
          mma_bf16(o[1], al[kk], bv[2], bv[3]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = dp * 16 + n * 8 + 2 * t;
          if (col >= D) continue;  // D is a multiple of 8
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int64_t row = half ? row_g8 : row_g;
            if (row >= 0)
              *reinterpret_cast<float2*>(
                  part_acc + (row * n_splits + j) * D + col) =
                  make_float2(o[n][2 * half], o[n][2 * half + 1]);
          }
        }
      }
    }
    griddep_launch_dependents();  // this block's partials are written
  }
};

// ------------------------------------------------------------------------
// f32: the CUDA cores.
template <>
struct Split<float> {
  using T = float;
  static constexpr int kSplit = 64;  // key columns of a split

  // Dynamic shared memory of one block (ops._split_smem_bytes): the
  // columns' offsets [kSplit] int64, then K and V [kSplit, D], q [16, D]
  // and the scores [16, kSplit], all f32.
  static size_t smem_bytes(int D) {
    return sizeof(int64_t) * kSplit +
           sizeof(float) * (2 * static_cast<size_t>(kSplit) * D +
                            static_cast<size_t>(kRows) * D + kRows * kSplit);
  }

  template <class Rows>
  static __device__ __forceinline__ void attend(
      unsigned char* smem, const T* __restrict__ q, const T* __restrict__ k,
      const T* __restrict__ v, const Rows& rows, float* __restrict__ part_acc,
      float* __restrict__ part_ml, int n_splits, int j, int D, float scale) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int64_t* off = reinterpret_cast<const int64_t*>(smem);
    float* ks = reinterpret_cast<float*>(smem + sizeof(int64_t) * kSplit);
    float* vs = ks + kSplit * D;  // [kSplit, D]
    float* qs = vs + kSplit * D;  // [16, D]
    float* ss = qs + kRows * D;   // [16, kSplit]

    const int cpr = D / 4;  // 16-byte chunks per row
    for (int i = tid; i < kSplit * cpr; i += kThreads) {
      const int r = i / cpr, c = (i % cpr) * 4;
      const int64_t o = off[r];
      const bool ok = o >= 0;
      cp_async16(ks + r * D + c, k + (ok ? o + c : 0), ok);
      cp_async16(vs + r * D + c, v + (ok ? o + c : 0), ok);
    }

    for (int m0 = 0; m0 < rows.n; m0 += kRows) {
      for (int i = tid; i < kRows * cpr; i += kThreads) {
        const int r = i / cpr, c = (i % cpr) * 4;
        const bool ok = m0 + r < rows.n;
        cp_async16(qs + r * D + c, q + (ok ? rows.row(m0 + r) * D + c : 0),
                   ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      // scores: one warp per column, lanes along D, a shuffle reduction
      // per row the column is visible to
      for (int c = warp; c < kSplit; c += kWarps) {
        const bool in = off[c] >= 0;  // warp-uniform
        const float* kc = ks + c * D;
        for (int r = 0; r < kRows; ++r) {
          const bool ok = in && m0 + r < rows.n && c <= rows.last(m0 + r);
          float dot = 0.f;
          if (ok) {
            const float* qr = qs + r * D;
            for (int d = lane; d < D; d += 32) dot += qr[d] * kc[d];
            dot = warp_sum(dot);
          }
          if (lane == 0) ss[r * kSplit + c] = ok ? dot * scale : -INFINITY;
        }
      }
      __syncthreads();

      // the split's softmax state, one warp per row; a row that sees no
      // column keeps m = -inf and gets p = 0
      for (int r = warp; r < kRows; r += kWarps) {
        float* sr = ss + r * kSplit;
        float mx = -INFINITY;
        for (int c = lane; c < kSplit; c += 32) mx = fmaxf(mx, sr[c]);
        mx = warp_max(mx);
        const float base = mx == -INFINITY ? 0.f : mx;
        float sum = 0.f;
        for (int c = lane; c < kSplit; c += 32) {
          const float p = expf(sr[c] - base);
          sr[c] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0 && m0 + r < rows.n) {
          float* ml = part_ml + (rows.row(m0 + r) * n_splits + j) * 2;
          ml[0] = mx;
          ml[1] = sum;
        }
      }
      __syncthreads();

      // acc[r][d] = sum over the split's columns, in order, of p[r][c] v[c][d]
      for (int i = tid; i < kRows * D; i += kThreads) {
        const int r = i / D, d = i % D;
        if (m0 + r >= rows.n) break;  // i only grows past the last row
        const float* pr = ss + r * kSplit;
        float a = 0.f;
        for (int c = 0; c < kSplit; ++c) a += pr[c] * vs[c * D + d];
        part_acc[(rows.row(m0 + r) * n_splits + j) * D + d] = a;
      }
      __syncthreads();  // the next m-tile rewrites q and the scores
    }
    griddep_launch_dependents();  // this block's partials are written
  }
};

}  // namespace split_attn
}  // namespace
