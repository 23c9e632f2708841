// Split-KV ring decode attention for Hopper (sm_90a).
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
// age (pos % C - slot) % C is below min(window, pos + 1): at most two runs
// of slots.  Softmax state is f32; out = acc / max(l, 1e-30), rounded to
// q's type once.  A row with no visible slot (pos < 0) returns zeros.
//
// What bounds it on the H100: bytes.  Each (b, kv head) reads the K and V
// of its visible slots once, 4 * n_vis * D bytes in bf16, against
// 4 * n_rep * n_vis * D flops: n_rep flops per byte, far below the card's
// ~295 bf16 flops per byte.  One block per (b, kv head) walking the whole
// ring, as the TPU kernel's grid does, leaves B * Hkv blocks: 8 on 132 SMs
// for recurrentgemma-9b (one kv head) at the serving batch, each reading up
// to 2 MB alone.  So the ring is cut into fixed splits of S slots (S = 128
// in bf16, 64 in f32), split s holding slots [S s, min(C, S s + S)), and
// the grid is (n_splits, Hkv, B): B * Hkv * n_splits blocks, 128 at B = 8,
// C = 2048 in bf16 (256 in f32).  A block intersects its slots with the
// row's visible runs; with none it writes (m = -inf, l = 0) and exits.
// Otherwise it copies the visible slots' K and V rows of head h into
// shared memory (16-byte cp.async; invisible slots, a short last split and
// the columns past D are zero-filled without being read, so a slot never
// written, NaN or not, never reaches P.V), computes its n_rep query rows'
// partial state (the row max m, l = sum exp(s - m) and acc = sum exp(s -
// m) v) over its slots, and writes it to f32 scratch.  A second launch,
// `merge_splits_kernel` (csrc/split_merge.cuh, B3's merge), weighs each
// row's splits by exp(m_s - max m) in split order.
//
// Why the split is fixed: the split layout depends on C and the type alone,
// never on the batch, the positions or the window, so a row's slots are
// reduced in the same tiles in the same order at any batch and its output
// is bitwise the same.  Splits sized to fill the SMs would tie the
// reduction order to B.  bf16 takes 128 slots rather than 64:
// tools/ring_ab.py timed both on an H100 80GB HBM3 at 700 W (bf16, B =
// 8; the 64-slot build is this source with the bf16 kSplit below and
// ops.RING_SPLIT set to 64): 0.0230 against 0.0261 ms at recurrentgemma's
// C = 1024, 0.0301 against 0.0402 at C = 2048, and 0.0186 / 0.0345
// against 0.0193 / 0.0358 at qwen3's decode shapes.  Twice the splits
// double the partials the merge reads (4 MB at C = 2048) and
// the splits it walks per row, while a 128-slot block at D = 256 (161 KB
// of shared memory, one an SM) still gives 128 blocks for 132 SMs.  f32
// keeps 64: 128 f32 slots of K and V at D = 256 would need 256 KB.
//
// bf16: the tensor cores.  The n_rep query rows of the kv head are the m
// dimension of mma.sync.m16n8k16 (bf16 in, f32 accumulate), zero-padded to
// a multiple of 16 (recurrentgemma's 16 fill one m-tile, qwen3's 2 are
// padded; more than 16 loop over m-tiles); D is zero-padded to a multiple
// of 16 in shared memory.  Each of the 4 warps takes a quarter of the
// split's slots for S = Q.K^T (ldmatrix fragments of Q and K); the scores,
// scaled and masked to -inf outside visibility, go through shared memory,
// where one warp per row takes the max and the exponentials in f32.  P enters
// P.V as bf16 hi + lo (two mma, P kept to ~2^-16 of itself, as close to
// the reference's f32 P.V as the tensor cores go), V through
// ldmatrix.trans, each warp owning 16-column slices of D.
//
// f32: the same grid and split on the CUDA cores, no TF32, the precision
// witness: a warp per slot reduces the n_rep dot products along D, a warp
// per row takes its softmax, a thread per (row, column) sums P.V in slot
// order.
//
// Measured with chip_smoke.py's guarded, L2-flushed timer on an NVIDIA
// H100 80GB HBM3 at 700 W, bf16, B = 8: 0.0219 ms at recurrentgemma's
// C = 1024 and 0.0302 at C = 2048 (one kv head of 16 queries, D = 256,
// wrapped; repeat + SDPA 0.2057 and 0.3801, byte bound 0.0025 and
// 0.0050), 0.0186 at qwen3's decode_step shape (C = 1024, 8 kv heads of
// 2, D = 128, pos 264..319; bound 0.0029).  ptxas: 115 registers (bf16),
// 40 (f32), no spill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx_sm90.cuh"
#include "split_merge.cuh"

namespace {

// The kernel's dynamic shared memory limit is set to the card's per-block
// limit (227 KB on an H100), the same value for every launch, not to the
// launch's own size: a caller on another thread (one engine per pump
// thread) would otherwise lower it under a launch that needs more, which
// then fails as an invalid argument.
constexpr int kMaxDynamicSmem = 232448;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

// The visible slots of a row at position p: [lo0, hi0) and [lo1, hi1).
struct Runs {
  int lo0 = 0, hi0 = 0, lo1 = 0, hi1 = 0;

  __device__ __forceinline__ bool has(int t) const {
    return (t >= lo0 && t < hi0) || (t >= lo1 && t < hi1);
  }
  // how many of slots [t0, t1) are visible
  __device__ __forceinline__ int count(int t0, int t1) const {
    return max(0, min(hi0, t1) - max(lo0, t0)) +
           max(0, min(hi1, t1) - max(lo1, t0));
  }
};

__device__ __forceinline__ Runs visible_runs(int p, int C, int window) {
  Runs r;
  if (window < 0) {
    r.hi0 = p < 0 ? 0 : min(p, C - 1) + 1;
  } else if (p >= 0) {
    const int n = min(min(window, p + 1), C);  // visible ages 0 .. n-1
    const int newest = p % C;
    const int start = newest - n + 1;
    if (start >= 0) {
      r.lo0 = start;
      r.hi0 = newest + 1;
    } else {  // the run wraps past slot 0
      r.hi0 = newest + 1;
      r.lo1 = C + start;
      r.hi1 = C;
    }
  }
  return r;
}

// A split with no visible slot: weight 0 in the merge, its acc never read.
__device__ __forceinline__ void write_empty(float* part_ml, int64_t row0,
                                            int n_rep, int n_splits, int j) {
  for (int r = threadIdx.x; r < n_rep; r += kThreads) {
    float* ml = part_ml + ((row0 + r) * n_splits + j) * 2;
    ml[0] = -INFINITY;
    ml[1] = 0.f;
  }
}

// ------------------------------------------------------------------------
// bf16: the tensor cores.
namespace tc {

constexpr int kSplit = 128;  // ring slots per split (ops.RING_SPLIT)
constexpr int kKeysPerWarp = kSplit / kWarps;  // slots of a warp's scores
constexpr int kSStride = kSplit + 8;  // f32 per row of the staged scores
constexpr int kPStride = kSplit + 8;  // bf16 per row of P hi / P lo

// Dynamic shared memory of one block (ops._ring_smem_bytes): q [MP, ST],
// K and V [kSplit, ST] in bf16 with ST = DP + 8 (rows padded by 16 bytes
// so that ldmatrix reads them without bank conflicts), one m-tile's scores
// [16, kSStride] in f32, P hi and P lo [16, kPStride] in bf16.
__host__ __device__ __forceinline__ int padded(int x) {
  return (x + 15) & ~15;
}
size_t smem_bytes(int n_rep, int D) {
  const size_t st = padded(D) + 8;
  return sizeof(__nv_bfloat16) * (padded(n_rep) + 2 * kSplit) * st +
         sizeof(float) * 16 * kSStride +
         2 * sizeof(__nv_bfloat16) * 16 * kPStride;
}

// One block per (split j, kv head h, sequence b).  Writes, for each of the
// group's n_rep query rows (row = b * H + h * n_rep + r), the partial state
// of split j: part_ml[row][j] = (m, l), part_acc[row][j][:] = acc.  D must
// be a multiple of 8 and the tensors 16-byte aligned (the wrapper checks).
__global__ void __launch_bounds__(kThreads)
ring_split_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ cache_k,
                  const __nv_bfloat16* __restrict__ cache_v,
                  const int* __restrict__ pos, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int C, int Hkv, int n_rep,
                  int D, int window, float scale) {
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
  const int64_t row0 = static_cast<int64_t>(b) * Hkv * n_rep + h * n_rep;
  const int t0 = j * kSplit, t1 = min(C, t0 + kSplit);
  const Runs runs = visible_runs(pos[b], C, window);
  if (runs.count(t0, t1) == 0) {  // block-uniform
    write_empty(part_ml, row0, n_rep, n_splits, j);
    return;
  }

  const int DP = padded(D), ST = DP + 8, MP = padded(n_rep);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + MP * ST;
  __nv_bfloat16* vs = ks + kSplit * ST;
  float* ss = reinterpret_cast<float*>(vs + kSplit * ST);
  __nv_bfloat16* ph = reinterpret_cast<__nv_bfloat16*>(ss + 16 * kSStride);
  __nv_bfloat16* pl = ph + 16 * kPStride;

  // q's rows and the split's visible K/V rows, 16-byte copies all in
  // flight; padding rows and columns and invisible slots zero-filled
  const int cpr = DP / 8;  // 16-byte chunks per staged row
  const __nv_bfloat16* qb = q + row0 * D;
  for (int i = tid; i < MP * cpr; i += kThreads) {
    const int r = i / cpr, c = (i % cpr) * 8;
    const bool ok = r < n_rep && c < D;
    cp_async16(qs + r * ST + c, ok ? qb + r * D + c : qb, ok);
  }
  const int64_t tok_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t base = (static_cast<int64_t>(b) * C * Hkv + h) * D;
  for (int i = tid; i < kSplit * cpr; i += kThreads) {
    const int r = i / cpr, c = (i % cpr) * 8;
    const int slot = t0 + r;
    const bool ok = slot < t1 && c < D && runs.has(slot);
    const int64_t off = ok ? base + slot * tok_stride + c : 0;
    cp_async16(ks + r * ST + c, cache_k + off, ok);
    cp_async16(vs + r * ST + c, cache_v + off, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // fragment addresses: A rows (l % 16), column 8 * (l / 16); B rows of K
  // (not transposed) and of V (transposed), as in the flash kernel
  const int a_row = lane & 15, a_col = (lane >> 4) << 3;
  const int k_row = ((lane >> 4) << 3) + (lane & 7);
  const int k_col = ((lane >> 3) & 1) << 3;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_col = (lane >> 4) << 3;
  const int key0 = warp * kKeysPerWarp;

  for (int m0 = 0; m0 < n_rep; m0 += 16) {
    // S = Q . K^T: the m-tile's 16 rows x the warp's slots, f32
    float s[kKeysPerWarp / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKeysPerWarp / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const uint32_t q_frag = smem_addr(qs + (m0 + a_row) * ST + a_col);
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
    // scaled, masked to -inf outside visibility, into shared memory
#pragma unroll
    for (int nt = 0; nt < kKeysPerWarp / 8; ++nt) {
      const int col = key0 + nt * 8 + 2 * t;
      const bool ok0 = t0 + col < t1 && runs.has(t0 + col);
      const bool ok1 = t0 + col + 1 < t1 && runs.has(t0 + col + 1);
      *reinterpret_cast<float2*>(ss + g * kSStride + col) = make_float2(
          ok0 ? s[nt][0] * scale : -INFINITY,
          ok1 ? s[nt][1] * scale : -INFINITY);
      *reinterpret_cast<float2*>(ss + (g + 8) * kSStride + col) =
          make_float2(ok0 ? s[nt][2] * scale : -INFINITY,
                      ok1 ? s[nt][3] * scale : -INFINITY);
    }
    __syncthreads();

    // the split's softmax state, one warp per row; P split into bf16 hi +
    // lo.  Every row sees a visible slot, so its max is finite.
    for (int r = warp; r < 16; r += kWarps) {
      const float* sr = ss + r * kSStride;
      float mx = -INFINITY;
      for (int c = 2 * lane; c < kSplit; c += 64) {
        const float2 x = *reinterpret_cast<const float2*>(sr + c);
        mx = fmaxf(mx, fmaxf(x.x, x.y));
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int c = 2 * lane; c < kSplit; c += 64) {
        const float2 x = *reinterpret_cast<const float2*>(sr + c);
        const float p0 = expf(x.x - mx), p1 = expf(x.y - mx);
        sum += p0 + p1;
        uint32_t hi, lo;
        split(p0, p1, hi, lo);
        *reinterpret_cast<uint32_t*>(ph + r * kPStride + c) = hi;
        *reinterpret_cast<uint32_t*>(pl + r * kPStride + c) = lo;
      }
      sum = warp_sum(sum);
      if (lane == 0 && m0 + r < n_rep) {
        float* ml = part_ml + ((row0 + m0 + r) * n_splits + j) * 2;
        ml[0] = mx;
        ml[1] = sum;
      }
    }
    __syncthreads();

    // acc = P . V: warp w owns 16-column slices w, w + 4, ... of D
    uint32_t ah[kSplit / 16][4], al[kSplit / 16][4];
#pragma unroll
    for (int kk = 0; kk < kSplit / 16; ++kk) {
      ldmatrix_x4(ah[kk], smem_addr(ph + a_row * kPStride + kk * 16 + a_col));
      ldmatrix_x4(al[kk], smem_addr(pl + a_row * kPStride + kk * 16 + a_col));
    }
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
          const int r = m0 + g + 8 * half;
          if (r < n_rep)
            *reinterpret_cast<float2*>(
                part_acc + ((row0 + r) * n_splits + j) * D + col) =
                make_float2(o[n][2 * half], o[n][2 * half + 1]);
        }
      }
    }
    __syncthreads();  // the next m-tile rewrites the scores and P
  }
}

}  // namespace tc

// ------------------------------------------------------------------------
// f32: the CUDA cores.
namespace f32 {

constexpr int kSplit = 64;  // ring slots per split (ops.RING_SPLIT)

// Dynamic shared memory of one block (ops._ring_smem_bytes): K and V
// [kSplit, D], q [n_rep, D] and the scores [n_rep, kSplit], all f32.
size_t smem_bytes(int n_rep, int D) {
  return sizeof(float) * (2 * static_cast<size_t>(kSplit) * D +
                          static_cast<size_t>(n_rep) * D +
                          static_cast<size_t>(n_rep) * kSplit);
}

// The grid and outputs of tc::ring_split_kernel.  D must be a multiple of
// 4 and the tensors 16-byte aligned (the wrapper checks).
__global__ void __launch_bounds__(kThreads)
ring_split_kernel(const float* __restrict__ q,
                  const float* __restrict__ cache_k,
                  const float* __restrict__ cache_v,
                  const int* __restrict__ pos, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int C, int Hkv, int n_rep,
                  int D, int window, float scale) {
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = static_cast<int64_t>(b) * Hkv * n_rep + h * n_rep;
  const int t0 = j * kSplit, t1 = min(C, t0 + kSplit);
  const Runs runs = visible_runs(pos[b], C, window);
  if (runs.count(t0, t1) == 0) {  // block-uniform
    write_empty(part_ml, row0, n_rep, n_splits, j);
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [kSplit, D]
  float* vs = ks + kSplit * D;                     // [kSplit, D]
  float* qs = vs + kSplit * D;                     // [n_rep, D]
  float* ss = qs + n_rep * D;                      // [n_rep, kSplit]

  const int cpr = D / 4;  // 16-byte chunks per row
  const float* qb = q + row0 * D;
  for (int i = tid; i < n_rep * cpr; i += kThreads)
    cp_async16(qs + i * 4, qb + i * 4, true);
  const int64_t tok_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t base = (static_cast<int64_t>(b) * C * Hkv + h) * D;
  for (int i = tid; i < kSplit * cpr; i += kThreads) {
    const int r = i / cpr, c = (i % cpr) * 4;
    const int slot = t0 + r;
    const bool ok = slot < t1 && runs.has(slot);
    const int64_t off = ok ? base + slot * tok_stride + c : 0;
    cp_async16(ks + r * D + c, cache_k + off, ok);
    cp_async16(vs + r * D + c, cache_v + off, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // scores: one warp per slot, lanes along D, n_rep shuffle reductions
  for (int c = warp; c < kSplit; c += kWarps) {
    const bool ok = t0 + c < t1 && runs.has(t0 + c);  // warp-uniform
    const float* kc = ks + c * D;
    for (int r = 0; r < n_rep; ++r) {
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

  // the split's softmax state, one warp per row
  for (int r = warp; r < n_rep; r += kWarps) {
    float* sr = ss + r * kSplit;
    float mx = -INFINITY;
    for (int c = lane; c < kSplit; c += 32) mx = fmaxf(mx, sr[c]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < kSplit; c += 32) {
      const float p = expf(sr[c] - mx);
      sr[c] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      float* ml = part_ml + ((row0 + r) * n_splits + j) * 2;
      ml[0] = mx;
      ml[1] = sum;
    }
  }
  __syncthreads();

  // acc[r][d] = sum over the split's slots, in order, of p[r][c] v[c][d]
  for (int i = tid; i < n_rep * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const float* pr = ss + r * kSplit;
    float a = 0.f;
    for (int c = 0; c < kSplit; ++c) a += pr[c] * vs[c * D + d];
    part_acc[((row0 + r) * n_splits + j) * D + d] = a;
  }
}

}  // namespace f32

template <typename T>
using SplitKernel = void (*)(const T*, const T*, const T*, const int*,
                             float*, float*, int, int, int, int, int, float);

template <typename T>
int launch(SplitKernel<T> kernel, int split, size_t smem, const void* q,
           const void* k, const void* v, const void* pos, float* part_acc,
           float* part_ml, void* out, int B, int C, int Hkv, int n_rep,
           int D, int window, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_splits = (C + split - 1) / split;
  kernel<<<dim3(n_splits, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos), part_acc,
      part_ml, C, Hkv, n_rep, D, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  split_merge::merge_splits_kernel<T>
      <<<B * Hkv * n_rep, split_merge::kThreads, 0, stream>>>(
          part_acc, part_ml, static_cast<T*>(out), n_splits, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window < 0 means no window.  part_acc [B*H, n_splits, D] and part_ml
// [B*H, n_splits, 2] are f32 scratch the caller allocates, n_splits =
// ceil(C / split) with splits of 128 slots in bf16 and 64 in f32
// (ops.ring_splits).  Launches the split kernel and the merge on `stream`;
// returns the first CUDA error (0 = both launched).
extern "C" int decode_ring_attention(const void* q, const void* cache_k,
                                     const void* cache_v, const void* pos,
                                     void* part_acc, void* part_ml,
                                     void* out, int B, int C, int Hkv,
                                     int n_rep, int D, int window,
                                     float scale, int is_bf16,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(part_acc);
  float* ml = static_cast<float*>(part_ml);
  if (is_bf16)
    return launch<__nv_bfloat16>(tc::ring_split_kernel, tc::kSplit,
                                 tc::smem_bytes(n_rep, D), q, cache_k,
                                 cache_v, pos, acc, ml, out, B, C, Hkv,
                                 n_rep, D, window, scale, s);
  return launch<float>(f32::ring_split_kernel, f32::kSplit,
                       f32::smem_bytes(n_rep, D), q, cache_k, cache_v, pos,
                       acc, ml, out, B, C, Hkv, n_rep, D, window, scale, s);
}

extern "C" const char* decode_ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
