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
// the merge shared with the paged kernels (csrc/split_merge.cuh,
// launch_merge), weighs each row's splits by exp(m_s - max m) in a fixed
// order.
//
// Why the split is fixed: the split layout depends on C and the type alone,
// never on the batch, the positions or the window, so a row's slots are
// reduced in the same tiles in the same order at any batch and its output
// is bitwise the same.  Splits sized to fill the SMs would tie the
// reduction order to B.  bf16 takes 128 slots rather than 64:
// tools/ring_ab.py timed both on an H100 80GB HBM3 at 700 W (bf16, B =
// 8; the 64-slot build had the bf16 kSplit, now Split<__nv_bfloat16>::
// kSplit in csrc/split_attention.cuh, and ops.RING_SPLIT, now ops.SPLIT,
// set to 64): 0.0230 against 0.0261 ms at recurrentgemma's
// C = 1024, 0.0301 against 0.0402 at C = 2048, and 0.0186 / 0.0345
// against 0.0193 / 0.0358 at qwen3's decode shapes.  Twice the splits
// double the partials the merge reads (4 MB at C = 2048) and
// the splits it walks per row, while a 128-slot block at D = 256 (161 KB
// of shared memory, one an SM) still gives 128 blocks for 132 SMs.  f32
// keeps 64: 128 f32 slots of K and V at D = 256 would need 256 KB.
//
// The split block (csrc/split_attention.cuh, shared with the paged chunk
// kernel) stages the split's K/V and walks the n_rep rows in m-tiles of
// 16: in bf16 on the tensor cores (mma.sync.m16n8k16, n_rep rows padded to
// a multiple of 16: recurrentgemma's 16 fill one m-tile, qwen3's 2 are
// padded; P as bf16 hi + lo), in f32 on the CUDA cores, no TF32, the
// precision witness.  Every row of a block sees the same slots.
//
// Measured with chip_smoke.py's guarded, L2-flushed timer on an NVIDIA
// H100 80GB HBM3 at 700.00 W, bf16, B = 8, over the shared split block
// and the parallel merge: 0.0166 ms at recurrentgemma's C = 1024 and
// 0.0202 at C = 2048 (one kv head of 16 queries, D = 256, wrapped; repeat
// + SDPA 0.2092 and 0.3837, byte bound 0.00254 and 0.00505), 0.0159 at
// qwen3's decode_step shape (C = 1024, 8 kv heads of 2, D = 128, pos
// 264..319; bound 0.00288) and 0.0303 at pos 975..1020 (bound 0.00981);
// over the merge before it, 0.0204, 0.0288, 0.0186 and 0.0329, and before
// the block was shared, 0.0218, 0.0307, 0.0183 and 0.0349.  ptxas: 117 registers (bf16), 56
// (f32), no spill; with __launch_bounds__(128) alone, not (128, 2), it
// gave the bf16 kernel 96 registers and 16 bytes of spill stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "split_attention.cuh"
#include "split_merge.cuh"

namespace {

// The kernel's dynamic shared memory limit is set to the card's per-block
// limit (227 KB on an H100), the same value for every launch, not to the
// launch's own size: a caller on another thread (one engine per pump
// thread) would otherwise lower it under a launch that needs more, which
// then fails as an invalid argument.
constexpr int kMaxDynamicSmem = 232448;

using split_attn::kThreads;

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

// The n_rep query rows of kv head h of sequence b, rows b * H + h * n_rep
// + r of q, the partials and out; each sees every visible slot.
struct RingRows {
  int64_t row0;
  int n;
  __device__ __forceinline__ int64_t row(int r) const { return row0 + r; }
  __device__ __forceinline__ int last(int) const { return INT_MAX; }
};

// One block per (split j, kv head h, sequence b): the partial state of
// split j for each of the group's n_rep query rows.  A row of D elements
// must be a multiple of 16 bytes and the tensors 16-byte aligned (the
// wrapper checks).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ring_split_kernel(const T* __restrict__ q, const T* __restrict__ cache_k,
                  const T* __restrict__ cache_v, const int* __restrict__ pos,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  int C, int Hkv, int n_rep, int D, int window, float scale) {
  using Split = split_attn::Split<T>;
  constexpr int S = Split::kSplit;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const RingRows rows{static_cast<int64_t>(b) * Hkv * n_rep + h * n_rep,
                      n_rep};
  const int t0 = j * S, t1 = min(C, t0 + S);
  const Runs runs = visible_runs(pos[b], C, window);
  if (runs.count(t0, t1) == 0) {  // block-uniform
    split_attn::write_empty(rows, part_ml, n_splits, j);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int64_t* off = reinterpret_cast<int64_t*>(smem_raw);
  const int64_t tok_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t base = (static_cast<int64_t>(b) * C * Hkv + h) * D;
  for (int c = threadIdx.x; c < S; c += kThreads) {
    const int slot = t0 + c;
    off[c] = slot < t1 && runs.has(slot) ? base + slot * tok_stride : -1;
  }
  __syncthreads();
  Split::attend(smem_raw, q, cache_k, cache_v, rows, part_acc, part_ml,
                n_splits, j, D, scale);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pos,
           float* part_acc, float* part_ml, void* out, int B, int C,
           int Hkv, int n_rep, int D, int window, float scale,
           cudaStream_t stream) {
  using Split = split_attn::Split<T>;
  cudaError_t err = cudaFuncSetAttribute(
      ring_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynamicSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_splits = (C + Split::kSplit - 1) / Split::kSplit;
  ring_split_kernel<T><<<dim3(n_splits, Hkv, B), kThreads,
                         Split::smem_bytes(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos), part_acc,
      part_ml, C, Hkv, n_rep, D, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(split_merge::launch_merge<T>(
      part_acc, part_ml, static_cast<T*>(out), B * Hkv * n_rep, n_splits, D,
      stream));
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
    return launch<__nv_bfloat16>(q, cache_k, cache_v, pos, acc, ml, out, B,
                                 C, Hkv, n_rep, D, window, scale, s);
  return launch<float>(q, cache_k, cache_v, pos, acc, ml, out, B, C, Hkv,
                       n_rep, D, window, scale, s);
}

extern "C" const char* decode_ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
