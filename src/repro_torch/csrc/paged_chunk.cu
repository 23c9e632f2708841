// Split-KV paged chunk attention for Hopper (sm_90a), and the one-token
// paged decode as the same kernel at T = 1.
//
// Replaces two TPU kernels of
// src/repro/kernels/paged_attention/paged_attention.py: `paged_decode_chunk`
// (`_paged_chunk_kernel`, B1), T-token chunk attention straight over the
// paged KV pool, the attention of every decode and chunked-prefill step of
// the serving engine; and `paged_decode` (`_paged_kernel`, B3), one-token
// attention over the pool with each sequence's length in place of pos
// (see "The one-token decode" below).
//
//   q          [B, T, H, D]            bf16 or f32, H = Hkv * n_rep
//   k/v pages  [n_pages, P, Hkv, D]    same type as q
//   page_table [B, max_pages] int32    -1 = no page (its tokens are unseen)
//   pos        [B] int32               first chunk position of each sequence
//   out        [B, T, H, D]
//
// The GQA group is folded into R = T * n_rep query rows per (b, kv head);
// row r = t * n_rep + rep (the reference's `qg` grouping) is chunk token t
// of query head h * n_rep + rep and sees table position tok (token tok % P
// of page page_table[b][tok / P]) when tok <= pos[b] + t and that entry is
// not -1.  The chunk's own K/V is already in the pages (write-then-attend).
// Softmax state is f32; out = acc / max(l, 1e-30), rounded to q's type
// once.  A row with no visible token returns zeros (the TPU kernel returns
// garbage there; the engine never reads such rows).
//
// What bounds it on the H100: bytes.  Each (b, kv head) must read the K and
// V of its visible tokens once, 4 * ctx * D bytes in bf16, against
// 4 * R * ctx * D flops: at qwen3's R = 16 (T = 8, n_rep 2) 16 flops per
// byte, far below the card's ~295 bf16 flops per byte.  One block per
// (b, kv head) walking its pages, as the TPU kernel's grid does, gives 64
// blocks on 132 SMs at the serving batch, each streaming its pages alone.
// So the table's positions are cut into fixed splits of S tokens (S = 128
// in bf16, 64 in f32, the split tile of csrc/split_attention.cuh, shared
// with the ring kernel), split s holding positions [S s, min(max_pages P,
// S s + S)), and the grid is (n_splits, Hkv, B): 8 x 8 x 8 = 512 blocks at
// qwen3's serving shape (P = 64, 16 table entries) where there were 64.
// For every page size that divides S (the engine's 64, the tests' 4..64) a
// split is S / P whole table entries; a larger page spans several splits
// and one that does not divide S lets a split straddle two pages, so the
// tile stays S tokens at any P and shared memory depends on D and the type
// alone.  A split wholly past pos + T - 1, or whose entries are all -1,
// writes (m = -inf, l = 0) for its rows and exits.  Otherwise each thread
// looks up one column's page and stores the offset of its K/V row, ((page
// P + tok % P) Hkv + h) D, in shared memory, or -1 for a column on a -1
// entry or past pos + T - 1, the largest position a row of the block sees.
// The split block (csrc/split_attention.cuh) copies the columns' K and V
// rows with 16-byte cp.async, zero-filling the -1 columns without reading
// them (so a stale or NaN token past a row's position, or a page never
// written, never meets 0 x NaN in P.V), then walks the R rows in m-tiles of
// 16, staging one q tile at a time against the staged K/V, so R has no cap:
// in bf16 q.K^T and P.V on mma.sync.m16n8k16 (P as bf16 hi + lo, V through
// ldmatrix.trans; qwen3's T = 8 rows fill one m-tile, T = 1's 2 are
// padded), in f32 on the CUDA cores, no TF32.  A second launch, the merge
// (csrc/split_merge.cuh, launch_merge), weighs each row's splits by
// exp(m_s - max m) in a fixed order and writes out [B, T, H, D]: the
// partials' row (b T + t) H + head is out's row.
//
// The masking hazard: rows of one m-tile see different numbers of tokens
// (row r's last column is pos + r / n_rep - S s), so the mask is per (row,
// column), and a row may see none of a split another row of its block sees:
// it writes l = 0, and its exponent subtracts 0 in place of its -inf max, so
// no exp(-inf - (-inf)) arises; padding rows of the last m-tile are zero in
// q, see nothing and are never written.
//
// Why the split is fixed: the layout depends on P and the type alone, never
// on B, T, pos or the table's contents, and each row's scores, softmax and
// P.V depend on its own q row and the split's columns only.  So a row's
// output is bitwise the same at any batch, and row t of a T-token launch at
// pos equals a one-token launch of its q row at pos + t over the same pages
// (which speculative decoding's verification chunk needs).  Splits sized to
// fill the SMs would tie the reduction order to B and T.  128 tokens is
// the ring kernel's bf16 split, which it timed faster than 64
// (csrc/decode_ring.cu); no other size was timed here.
//
// The one-token decode (B3): paged_decode_attention() launches this kernel
// at T = 1 with each sequence's length as pos and a shift of -1, so the
// block's rows are the n_rep query heads of kv head h, each seeing table
// positions up to lengths[b] - 1 (clamped to max_pages P), and a sequence
// of length 0 sees nothing and gets zeros.  Its bound is the same: bytes,
// 4 * len * D per (b, kv head) in bf16 against n_rep flops a byte.  Each
// of its rows is thus, by construction, what B1 gives at T = 1 with pos =
// lengths - 1, and bitwise the same at any batch.  It replaces B3's own
// kernel: one block per page table entry (512 splits of 16 tokens at
// P = 16), scores one key at a time with warp shuffles and P.V one (row,
// d) a thread on the CUDA cores, shared memory growing with P (the wrapper
// refused large pages), and a merge that walked every page's split in
// series.
//
// ptxas (-Xptxas -v, __launch_bounds__(128, 2)): 124 registers in bf16, 64
// in f32, no spill.  Measured with chip_smoke.py's guarded, L2-flushed
// timer on an NVIDIA H100 80GB HBM3 at 700.00 W, bf16, over the merge of
// csrc/split_merge.cuh, qwen3-0.6b's shapes (8 kv heads of 2, D = 128,
// P = 64).  B1 at B = 8, 16 table entries, contexts 32..544: 0.0166 ms at
// T = 8 (the one block per (b, kv head) kernel before it: 0.1456; gather
// + SDPA 0.1462; byte bound 0.00249) and 0.0173 at T = 1 (was 0.0550;
// gather + SDPA 0.1374; bound 0.00298); past the old cap, R = 256 (T =
// 16, 4 kv heads of 16) 0.0773 ms (gather + SDPA 0.4126; bound 0.00296),
// where the 16 m-tiles of a block run one after another.  B3: 0.0162 ms
// at B = 8, lengths 264..319 (B3's own kernel: 0.0291; byte bound
// 0.00280), 0.0304 at 975..1020 (0.0515; 0.00972), 0.0319 for one
// 8192-token sequence (0.0835; 0.01002) and 0.0734 for one of 32768
// tokens (gather + SDPA 0.4927; bound 0.04007).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_attention.cuh"
#include "split_merge.cuh"

namespace {

// The kernel's dynamic shared memory limit is set to the card's per-block
// limit (227 KB on an H100), the same value on every call, not to the
// launch's own size: a caller on another thread (one engine per pump
// thread) would otherwise lower it under a launch that needs more, which
// then fails as an invalid argument.
constexpr int kMaxDynamicSmem = 232448;

using split_attn::kThreads;

// The R = T * n_rep query rows of kv head h of sequence b: row r is chunk
// token t = r / n_rep of query head h * n_rep + r % n_rep, row (b T + t) H
// + h n_rep + r % n_rep of q, the partials and out, and sees split columns
// up to p0 + t - t0 (p0 = pos[b] + shift).
struct ChunkRows {
  int64_t bT;  // b * T
  int n, n_rep, H, h, last0;  // last0 = pos - t0
  __device__ __forceinline__ int64_t row(int r) const {
    const int t = r / n_rep;
    return (bT + t) * H + h * n_rep + (r - t * n_rep);
  }
  __device__ __forceinline__ int last(int r) const {
    return last0 + r / n_rep;
  }
};

// One block per (split j, kv head h, sequence b): the partial state of
// split j for each of the block's R query rows.  The chunk's first
// position is pos[b] + shift: B1 passes its positions and 0, B3 its
// lengths and -1.  A row of D elements must be a multiple of 16 bytes and
// the tensors 16-byte aligned (the wrapper checks).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages,
                   const int* __restrict__ page_table,
                   const int* __restrict__ pos, float* __restrict__ part_acc,
                   float* __restrict__ part_ml, int shift, int Tq, int Hkv,
                   int n_rep, int D, int P, int max_pages, float scale) {
  using Split = split_attn::Split<T>;
  constexpr int S = Split::kSplit;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int p0 = pos[b] + shift, t0 = j * S;
  const ChunkRows rows{static_cast<int64_t>(b) * Tq, Tq * n_rep, n_rep,
                       Hkv * n_rep, h, p0 - t0};
  // positions [t0, end) may be seen by some row of the block
  const int end = min(min(t0 + S, max_pages * P), p0 + Tq);
  if (end <= t0) {  // block-uniform
    split_attn::write_empty(rows, part_ml, n_splits, j);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int64_t* off = reinterpret_cast<int64_t*>(smem_raw);
  const int* table = page_table + static_cast<int64_t>(b) * max_pages;
  bool any = false;
  for (int c = threadIdx.x; c < S; c += kThreads) {
    const int tok = t0 + c;
    const int page = tok < end ? table[tok / P] : -1;
    off[c] = page < 0 ? -1
                      : ((static_cast<int64_t>(page) * P + tok % P) * Hkv +
                         h) * D;
    any |= page >= 0;
  }
  if (!__syncthreads_or(any)) {  // every entry of the split is -1
    split_attn::write_empty(rows, part_ml, n_splits, j);
    return;
  }
  Split::attend(smem_raw, q, k_pages, v_pages, rows, part_acc, part_ml,
                n_splits, j, D, scale);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pt,
           const void* pos, float* part_acc, float* part_ml, void* out,
           int shift, int B, int Tq, int Hkv, int n_rep, int D, int P,
           int max_pages, float scale, cudaStream_t stream) {
  using Split = split_attn::Split<T>;
  cudaError_t err = cudaFuncSetAttribute(
      paged_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynamicSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_splits = (max_pages * P + Split::kSplit - 1) / Split::kSplit;
  paged_split_kernel<T><<<dim3(n_splits, Hkv, B), kThreads,
                          Split::smem_bytes(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pt),
      static_cast<const int*>(pos), part_acc, part_ml, shift, Tq, Hkv, n_rep,
      D, P, max_pages, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(split_merge::launch_merge<T>(
      part_acc, part_ml, static_cast<T*>(out), B * Tq * Hkv * n_rep,
      n_splits, D, stream));
}

}  // namespace

// part_acc [B*T*H, n_splits, D] and part_ml [B*T*H, n_splits, 2] are f32
// scratch the caller allocates, n_splits = ceil(max_pages * P / split) with
// splits of 128 tokens in bf16 and 64 in f32 (ops.paged_splits).  Launches
// the split kernel and the merge on `stream`; returns the first CUDA error
// (0 = both launched).
extern "C" int paged_chunk_attention(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* page_table, const void* pos,
                                     void* part_acc, void* part_ml, void* out,
                                     int B, int Tq, int Hkv, int n_rep, int D,
                                     int P, int max_pages, float scale,
                                     int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(part_acc);
  float* ml = static_cast<float*>(part_ml);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, pos, acc,
                                 ml, out, 0, B, Tq, Hkv, n_rep, D, P,
                                 max_pages, scale, s);
  return launch<float>(q, k_pages, v_pages, page_table, pos, acc, ml, out, 0,
                       B, Tq, Hkv, n_rep, D, P, max_pages, scale, s);
}

// The one-token decode: q and out [B, H, D], lengths [B] int32 the tokens
// each sequence sees; part_acc [B*H, n_splits, D] and part_ml [B*H,
// n_splits, 2] as above.  The chunk kernel at T = 1 with pos = lengths - 1.
extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table,
                                      const void* lengths, void* part_acc,
                                      void* part_ml, void* out, int B,
                                      int Hkv, int n_rep, int D, int P,
                                      int max_pages, float scale,
                                      int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(part_acc);
  float* ml = static_cast<float*>(part_ml);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, lengths,
                                 acc, ml, out, -1, B, 1, Hkv, n_rep, D, P,
                                 max_pages, scale, s);
  return launch<float>(q, k_pages, v_pages, page_table, lengths, acc, ml,
                       out, -1, B, 1, Hkv, n_rep, D, P, max_pages, scale, s);
}

extern "C" const char* paged_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
