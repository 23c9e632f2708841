// RG-LRU linear-recurrence scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `rglru_scan_blocked` (`_rglru_kernel`) of
// src/repro/kernels/rglru_scan/rglru_scan.py: the recurrence of every
// RG-LRU layer of a RecurrentGemma prefill,
//
//   h_t = a_t * h_{t-1} + b_t        (elementwise over the width W)
//
//   a, b   [B, S, W]   f32 contiguous (the decay exp(log_a) and the gated
//                      input)
//   h0     [B, W]      f32 contiguous, or null (a zero state)
//   y      [B, S, W]   f32 contiguous: every h_t
//   final  [B, W]      f32 contiguous: h_{S-1} (h0, or zeros, when S = 0)
//
// Each step is a product rounded to f32, then a sum rounded to f32
// (__fmul_rn, __fadd_rn: never fused into one FMA), which is the plain
// version's order, so the two agree bit for bit.
//
// Design.  The recurrence is diagonal: every (b, w) channel is independent
// and sequential in t, and one thread per channel walks it in order (the
// TPU kernel's sequential grid axis over sequence chunks, with the state
// carried in VMEM scratch between grid steps, becomes this loop; its
// padding of the sequence to 256 with identity steps is not needed: the
// loop stops at S).  What the layout decides is how the data reaches the
// threads:
//   - Narrow blocks: one warp of 32 channels each, so B * ceil(W / 32)
//     blocks spread over the 132 SMs (128 at B = 1, W = 4096).
//   - A deep asynchronous pipeline: tiles of kRows steps x 32 channels of a
//     and of b go through kStages stages of shared memory by cp.async, the
//     next kStages - 1 tiles in flight while one is scanned, so the chain of
//     multiply-adds reads shared memory and never waits on a load's round
//     trip.  Rows are 16-byte copies when W % 4 == 0 (a 128-byte row per 8
//     lanes), else 4-byte copies; lanes past W copy nothing and store
//     nothing.
//   - Few instructions a step: one warp is all an SM holds at B = 1, so it
//     issues alone and every instruction of a step counts.  A step is two
//     shared loads (a tile's all issued before its chain), the multiply,
//     the add and a shared store of h into a y tile; the tile goes out
//     after the chain as 16-byte rows.
//
// What bounds it on the H100: bytes.  It reads a and b and writes y, 12
// bytes per element, and does 2 flops per element.  At B = 1, S = 512, W =
// 4096 that is 25.2 MB, 7.5 us at 3.35 TB/s: 128 warps must keep ~25 MB
// moving, with (kStages - 1) * 8 KB in flight per warp.
//
// Measured with chip_smoke.py's guarded, L2-flushed timer on an NVIDIA
// H100 80GB HBM3 at 700 W, W = 4096: 0.0184 ms at B = 1, S = 512 (2.4x the
// byte bound), 0.0772 at B = 8 (1.3x), 0.0077 and 0.0160 at S = 64.  At B = 1 the lone warp of each SM
// takes ~36 ns a step (0.0184 ms / 512) through its chain of dependent
// instructions: the chain, not the memory, sets the time.
// ptxas: 64 registers, no spill.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx_sm90.cuh"

namespace {

// The kernel's dynamic shared memory limit is set to the card's per-block
// limit (227 KB on an H100) on every call, whatever the launch needs, as
// every kernel of the port does: a caller on another thread (one engine per
// pump thread) would otherwise lower it under a launch that needs more.
constexpr int kMaxDynamicSmem = 232448;

constexpr int kWidth = 32;   // channels per block: one warp
constexpr int kRows = 32;    // steps per staged tile
constexpr int kStages = 4;   // tiles staged; kStages - 1 in flight
constexpr int kTileFloats = kRows * kWidth;
// kStages tiles of a and b, and one of y: 36 KB
constexpr size_t kSmem = sizeof(float) * (2 * kStages + 1) * kTileFloats;

__global__ void __launch_bounds__(kWidth)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ y,
                  float* __restrict__ final_state, int S, int W, int vec) {
  // [kStages][a, b][kRows][kWidth], then y [kRows][kWidth]
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * kWidth, bi = blockIdx.y;
  const int w = w0 + lane;
  const bool live = w < W;
  const int64_t base = static_cast<int64_t>(bi) * S * W + w0;
  const int n_tiles = (S + kRows - 1) / kRows;

  // tile `tile` (steps tile * kRows ..) of a and b into stage s
  auto load = [&](int tile, int s) {
    float* as = smem + s * 2 * kTileFloats;
    float* bs = as + kTileFloats;
    const int t0 = tile * kRows;
    const int rows = min(kRows, S - t0);
    if (vec) {
      // kWidth / 4 copies of 16 bytes a row, 4 rows a pass of the lanes
      constexpr int kCopies = kWidth / 4;
      const int c = (lane % kCopies) * 4;
      const int bytes = 4 * min(max(W - (w0 + c), 0), 4);
      for (int r = lane / kCopies; r < rows; r += kWidth / kCopies) {
        const int64_t off = base + static_cast<int64_t>(t0 + r) * W + c;
        cp_async16_n(as + r * kWidth + c, bytes ? a + off : a, bytes);
        cp_async16_n(bs + r * kWidth + c, bytes ? b + off : b, bytes);
      }
    } else if (live) {
      for (int r = 0; r < rows; ++r) {
        const int64_t off = base + static_cast<int64_t>(t0 + r) * W + lane;
        cp_async4(as + r * kWidth + lane, a + off);
        cp_async4(bs + r * kWidth + lane, b + off);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load(s, s);
    cp_async_commit();
  }
  float h = live && h0 != nullptr ? h0[static_cast<int64_t>(bi) * W + w] : 0.f;
  float* ys = smem + 2 * kStages * kTileFloats;
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();  // this tile has landed
    __syncwarp();                  // for every lane, and the last one is read
    if (tile + kStages - 1 < n_tiles)
      load(tile + kStages - 1, (tile + kStages - 1) % kStages);
    cp_async_commit();
    const float* as = smem + (tile % kStages) * 2 * kTileFloats + lane;
    const float* bs = as + kTileFloats;
    const int t0 = tile * kRows;
    const int rows = min(kRows, S - t0);
    // the chain, each h_t into the y tile
    if (rows == kRows) {
      // the tile's a and b into registers first: in program order before
      // the y stores, so no load of a later step waits behind them
      float av[kRows], bv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        av[r] = as[r * kWidth];
        bv[r] = bs[r * kWidth];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        h = __fadd_rn(__fmul_rn(av[r], h), bv[r]);
        ys[r * kWidth + lane] = h;
      }
    } else {
      for (int r = 0; r < rows; ++r) {
        h = __fadd_rn(__fmul_rn(as[r * kWidth], h), bs[r * kWidth]);
        ys[r * kWidth + lane] = h;
      }
    }
    __syncwarp();
    // the y tile out: 16-byte rows where a and b came so, else each lane
    // its own channel
    if (vec) {
      constexpr int kCopies = kWidth / 4;
      const int c = (lane % kCopies) * 4;
      if (w0 + c < W) {
        float* yt = y + base + static_cast<int64_t>(t0) * W + c;
        for (int r = lane / kCopies; r < rows; r += kWidth / kCopies)
          *reinterpret_cast<float4*>(yt + static_cast<int64_t>(r) * W) =
              *reinterpret_cast<const float4*>(ys + r * kWidth + c);
      }
    } else if (live) {
      float* yt = y + base + static_cast<int64_t>(t0) * W + lane;
      for (int r = 0; r < rows; ++r)
        yt[static_cast<int64_t>(r) * W] = ys[r * kWidth + lane];
    }
  }
  if (live) final_state[static_cast<int64_t>(bi) * W + w] = h;
}

}  // namespace

// h0 may be null.  Returns the CUDA error code of the launch (0 =
// launched).
extern "C" int rglru_scan_fwd(const void* a, const void* b, const void* h0,
                              void* y, void* final_state, int B, int S,
                              int W, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rglru_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynamicSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies need every row start 16-byte aligned
  const int vec = W % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(a) & 15u) == 0 &&
                  (reinterpret_cast<uintptr_t>(b) & 15u) == 0;
  const dim3 grid((W + kWidth - 1) / kWidth, B);
  rglru_scan_kernel<<<grid, kWidth, kSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(final_state), S, W, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
