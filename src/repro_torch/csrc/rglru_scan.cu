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
// and sequential in t.  One thread per channel walks the sequence, with
// neighbouring threads on neighbouring w, so each step's loads of a and b
// and its store of y are coalesced 128-byte rows.  The TPU kernel's
// sequential grid axis over sequence chunks (with the state carried in
// VMEM scratch between grid steps) becomes this loop, and its padding of
// the sequence to 256 with identity steps is not needed: the loop stops at
// S.  The loop is unrolled so that the loads of later steps, which do not
// depend on h, are in flight while the chain of multiply-adds runs.
//
// What bounds it on the H100: bytes.  It reads a and b and writes y, 12
// bytes per element, and does 2 flops per element.  At B = 1, S = 512, W =
// 4096 that is 25.2 MB, 7.5 us at 3.35 TB/s.  But at B = 1, W = 4096 only
// 4096 threads run (16 blocks of 256 on 132 SMs), too few to keep enough
// loads in flight to reach the memory's rate, so the time is latency: S
// dependent steps of a load's round trip, partly hidden by the unrolling.
// A chunked two-pass scan (more blocks along S: each block scans its chunk
// from a zero state, then a second pass folds in the carried states) is the
// later remedy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ y,
                  float* __restrict__ final_state, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (w >= W) return;
  float h = h0 != nullptr ? h0[static_cast<int64_t>(bi) * W + w] : 0.f;
  const int64_t base = static_cast<int64_t>(bi) * S * W + w;
  const float* ap = a + base;
  const float* bp = b + base;
  float* yp = y + base;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = __ldg(ap + static_cast<int64_t>(t + u) * W);
      bv[u] = __ldg(bp + static_cast<int64_t>(t + u) * W);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      yp[static_cast<int64_t>(t + u) * W] = h;
    }
  }
  for (; t < S; ++t) {
    h = __fadd_rn(__fmul_rn(__ldg(ap + static_cast<int64_t>(t) * W), h),
                  __ldg(bp + static_cast<int64_t>(t) * W));
    yp[static_cast<int64_t>(t) * W] = h;
  }
  final_state[static_cast<int64_t>(bi) * W + w] = h;
}

}  // namespace

// h0 may be null.  Returns the CUDA error code of the launch (0 =
// launched).
extern "C" int rglru_scan_fwd(const void* a, const void* b, const void* h0,
                              void* y, void* final_state, int B, int S,
                              int W, void* stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(final_state), S, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
