// PTX helpers shared by the port's Hopper (sm_90a) kernels: asynchronous
// copies into shared memory (cp.async), ldmatrix, the bf16 tensor-core
// product mma.sync.m16n8k16 with f32 accumulation, and the two halves of
// programmatic dependent launch (griddepcontrol).  Every csrc/*.cu that
// needs them includes this header and still builds into a library of its
// own (kernels/_build.py hashes the header into each library's name).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously: the first `bytes` (0 to 16)
// from src, the rest zero-filled.  With 0 no byte is read, and src need
// only be a valid address.
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src,
                                             int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
// The whole 16 bytes when ok, zeros when not.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  cp_async16_n(dst, src, ok ? 16 : 0);
}
// 4 bytes global -> shared (rows no 16-byte copy can read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices from shared memory; addr is a shared-memory
// address (smem_addr), or a pointer into shared memory.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  ldmatrix_x4(r, smem_addr(p));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  ldmatrix_x4_trans(r, smem_addr(p));
}

// c[16x8] += a[16x16] . b[16x8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two f32 as a bf16 pair, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

// Two f32 values as a bf16 pair hi and the pair of their remainders lo
// (v - hi, rounded to bf16): an f32 operand of two mma, kept to ~2^-16 of
// itself.
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - __low2float(h), b - __high2float(h)));
}

// Programmatic dependent launch.  A kernel launched after this one on its
// stream with cudaLaunchAttributeProgrammaticStreamSerialization may be
// scheduled once every block of this grid has issued launch_dependents (or
// exited); it must execute griddep_wait() before it reads anything this
// grid writes.  Both are no-ops where no such launch is involved.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
// Wait until every grid this one depends on has completed and its writes
// are visible.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

}  // namespace
