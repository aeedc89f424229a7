// mbarrier and 1-D bulk-copy primitives of sm_90, shared by the kernels
// that stage their inputs through shared memory (minhash.cu, rans.cu,
// score.cu).  A bulk copy (cp.async.bulk, no tensor map) moves a contiguous
// run of bytes from device memory into shared memory and reports it to an
// mbarrier; its addresses and size must be multiples of 16 bytes.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the bulk-copy unit; one
// thread calls it after its bar_init calls, before the block synchronises.
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ bool bar_test(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!ok);
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// Arrive on `bar` and announce `bytes` of bulk-copy traffic for its phase.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Copy `bytes` into shared memory, completing them on `bar` (whose phase
// was announced by bar_expect).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Announce `bytes` on `bar`, then copy them: one copy a barrier phase.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  bar_expect(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

}  // namespace
