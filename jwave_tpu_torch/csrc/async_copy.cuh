// Asynchronous global -> shared copies for Hopper (sm_90a): one-shot bulk
// copies (cp.async.bulk, the TMA's raw-bytes form) that complete on an
// mbarrier in shared memory. Used by K2 (modwt.cu) and K5 (pyramid.cu).
//
// A bulk copy needs its global and shared addresses 16-byte aligned and a
// size that is a multiple of 16 bytes; the callers copy what falls outside
// that (a ragged head or tail, a piece whose two addresses disagree mod 16)
// with plain loads, which a __syncthreads() publishes.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace jw {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises the barrier for one arrival (the issuing thread's
// arrive.expect_tx); the caller then runs __syncthreads() before any wait.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on `bar` and announce `bytes` of copies that will complete on it.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase with parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global `src` to shared `dst`; completion is counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace jw
