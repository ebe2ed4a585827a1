// Asynchronous bulk copies for Hopper (sm_90a), the TMA's raw-bytes form
// (cp.async.bulk): global -> shared copies that complete on an mbarrier in
// shared memory (K1, K2 in modwt.cu; K4, K5 in pyramid.cu), and shared ->
// global stores that complete in bulk groups of the issuing thread (K1).
//
// A bulk copy needs its global and shared addresses 16-byte aligned and a
// size that is a multiple of 16 bytes; the callers copy what falls outside
// that (a ragged head or tail, a piece whose two addresses disagree mod 16)
// with plain loads or stores, which a __syncthreads() publishes.
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

// Make this thread's plain writes to shared memory visible to the bulk
// copies (the async proxy): every writing thread runs it, then a
// __syncthreads(), before one thread starts a bulk store of that memory.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Store `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// shared `src` to global `dst`, in the issuing thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

// Close the issuing thread's current bulk group of stores.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of the issuing thread's bulk groups still read their
// shared sources: the shared memory of the others may be written again.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

}  // namespace jw
