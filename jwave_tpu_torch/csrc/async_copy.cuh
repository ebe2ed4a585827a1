// Asynchronous bulk copies for Hopper (sm_90a), the TMA's raw-bytes form
// (cp.async.bulk): global -> shared copies that complete on an mbarrier in
// shared memory (K1, K2 in modwt.cu; K3, K4, K5 in pyramid.cu; K6 in
// reassign.cu), and shared -> global stores that complete in bulk groups of
// the issuing thread (K1, K2, K3, K6); and the segment staging and tile
// stores built on them that K1, K2 and K3 share.
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

// Stage samples [t0, t0 + cnt) mod n of `row` into dst[0, cnt): one piece
// per pass over the row. Thread 0 announces the stage's bulk bytes on `bar`
// and starts one bulk copy per piece for its part that is 16-byte aligned
// on both sides; every thread loads the rest plainly (the caller's
// __syncthreads() publishes those).
template <typename T>
__device__ void stage_segment(T* dst, const T* row, long long t0, int cnt, int n,
                              uint64_t* bar) {
  constexpr int kVec = 16 / sizeof(T);
  cnt = (cnt + kVec - 1) / kVec * kVec;  // whole 16 bytes: no plain-loaded tail where aligned
  for (int pass = 0; pass < 2; ++pass) {  // 0: count the bulk bytes, 1: copy
    uint32_t bulk_bytes = 0;
    int o = 0;
    long long s = t0;
    while (o < cnt) {
      const int len = (int)min((long long)(cnt - o), (long long)n - s);
      const uintptr_t ga = reinterpret_cast<uintptr_t>(row + s);
      int head = len, body = 0;  // [0, head) plain, [head, head + body) bulk, the rest plain
      if ((ga & 15) == (jw::smem_addr(dst + o) & 15)) {
        head = min(len, (int)(((16 - (ga & 15)) & 15) / sizeof(T)));
        body = (len - head) / kVec * kVec;
      }
      if (pass == 0) {
        bulk_bytes += body * sizeof(T);
      } else {
        if (body > 0 && threadIdx.x == 0)
          jw::bulk_copy(dst + o + head, row + s + head, body * sizeof(T), bar);
        for (int i = threadIdx.x; i < len - body; i += blockDim.x) {
          const int e = i < head ? i : i + body;
          dst[o + e] = row[s + e];
        }
      }
      o += len;
      s = 0;
    }
    if (pass == 0 && threadIdx.x == 0) jw::mbar_expect(bar, bulk_bytes);
  }
}

// Stage the contiguous run src[0, cnt) into dst[0, cnt), dst from
// stage_for(base, src), which agrees with src mod 16. Thread 0 announces
// the bulk bytes on `bar` and copies the 16-byte aligned body in one bulk
// copy, rounded up to whole 16 bytes where src[0, avail) holds them; every
// thread loads the ragged head (and a tail the rounding could not take)
// plainly, which the caller's __syncthreads() publishes.
template <typename T>
__device__ void stage_run(T* dst, const T* src, int cnt, long long avail, uint64_t* bar) {
  constexpr int kVec = 16 / sizeof(T);
  const uintptr_t ga = reinterpret_cast<uintptr_t>(src);
  const int head = min(cnt, (int)(((16 - (ga & 15)) & 15) / sizeof(T)));
  int body = (cnt - head + kVec - 1) / kVec * kVec;
  if (head + body > avail) body = (cnt - head) / kVec * kVec;
  const int tail = min(cnt, head + body);  // plain from here to cnt
  if (threadIdx.x == 0) {
    jw::mbar_expect(bar, body * sizeof(T));
    if (body > 0) jw::bulk_copy(dst + head, src + head, body * sizeof(T), bar);
  }
  for (int i = threadIdx.x; i < head + cnt - tail; i += blockDim.x) {
    const int e = i < head ? i : tail + i - head;
    dst[e] = src[e];
  }
}

// The stage for a tile bound for global `dst`: `base` (16-byte aligned)
// advanced by dst's offset mod 16, so that the stage and dst agree mod 16.
template <typename T>
__device__ __forceinline__ T* stage_for(unsigned char* base, const T* dst) {
  return reinterpret_cast<T*>(base + (reinterpret_cast<uintptr_t>(dst) & 15));
}

// dst[0, cnt) = src[0, cnt), src a stage from stage_for(dst): thread 0
// issues one bulk store of the 16-byte aligned body into its current bulk
// group, and every thread stores the ragged head and tail plainly. The
// caller has fenced (jw::fence_async_smem) and synchronised the writes of
// src, and later commits the group.
template <typename T>
__device__ void store_segment(T* dst, const T* src, int cnt) {
  constexpr int kVec = 16 / sizeof(T);
  const uintptr_t ga = reinterpret_cast<uintptr_t>(dst);
  const int head = min(cnt, (int)(((16 - (ga & 15)) & 15) / sizeof(T)));
  const int body = (cnt - head) / kVec * kVec;
  if (body > 0 && threadIdx.x == 0)
    jw::bulk_store(dst + head, src + head, body * (uint32_t)sizeof(T));
  for (int i = threadIdx.x; i < cnt - body; i += blockDim.x) {
    const int e = i < head ? i : i + body;
    dst[e] = src[e];
  }
}

}  // namespace jw
