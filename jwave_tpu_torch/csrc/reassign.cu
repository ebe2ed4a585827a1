// K6: the synchrosqueezing reassignment, for Hopper (sm_90a).
//
// Replaces: jwave_tpu/ops/pallas_reassign.py::_reassign_kernel (driven by
// reassign_pallas / _reassign_impl). Per batch row g and time column t:
//   T[g, k, t] = sum over s with k_idx[g, s, t] == k of c[g, s, t]
// for k in [0, K); an index outside [0, K) (negative, or the drop sentinel
// K) lands nowhere. c and T are complex64, read and written as torch lays
// them out (interleaved re/im, float2); k_idx is int32.
//
// Bound on this card: bytes. Each (g, s, t) is read once (8 B + 4 B) and
// each (g, k, t) written once (8 B); at G=8, S=64, K=64, N=65536 that is
// 403 MB read and 268 MB written, about 0.2 ms at the HBM peak. The work
// per byte is one compare and two adds.
//
// Design. A block owns one batch row g, a tile of kTile time columns and a
// chunk of kc <= kChunk bins; each thread owns one column of a kc x kTile
// float2 plane in shared memory and adds into it in ascending s: no two
// threads touch the same entry, so there are no atomics, and the sum is
// deterministic and in the plain scatter's order. The plane (512 B a column
// at 64 bins) caps an SM at a few hundred columns whatever the block shape,
// so what a column keeps in flight has to come from depth along s, and the
// first version had little: four s-rows unrolled, and the load of c waited
// for the loaded index (9-18 KB in flight an SM), with zeroing, the s loop
// and the plane's stores as three phases. Here:
//  - k_idx and c come through a ring of kStages shared stages of kStageRows s-rows each
//    (an s-row of the tile is 4*kTile B of indices and 8*kTile B of
//    contributions, contiguous), filled by bulk copies (TMA, cp.async.bulk)
//    that one thread issues kStages stages ahead, each stage on its own
//    mbarrier; the threads consume a stage, meet at a barrier, and the
//    stage is filled again. c is read unconditionally: for K <= kChunk
//    every kept coefficient is in the chunk, so that costs no byte, and no
//    load depends on another;
//  - the plane is zeroed while the first stages are in flight;
//  - after the last s one thread sends the plane out by bulk stores, one of
//    8*kTile B a bin row, so no thread stores 8 bytes at a time; the other
//    block of the SM goes on loading meanwhile;
//  - a tile at the ragged end of a row, or rows that are not 16-byte
//    aligned (N % 4 != 0 for the indices, N % 2 != 0 for c and the plane),
//    take plain loads or stores in the same kernel.
// K > kChunk takes several bin chunks (grid y), each of which stages
// k_idx and c again. The TPU kernel's compare-select-reduce over every bin
// and its re/im plane split were TPU needs and are not carried over;
// padding is masked here (t < N).
// On the H100 (PERF.md, "NVIDIA H100 80GB HBM3, 700.00 W") G=8, S=64,
// N=65536 on 64 bins takes 0.2358 ms (the first version 0.4918) against a
// bound of 0.2003 (671 MB over 3.35 TB/s); two clone() calls that move the
// inputs' 806 MB take 0.274. On 128 bins, two chunks, it takes 0.460.
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kTile = 128;   // time columns per block = threads per block
constexpr int kChunk = 64;  // bins per block: 64 x 128 x 8 B = 64 KB of shared memory
constexpr int kStageRows = 4;       // s-rows a ring stage
constexpr int kStages = 4;      // ring stages: 24 KB beside the plane, two blocks an SM

// Shared bytes of a block, mirrored by ops/cuda_reassign.py::k6_smem_bytes:
// the plane of min(K, kChunk) bin rows, the ring of contributions, the ring
// of indices, the stages' mbarriers.
constexpr int smem_bytes(int K) {
  return (K < kChunk ? K : kChunk) * kTile * 8 + kStages * kStageRows * kTile * 12 + kStages * 8;
}

__global__ void __launch_bounds__(kTile)
reassign_kernel(const float2* __restrict__ c, const int* __restrict__ k_idx,
                float2* __restrict__ out, int S, int N, int K, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows_p = min(K, kChunk);
  float2* plane = reinterpret_cast<float2*>(smem);
  float2* ring_c = plane + rows_p * kTile;
  int* ring_k = reinterpret_cast<int*>(ring_c + kStages * kStageRows * kTile);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_k + kStages * kStageRows * kTile);
  const int tid = threadIdx.x;
  const int g = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - g * tiles) * kTile;
  const int t = t0 + tid;
  const int k0 = blockIdx.y * kChunk;
  const int kc = min(kChunk, K - k0);
  const bool whole = t0 + kTile <= N;
  const bool bulk_in = whole && (N & 3) == 0 &&
                       ((reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(k_idx)) & 15) == 0;
  const bool bulk_out = whole && (N & 1) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const long long base = (long long)g * S * N + t0;
  float2* col = plane + tid;
  if (bulk_in) {
    const int iters = (S + kStageRows - 1) / kStageRows;
    // stage `it` of the s loop: rows it*kStageRows .. of the tile into ring slot it % kStages
    auto fill = [&](int it) {
      const int st = it % kStages;
      const int rows = min(kStageRows, S - it * kStageRows);
      jw::mbar_expect(&full[st], (uint32_t)rows * kTile * 12);
      for (int rr = 0; rr < rows; ++rr) {
        const long long at = base + (long long)(it * kStageRows + rr) * N;
        jw::bulk_copy(ring_c + (st * kStageRows + rr) * kTile, c + at, kTile * 8, &full[st]);
        jw::bulk_copy(ring_k + (st * kStageRows + rr) * kTile, k_idx + at, kTile * 4, &full[st]);
      }
    };
    if (tid == 0)
      for (int st = 0; st < kStages; ++st) jw::mbar_init(&full[st]);
    __syncthreads();
    if (tid == 0)
      for (int it = 0; it < min(kStages, iters); ++it) fill(it);
    for (int kk = 0; kk < kc; ++kk) col[kk * kTile] = make_float2(0.f, 0.f);
    for (int it = 0; it < iters; ++it) {
      const int st = it % kStages;
      const int rows = min(kStageRows, S - it * kStageRows);
      jw::mbar_wait(&full[st], (it / kStages) & 1);
#pragma unroll
      for (int rr = 0; rr < kStageRows; ++rr) {
        if (rr < rows) {
          const unsigned kk = (unsigned)(ring_k[(st * kStageRows + rr) * kTile + tid] - k0);
          const float2 v = ring_c[(st * kStageRows + rr) * kTile + tid];
          if (kk < (unsigned)kc) {
            float2 acc = col[kk * kTile];
            acc.x += v.x;
            acc.y += v.y;
            col[kk * kTile] = acc;
          }
        }
      }
      __syncthreads();  // every thread has read slot st: it may be filled again
      if (tid == 0 && it + kStages < iters) fill(it + kStages);
    }
  } else if (t < N) {
    for (int kk = 0; kk < kc; ++kk) col[kk * kTile] = make_float2(0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      const long long at = base + tid + (long long)s * N;
      const unsigned kk = (unsigned)(__ldg(k_idx + at) - k0);
      const float2 v = __ldg(c + at);
      if (kk < (unsigned)kc) {
        float2 acc = col[kk * kTile];
        acc.x += v.x;
        acc.y += v.y;
        col[kk * kTile] = acc;
      }
    }
  }
  float2* o = out + ((long long)g * K + k0) * N + t0;
  if (bulk_out) {
    jw::fence_async_smem();
    __syncthreads();
    if (tid == 0) {
      for (int kk = 0; kk < kc; ++kk)
        jw::bulk_store(o + (long long)kk * N, plane + kk * kTile, kTile * 8);
      jw::bulk_commit();
      jw::bulk_wait_read<0>();  // the plane outlives the stores
    }
  } else if (t < N) {
    for (int kk = 0; kk < kc; ++kk) o[(long long)kk * N + tid] = col[kk * kTile];
  }
}

}  // namespace

extern "C" {

const char* jw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int jw_reassign(const void* c, const void* k_idx, void* out, int G, int S, int N, int K,
                void* stream) {
  cudaGetLastError();
  const int smem = smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(reassign_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N + kTile - 1) / kTile;
  const dim3 grid((unsigned)G * tiles, (K + kChunk - 1) / kChunk);
  reassign_kernel<<<grid, kTile, smem, (cudaStream_t)stream>>>(
      (const float2*)c, (const int*)k_idx, (float2*)out, S, N, K, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
