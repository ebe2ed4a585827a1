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
// Design: a block owns one batch row g, a tile of kTile time columns and a
// chunk of kc <= kChunk bins. Each thread owns one column: it zeroes its
// column of a kc x kTile float2 plane in shared memory, walks s = 0..S-1
// reading k_idx and (only where the bin falls in the chunk) the
// contribution, coalesced along t, adds into its own column, then writes the
// column out. No two threads touch the same plane entry, so there are no
// atomics and no barriers, and the sum runs in ascending s: deterministic,
// and in the order of the plain scatter version. K > kChunk takes several
// bin chunks (grid y), each of which re-reads k_idx. The TPU kernel's
// compare-select-reduce over every bin and its re/im plane split were TPU
// needs and are not carried over; padding is masked here (t < N).
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;   // time columns per block = threads per block
constexpr int kChunk = 64;   // bins per block: 64 x 128 x 8 B = 64 KB of shared memory

__global__ void __launch_bounds__(kTile)
reassign_kernel(const float2* __restrict__ c, const int* __restrict__ k_idx,
                float2* __restrict__ out, int S, int N, int K, int tiles) {
  extern __shared__ float2 plane[];
  const int g = blockIdx.x / tiles;
  const int t = (blockIdx.x - g * tiles) * kTile + threadIdx.x;
  const int k0 = blockIdx.y * kChunk;
  const int kc = min(kChunk, K - k0);
  if (t >= N) return;
  float2* col = plane + threadIdx.x;
  for (int kk = 0; kk < kc; ++kk) col[kk * kTile] = make_float2(0.f, 0.f);
  const long long base = (long long)g * S * N + t;
#pragma unroll 4
  for (int s = 0; s < S; ++s) {
    const long long at = base + (long long)s * N;
    const unsigned kk = (unsigned)(__ldg(k_idx + at) - k0);
    if (kk < (unsigned)kc) {
      const float2 v = __ldg(c + at);
      float2 acc = col[kk * kTile];
      acc.x += v.x;
      acc.y += v.y;
      col[kk * kTile] = acc;
    }
  }
  float2* o = out + ((long long)g * K + k0) * N + t;
  for (int kk = 0; kk < kc; ++kk) o[(long long)kk * N] = col[kk * kTile];
}

}  // namespace

extern "C" {

const char* jw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int jw_reassign(const void* c, const void* k_idx, void* out, int G, int S, int N, int K,
                void* stream) {
  cudaGetLastError();
  const int smem = kChunk * kTile * (int)sizeof(float2);
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
