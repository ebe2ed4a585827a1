// K1 and K2: the MODWT cascade, forward and inverse, for Hopper (sm_90a).
//
// Replaces: jwave_tpu/ops/pallas_modwt.py::_modwt_kernel (K1) and
// ::_imodwt_kernel (K2). Both compute, for levels j with gap 2^(j-1),
//   forward  W_j[t] = sum_m h0[m] V_{j-1}[(t - m*gap) mod N],  V_j likewise with g0
//   inverse  V_{j-1}[t] = sum_m g0[m] V_j[(t + m*gap) mod N] + h0[m] W_j[(t + m*gap) mod N]
// with f32 accumulation over f32 or bf16 storage.
//
// Bound on this card: bytes. Each level does 2M FMAs per sample against one
// read of the input and one write of each of the J+1 output rows (the
// minimum traffic); for db4 (M=8) that is ~16 FMAs per 4-byte sample per
// level, far under the H100's flop/byte balance.
//
// Design: the Pallas kernel keeps a whole row in VMEM across all levels; a
// 65536-sample f32 row (256 KB) does not fit one block's shared memory. So
// the time axis is tiled: a block owns `tile` outputs of one row and stages
// the tile plus a halo of (M-1)(2^j1 - 2^(j0-1)) samples (left for K1, right
// for K2) in shared memory, runs the levels j0..j1 there, and writes each
// row of its tile once. Indices are taken mod N, so a halo longer than the
// row wraps as often as it must. When the halo of a run of levels does not
// fit, the host splits the levels into groups that pass V through an f32
// scratch row; a level whose halo alone does not fit runs unstaged, reading
// device memory (L2) directly. One block per (row, tile) fills the card even
// at 64 rows.
//
// K2 reads J+1 rows to write one, so what bounds it is how many bytes are in
// flight: the first version staged each level's W segment with scalar loads
// only when the level before it was done (8 KB in flight per SM at most),
// and spent 2M shared loads per output. The design here:
//  - at the block's start one thread starts bulk copies (TMA,
//    cp.async.bulk) of the V_j1 segment and of every W_j segment the group
//    needs, each into its own buffer with its own mbarrier, in storage type
//    (bf16 stays bf16 in shared memory); level j waits only for its own
//    stage, so W_{j-1}..W_j0 are in flight while level j computes, as the
//    Pallas kernel's double buffer overlapped them on the TPU (a 2048 tile
//    at db4 L5: 6 segments, 68 KB a block, three blocks an SM);
//  - a segment is copied in whole 16 bytes (its length rounded up), in
//    pieces where it wraps past N (many when the halo exceeds N); a piece
//    whose global and shared addresses disagree mod 16 (unaligned N) is
//    loaded by all threads with plain loads, in the same kernel. A plain
//    load of a ragged tail held every block for one load latency a stage;
//  - each thread computes kR = 9 outputs spaced by the level's gap, so the
//    M + kR - 1 samples of V and W it reads serve all of them from
//    registers (~4 shared loads an output, not 2M); kR is odd, so the
//    threads of a warp hit distinct banks at every gap; db4's 8 taps
//    unroll at compile time, other lengths slide a window over the taps;
//  - V ping-pongs between two f32 buffers; the last level's tile leaves
//    with 16-byte stores.
// On the H100 (PERF.md) K2 takes about a plain reduction over the same
// bytes (chip_smoke.py prints both) plus its levels' FMAs: the blocks of an
// SM start together and stay in step, so their arithmetic does not hide
// behind one another's copies. A persistent grid that fills a second stage
// set for the next tile while computing this one was slower (one 121 KB
// block an SM: too few warps for the arithmetic).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "async_copy.cuh"

namespace {

constexpr int kMaxTaps = 64;
constexpr int kThreads = 256;  // K1 (K2 has kInvThreads)

__device__ __forceinline__ float load_f(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ long long wrap(long long t, long long n) {
  long long r = t % n;
  return r < 0 ? r + n : r;
}

// Forward levels j0..j1 of one (row, tile). `src` holds V_{j0-1} as rows of
// n samples; W_j goes to row j-1 of `out` (rows x (levels+1) x n); V_{j1}
// goes to row `levels` of `out` when j1 == levels, else to `vnext` (rows x n).
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
modwt_fwd_kernel(const Tin* __restrict__ src, Tout* __restrict__ out,
                 float* __restrict__ vnext, const float* __restrict__ taps,
                 int n, int m, int levels, int j0, int j1, int tile, int tiles,
                 int staged) {
  extern __shared__ __align__(16) float smem[];
  float* g = smem;
  float* h = smem + kMaxTaps;
  const long long row = blockIdx.x / tiles;
  const long long t0 = (long long)(blockIdx.x % tiles) * tile;
  const int tl = (int)min((long long)tile, (long long)n - t0);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    g[i] = taps[i];
    h[i] = taps[m + i];
  }
  __syncthreads();
  const Tin* x = src + row * n;
  Tout* orow = out + row * (long long)(levels + 1) * n;
  float* vrow = vnext ? vnext + row * n : nullptr;

  if (!staged) {  // one level (j0 == j1), read straight from device memory
    const long long gap = 1LL << (j0 - 1);
    for (int p = threadIdx.x; p < tl; p += blockDim.x) {
      const long long t = t0 + p;
      float aw = 0.f, av = 0.f;
      for (int k = 0; k < m; ++k) {
        const float v = load_f(x, wrap(t - k * gap, n));
        aw = fmaf(h[k], v, aw);
        av = fmaf(g[k], v, av);
      }
      store_f(orow, (long long)(j0 - 1) * n + t, aw);
      if (j1 == levels) store_f(orow, (long long)levels * n + t, av);
      else vrow[t] = av;
    }
    return;
  }

  // buffer index p holds time t0 - halo + p
  const int halo = (m - 1) * ((1 << j1) - (1 << (j0 - 1)));
  const int len = halo + tl;
  float* cur = smem + 2 * kMaxTaps;
  float* nxt = cur + len;
  const long long start = wrap(t0 - halo, n);
  for (int p = threadIdx.x; p < len; p += blockDim.x) {
    long long idx = start + p;
    if (idx >= n) idx %= n;
    cur[p] = load_f(x, idx);
  }
  __syncthreads();
  int rem = halo;  // cur is valid on [halo - rem, len)
  for (int j = j0; j <= j1; ++j) {
    const int gap = 1 << (j - 1);
    rem -= (m - 1) * gap;
    const long long wbase = (long long)(j - 1) * n + t0 - halo;
    for (int p = halo - rem + threadIdx.x; p < len; p += blockDim.x) {
      float aw = 0.f, av = 0.f;
      for (int k = 0; k < m; ++k) {
        const float v = cur[p - k * gap];
        aw = fmaf(h[k], v, aw);
        av = fmaf(g[k], v, av);
      }
      nxt[p] = av;
      if (p >= halo) store_f(orow, wbase + p, aw);
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int p = threadIdx.x; p < tl; p += blockDim.x) {
    const long long t = t0 + p;
    if (j1 == levels) store_f(orow, (long long)levels * n + t, cur[halo + p]);
    else vrow[t] = cur[halo + p];
  }
}

// ---- K2's staged plan, mirrored by ops/cuda_modwt.py::k2_smem_bytes ----
// Shared memory of a staged K2 block: the taps (512 B) and 16 mbarriers
// (128 B), then, each rounded up to 16 bytes, the V_j1 segment (Tv), the
// W_j segments for j = j1..j0 (Tc) and two f32 V buffers (one when the
// group has one level).
constexpr int kInvThreads = 128;
constexpr int kInvTapBytes = 2 * kMaxTaps * sizeof(float);
constexpr int kInvHeadBytes = kInvTapBytes + 16 * sizeof(uint64_t);
constexpr int kR = 9;  // outputs per thread and level, spaced by the gap

struct InvLayout {
  int len;     // the tile plus its halo: V_j1's segment
  int v0, w;   // byte offsets: V_j1, then W_j1 .. W_j0 one after another
  int f0, f1;  // the f32 V buffers
  int bytes;
};

__host__ __device__ inline int round16(int b) { return (b + 15) & ~15; }

// samples of W_j a group (j0..j1) reads: level j's outputs and their taps
__host__ __device__ inline int inv_wlen(int tl, int m, int j0, int j) {
  return tl + (m - 1) * ((1 << j) - (1 << (j0 - 1)));
}

__host__ __device__ inline InvLayout inv_layout(int tl, int m, int j0, int j1, int es_v,
                                                int es_c) {
  InvLayout L;
  L.len = inv_wlen(tl, m, j0, j1);
  L.v0 = kInvHeadBytes;
  L.w = L.v0 + round16(L.len * es_v);
  int off = L.w;
  for (int j = j1; j >= j0; --j) off += round16(inv_wlen(tl, m, j0, j) * es_c);
  const int flen = inv_wlen(tl, m, j0, j1 - 1);  // level j1's outputs
  L.f0 = off;
  off += round16(flen * (int)sizeof(float));
  L.f1 = off;
  if (j1 > j0) off += round16(flen * (int)sizeof(float));
  L.bytes = off;
  return L;
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

__device__ __forceinline__ float ld_s(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float ld_s(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

// One inverse level in shared memory: nxt[p] = sum_k g[k] cur[p + k*gap] +
// h[k] w[p + k*gap] for p < valid - (m-1)*gap. A thread takes kR outputs
// p, p + gap, ..., which read kR + M - 1 samples of cur and of w between
// them; reads past `valid` (only for outputs that are not stored) clamp.
// With the filter length MT known at compile time the samples are read
// once into registers and the taps unroll; MT = 0 takes any length and
// slides a window of kR samples over the taps.
template <int MT, typename TV, typename TW>
__device__ void inv_level_m(const TV* cur, const TW* w, float* nxt, int valid, int gap, int m,
                            const float* g, const float* h) {
  const int out_len = valid - (m - 1) * gap;
  const int span = gap * kR;
  const int lg_gap = __ffs(gap) - 1;
  const int groups = ((out_len + span - 1) / span) << lg_gap;
  for (int b = threadIdx.x; b < groups; b += blockDim.x) {
    const int p = (b >> lg_gap) * span + (b & (gap - 1));
    float acc[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[r] = 0.f;
    if constexpr (MT > 0) {
      constexpr int kW = kR + MT - 1;
      float wv[kW], ww[kW];
#pragma unroll
      for (int q = 0; q < kW; ++q) {
        const int qq = min(p + q * gap, valid - 1);
        wv[q] = ld_s(cur, qq);
        ww[q] = ld_s(w, qq);
      }
#pragma unroll
      for (int k = 0; k < MT; ++k) {
        const float gk = g[k], hk = h[k];
#pragma unroll
        for (int r = 0; r < kR; ++r) acc[r] = fmaf(hk, ww[r + k], fmaf(gk, wv[r + k], acc[r]));
      }
    } else {
      float wv[kR], ww[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int q = min(p + r * gap, valid - 1);
        wv[r] = ld_s(cur, q);
        ww[r] = ld_s(w, q);
      }
      for (int k = 0; k < m; ++k) {
        const float gk = g[k], hk = h[k];
#pragma unroll
        for (int r = 0; r < kR; ++r) acc[r] = fmaf(hk, ww[r], fmaf(gk, wv[r], acc[r]));
        if (k + 1 < m) {
#pragma unroll
          for (int r = 0; r < kR - 1; ++r) {
            wv[r] = wv[r + 1];
            ww[r] = ww[r + 1];
          }
          const int q = min(p + (k + kR) * gap, valid - 1);
          wv[kR - 1] = ld_s(cur, q);
          ww[kR - 1] = ld_s(w, q);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (p + r * gap < out_len) nxt[p + r * gap] = acc[r];
  }
}

// The filter length whose taps unroll at compile time: db4's 8, the main
// path, where the unrolled body takes 0.72x the generic one's time on the
// H100 (64x65536 L5, PERF.md). Every other length takes the generic body.
// Built with -DJW_K2_UNROLLED_TAPS=0, db4 takes it too (tools/ab_times.py
// times the two against each other).
#ifndef JW_K2_UNROLLED_TAPS
#define JW_K2_UNROLLED_TAPS 8
#endif

template <typename TV, typename TW>
__device__ void inv_level(const TV* cur, const TW* w, float* nxt, int valid, int gap, int m,
                          const float* g, const float* h) {
  if (JW_K2_UNROLLED_TAPS > 0 && m == JW_K2_UNROLLED_TAPS)
    inv_level_m<JW_K2_UNROLLED_TAPS>(cur, w, nxt, valid, gap, m, g, h);
  else
    inv_level_m<0>(cur, w, nxt, valid, gap, m, g, h);
}

// dst[0, tl) = src[0, tl) (f32 in shared memory), 16 bytes a store where
// dst is 16-byte aligned, the ragged tail (and an unaligned dst) by scalars.
template <typename TO>
__device__ void store_tile(TO* dst, const float* src, int tl) {
  constexpr int kVec = 16 / sizeof(TO);
  const int nvec = (reinterpret_cast<uintptr_t>(dst) & 15) == 0 ? tl / kVec : 0;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    if constexpr (sizeof(TO) == 4) {
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    } else {
      const float4 a = reinterpret_cast<const float4*>(src)[2 * i];
      const float4 b = reinterpret_cast<const float4*>(src)[2 * i + 1];
      __align__(16) __nv_bfloat162 q[4] = {__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
                             __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
      reinterpret_cast<uint4*>(dst)[i] = *reinterpret_cast<const uint4*>(q);
    }
  }
  for (int i = nvec * kVec + threadIdx.x; i < tl; i += blockDim.x) store_f(dst, i, src[i]);
}

// Inverse levels j1 down to j0 of one (row, tile). V_{j1} comes from `vsrc`
// (row stride `vstride`); W_j from row j-1 of `coeffs` (rows x (levels+1) x n).
// V_{j0-1} goes to `out` (rows x n) when j0 == 1, else to `vnext` (rows x n).
template <typename Tc, typename Tv>
__global__ void __launch_bounds__(kInvThreads)
modwt_inv_kernel(const Tc* __restrict__ coeffs, const Tv* __restrict__ vsrc,
                 long long vstride, Tc* __restrict__ out, float* __restrict__ vnext,
                 const float* __restrict__ taps, int n, int m, int levels, int j0,
                 int j1, int tile, int tiles, int staged) {
  extern __shared__ __align__(16) float smem[];
  float* g = smem;
  float* h = smem + kMaxTaps;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    g[i] = taps[i];
    h[i] = taps[m + i];
  }
  __syncthreads();

  if (!staged) {  // one level (j0 == j1) of one (row, tile) a block, from device memory
    const long long row = blockIdx.x / tiles;
    const long long t0 = (long long)(blockIdx.x % tiles) * tile;
    const int tl = (int)min((long long)tile, (long long)n - t0);
    const Tc* crow = coeffs + row * (long long)(levels + 1) * n;
    const Tv* v = vsrc + row * vstride;
    const long long gap = 1LL << (j0 - 1);
    const Tc* w = crow + (long long)(j0 - 1) * n;
    for (int p = threadIdx.x; p < tl; p += blockDim.x) {
      const long long t = t0 + p;
      float acc = 0.f;
      for (int k = 0; k < m; ++k) {
        const long long idx = wrap(t + k * gap, n);
        acc = fmaf(g[k], load_f(v, idx), acc);
        acc = fmaf(h[k], load_f(w, idx), acc);
      }
      if (j0 == 1) store_f(out, row * n + t, acc);
      else vnext[row * n + t] = acc;
    }
    return;
  }

  // one (row, tile) a block; buffer index p holds time t0 + p. See the
  // header for the design.
  const long long row = blockIdx.x / tiles;
  const long long t0 = (long long)(blockIdx.x % tiles) * tile;
  const int tl = (int)min((long long)tile, (long long)n - t0);
  const Tc* crow = coeffs + row * (long long)(levels + 1) * n;
  const InvLayout L = inv_layout(tl, m, j0, j1, sizeof(Tv), sizeof(Tc));
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + kInvTapBytes);  // 0: V_j1, 1 + j1 - j: W_j
  const Tv* v0 = reinterpret_cast<const Tv*>(base + L.v0);
  float* cur = reinterpret_cast<float*>(base + L.f1);  // V_j for j < j1
  float* nxt = reinterpret_cast<float*>(base + L.f0);
  if (threadIdx.x == 0)
    for (int q = 0; q <= j1 - j0 + 1; ++q) jw::mbar_init(&bars[q]);
  __syncthreads();
  stage_segment(reinterpret_cast<Tv*>(base + L.v0), vsrc + row * vstride, t0, L.len, n, &bars[0]);
  for (int j = j1, off = L.w; j >= j0; off += round16(inv_wlen(tl, m, j0, j) * sizeof(Tc)), --j)
    stage_segment(reinterpret_cast<Tc*>(base + off), crow + (long long)(j - 1) * n, t0,
                  inv_wlen(tl, m, j0, j), n, &bars[1 + j1 - j]);
  __syncthreads();  // the plain-loaded parts of every stage
  jw::mbar_wait(&bars[0], 0);
  int valid = L.len;  // V_j is valid on [0, valid)
  for (int j = j1, off = L.w; j >= j0; off += round16(inv_wlen(tl, m, j0, j) * sizeof(Tc)), --j) {
    const int gap = 1 << (j - 1);
    const Tc* wj = reinterpret_cast<const Tc*>(base + off);
    jw::mbar_wait(&bars[1 + j1 - j], 0);
    if (j == j1) inv_level(v0, wj, nxt, valid, gap, m, g, h);
    else inv_level(static_cast<const float*>(cur), wj, nxt, valid, gap, m, g, h);
    __syncthreads();
    valid -= (m - 1) * gap;
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (j0 == 1) store_tile(out + row * n + t0, static_cast<const float*>(cur), tl);
  else store_tile(vnext + row * n + t0, static_cast<const float*>(cur), tl);
}

int smem_bytes(int halo, int tile, int staged) {  // K1: two f32 buffers of tile + halo
  const int len = staged ? halo + tile : 0;
  return (2 * kMaxTaps + 2 * len) * (int)sizeof(float);
}

template <typename Tin, typename Tout>
int launch_fwd(const void* src, void* out, void* vnext, const void* taps, int rows, int n,
               int m, int levels, int j0, int j1, int tile, int staged, void* stream) {
  cudaGetLastError();
  const int tiles = (n + tile - 1) / tile;
  const int halo = (m - 1) * ((1 << j1) - (1 << (j0 - 1)));
  const int smem = smem_bytes(halo, tile < n ? tile : n, staged);
  auto kern = modwt_fwd_kernel<Tin, Tout>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)rows * tiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const Tin*)src, (Tout*)out, (float*)vnext, (const float*)taps, n, m, levels, j0, j1,
      tile, tiles, staged);
  return (int)cudaGetLastError();
}

template <typename Tc, typename Tv>
int launch_inv(const void* coeffs, const void* vsrc, long long vstride, void* out,
               void* vnext, const void* taps, int rows, int n, int m, int levels, int j0,
               int j1, int tile, int staged, void* stream) {
  cudaGetLastError();
  const int tiles = (n + tile - 1) / tile;
  const int smem = staged ? inv_layout(tile < n ? tile : n, m, j0, j1, sizeof(Tv), sizeof(Tc)).bytes
                          : kInvTapBytes;
  auto kern = modwt_inv_kernel<Tc, Tv>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)rows * tiles, kInvThreads, smem, (cudaStream_t)stream>>>(
      (const Tc*)coeffs, (const Tv*)vsrc, vstride, (Tc*)out, (float*)vnext,
      (const float*)taps, n, m, levels, j0, j1, tile, tiles, staged);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* jw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Forward levels j0..j1. `src` is f32 (the input, or a scratch row from an
// earlier group) for the f32 entry; for the bf16 entry it is bf16 storage
// unless src_f32 is set (a scratch row). Returns a cudaError_t.
int jw_modwt_fwd_f32(const void* src, int src_f32, void* out, void* vnext, const void* taps,
                     int rows, int n, int m, int levels, int j0, int j1, int tile,
                     int staged, void* stream) {
  (void)src_f32;
  return launch_fwd<float, float>(src, out, vnext, taps, rows, n, m, levels, j0, j1, tile,
                                  staged, stream);
}

int jw_modwt_fwd_bf16(const void* src, int src_f32, void* out, void* vnext, const void* taps,
                      int rows, int n, int m, int levels, int j0, int j1, int tile,
                      int staged, void* stream) {
  if (src_f32)
    return launch_fwd<float, __nv_bfloat16>(src, out, vnext, taps, rows, n, m, levels, j0,
                                            j1, tile, staged, stream);
  return launch_fwd<__nv_bfloat16, __nv_bfloat16>(src, out, vnext, taps, rows, n, m, levels,
                                                  j0, j1, tile, staged, stream);
}

// Inverse levels j1 down to j0. `vsrc` holds V_{j1}: row `levels` of the
// coefficients (storage type, vsrc_f32 = 0) or an f32 scratch row.
int jw_imodwt_f32(const void* coeffs, const void* vsrc, int vsrc_f32, long long vstride,
                  void* out, void* vnext, const void* taps, int rows, int n, int m,
                  int levels, int j0, int j1, int tile, int staged, void* stream) {
  (void)vsrc_f32;
  return launch_inv<float, float>(coeffs, vsrc, vstride, out, vnext, taps, rows, n, m,
                                  levels, j0, j1, tile, staged, stream);
}

int jw_imodwt_bf16(const void* coeffs, const void* vsrc, int vsrc_f32, long long vstride,
                   void* out, void* vnext, const void* taps, int rows, int n, int m,
                   int levels, int j0, int j1, int tile, int staged, void* stream) {
  if (vsrc_f32)
    return launch_inv<__nv_bfloat16, float>(coeffs, vsrc, vstride, out, vnext, taps, rows,
                                            n, m, levels, j0, j1, tile, staged, stream);
  return launch_inv<__nv_bfloat16, __nv_bfloat16>(coeffs, vsrc, vstride, out, vnext, taps,
                                                   rows, n, m, levels, j0, j1, tile, staged,
                                                   stream);
}

}  // extern "C"
