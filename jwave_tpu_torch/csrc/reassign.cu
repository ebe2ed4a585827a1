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
//
// The fused form (Phase below; ops/cuda_reassign.py::squeeze) is the same
// block with another input: the ring carries an s-row of W and one of dW
// (16 B a column, read in place from the two halves of the inverse FFT's
// (G, 2S, P) output by their row and scale strides), and each thread turns
// its column's (W, dW) into a bin and a contribution in registers with
// transforms/ssq.py::_reassign_inputs' roundings, so no (S, N) plane of
// contributions or indices is ever written. Its arithmetic (a division and
// a log a coefficient) wants more in flight than the unfused form's, so its
// ring holds 3 stages of 8 s-rows (48 KB) and a stage's bins are all
// computed before its adds. On the H100 G=2, S=64, N=2^20 on 64 bins takes
// 1.247 ms against a bound of 0.961 (W and dW read, the plane written). The
// default threshold needs each row's max |W|^2 first: ssq_peak_kernel.
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kTile = 128;   // time columns per block = threads per block
constexpr int kChunk = 64;  // bins per block: 64 x 128 x 8 B = 64 KB of shared memory
// The ring: kStages stages of kStageRows s-rows, per form (below): 24 KB
// of contributions and indices beside the plane, or 48 KB of W and dW in
// the fused form, whose arithmetic wants more rows a stage in flight; two
// blocks an SM either way

// Shared bytes of a block of form In, mirrored by
// ops/cuda_reassign.py::k6_smem_bytes: the plane of min(K, kChunk) bin rows,
// the ring (12 B a column and s-row of contributions and indices, 16 B of W
// and dW) and the stages' mbarriers.
template <class In>
constexpr int smem_bytes(int K) {
  return (K < kChunk ? K : kChunk) * kTile * 8 +
         In::kStages * In::kStageRows * kTile * (8 + (int)sizeof(typename In::B)) +
         In::kStages * 8;
}

// The unfused form's input: contributions c and bin indices k_idx, each a
// contiguous (G, S, N) tensor.
struct Stored {
  using B = int;  // the ring's second plane
  static constexpr int kStageRows = 4, kStages = 4;
  static constexpr bool kBinsFirst = false;  // a row's load, then its add
  struct Block {};
  const float2* c;
  const int* k_idx;
  int S, N;
  __device__ bool bulk() const {
    return (N & 3) == 0 &&
           ((reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(k_idx)) & 15) == 0;
  }
  __device__ long long at(int g, int s, int t) const { return ((long long)g * S + s) * N + t; }
  __device__ const float2* a(long long i) const { return c + i; }
  __device__ const int* b(long long i) const { return k_idx + i; }
  __device__ Block prepare(int) const { return {}; }
  // the bin of one (s, t) and its contribution
  __device__ int item(const Block&, int, float2 a, int b, float2& v) const {
    v = a;
    return b;
  }
};

// The fused form's input: W and dW, (G, S, N) views with one row stride, one
// scale stride and unit time stride (the two halves of the inverse FFT's
// (G, 2S, P) output, read in place), and what the phase transform and the
// bin index take. kEdges: a grid searched by its K + 1 edges (else the affine
// map of a log-uniform grid); kDrop: out_of_range "drop" (else "clip").
template <bool kEdges, bool kDrop>
struct Phase {
  using B = float2;
  static constexpr int kStageRows = 8, kStages = 3;
  static constexpr bool kBinsFirst = true;  // a stage's bins, then its adds
  struct Block {
    float thr2;  // the row's squared |W| threshold
  };
  const float2* w;
  const float2* dw;
  long long row_stride, scale_stride;  // in complex elements
  const float* wgt;                    // (S,) a^-1/2 dln(a)
  const float* thr;  // (G,): max |W|^2 of the row (from_peak), or the row's |W| threshold
  int from_peak;
  float peak_scale;  // the threshold is peak_scale * sqrt(max |W|^2)
  float f_lo;        // the lowest bin's frequency, the stand-in of a coefficient not kept
  float log_f0, inv_dlf;  // ln f_0 and 1 / d ln f of a log-uniform grid
  float inv_2pi;
  const float* edges;  // (K + 1,) edges of another grid, searched through the L1
  int K;
  __device__ bool bulk() const {
    return (((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(dw)) & 15) |
            ((row_stride | scale_stride) & 1)) == 0;
  }
  __device__ long long at(int g, int s, int t) const {
    return g * row_stride + s * scale_stride + t;
  }
  __device__ const float2* a(long long i) const { return w + i; }
  __device__ const float2* b(long long i) const { return dw + i; }
  // the row's squared threshold
  __device__ Block prepare(int g) const {
    float gam = __ldg(thr + g);
    if (from_peak) gam = __fmul_rn(peak_scale, __fsqrt_rn(gam));
    return {__fmul_rn(gam, gam)};
  }
  // transforms/ssq.py::_reassign_inputs for one (s, t) in its order of
  // operations, each rounded as torch's eager kernels round it (measured on
  // the H100 against torch 2.11, PERF.md): a division by a Python float is a
  // product with its float32 reciprocal there, and the complex product
  // (a + bi)(c + di) forms its imaginary part as fma(a, d, b c)
  __device__ int item(const Block& blk, int s, float2 x, float2 d, float2& v) const {
    const float mag2 = __fadd_rn(__fmul_rn(x.x, x.x), __fmul_rn(x.y, x.y));
    const float cross = __fmaf_rn(d.x, -x.y, __fmul_rn(d.y, x.x));  // Im(dW conj W)
    const float f = __fmul_rn(__fdiv_rn(cross, mag2 > 0.f ? mag2 : 1.f), inv_2pi);
    bool keep = mag2 > blk.thr2;
    if (kDrop) keep = keep && f > 0.f;
    const float safe_f = keep && f > 0.f ? f : f_lo;
    int k;
    if (kEdges) {  // searchsorted(edges, f, side="left") - 1
      int lo = 0, hi = K + 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(edges + mid) < safe_f) lo = mid + 1;
        else hi = mid;
      }
      k = lo - 1;
    } else {  // round half to even
      k = __float2int_rz(rintf(__fmul_rn(__fsub_rn(logf(safe_f), log_f0), inv_dlf)));
    }
    if (kDrop) k = keep && k >= 0 && k < K ? k : K;
    else k = keep ? min(max(k, 0), K - 1) : K;
    const float ws = __ldg(wgt + s);
    v = make_float2(__fmul_rn(x.x, ws), __fmul_rn(x.y, ws));
    return k;
  }
};

template <class In>
__global__ void __launch_bounds__(kTile)
reassign_kernel(In in, float2* __restrict__ out, int S, int N, int K, int tiles) {
  using B = typename In::B;
  constexpr int kStageRows = In::kStageRows, kStages = In::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows_p = min(K, kChunk);
  float2* plane = reinterpret_cast<float2*>(smem);
  float2* ring_a = plane + rows_p * kTile;
  B* ring_b = reinterpret_cast<B*>(ring_a + kStages * kStageRows * kTile);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_b + kStages * kStageRows * kTile);
  const int tid = threadIdx.x;
  const int g = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - g * tiles) * kTile;
  const int t = t0 + tid;
  const int k0 = blockIdx.y * kChunk;
  const int kc = min(kChunk, K - k0);
  const bool whole = t0 + kTile <= N;
  const bool bulk_in = whole && in.bulk();
  const bool bulk_out = whole && (N & 1) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  float2* col = plane + tid;
  const typename In::Block blk = in.prepare(g);
  auto add = [&](int bin, float2 v) {
    const unsigned kk = (unsigned)(bin - k0);
    if (kk < (unsigned)kc) {
      float2 acc = col[kk * kTile];
      acc.x += v.x;
      acc.y += v.y;
      col[kk * kTile] = acc;
    }
  };
  if (bulk_in) {
    const int iters = (S + kStageRows - 1) / kStageRows;
    // stage `it` of the s loop: rows it*kStageRows .. of the tile into ring slot it % kStages
    auto fill = [&](int it) {
      const int st = it % kStages;
      const int rows = min(kStageRows, S - it * kStageRows);
      jw::mbar_expect(&full[st], (uint32_t)rows * kTile * (8 + sizeof(B)));
      for (int rr = 0; rr < rows; ++rr) {
        const long long at = in.at(g, it * kStageRows + rr, t0);
        jw::bulk_copy(ring_a + (st * kStageRows + rr) * kTile, in.a(at), kTile * 8, &full[st]);
        jw::bulk_copy(ring_b + (st * kStageRows + rr) * kTile, in.b(at), kTile * sizeof(B),
                      &full[st]);
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
      if constexpr (In::kBinsFirst) {
        // every row's bin first, then the adds: the rows' loads and arithmetic
        // overlap, which the adds to shared memory would otherwise order
        int bin[kStageRows];
        float2 v[kStageRows];
#pragma unroll
        for (int rr = 0; rr < kStageRows; ++rr) {
          const int at = (st * kStageRows + rr) * kTile + tid;
          v[rr] = make_float2(0.f, 0.f);
          bin[rr] = rr < rows ? in.item(blk, it * kStageRows + rr, ring_a[at], ring_b[at], v[rr])
                              : K;
        }
#pragma unroll
        for (int rr = 0; rr < kStageRows; ++rr) add(bin[rr], v[rr]);
      } else {
#pragma unroll
        for (int rr = 0; rr < kStageRows; ++rr) {
          if (rr < rows) {
            const int at = (st * kStageRows + rr) * kTile + tid;
            float2 v;
            const int bin = in.item(blk, it * kStageRows + rr, ring_a[at], ring_b[at], v);
            add(bin, v);
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
      const long long at = in.at(g, s, t);
      float2 v;
      const int bin = in.item(blk, s, __ldg(in.a(at)), __ldg(in.b(at)), v);
      add(bin, v);
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

// The default threshold's peak: max over (s, t) of |W|^2 = re^2 + im^2 (each
// rounded as torch's eager pow and add round them) for each row g, into
// peak[g] as the float's bits by atomicMax; the caller zeroes peak first.
// The values are >= +0, whose bits order as the floats do; a NaN enters as
// the largest pattern below the sign bit, so it wins as torch.amax's NaN
// does, and +inf wins over every finite value. A block takes kPeakCols
// columns of one (g, s) row, kPeakThreads threads two columns a load.
constexpr int kPeakThreads = 256;
constexpr int kPeakCols = 4096;

__device__ __forceinline__ float peak_of(float m, float v) {
  return (v != v || v > m) ? v : m;  // NaN sticks
}

__global__ void __launch_bounds__(kPeakThreads)
ssq_peak_kernel(const float2* __restrict__ w, long long row_stride, long long scale_stride,
                int S, int N, int tiles, unsigned* __restrict__ peak) {
  __shared__ float warp_max[kPeakThreads / 32];
  const int per_row = S * tiles;
  const int g = blockIdx.x / per_row;
  const int s = (blockIdx.x - g * per_row) / tiles;
  const int t0 = (blockIdx.x - g * per_row - s * tiles) * kPeakCols;
  const float2* row = w + g * row_stride + s * scale_stride;
  const int end = min(N, t0 + kPeakCols);
  float m = 0.f;
  auto mag2 = [](float2 x) { return __fadd_rn(__fmul_rn(x.x, x.x), __fmul_rn(x.y, x.y)); };
  if (((reinterpret_cast<uintptr_t>(row) + 8ll * t0) & 15) == 0) {
    const int pairs = (end - t0) / 2;
    const float4* r4 = reinterpret_cast<const float4*>(row + t0);
    for (int i = threadIdx.x; i < pairs; i += kPeakThreads) {
      const float4 v = __ldg(r4 + i);
      m = peak_of(m, mag2(make_float2(v.x, v.y)));
      m = peak_of(m, mag2(make_float2(v.z, v.w)));
    }
    if (threadIdx.x == 0 && t0 + 2 * pairs < end) m = peak_of(m, mag2(__ldg(row + end - 1)));
  } else {
    for (int t = t0 + threadIdx.x; t < end; t += kPeakThreads) m = peak_of(m, mag2(__ldg(row + t)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = peak_of(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kPeakThreads / 32; ++i) m = peak_of(m, warp_max[i]);
    atomicMax(peak + g, m != m ? 0x7fffffffu : __float_as_uint(m));
  }
}

template <class In>
int launch(const In& in, void* out, int G, int S, int N, int K, void* stream) {
  const int smem = smem_bytes<In>(K);
  cudaError_t err = cudaFuncSetAttribute(reassign_kernel<In>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N + kTile - 1) / kTile;
  const dim3 grid((unsigned)G * tiles, (K + kChunk - 1) / kChunk);
  reassign_kernel<In><<<grid, kTile, smem, (cudaStream_t)stream>>>(in, (float2*)out, S, N, K,
                                                                   tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* jw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int jw_reassign(const void* c, const void* k_idx, void* out, int G, int S, int N, int K,
                void* stream) {
  cudaGetLastError();
  const Stored in{(const float2*)c, (const int*)k_idx, S, N};
  return launch(in, out, G, S, N, K, stream);
}

// The fused form: W and dW in (strides in complex elements), the plane out.
// thr: G floats, each row's max |W|^2 (from_peak, as jw_ssq_peak leaves it)
// or its |W| threshold; edges: K + 1 floats, or null for the affine map.
int jw_reassign_fused(const void* w, const void* dw, long long row_stride,
                      long long scale_stride, const void* wgt, const void* thr, int from_peak,
                      float peak_scale, float f_lo, float log_f0, float inv_dlf, float inv_2pi,
                      const void* edges, int drop, void* out, int G, int S, int N, int K,
                      void* stream) {
  cudaGetLastError();
#define JW_FUSED(E, D)                                                                       \
  launch(Phase<E, D>{(const float2*)w, (const float2*)dw, row_stride, scale_stride,          \
                     (const float*)wgt, (const float*)thr, from_peak, peak_scale, f_lo,       \
                     log_f0, inv_dlf, inv_2pi, (const float*)edges, K},                       \
         out, G, S, N, K, stream)
  if (edges != nullptr) return drop ? JW_FUSED(true, true) : JW_FUSED(true, false);
  return drop ? JW_FUSED(false, true) : JW_FUSED(false, false);
#undef JW_FUSED
}

// Each row's max |W|^2 into peak (G unsigned, zeroed here first).
int jw_ssq_peak(const void* w, long long row_stride, long long scale_stride, int G, int S,
                int N, void* peak, void* stream) {
  cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(peak, 0, (size_t)G * 4, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N + kPeakCols - 1) / kPeakCols;
  ssq_peak_kernel<<<(unsigned)G * S * tiles, kPeakThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)w, row_stride, scale_stride, S, N, tiles, (unsigned*)peak);
  return (int)cudaGetLastError();
}

}  // extern "C"
