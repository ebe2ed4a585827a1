// K3 and K4: the whole FWT pyramid along each row, for Hopper (sm_90a).
//
// Replaces: jwave_tpu/ops/pallas_pyramid.py::_pyramid_rows_kernel_flat (K3,
// in-place rows, output (R, N)) and ::_pyramid_rows_kernel (K4, the same
// pyramid per row with the block written transposed, output (N, R); two K4
// passes make the 2D standard decomposition). Per row, with h = N and for
// each level done:
//   a[i] = sum_j x[(2i+j) mod h] dec_lo[j],  d[i] = sum_j x[(2i+j) mod h] dec_hi[j]
//   d -> out[h/2 : h], x <- a, h <- h/2;   finally a -> out[: h]
// giving the in-place layout [A_L | D_L | ... | D_1]. K4 takes a `gain` that
// scales each level's a and d as they are made (so the level-l details carry
// gain^l): with the synthesis filters and recon_gain it is K5's adjoint, the
// backward of ifwt2d. K3 runs with gain 1.
//
// Bound on this card: bytes. The pyramid does about 4M FMAs per sample in
// all (2M at level 1, halving after), against one read and one write of the
// row. The Pallas kernel's pair-tile matmuls exist for the TPU's MXU; here
// the butterfly is a direct FMA loop.
//
// K3's design: one block a row. Level 1 reads the row straight from device
// memory (a 64x65536 f32 batch is 16 MB and stays in the 50 MB L2); its
// approximation, half the row, lives in shared memory, and every later level
// ping-pongs between two shared buffers of h0/2 and h0/4 floats, so device
// memory sees one read of the row and one write of each output element.
// Details are stored as soon as they are computed. h0 <= 65536 fits (192 KB);
// longer rows are first cut down by single-level launches of K3 whose
// approximation goes to a scratch row.
//
// K4 and K5 stage a block of rb rows in shared memory and store it
// transposed; they share the staging (stage_rows) and the transposed store
// of staged rows (store_columns):
//  - a block's rb rows are staged by bulk copies (TMA, cp.async.bulk on one
//    mbarrier, one a row, at a stride of n + 4 floats) started at the
//    block's start, before any arithmetic; no level reads device memory.
//    Rows that are not 16-byte aligned (n < 4, an offset source) are staged
//    by plain loads in the same kernel;
//  - levels run outside, rows inside: one level's outputs for all rb rows
//    are spread over all threads, so one barrier covers rb rows and the
//    coarse levels still keep the block busy;
//  - output column k takes the rb rows as rb contiguous floats, written 16
//    bytes a thread by neighbouring threads, so a warp store fills whole
//    32-byte pieces of 16 columns (a thread writing all rb floats of its own
//    column, 32 columns a warp store, was slower on this card); the row pad
//    keeps the two threads of a column on different banks. A ragged last
//    block or a row count that is not a multiple of 4 stores scalars;
//  - one block a row block.
//
// K4. The first version read level 1 tap by tap from device memory and ran
// a block's 8 rows one after another, 48 barriers a block at db4 L6, with
// most threads idle in the coarse levels. Here a thread takes a pair index
// i of a 4-row part and makes (a, d) of each of the 4 rows from the samples
// (2i .. 2i+M-1) mod h, read two at a time as float2 (conflict-free, half
// the shared loads of stride-2 scalars), so the index arithmetic serves 4
// rows. Level 1, the largest, stores its details straight from registers to
// their columns of out (they are final), 16 bytes a thread as the
// transposed store does, while the block computes; its approximations go to
// a second buffer of rb rows of n/2 floats. Later levels read that buffer
// or the free second half of the staged rows in turns, write d to its place
// in the staged rows and a to the other buffer, so no level reads where it
// writes: one barrier a level, and no output waits in registers. At the
// end the transposed store takes the first n/2 columns. A block needs
// rb*(3n/2 + 8) floats: two blocks an SM at 2048^2 (8 rows, 99 KB).
// On the H100 (PERF.md, "NVIDIA H100 80GB HBM3, 700.00 W") one K4 pass at
// 2048^2 db4 L6 takes 0.0295 ms (the first version 0.0479) against a bound
// of 0.0100 (33.5 MB over 3.35 TB/s); K4 with no level, its staging and
// store alone, takes 0.0206. Holding each level's outputs in registers
// across a barrier and writing them back in place, as K5 does, took 0.042:
// K4's largest level is its first, with twice K5's pairs to hold.
//
// K5 replaces jwave_tpu/ops/pallas_pyramid.py::_ipyramid_rows_kernel (driven
// by _inv_axis_pass / ifwt2d_fused): the inverse pyramid of each row over
// `levels` levels, stored transposed, output (N, R); two K5 passes make the
// 2D inverse. Per level, with head h = N >> (levels-1), ..., N, a = y[:h/2]
// and d = y[h/2:h], and A, D a and d zero-upsampled:
//   x[k] = gain * sum_j (rec_lo[j] A[(k-j) mod h] + rec_hi[j] D[(k-j) mod h])
// so only taps j of k's parity contribute, each with a[((k-j) mod h) / 2].
// Bound on this card: bytes, as for K4 (33.5 MB per pass at 2048 x 2048 f32,
// 10 us at 3.35 TB/s); the ~M FMAs per output are far below the f32 rate.
// What held the first version to a tenth of that bound was latency: each
// level read its details tap by tap from device memory, one row after
// another. K5 stages as K4 does and runs each level below the last in
// place: a thread takes output pairs (2c, 2c+1), which read the same
// samples a[c - t], d[c - t] with the even and the odd taps, so a sample
// read serves two outputs; the outputs wait in registers across a barrier
// and then overwrite the head of the staged row (no second buffer: rb*(n +
// 4) floats a block). Its last level, the largest, stores straight to
// (N, R), 16 bytes a thread as store_columns does.
// At 2048^2 all 256 blocks of 8 rows are resident at once (two an SM by
// registers), so the copies, the levels and the stores run as three phases
// with little overlap; staging and storing alone (levels = 0) take longer
// than a plain copy of the same bytes (chip_smoke.py prints both).
// The TPU kernel's folded dense head, split a/d matmuls, tail roll and
// chunked contractions were MXU and Mosaic needs and are not carried over.
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kMaxTaps = 64;

// One row's pyramid: `levels` levels on the head of length h0 of row `x`.
// `store(idx, v)` receives every output element at its in-place index.
// A and B are shared scratch of h0/2 and h0/4 floats (unused when levels < 2).
// Each level's outputs are scaled by `gain`.
template <typename Store>
__device__ void pyramid_row(const float* __restrict__ x, int h0, int levels,
                            const float* lo, const float* hi, int m, float gain, float* A,
                            float* B, Store store) {
  if (levels == 0) {
    for (int i = threadIdx.x; i < h0; i += blockDim.x) store(i, x[i]);
    __syncthreads();
    return;
  }
  int h = h0;
  int half = h >> 1;
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    float sa = 0.f, sd = 0.f;
    for (int k = 0; k < m; ++k) {
      const float v = x[(2 * i + k) & (h - 1)];
      sa = fmaf(lo[k], v, sa);
      sd = fmaf(hi[k], v, sd);
    }
    sa *= gain;
    store(half + i, gain * sd);
    if (levels == 1) store(i, sa);
    else A[i] = sa;
  }
  __syncthreads();
  float* cur = A;
  float* nxt = B;
  h = half;
  for (int l = 1; l < levels; ++l) {
    half = h >> 1;
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      float sa = 0.f, sd = 0.f;
      for (int k = 0; k < m; ++k) {
        const float v = cur[(2 * i + k) & (h - 1)];
        sa = fmaf(lo[k], v, sa);
        sd = fmaf(hi[k], v, sd);
      }
      sa *= gain;
      store(half + i, gain * sd);
      if (l == levels - 1) store(i, sa);
      else nxt[i] = sa;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    h = half;
  }
}

// Final approximation (index < a_len) to `a`, everything else to `d`.
struct RowStore {
  float* d;
  float* a;
  int a_len;
  __device__ void operator()(int idx, float v) const {
    if (idx < a_len) a[idx] = v;
    else d[idx] = v;
  }
};

// The taps into shared lo[0, kMaxTaps), hi[0, kMaxTaps), zero past m (K4
// reads taps in pairs).
__device__ void load_taps(const float* taps, int m, float* lo, float* hi) {
  for (int i = threadIdx.x; i < kMaxTaps; i += blockDim.x) {
    lo[i] = i < m ? taps[i] : 0.f;
    hi[i] = i < m ? taps[m + i] : 0.f;
  }
  __syncthreads();
}

// K3: one block per row. Reads the head [0, h0) of row r of `src`; details
// go to row r of `out` at their in-place index, the final approximation to
// row r of `a_out` (which is `out` itself except when cutting a long row).
__global__ void __launch_bounds__(1024)
pyramid_rows_kernel(const float* __restrict__ src, long long src_stride,
                                    float* __restrict__ out, long long out_stride,
                                    float* __restrict__ a_out, long long a_stride,
                                    const float* __restrict__ taps, int h0, int levels,
                                    int m) {
  extern __shared__ __align__(16) float smem[];
  float* lo = smem;
  float* hi = smem + kMaxTaps;
  float* A = smem + 2 * kMaxTaps;
  float* B = A + h0 / 2;
  load_taps(taps, m, lo, hi);
  const long long r = blockIdx.x;
  RowStore st{out + r * out_stride, a_out + r * a_stride, h0 >> levels};
  pyramid_row(src + r * src_stride, h0, levels, lo, hi, m, 1.f, A, B, st);
}

// K4 and K5 limits, mirrored by ops/cuda_pyramid.py: at most kMaxRows rows
// per block; a K5 level's nr*h/2 output pairs (h <= n/2) must fit kK5Pairs
// pairs of registers of each of the block's threads; the host keeps
// rb*n <= 16384 floats.
constexpr int kMaxRows = 8;
constexpr int kK5Pairs = 8;
// shared floats before the staged rows: the taps, then the mbarrier padded
// to 16 bytes so that the rows start 16-byte aligned
constexpr int kRowsHead = 2 * kMaxTaps + 4;

// min(cnt, 4) floats of one output column to o: one 16-byte store when the
// caller vouches for alignment and a full block, else scalars
__device__ __forceinline__ void store4(float* o, const float* v, int cnt, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < cnt) o[q] = v[q];
  }
}

// Stage rows [0, nr) of y (rows of n floats) into S at a stride of ns floats:
// one bulk copy a row on `bar` when `bulk` (n % 4 == 0 and y 16-byte
// aligned), else plain loads. The caller has initialised `bar` and run a
// __syncthreads() since; on return the rows are visible to every thread.
__device__ void stage_rows(float* S, const float* y, int nr, int n, int ns, uint64_t* bar,
                           bool bulk) {
  if (bulk) {
    if (threadIdx.x == 0) {
      const uint32_t bytes = (uint32_t)n * sizeof(float);
      jw::mbar_expect(bar, bytes * nr);
      for (int rr = 0; rr < nr; ++rr) jw::bulk_copy(S + rr * ns, y + rr * n, bytes, bar);
    }
    jw::mbar_wait(bar, 0);
  } else {
    for (int i = threadIdx.x; i < nr * n; i += blockDim.x) S[i / n * ns + i % n] = y[i];
    __syncthreads();
  }
}

// The nr staged rows of S (stride ns) to columns r0 .. r0+nr-1 of out (n
// rows of `rows` floats). Output column k takes the nr rows as nr contiguous
// floats; a thread takes four of them (a quarter-row `part`), and the
// threads of one column are neighbours, so one warp store writes whole
// 32-byte pieces of few columns rather than 16 bytes of 32 columns.
__device__ void store_columns(float* out, const float* S, int ns, int n, int nr, int rows,
                              int r0, bool vec4) {
  const int lg_parts = nr > 4 ? 1 : 0;  // 4-row parts of a column: 1 or 2
  for (int idx = threadIdx.x; idx < n << lg_parts; idx += blockDim.x) {
    const int k = idx >> lg_parts, r4 = 4 * (idx & lg_parts);
    float col[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) col[q] = r4 + q < nr ? S[(r4 + q) * ns + k] : 0.f;
    store4(out + (long long)k * rows + r0 + r4, col, nr - r4, vec4);
  }
}

// K4: one block per `rb` rows of (rows, n); output (n, rows) transposed.
// See the header for the design.
__global__ void __launch_bounds__(512)
pyramid_rows_t_kernel(const float* __restrict__ src, float* __restrict__ out,
                      const float* __restrict__ taps, int rows, int n, int levels, int m,
                      int rb, float gain) {
  extern __shared__ __align__(16) float smem[];
  float* lo = smem;
  float* hi = smem + kMaxTaps;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * kMaxTaps);
  float* S = smem + kRowsHead;  // nr staged rows of n floats at stride ns
  const int ns = n + 4;         // 16 bytes of pad: row q and row q + 4 fall on other banks
  float* A = S + rb * ns;       // level 1's approximations, rows of n/2 at stride na
  const int na = n / 2 + 4;
  const int r0 = blockIdx.x * rb;
  const int nr = min(rb, rows - r0);
  const int lg_parts = nr > 4 ? 1 : 0;  // 4-row parts of a column: 1 or 2
  const bool vec4 = rb % 4 == 0 && rows % 4 == 0 && nr == rb &&
                    (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (threadIdx.x == 0) jw::mbar_init(bar);
  load_taps(taps, m, lo, hi);  // its __syncthreads also publishes the barrier
  stage_rows(S, src + (long long)r0 * n, nr, n, ns, bar,
             n % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0);
  // Level l reads its head of h samples from P and writes d to S[h/2, h) and
  // a to Q, never where it reads: level 1 reads the staged rows, stores its
  // details (final) straight to their columns of out and its approximation
  // to A; later levels read A or S[n/2, n), free since level 1, in turns,
  // and the last writes a to the head of S. So each level needs one barrier
  // and no output waits in registers. A thread takes pairs i of a 4-row
  // part, (a, d) for each row from the same samples (2i .. 2i+M-1) mod h,
  // read two at a time (2i and h are even, so a pair never straddles the
  // wrap); the row parts share the index arithmetic.
  const float* P = S;
  int ps = ns;
  for (int l = 0, h = n; l < levels; ++l, h >>= 1) {
    const int half = h >> 1;
    const bool last = l == levels - 1;
    float* Q = last ? S : (l & 1) ? S + n / 2 : A;
    const int qs = Q == A ? na : ns;
    for (int idx = threadIdx.x; idx < half << lg_parts; idx += blockDim.x) {
      const int i = idx >> lg_parts, r4 = 4 * (idx & lg_parts);
      const float* row = P + r4 * ps;
      float a[4] = {0.f, 0.f, 0.f, 0.f}, d[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < m; k += 2) {
        const int j = (2 * i + k) & (h - 1);
        const float l0 = lo[k], l1 = lo[k + 1], h0 = hi[k], h1 = hi[k + 1];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (r4 + q < nr) {
            const float2 v = *reinterpret_cast<const float2*>(row + q * ps + j);
            a[q] = fmaf(l1, v.y, fmaf(l0, v.x, a[q]));
            d[q] = fmaf(h1, v.y, fmaf(h0, v.x, d[q]));
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] *= gain;
        d[q] *= gain;
      }
      if (l == 0) {
        store4(out + (long long)(half + i) * rows + r0 + r4, d, nr - r4, vec4);
        if (last) store4(out + (long long)i * rows + r0 + r4, a, nr - r4, vec4);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (r4 + q < nr) {
          if (l > 0) S[(r4 + q) * ns + half + i] = d[q];
          if (l > 0 || !last) Q[(r4 + q) * qs + i] = a[q];
        }
      }
    }
    __syncthreads();
    P = Q;
    ps = qs;
  }
  // what is left: the head of S (n/2 columns) after two levels or more, the
  // staged rows with none; one level stored everything
  if (levels != 1) store_columns(out, S, ns, levels ? n / 2 : n, nr, rows, r0, vec4);
}

// K5: one block per `rb` rows of (rows, n); output (n, rows) transposed.
// See the header for the design.
__global__ void __launch_bounds__(512)
ipyramid_rows_t_kernel(const float* __restrict__ src, float* __restrict__ out,
                       const float* __restrict__ taps, int rows, int n, int levels, int m,
                       int rb, float gain) {
  extern __shared__ __align__(16) float smem[];
  float* lo = smem;
  float* hi = smem + kMaxTaps;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * kMaxTaps);
  float* S = smem + kRowsHead;  // nr staged rows of n floats at stride ns
  const int ns = n + 4;
  const int nthreads = blockDim.x;
  const int half_n = n >> 1;
  const int r0 = blockIdx.x * rb;
  const int nr = min(rb, rows - r0);
  const bool vec4 = rb % 4 == 0 && rows % 4 == 0 && nr == rb &&
                    (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (threadIdx.x == 0) jw::mbar_init(bar);
  load_taps(taps, m, lo, hi);  // its __syncthreads also publishes the barrier
  stage_rows(S, src + (long long)r0 * n, nr, n, ns, bar,
             n % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0);
  // levels with head h < n, in place in S. A thread takes output pairs
  // (2c, 2c+1): the even output uses the even taps and the odd one the odd
  // taps, at the same samples a[c - t], d[c - t], so each sample read
  // serves both.
  for (int h = levels > 0 ? n >> (levels - 1) : n; h < n; h <<= 1) {
    const int half = h >> 1;
    const int lg_half = __ffs(half) - 1;
    const int total = nr << lg_half;
    float v[2 * kK5Pairs];
#pragma unroll
    for (int s = 0; s < kK5Pairs; ++s) {
      const int idx = threadIdx.x + s * nthreads;
      if (idx < total) {
        const float* row = S + (idx >> lg_half) * ns;
        const int c = idx & (half - 1);
        float x0 = 0.f, x1 = 0.f;
        for (int t = 0, j = 0; j < m; ++t, j += 2) {
          const int i = (c - t) & (half - 1);
          const float a = row[i], d = row[half + i];
          x0 = fmaf(hi[j], d, fmaf(lo[j], a, x0));
          if (j + 1 < m) x1 = fmaf(hi[j + 1], d, fmaf(lo[j + 1], a, x1));
        }
        v[2 * s] = gain * x0;
        v[2 * s + 1] = gain * x1;
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kK5Pairs; ++s) {
      const int idx = threadIdx.x + s * nthreads;
      if (idx < total) {
        float* dst = S + (idx >> lg_half) * ns + 2 * (idx & (half - 1));
        dst[0] = v[2 * s];
        dst[1] = v[2 * s + 1];
      }
    }
    __syncthreads();
  }
  // the last level straight to the columns of out, as store_columns stores
  // (with levels == 0, the staged rows as they are)
  const int lg_parts = nr > 4 ? 1 : 0;  // 4-row parts of a column: 1 or 2
  if (levels == 0) {
    store_columns(out, S, ns, n, nr, rows, r0, vec4);
  } else {
    for (int idx = threadIdx.x; idx < half_n << lg_parts; idx += nthreads) {
      const int c = idx >> lg_parts, r4 = 4 * (idx & lg_parts);  // the pair (2c, 2c+1)
      const float* row = S + r4 * ns;
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
      for (int t = 0, j = 0; j < m; ++t, j += 2) {
        const int i = (c - t) & (half_n - 1);
        const float la = lo[j], ha = hi[j];
        const float lb = j + 1 < m ? lo[j + 1] : 0.f, hb = j + 1 < m ? hi[j + 1] : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (r4 + q < nr) {
            const float a = row[q * ns + i], d = row[q * ns + half_n + i];
            c0[q] = fmaf(ha, d, fmaf(la, a, c0[q]));
            c1[q] = fmaf(hb, d, fmaf(lb, a, c1[q]));
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        c0[q] *= gain;
        c1[q] *= gain;
      }
      float* o = out + (long long)(2 * c) * rows + r0 + r4;
      store4(o, c0, nr - r4, vec4);
      store4(o + rows, c1, nr - r4, vec4);
    }
  }
}

}  // namespace

extern "C" {

const char* jw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int jw_pyramid_rows(const void* src, long long src_stride, void* out, long long out_stride,
                    void* a_out, long long a_stride, const void* taps, int rows, int h0,
                    int levels, int m, int threads, void* stream) {
  cudaGetLastError();
  const int bufs = levels >= 2 ? h0 / 2 + h0 / 4 : 0;
  const int smem = (2 * kMaxTaps + bufs) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(pyramid_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  pyramid_rows_kernel<<<rows, threads, smem, (cudaStream_t)stream>>>(
      (const float*)src, src_stride, (float*)out, out_stride, (float*)a_out, a_stride,
      (const float*)taps, h0, levels, m);
  return (int)cudaGetLastError();
}

int jw_pyramid_rows_t(const void* src, void* out, const void* taps, int rows, int n,
                      int levels, int m, int rb, float gain, int threads, void* stream) {
  cudaGetLastError();
  if (rb < 1 || rb > kMaxRows) return (int)cudaErrorInvalidValue;
  const int smem = (int)((kRowsHead + (long long)rb * (n + 4 + n / 2 + 4)) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(pyramid_rows_t_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + rb - 1) / rb;
  pyramid_rows_t_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)src, (float*)out, (const float*)taps, rows, n, levels, m, rb, gain);
  return (int)cudaGetLastError();
}

int jw_ipyramid_rows_t(const void* src, void* out, const void* taps, int rows, int n,
                       int levels, int m, int rb, float gain, int threads, void* stream) {
  cudaGetLastError();
  if (rb < 1 || rb > kMaxRows || (long long)rb * (n / 4) > (long long)kK5Pairs * threads)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)((kRowsHead + (long long)rb * (n + 4)) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(ipyramid_rows_t_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + rb - 1) / rb;
  ipyramid_rows_t_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)src, (float*)out, (const float*)taps, rows, n, levels, m, rb, gain);
  return (int)cudaGetLastError();
}

}  // extern "C"
