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
// Design: level 1 reads the row straight from device memory (a 64x65536 f32
// batch is 16 MB and stays in the 50 MB L2); its approximation, half the row,
// lives in shared memory, and every later level ping-pongs between two
// shared buffers of h0/2 and h0/4 floats, so device memory sees one read of
// the row and one write of each output element. Details are stored as soon
// as they are computed. h0 <= 65536 fits (192 KB); longer rows are first cut
// down by single-level launches of K3 whose approximation goes to a scratch
// row. K4 stages the finished rows of a block of `rb` rows in shared memory
// (row stride n+1 against bank conflicts) and writes them transposed, so each
// output column takes rb contiguous floats instead of one float per line.
// K3 and K4 share the device routine `pyramid_row` and differ in the store.
//
// K5 replaces jwave_tpu/ops/pallas_pyramid.py::_ipyramid_rows_kernel (driven
// by _inv_axis_pass / ifwt2d_fused): the inverse pyramid of each row over
// `levels` levels, stored transposed, output (N, R); two K5 passes make the
// 2D inverse. Per level, with head h = N >> (levels-1), ..., N, a = y[:h/2]
// and d = y[h/2:h], and A, D a and d zero-upsampled:
//   x[k] = gain * sum_j (rec_lo[j] A[(k-j) mod h] + rec_hi[j] D[(k-j) mod h])
// so only taps j of k's parity contribute, each with a[((k-j) mod h) / 2].
// Bound: bytes, as for K4 (33.5 MB per pass at 2048 x 2048 f32). Design, the
// mirror of K4: the details of every level are read straight from device
// memory once (through L1), the approximation of the levels before the last
// ping-pongs in shared memory (n/2 and n/4 floats), the last level writes the
// finished row into a block of `rb` rows staged at stride n+1, and the block
// is written column by column. The TPU kernel's folded dense head, split a/d
// matmuls, tail roll and chunked contractions were MXU and Mosaic needs and
// are not carried over.
#include <cuda_runtime.h>

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

struct SmemStore {
  float* row;
  __device__ void operator()(int idx, float v) const { row[idx] = v; }
};

__device__ void load_taps(const float* taps, int m, float* lo, float* hi) {
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    lo[i] = taps[i];
    hi[i] = taps[m + i];
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
  extern __shared__ float smem[];
  float* lo = smem;
  float* hi = smem + kMaxTaps;
  float* A = smem + 2 * kMaxTaps;
  float* B = A + h0 / 2;
  load_taps(taps, m, lo, hi);
  const long long r = blockIdx.x;
  RowStore st{out + r * out_stride, a_out + r * a_stride, h0 >> levels};
  pyramid_row(src + r * src_stride, h0, levels, lo, hi, m, 1.f, A, B, st);
}

// K4: one block per `rb` rows of (rows, n); output (n, rows) transposed.
__global__ void __launch_bounds__(512)
pyramid_rows_t_kernel(const float* __restrict__ src, float* __restrict__ out,
                                      const float* __restrict__ taps, int rows, int n,
                                      int levels, int m, int rb, float gain) {
  extern __shared__ float smem[];
  float* lo = smem;
  float* hi = smem + kMaxTaps;
  float* res = smem + 2 * kMaxTaps;          // rb rows of n+1 floats
  float* A = res + (long long)rb * (n + 1);  // n/2
  float* B = A + n / 2;                      // n/4
  load_taps(taps, m, lo, hi);
  const int r0 = blockIdx.x * rb;
  const int nr = min(rb, rows - r0);
  for (int rr = 0; rr < nr; ++rr) {
    SmemStore st{res + rr * (n + 1)};
    pyramid_row(src + (long long)(r0 + rr) * n, n, levels, lo, hi, m, gain, A, B, st);
  }
  __syncthreads();
  const long long total = (long long)nr * n;
  for (long long k = threadIdx.x; k < total; k += blockDim.x) {
    const int rr = (int)(k % nr);
    const long long c = k / nr;
    out[c * rows + r0 + rr] = res[rr * (n + 1) + c];
  }
}

// K5: one row's inverse pyramid. Reads row `y` (n floats) from device
// memory and leaves the reconstructed row in `dst`. A and B are shared
// scratch of n/2 and n/4 floats: the level with head h < n writes A when
// log2(n/h) is odd and B when it is even, so each fits and the next level
// reads the buffer the previous one wrote.
__device__ void ipyramid_row(const float* __restrict__ y, int n, int levels, const float* lo,
                             const float* hi, int m, float gain, float* A, float* B,
                             float* dst) {
  if (levels == 0) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = y[i];
    __syncthreads();
    return;
  }
  const float* a = y;  // the first level reads its approximation from device memory
  int depth = levels - 1;  // log2(n / h)
  for (int h = n >> (levels - 1); h <= n; h <<= 1, --depth) {
    const int half = h >> 1;
    const float* d = y + half;
    float* out = depth == 0 ? dst : ((depth & 1) ? A : B);
    for (int k = threadIdx.x; k < h; k += blockDim.x) {
      float s = 0.f;
      for (int j = k & 1; j < m; j += 2) {
        const int i = ((k - j) & (h - 1)) >> 1;
        s = fmaf(lo[j], a[i], s);
        s = fmaf(hi[j], __ldg(d + i), s);
      }
      out[k] = gain * s;
    }
    __syncthreads();
    a = out;
  }
}

// K5: one block per `rb` rows of (rows, n); output (n, rows) transposed.
__global__ void __launch_bounds__(512)
ipyramid_rows_t_kernel(const float* __restrict__ src, float* __restrict__ out,
                       const float* __restrict__ taps, int rows, int n, int levels, int m,
                       int rb, float gain) {
  extern __shared__ float smem[];
  float* lo = smem;
  float* hi = smem + kMaxTaps;
  float* res = smem + 2 * kMaxTaps;          // rb rows of n+1 floats
  float* A = res + (long long)rb * (n + 1);  // n/2
  float* B = A + n / 2;                      // n/4
  load_taps(taps, m, lo, hi);
  const int r0 = blockIdx.x * rb;
  const int nr = min(rb, rows - r0);
  for (int rr = 0; rr < nr; ++rr)
    ipyramid_row(src + (long long)(r0 + rr) * n, n, levels, lo, hi, m, gain, A, B,
                 res + rr * (n + 1));
  const long long total = (long long)nr * n;
  for (long long k = threadIdx.x; k < total; k += blockDim.x) {
    const int rr = (int)(k % nr);
    const long long c = k / nr;
    out[c * rows + r0 + rr] = res[rr * (n + 1) + c];
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
  const long long floats = 2LL * kMaxTaps + (long long)rb * (n + 1) + n / 2 + n / 4;
  const int smem = (int)(floats * sizeof(float));
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
  const long long floats = 2LL * kMaxTaps + (long long)rb * (n + 1) + n / 2 + n / 4;
  const int smem = (int)(floats * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(ipyramid_rows_t_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + rb - 1) / rb;
  ipyramid_rows_t_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)src, (float*)out, (const float*)taps, rows, n, levels, m, rb, gain);
  return (int)cudaGetLastError();
}

}  // extern "C"
