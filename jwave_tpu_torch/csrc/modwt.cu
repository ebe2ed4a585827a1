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
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxTaps = 64;
constexpr int kThreads = 256;

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
  extern __shared__ float smem[];
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

// Inverse levels j1 down to j0 of one (row, tile). V_{j1} comes from `vsrc`
// (row stride `vstride`); W_j from row j-1 of `coeffs` (rows x (levels+1) x n).
// V_{j0-1} goes to `out` (rows x n) when j0 == 1, else to `vnext` (rows x n).
template <typename Tc, typename Tv>
__global__ void __launch_bounds__(kThreads)
modwt_inv_kernel(const Tc* __restrict__ coeffs, const Tv* __restrict__ vsrc,
                 long long vstride, Tc* __restrict__ out, float* __restrict__ vnext,
                 const float* __restrict__ taps, int n, int m, int levels, int j0,
                 int j1, int tile, int tiles, int staged) {
  extern __shared__ float smem[];
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
  const Tc* crow = coeffs + row * (long long)(levels + 1) * n;
  const Tv* v = vsrc + row * vstride;

  if (!staged) {  // one level (j0 == j1), read straight from device memory
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

  // buffer index p holds time t0 + p
  const int halo = (m - 1) * ((1 << j1) - (1 << (j0 - 1)));
  const int len = halo + tl;
  float* cur = smem + 2 * kMaxTaps;
  float* nxt = cur + len;
  float* wb = nxt + len;
  const long long start = wrap(t0, n);
  for (int p = threadIdx.x; p < len; p += blockDim.x) {
    long long idx = start + p;
    if (idx >= n) idx %= n;
    cur[p] = load_f(v, idx);
  }
  int valid = len;  // cur is valid on [0, valid)
  for (int j = j1; j >= j0; --j) {
    const int gap = 1 << (j - 1);
    const Tc* w = crow + (long long)(j - 1) * n;
    for (int p = threadIdx.x; p < valid; p += blockDim.x) {
      long long idx = start + p;
      if (idx >= n) idx %= n;
      wb[p] = load_f(w, idx);
    }
    __syncthreads();
    valid -= (m - 1) * gap;
    for (int p = threadIdx.x; p < valid; p += blockDim.x) {
      float acc = 0.f;
      for (int k = 0; k < m; ++k) {
        acc = fmaf(g[k], cur[p + k * gap], acc);
        acc = fmaf(h[k], wb[p + k * gap], acc);
      }
      nxt[p] = acc;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int p = threadIdx.x; p < tl; p += blockDim.x) {
    const long long t = t0 + p;
    if (j0 == 1) store_f(out, row * n + t, cur[p]);
    else vnext[row * n + t] = cur[p];
  }
}

int smem_bytes(int m, int halo, int tile, int staged, int buffers) {
  const int len = staged ? halo + tile : 0;
  return (2 * kMaxTaps + buffers * len) * (int)sizeof(float);
}

template <typename Tin, typename Tout>
int launch_fwd(const void* src, void* out, void* vnext, const void* taps, int rows, int n,
               int m, int levels, int j0, int j1, int tile, int staged, void* stream) {
  cudaGetLastError();
  const int tiles = (n + tile - 1) / tile;
  const int halo = (m - 1) * ((1 << j1) - (1 << (j0 - 1)));
  const int smem = smem_bytes(m, halo, tile < n ? tile : n, staged, 2);
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
  const int halo = (m - 1) * ((1 << j1) - (1 << (j0 - 1)));
  const int smem = smem_bytes(m, halo, tile < n ? tile : n, staged, 3);
  auto kern = modwt_inv_kernel<Tc, Tv>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)rows * tiles, kThreads, smem, (cudaStream_t)stream>>>(
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
