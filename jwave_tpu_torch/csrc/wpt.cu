// K8 and K9: the fused wavelet packet transform, c levels of the packet
// butterfly in one pass over each row, and its adjoint, for Hopper (sm_90a).
//
// Replaces (no pallas_call behind either): jwave_tpu/ops/mxu_wpt.py
// ::wpt_fused_forward_mxu (:87, K8) and ::wpt_fused_inverse_mxu (:125, K9),
// the banded 128 x 128 tile matmuls that jwave_tpu/ops/composite.py:59 and
// :90 route to on the TPU. K8 computes, on rows of h samples (the packets
// of one chunk of transforms/wpt.py::_chunk_schedule), with S = 2^c:
//   out[s, i] = sum_m bank[s, m] x[(S i + m) mod h],  bank = composite_filters(lo, hi, c)
// subband-major (S runs of h / S), or interleaved: out[i S + s], the MXU
// tile layout (lane p S + s of tile j holds position j P + p of subband s,
// which is position-major for any tile width). It computes this as the
// level cascade, not as the composite convolution: level l applies the
// butterfly to every packet of h >> (l-1) samples,
//   a[u] = sum_j lo[j] x[(2u + j) mod h_l],  d[u] = sum_j hi[j] x[(2u + j) mod h_l],
// the packet's a and d becoming packets 2b and 2b + 1 (the level-1 choice is
// the most significant bit of s). At db4 L6 that is 6 x 8 = 48 multiply-adds
// an output where the 442-tap composite bank takes 442. K9 is the adjoint,
// the same cascade coarsest level first, each level the synthesis butterfly
//   x[2c + q] = sum_t lo[2t + q] a[(c - t) mod h] + hi[2t + q] d[(c - t) mod h]
// with the rec pair; both kernels take a per-level gain folded into the taps
// by the host (ops/cuda_wpt.py), so K9 with the rec pair and recon_gain is
// wpt_fused_inverse, K9 with K8's pair and gain K8's transpose, and K8 with
// K9's pair and gain K9's.
//
// Bound on this card: bytes. Each row is read once and written once (64 x
// 65536 f32: 33.5 MB, 10 us at 3.35 TB/s); the cascade's ~2cM flops a sample
// are far below the float32 rate.
//
// Design (a first version: right and simple, one work item a block):
//  - Work items. A row longer than the tile T (4096 output samples; T >= 8S)
//    is cut into items of P = T / S positions of every subband. K8's item
//    stages the contiguous window x[(S i0 + k) mod h], k < T + (M-1)(S-1),
//    which holds every sample its outputs read, and runs the levels on it
//    without a wrap: level l keeps the (T >> l) + (M-1)(2^(c-l) - 1) outputs
//    of each of its 2^l packets that later levels read (k8_count), so the
//    working set stays about one window at every level. K9's item owns T
//    output samples of a row and stages the dependency cone of each of the S
//    subbands (half of the level below and ceil(M/2) - 1 more to the left,
//    its ends rounded out to multiples of 8 as K7's cones are, or the whole
//    packet, then read circularly). Rows of at most T run T / h whole rows
//    an item (the last item shorter), every level circular within its
//    packets: no halo however short the packets (rows of 16 at c = 4 read
//    105 taps mod 16).
//  - Staging: bulk copies (TMA) of each run on one mbarrier, the ragged
//    parts and sources off 16-byte alignment by plain loads (the runs of
//    jw::stage_segment); warp 0 issues one run a lane, and each warp walks
//    the plain parts of its own runs (K9's S runs walked by every thread
//    held K9 at 0.073 ms, 0.042 without: PERF.md, section 6).
//  - Levels alternate between two buffers with one barrier a level; a
//    thread makes four consecutive output pairs of one packet from float4
//    reads (db4's and Haar's taps unrolled in registers) and writes them as
//    float4s; other banks and packets shorter than 8 take a pair a thread.
//  - K8's last level lands in shared memory and leaves as S runs of P floats
//    (subband, float4 stores) or one contiguous run of S P floats
//    (interleaved); K9 reads the interleaved layout as one contiguous run and
//    transposes it in shared memory, and its level 1 stores straight to the
//    output. So neither layout costs a second pass over the row.
// On the H100 (PERF.md, "NVIDIA H100 80GB HBM3, 700.00 W") 64 x 65536 db4
// L6 takes 0.038 ms in K8 and 0.042 in K9 against a bound of 0.0100 and the
// conv form's 0.444 and 0.306; tiles of 1024 to 16384 and 128 or 256
// threads took no less (tools/ab_times.py --wpt-plans).
// Mirrored by ops/cuda_wpt.py (wpt_plan, wpt_layout, k8_count, k9_cones,
// wpt_analysis_tiled_torch, wpt_synthesis_tiled_torch).
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kMaxTaps = 64;
constexpr int kMaxThreads = 256;
constexpr int kMaxLevels = 12;
constexpr int kMeta = 16;   // ints of each cone table (levels 1 .. kMaxLevels + 1)
constexpr int kSlack = 16;  // floats past a tiled K8 buffer that a group's reads may reach
// shared floats before the two buffers: the taps, the mbarrier (padded to 16
// bytes) and K9's three cone tables
constexpr int kHead = 2 * kMaxTaps + 4 + 3 * kMeta;

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Outputs of each packet that a tiled K8 item keeps at level l (0: the window).
__host__ __device__ inline int k8_count(int tile, int levels, int m, int l) {
  return (tile >> l) + (m - 1) * ((1 << (levels - l)) - 1);
}

// R_{l+1} from R_l = [s, s + cnt) (unwrapped) on packets of `half` samples:
// the inputs of the pairs [s/2, s/2 + cnt/2) reach back mh - 1 samples; the
// ends rounded out to multiples of 8, or the whole packet where they would
// cover it (ops/cuda_pyramid.py::k7_cones, every branch at once).
__host__ __device__ inline void k9_cone_next(int& s, int& cnt, int& whole, int half, int mh) {
  const int u = s >> 1;  // s may be negative: an arithmetic shift floors
  const int st = (u - (mh - 1)) & ~7, en = (u + cnt / 2 + 7) & ~7;
  if (en - st >= half) {
    s = 0, cnt = half, whole = 1;
  } else {
    s = st, cnt = en - st, whole = 0;
  }
}

// Floats of the two buffers. Whole rows: T / h rows, T floats (and the
// round-up of a staged run). K8 tiled: the window, then level l's 2^l packets
// at a stride of round4(k8_count) in buffer l & 1, with kSlack behind each.
// K9 tiled: the S staged cones in buffer 0, level l's 2^(l-1) cones at a
// stride of round4(count) in buffer (c - l + 1) & 1 (level 1 stores to the
// output), and the interleaved layout's raw run in buffer 1.
struct WptLayout {
  int buf0, buf1, floats;
};

__host__ __device__ inline WptLayout k8_layout(int h, int tile, int levels, int m) {
  WptLayout L;
  if (h <= tile) {
    L.buf0 = L.buf1 = tile + 4;
  } else {
    int b0 = round4(k8_count(tile, levels, m, 0)), b1 = 0;
    for (int l = 1; l <= levels; ++l) {
      const int f = (1 << l) * round4(k8_count(tile, levels, m, l));
      if (l & 1) b1 = max(b1, f);
      else b0 = max(b0, f);
    }
    L.buf0 = b0 + kSlack, L.buf1 = b1 + kSlack;
  }
  L.floats = kHead + L.buf0 + L.buf1;
  return L;
}

__host__ __device__ inline WptLayout k9_layout(int h, int tile, int levels, int m) {
  WptLayout L;
  if (h <= tile) {
    L.buf0 = L.buf1 = tile + 4;
  } else {
    const int mh = (m + 1) / 2;
    int s = 0, cnt = tile, whole = 0, b0 = 0, b1 = 0;
    for (int l = 1; l <= levels; ++l) {
      if (l >= 2) {
        const int f = (1 << (l - 1)) * round4(cnt);
        if ((levels - l) & 1) b0 = max(b0, f);
        else b1 = max(b1, f);
      }
      k9_cone_next(s, cnt, whole, h >> l, mh);
    }
    L.buf0 = max(b0, (1 << levels) * round4(cnt));
    L.buf1 = max(b1, round4(cnt << levels) + 4);
  }
  L.floats = kHead + L.buf0 + L.buf1;
  return L;
}

// The taps [lo | hi] (gain folded in), zero past m, and the mbarrier's init;
// the caller's __syncthreads publishes both.
__device__ void k89_setup(const float* taps, int m, float* lo, float* hi, uint64_t* bar) {
  if (threadIdx.x == 0) jw::mbar_init(bar);
  for (int j = threadIdx.x; j < kMaxTaps; j += blockDim.x) {
    lo[j] = j < m ? taps[j] : 0.f;
    hi[j] = j < m ? taps[m + j] : 0.f;
  }
}

// One run of a stage, as jw::stage_segment cuts it: samples [t0, t0 + cnt)
// mod n of `row` into dst[0, round4(cnt)) (dst 16-byte aligned), one piece a
// pass over the row, the parts 16-byte aligned on both sides by bulk copies.
// kCount: return the bytes those copies bring; kBulk: start them (one
// thread); kPlain: threads tid, tid + nthr, ... load the rest plainly.
enum StageStep { kCount, kBulk, kPlain };

__device__ uint32_t stage_run(StageStep step, float* dst, const float* row, long long t0,
                              int cnt, int n, uint64_t* bar, int tid, int nthr) {
  cnt = round4(cnt);
  uint32_t bulk_bytes = 0;
  int o = 0;
  long long s = t0;
  while (o < cnt) {
    const int len = (int)min((long long)(cnt - o), (long long)n - s);
    const uintptr_t ga = reinterpret_cast<uintptr_t>(row + s);
    int head = len, body = 0;  // [0, head) plain, [head, head + body) bulk, the rest plain
    if ((ga & 15) == (jw::smem_addr(dst + o) & 15)) {
      head = min(len, (int)(((16 - (ga & 15)) & 15) / sizeof(float)));
      body = (len - head) & ~3;
    }
    if (step == kCount) {
      bulk_bytes += body * sizeof(float);
    } else if (step == kBulk) {
      if (body > 0) jw::bulk_copy(dst + o + head, row + s + head, body * sizeof(float), bar);
    } else {
      for (int i = tid; i < len - body; i += nthr) {
        const int e = i < head ? i : i + body;
        dst[o + e] = row[s + e];
      }
    }
    o += len;
    s = 0;
  }
  return bulk_bytes;
}

// Stage `runs` runs: run k is samples [t0, t0 + cnt) mod n of row + k *
// rstride into dst + k * dstride. Warp 0 counts the bulk bytes (a lane a
// run), lane 0 announces them on `bar`, then each lane issues its runs'
// copies; the plain parts of one run are the block's, of several runs a
// warp's each (a thread walking every run's pieces cost as much as the
// levels). The caller waits on `bar` (parity 0: one stage a launch) and
// then runs __syncthreads.
__device__ void stage_runs(float* dst, int dstride, const float* row, long long rstride, int runs,
                           long long t0, int cnt, int n, uint64_t* bar) {
  if (threadIdx.x < 32) {
    uint32_t bytes = 0;
    for (int k = threadIdx.x; k < runs; k += 32)
      bytes += stage_run(kCount, dst + k * dstride, row + k * rstride, t0, cnt, n, bar, 0, 1);
    for (int off = 16; off > 0; off >>= 1) bytes += __shfl_xor_sync(0xffffffffu, bytes, off);
    if (threadIdx.x == 0) jw::mbar_expect(bar, bytes);
    __syncwarp();
    for (int k = threadIdx.x; k < runs; k += 32)
      stage_run(kBulk, dst + k * dstride, row + k * rstride, t0, cnt, n, bar, 0, 1);
  }
  if (runs == 1) {
    stage_run(kPlain, dst, row, t0, cnt, n, bar, threadIdx.x, blockDim.x);
    return;
  }
  for (int k = threadIdx.x >> 5; k < runs; k += blockDim.x >> 5)
    stage_run(kPlain, dst + k * dstride, row + k * rstride, t0, cnt, n, bar, threadIdx.x & 31,
              32);
}

// ---- K8: one analysis level ----
// Input packet b (b < nb) at in + b * is, read at (2u + j) & mask (mask: the
// packet's length - 1 where packets are whole, read circularly; else -1);
// its a and d of nout outputs go to packets 2b and 2b + 1 at out + k * os.
struct K8Level {
  const float* in;
  float* out;
  int nb, is, os, nout, mask;
};

template <int MT>
__device__ __forceinline__ void k8_level(const K8Level& v, int m, const float* lo,
                                         const float* hi) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  if (MT > 0 && ((v.is | v.os) & 3) == 0 && (v.mask == -1 || v.mask >= 7)) {
    constexpr int R = MT > 0 ? MT : 1;
    constexpr int NV = (R + 6 + 3) / 4;  // float4s a group of four pairs reads
    float tl[R], th[R];
#pragma unroll
    for (int j = 0; j < R; ++j) tl[j] = lo[j], th[j] = hi[j];
    const int ng = (v.nout + 3) >> 2;
    const int total = v.nb * ng;
    for (int idx = tid; idx < total; idx += nthr) {
      const int b = idx / ng, g = idx - b * ng;
      const float* ib = v.in + b * v.is;
      float w[4 * NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const float4 q = *reinterpret_cast<const float4*>(ib + ((8 * g + 4 * k) & v.mask));
        w[4 * k] = q.x, w[4 * k + 1] = q.y, w[4 * k + 2] = q.z, w[4 * k + 3] = q.w;
      }
      float a[4], d[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float sa = 0.f, sd = 0.f;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          sa = fmaf(tl[j], w[2 * p + j], sa);
          sd = fmaf(th[j], w[2 * p + j], sd);
        }
        a[p] = sa, d[p] = sd;
      }
      *reinterpret_cast<float4*>(v.out + 2 * b * v.os + 4 * g) =
          make_float4(a[0], a[1], a[2], a[3]);
      *reinterpret_cast<float4*>(v.out + (2 * b + 1) * v.os + 4 * g) =
          make_float4(d[0], d[1], d[2], d[3]);
    }
    return;
  }
  const int total = v.nb * v.nout;
  for (int idx = tid; idx < total; idx += nthr) {
    const int b = idx / v.nout, u = idx - b * v.nout;
    const float* ib = v.in + b * v.is;
    float sa = 0.f, sd = 0.f;
    for (int j = 0; j < m; ++j) {
      const float x = ib[(2 * u + j) & v.mask];
      sa = fmaf(lo[j], x, sa);
      sd = fmaf(hi[j], x, sd);
    }
    v.out[2 * b * v.os + u] = sa;
    v.out[(2 * b + 1) * v.os + u] = sd;
  }
}

// K8: `levels` analysis levels of the packets of each row of (rows, h); one
// work item a block (see the header).
template <int MT>
__global__ void __launch_bounds__(kMaxThreads)
wpt_analysis_kernel(const float* __restrict__ src, float* __restrict__ out,
                    const float* __restrict__ taps, int rows, int h, int tile, int levels, int m,
                    int interleaved) {
  extern __shared__ __align__(16) float smem[];
  float* lo = smem;
  float* hi = smem + kMaxTaps;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * kMaxTaps);
  const WptLayout L = k8_layout(h, tile, levels, m);
  float* buf0 = smem + kHead;
  float* buf1 = buf0 + L.buf0;
  const int S = 1 << levels, hc = h >> levels;
  const bool whole = h <= tile;
  const long long item = blockIdx.x;
  long long r0;
  int nr, i0, P;
  if (whole) {
    const int rb = tile / h;
    r0 = item * rb;
    nr = (int)min((long long)rb, rows - r0);
    i0 = 0, P = hc;
  } else {
    const int tiles = h / tile;
    r0 = item / tiles;
    nr = 1;
    P = tile >> levels;
    i0 = (int)(item % tiles) * P;
  }
  k89_setup(taps, m, lo, hi, bar);
  __syncthreads();
  const float* row = src + r0 * h;
  if (whole)
    stage_runs(buf0, 0, row, 0, 1, 0, nr * h, nr * h, bar);
  else
    stage_runs(buf0, 0, row, 0, 1, (long long)i0 * S, k8_count(tile, levels, m, 0), h, bar);
  jw::mbar_wait(bar, 0);
  __syncthreads();

  for (int l = 1; l <= levels; ++l) {
    K8Level v;
    v.in = (l & 1) ? buf0 : buf1;
    v.out = (l & 1) ? buf1 : buf0;
    v.nb = nr << (l - 1);
    if (whole) {
      v.is = h >> (l - 1), v.os = v.nout = h >> l, v.mask = (h >> (l - 1)) - 1;
    } else {
      v.is = round4(k8_count(tile, levels, m, l - 1));
      v.nout = k8_count(tile, levels, m, l);
      v.os = round4(v.nout);
      v.mask = -1;
    }
    k8_level<MT>(v, m, lo, hi);
    __syncthreads();
  }

  // packet (q, s) of the last level: P outputs at F + (q S + s) P
  const float* F = (levels & 1) ? buf1 : buf0;
  float* orow = out + r0 * h;
  const int tid = threadIdx.x, nthr = blockDim.x;
  if (!interleaved) {
    if (((hc | P) & 3) == 0) {
      const int p4 = P >> 2, total = nr * S * p4;
      for (int idx = tid; idx < total; idx += nthr) {
        const int br = idx / p4, k = idx - br * p4;
        const int q = br >> levels, s = br & (S - 1);
        *reinterpret_cast<float4*>(orow + (long long)q * h + s * hc + i0 + 4 * k) =
            *reinterpret_cast<const float4*>(F + br * P + 4 * k);
      }
    } else {
      const int total = nr * S * P;
      for (int idx = tid; idx < total; idx += nthr) {
        const int br = idx / P, p = idx - br * P;
        const int q = br >> levels, s = br & (S - 1);
        orow[(long long)q * h + s * hc + i0 + p] = F[idx];
      }
    }
  } else {
    const int run = P * S, total = nr * run;
    for (int idx = tid; idx < total; idx += nthr) {
      const int q = idx / run, e = idx - q * run;  // e = p S + s
      orow[(long long)q * h + (long long)i0 * S + e] =
          F[(q * S + (e & (S - 1))) * P + (e >> levels)];
    }
  }
}

// ---- K9: one synthesis level ----
// Output packet b (b < nb) at out + b * os makes the pairs p < npairs from
// input packets 2b (a) and 2b + 1 (d) at in + k * is, read at (off + p - t)
// & mask (mask: the input packet's length - 1 where it is whole, read
// circularly; else -1); half: the input packets' length.
struct K9Level {
  const float* in;
  float* out;
  int nb, is, os, npairs, off, mask, half;
};

template <int MH>
__device__ __forceinline__ void k9_level(const K9Level& v, int mh, const float* lo,
                                         const float* hi) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const uintptr_t al = reinterpret_cast<uintptr_t>(v.in) | reinterpret_cast<uintptr_t>(v.out);
  if (MH > 0 && (al & 15) == 0 && ((v.is | v.os | v.npairs | v.off) & 3) == 0 &&
      (v.mask == -1 || v.half >= 4)) {
    static_assert(MH <= 5, "one float4 of window before the group");
    constexpr int R = MH > 0 ? MH : 1;
    constexpr int W = R > 1 ? 4 : 0;  // window samples before the group
    float le[R], lod[R], he[R], hod[R];
#pragma unroll
    for (int t = 0; t < R; ++t)
      le[t] = lo[2 * t], lod[t] = lo[2 * t + 1], he[t] = hi[2 * t], hod[t] = hi[2 * t + 1];
    const int ng = v.npairs >> 2;
    const int total = v.nb * ng;
    for (int idx = tid; idx < total; idx += nthr) {
      const int b = idx / ng, g = idx - b * ng;
      const int i0 = v.off + 4 * g;  // a multiple of 4; below 0 only where the input wraps
      const float* ar = v.in + 2 * b * v.is;
      const float* dr = ar + v.is;
      float av[W + 4], dv[W + 4];
      if constexpr (W > 0) {
        const float4 wa = *reinterpret_cast<const float4*>(ar + ((i0 - 4) & v.mask));
        const float4 wd = *reinterpret_cast<const float4*>(dr + ((i0 - 4) & v.mask));
        av[0] = wa.x, av[1] = wa.y, av[2] = wa.z, av[3] = wa.w;
        dv[0] = wd.x, dv[1] = wd.y, dv[2] = wd.z, dv[3] = wd.w;
      }
      const float4 ca = *reinterpret_cast<const float4*>(ar + (i0 & v.mask));
      const float4 cd = *reinterpret_cast<const float4*>(dr + (i0 & v.mask));
      av[W] = ca.x, av[W + 1] = ca.y, av[W + 2] = ca.z, av[W + 3] = ca.w;
      dv[W] = cd.x, dv[W + 1] = cd.y, dv[W + 2] = cd.z, dv[W + 3] = cd.w;
      float o[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x0 = 0.f, x1 = 0.f;
#pragma unroll
        for (int t = 0; t < R; ++t) {
          x0 = fmaf(he[t], dv[W + j - t], fmaf(le[t], av[W + j - t], x0));
          x1 = fmaf(hod[t], dv[W + j - t], fmaf(lod[t], av[W + j - t], x1));
        }
        o[2 * j] = x0, o[2 * j + 1] = x1;
      }
      float4* xr = reinterpret_cast<float4*>(v.out + (long long)b * v.os + 8 * g);
      xr[0] = make_float4(o[0], o[1], o[2], o[3]);
      xr[1] = make_float4(o[4], o[5], o[6], o[7]);
    }
    return;
  }
  const int total = v.nb * v.npairs;
  for (int idx = tid; idx < total; idx += nthr) {
    const int b = idx / v.npairs, p = idx - b * v.npairs;
    const int c = v.off + p;
    const float* ar = v.in + 2 * b * v.is;
    const float* dr = ar + v.is;
    float x0 = 0.f, x1 = 0.f;
    for (int t = 0; t < mh; ++t) {
      const int i = (c - t) & v.mask;
      const float a = ar[i], d = dr[i];
      x0 = fmaf(hi[2 * t], d, fmaf(lo[2 * t], a, x0));
      x1 = fmaf(hi[2 * t + 1], d, fmaf(lo[2 * t + 1], a, x1));
    }
    float* xo = v.out + (long long)b * v.os + 2 * p;
    xo[0] = x0;
    xo[1] = x1;
  }
}

// K9: `levels` synthesis levels of the packets of each row of (rows, h),
// coarsest first; one work item a block (see the header).
template <int MH>
__global__ void __launch_bounds__(kMaxThreads)
wpt_synthesis_kernel(const float* __restrict__ src, float* __restrict__ out,
                     const float* __restrict__ taps, int rows, int h, int tile, int levels, int m,
                     int interleaved) {
  extern __shared__ __align__(16) float smem[];
  float* lo = smem;
  float* hi = smem + kMaxTaps;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * kMaxTaps);
  int* cs = reinterpret_cast<int*>(smem + 2 * kMaxTaps + 4);  // R_l: start, count, whole
  int* cn = cs + kMeta;
  int* cf = cn + kMeta;
  const WptLayout L = k9_layout(h, tile, levels, m);
  float* buf0 = smem + kHead;
  float* buf1 = buf0 + L.buf0;
  const int S = 1 << levels, hc = h >> levels, mh = (m + 1) / 2;
  const bool whole = h <= tile;
  const long long item = blockIdx.x;
  long long r0;
  int nr, t0;
  if (whole) {
    const int rb = tile / h;
    r0 = item * rb;
    nr = (int)min((long long)rb, rows - r0);
    t0 = 0;
  } else {
    const int tiles = h / tile;
    r0 = item / tiles;
    nr = 1;
    t0 = (int)(item % tiles) * tile;
  }
  if (threadIdx.x == 0 && !whole) {
    int s = t0, cnt = tile, wh = 0;
    cs[1] = s, cn[1] = cnt, cf[1] = 0;
    for (int l = 1; l <= levels; ++l) {
      k9_cone_next(s, cnt, wh, h >> l, mh);
      cs[l + 1] = s, cn[l + 1] = cnt, cf[l + 1] = wh;
    }
  }
  k89_setup(taps, m, lo, hi, bar);
  __syncthreads();
  const float* row = src + r0 * h;
  const int tid = threadIdx.x, nthr = blockDim.x;
  // the coarsest level's packets: nc samples from sc of each, in buffer 0 at
  // a stride of cstride
  int sc = 0, nc = hc, cstride = hc;
  if (!whole) sc = cs[levels + 1] & (hc - 1), nc = cn[levels + 1], cstride = round4(nc);
  if (whole)
    stage_runs(interleaved ? buf1 : buf0, 0, row, 0, 1, 0, nr * h, nr * h, bar);
  else if (interleaved)
    stage_runs(buf1, 0, row, 0, 1, (long long)sc * S, nc * S, h, bar);
  else
    stage_runs(buf0, cstride, row, hc, S, sc, nc, hc, bar);
  jw::mbar_wait(bar, 0);
  __syncthreads();
  if (interleaved) {
    // raw: element (q, s, i) at q h + i S + s (whole rows) or i S + s
    const int per = S * nc, total = nr * per;
    for (int idx = tid; idx < total; idx += nthr) {
      const int q = idx / per, e = idx - q * per;
      const int s = e / nc, i = e - s * nc;
      buf0[(q * S + s) * cstride + i] = buf1[q * h + i * S + s];
    }
    __syncthreads();
  }

  for (int l = levels; l >= 1; --l) {
    K9Level v;
    v.in = l == levels ? buf0 : (((levels - l - 1) & 1) ? buf0 : buf1);
    v.out = l == 1 ? out + r0 * h + t0 : (((levels - l) & 1) ? buf0 : buf1);
    v.half = h >> l;
    if (whole) {
      v.nb = nr << (l - 1);
      v.is = v.half, v.os = 2 * v.half;
      v.npairs = v.half, v.off = 0, v.mask = v.half - 1;
    } else {
      v.nb = 1 << (l - 1);
      v.is = round4(cn[l + 1]);
      v.os = l == 1 ? 0 : round4(cn[l]);
      v.npairs = cn[l] >> 1;
      v.off = (cs[l] >> 1) - cs[l + 1];
      v.mask = cf[l + 1] ? v.half - 1 : -1;
    }
    k9_level<MH>(v, mh, lo, hi);
    if (l > 1) __syncthreads();
  }
}

template <typename K>
int launch(K kern, int smem, long long items, int threads, cudaStream_t stream, const float* src,
           float* out, const float* taps, int rows, int h, int tile, int levels, int m,
           int interleaved) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)items, threads, smem, stream>>>(src, out, taps, rows, h, tile, levels, m,
                                                   interleaved);
  return (int)cudaGetLastError();
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// The arguments both kernels take, and their work items (0 where refused).
long long items_of(int rows, int h, int tile, int levels, int m, int threads) {
  if (rows < 1 || !pow2(h) || !pow2(tile) || tile < 8 || levels < 1 || levels > kMaxLevels ||
      (h >> levels) < 1 || m < 1 || m > kMaxTaps || threads % 32 || threads < 32 ||
      threads > kMaxThreads)
    return 0;
  if (h <= tile) return (rows + (long long)(tile / h) - 1) / (tile / h);
  if ((tile >> levels) < 8) return 0;
  return (long long)rows * (h / tile);
}

}  // namespace

extern "C" {

const char* jw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K8: `levels` fused analysis levels (1 .. kMaxLevels) of each row of (rows,
// h), h a power of two, into out, subband-major or (interleaved) at i S + s;
// work items of `tile` samples (a power of two, tile >> levels >= 8 where
// h > tile) or tile / h whole rows; the gain folded into the taps; db4's 8
// taps and Haar's 2 unroll at compile time.
int jw_wpt_analysis(const void* src, void* out, const void* taps, int rows, int h, int tile,
                    int levels, int m, int interleaved, int threads, void* stream) {
  cudaGetLastError();
  const long long items = items_of(rows, h, tile, levels, m, threads);
  if (items < 1 || items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int smem = k8_layout(h, tile, levels, m).floats * (int)sizeof(float);
  auto kern = m == 8 ? wpt_analysis_kernel<8> : m == 2 ? wpt_analysis_kernel<2>
                                                       : wpt_analysis_kernel<0>;
  return launch(kern, smem, items, threads, (cudaStream_t)stream, (const float*)src, (float*)out,
                (const float*)taps, rows, h, tile, levels, m, interleaved);
}

// K9: the adjoint of K8 with the same arguments (its input in K8's layout).
int jw_wpt_synthesis(const void* src, void* out, const void* taps, int rows, int h, int tile,
                     int levels, int m, int interleaved, int threads, void* stream) {
  cudaGetLastError();
  const long long items = items_of(rows, h, tile, levels, m, threads);
  if (items < 1 || items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int smem = k9_layout(h, tile, levels, m).floats * (int)sizeof(float);
  auto kern = m == 8 ? wpt_synthesis_kernel<4> : m == 2 ? wpt_synthesis_kernel<1>
                                                        : wpt_synthesis_kernel<0>;
  return launch(kern, smem, items, threads, (cudaStream_t)stream, (const float*)src, (float*)out,
                (const float*)taps, rows, h, tile, levels, m, interleaved);
}

}  // extern "C"
