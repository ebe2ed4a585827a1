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
// row wraps as often as it must. When the staged group does not fit, the
// host splits the levels into groups that pass V through an f32 scratch
// row; a level whose halo alone does not fit runs unstaged, reading device
// memory (L2) directly. One block per (row, tile) fills the card even at 64
// rows.
//
// What bounds both is how many bytes are in flight. The first versions
// staged with scalar loads behind a barrier (8 KB in flight per SM at
// most), spent M shared loads per output and tap, and K1 stored each W_j
// sample as it was computed. The design here:
//  - at the block's start one thread starts bulk copies (TMA,
//    cp.async.bulk) of what the group reads, in storage type (bf16 stays
//    bf16 in shared memory), each segment on its own mbarrier: K1's segment
//    of V_{j0-1} (tile plus left halo); K2's V_j1 segment and every W_j
//    segment, so that W_{j-1}..W_j0 are in flight while level j computes,
//    as the Pallas kernel's double buffer overlapped them on the TPU;
//  - a segment is copied in whole 16 bytes (its length rounded up), in
//    pieces where it wraps past N (many when the halo exceeds N); a piece
//    whose global and shared addresses disagree mod 16 (unaligned N) is
//    loaded by all threads with plain loads, in the same kernel. A plain
//    load of a ragged tail held every block for one load latency a stage.
//    K1's segment starts a halo before its tile (217 samples at db4 L5), so
//    it is staged at its start's offset mod 16: staged from offset 0, every
//    piece disagreed and the whole segment took plain loads, which held K1
//    at 0.088 ms at 64x65536 db4 L5;
//  - one level routine serves both directions (cascade_level): each thread
//    computes kR = 9 outputs spaced by the level's gap, so the M + kR - 1
//    samples it reads serve all of them from registers (~2-4 shared loads
//    an output, not 2M); kR is odd, so the threads of a warp hit distinct
//    banks at every gap; db4's 8 taps unroll at compile time, other lengths
//    slide a window over the taps. K1 takes its taps reversed, so that its
//    outputs read the samples above them as K2's do;
//  - V ping-pongs between two f32 buffers. K2's last level leaves with
//    16-byte stores. K1 writes 6 rows for each row it reads, so its stores
//    must leave the block without holding its threads: each level writes
//    its tile of W_j into a shared stage, and after the level's barrier one
//    thread issues a bulk store of it (cp.async.bulk.global.shared::cta) and
//    the next level computes while it drains; two stages alternate, and a
//    stage is written again only after cp.async.bulk.wait_group.read says
//    its store has read it. The last level's V_j1 leaves the same way. A
//    stage holds its tile at the offset its row has mod 16 bytes, so the
//    16-byte aligned body of every row leaves by one bulk store, unaligned
//    N included; the ragged edges (at most 15 bytes each) take plain stores.
// On the H100 (PERF.md, "NVIDIA H100 80GB HBM3, 700.00 W") at 64x65536 db4
// L5, against a bound of 0.035 ms (117 MB over 3.35 TB/s): K2 takes 0.062
// ms, about a plain reduction over the same bytes (0.051, chip_smoke.py
// prints both) plus its levels' FMAs; K1 0.057 (the first version 0.104),
// where writing its 101 MB of rows alone (fill_) takes 0.035. The blocks of
// an SM start together and stay in step, so their arithmetic does not hide
// behind one another's copies. Blocks that loop over tiles and load the
// next tile's segment while the later levels compute were slower in a
// trial, for K1 as for K2 (one 121 KB block an SM: too few warps).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "async_copy.cuh"

namespace {

constexpr int kMaxTaps = 64;
constexpr int kThreads = 128;
constexpr int kR = 9;  // outputs per thread and level, spaced by the gap

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

// ---- the staged plans, mirrored by ops/cuda_modwt.py::k1_smem_bytes and
// ::k2_smem_bytes. A staged block's shared memory starts with the taps
// (512 B) and 16 mbarriers (128 B); every buffer after them is rounded up
// to 16 bytes. ----
constexpr int kTapBytes = 2 * kMaxTaps * sizeof(float);
constexpr int kHeadBytes = kTapBytes + 16 * sizeof(uint64_t);

__host__ __device__ inline int round16(int b) { return (b + 15) & ~15; }

// samples a group (j0..j1) keeps of the level-j signal for a tile of tl
// outputs: the tile and the halo of levels j0..j, (M-1)(2^j - 2^(j0-1))
__host__ __device__ inline int seg_len(int tl, int m, int j0, int j) {
  return tl + (m - 1) * ((1 << j) - (1 << (j0 - 1)));
}

// K1: the V_{j0-1} segment (Tin, seg_len(j1) samples and 16 bytes for its
// offset mod 16 in device memory), two f32 V buffers
// for V_j0 .. V_{j1-1} (none for a single level; each of seg_len(j0+1, j1)
// samples and 16 bytes), the stages of W (two, one for a single level; tl
// samples of Tout and 16 bytes for the offset mod 16 of their row) and the
// stage of V_j1 (Tout into the output, f32 into a scratch row): the V
// buffer that level j1 does not read, or its own for a single level.
struct FwdLayout {
  int len;           // the tile plus its halo
  int x, f0, f1;     // byte offsets: the V_{j0-1} segment, the f32 V buffers
  int w0, w1, v;     // the stages
  int bytes;
};

__host__ __device__ inline FwdLayout fwd_layout(int tl, int m, int j0, int j1, int es_x,
                                                int es_w, int es_v) {
  FwdLayout L;
  L.len = seg_len(tl, m, j0, j1);
  L.x = kHeadBytes;
  int off = L.x + round16(L.len * es_x) + 16;
  const int fbytes = round16(seg_len(tl, m, j0 + 1, j1) * (int)sizeof(float)) + 16;
  L.f0 = off;
  L.f1 = off + fbytes;
  if (j1 > j0) off += 2 * fbytes;
  const int wbytes = round16(tl * es_w) + 16;
  L.w0 = off;
  off += wbytes;
  L.w1 = off;
  if (j1 > j0) off += wbytes;
  L.v = j1 == j0 ? off : ((j1 - j0) & 1 ? L.f1 : L.f0);
  L.bytes = j1 == j0 ? off + round16(tl * es_v) + 16 : off;
  return L;
}

// K2: the V_j1 segment (Tv), the W_j segments for j = j1..j0 (Tc) and two
// f32 V buffers (one when the group has one level).
struct InvLayout {
  int len;     // the tile plus its halo: V_j1's segment
  int v0, w;   // byte offsets: V_j1, then W_j1 .. W_j0 one after another
  int f0, f1;  // the f32 V buffers
  int bytes;
};

__host__ __device__ inline InvLayout inv_layout(int tl, int m, int j0, int j1, int es_v,
                                                int es_c) {
  InvLayout L;
  L.len = seg_len(tl, m, j0, j1);
  L.v0 = kHeadBytes;
  L.w = L.v0 + round16(L.len * es_v);
  int off = L.w;
  for (int j = j1; j >= j0; --j) off += round16(seg_len(tl, m, j0, j) * es_c);
  const int flen = seg_len(tl, m, j0, j1 - 1);  // level j1's outputs
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

__device__ __forceinline__ float ld_s(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float ld_s(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

// One cascade level in shared memory, over the outputs q in
// [0, valid - (m-1)*gap), with x (and y) valid on [0, valid):
//   K2 (kInv):  o1[q] = sum_k a[k] x[q + k*gap] + b[k] y[q + k*gap]
//   K1:         o1[q] = sum_k a[k] x[q + k*gap], and for q >= o2_lo
//               o2[q - o2_lo] = sum_k b[k] x[q + k*gap]
// (K1 passes its taps reversed: its outputs read the samples below them).
// A thread takes kR outputs q, q + gap, ..., which read kR + M - 1 samples
// of x (and y) between them; reads past `valid` (only for outputs that are
// not stored) clamp. With the filter length MT known at compile time the
// samples are read once into registers and the taps unroll; MT = 0 takes
// any length and slides a window of kR samples over the taps.
template <int MT, bool kInv, typename TX, typename TY, typename T1, typename T2>
__device__ void cascade_level_m(const TX* x, const TY* y, T1* o1, T2* o2, int o2_lo, int valid,
                                int gap, int m, const float* a, const float* b) {
  const int out_len = valid - (m - 1) * gap;
  const int span = gap * kR;
  const int lg_gap = __ffs(gap) - 1;
  const int groups = ((out_len + span - 1) / span) << lg_gap;
  for (int bi = threadIdx.x; bi < groups; bi += blockDim.x) {
    const int p = (bi >> lg_gap) * span + (bi & (gap - 1));
    float acc[kR], acc2[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[r] = acc2[r] = 0.f;
    if constexpr (MT > 0) {
      constexpr int kW = kR + MT - 1;
      float wx[kW], wy[kW];
#pragma unroll
      for (int q = 0; q < kW; ++q) {
        const int qq = min(p + q * gap, valid - 1);
        wx[q] = ld_s(x, qq);
        if constexpr (kInv) wy[q] = ld_s(y, qq);
      }
#pragma unroll
      for (int k = 0; k < MT; ++k) {
        const float ak = a[k], bk = b[k];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if constexpr (kInv) {
            acc[r] = fmaf(bk, wy[r + k], fmaf(ak, wx[r + k], acc[r]));
          } else {
            acc[r] = fmaf(ak, wx[r + k], acc[r]);
            acc2[r] = fmaf(bk, wx[r + k], acc2[r]);
          }
        }
      }
    } else {
      float wx[kR], wy[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int q = min(p + r * gap, valid - 1);
        wx[r] = ld_s(x, q);
        if constexpr (kInv) wy[r] = ld_s(y, q);
      }
      for (int k = 0; k < m; ++k) {
        const float ak = a[k], bk = b[k];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if constexpr (kInv) {
            acc[r] = fmaf(bk, wy[r], fmaf(ak, wx[r], acc[r]));
          } else {
            acc[r] = fmaf(ak, wx[r], acc[r]);
            acc2[r] = fmaf(bk, wx[r], acc2[r]);
          }
        }
        if (k + 1 < m) {
#pragma unroll
          for (int r = 0; r < kR - 1; ++r) {
            wx[r] = wx[r + 1];
            if constexpr (kInv) wy[r] = wy[r + 1];
          }
          const int q = min(p + (k + kR) * gap, valid - 1);
          wx[kR - 1] = ld_s(x, q);
          if constexpr (kInv) wy[kR - 1] = ld_s(y, q);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int q = p + r * gap;
      if (q < out_len) {
        store_f(o1, q, acc[r]);
        if constexpr (!kInv) {
          if (q >= o2_lo) store_f(o2, q - o2_lo, acc2[r]);
        }
      }
    }
  }
}

// The filter length whose taps unroll at compile time: db4's 8, the main
// path, where the unrolled body took 0.72x the generic one's time in K2 on
// the H100 (64x65536 L5, PERF.md). Every other length takes the generic body.
constexpr int kUnrolledTaps = 8;

template <bool kInv, typename TX, typename TY, typename T1, typename T2>
__device__ void cascade_level(const TX* x, const TY* y, T1* o1, T2* o2, int o2_lo, int valid,
                              int gap, int m, const float* a, const float* b) {
  if (m == kUnrolledTaps)
    cascade_level_m<kUnrolledTaps, kInv>(x, y, o1, o2, o2_lo, valid, gap, m, a, b);
  else
    cascade_level_m<0, kInv>(x, y, o1, o2, o2_lo, valid, gap, m, a, b);
}

// K1's level j on x valid on [0, valid): V_j into v (all outputs), the tile
// of W_j (its last tl outputs) into the stage w.
template <typename TX, typename TV, typename TW>
__device__ __forceinline__ void fwd_level(const TX* x, TV* v, TW* w, int tl, int valid, int gap,
                                          int m, const float* g, const float* h) {
  const int o2_lo = valid - (m - 1) * gap - tl;
  cascade_level<false>(x, static_cast<const float*>(nullptr), v, w, o2_lo, valid, gap, m, g, h);
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
  float* g = smem;  // the taps reversed
  float* h = smem + kMaxTaps;
  const long long row = blockIdx.x / tiles;
  const long long t0 = (long long)(blockIdx.x % tiles) * tile;
  const int tl = (int)min((long long)tile, (long long)n - t0);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    g[i] = taps[m - 1 - i];
    h[i] = taps[2 * m - 1 - i];
  }
  const Tin* x = src + row * n;
  Tout* orow = out + row * (long long)(levels + 1) * n;
  float* vrow = vnext ? vnext + row * n : nullptr;

  if (!staged) {  // one level (j0 == j1), read straight from device memory
    __syncthreads();
    const long long gap = 1LL << (j0 - 1);
    for (int p = threadIdx.x; p < tl; p += blockDim.x) {
      const long long t = t0 + p;
      float aw = 0.f, av = 0.f;
      for (int k = 0; k < m; ++k) {
        const float v = load_f(x, wrap(t - (m - 1 - k) * gap, n));
        aw = fmaf(h[k], v, aw);
        av = fmaf(g[k], v, av);
      }
      store_f(orow, (long long)(j0 - 1) * n + t, aw);
      if (j1 == levels) store_f(orow, (long long)levels * n + t, av);
      else vrow[t] = av;
    }
    return;
  }

  // one (row, tile) a block; see the header for the design. Level j's
  // outputs end with the tile, so its tile is its last tl outputs.
  const bool to_out = j1 == levels;
  const FwdLayout L = fwd_layout(tl, m, j0, j1, sizeof(Tin), sizeof(Tout),
                                 to_out ? sizeof(Tout) : sizeof(float));
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + kTapBytes);
  float* f0 = reinterpret_cast<float*>(base + L.f0);  // V_j of levels j0, j0 + 2, ...
  float* f1 = reinterpret_cast<float*>(base + L.f1);  // V_j of levels j0 + 1, j0 + 3, ...
  if (threadIdx.x == 0) jw::mbar_init(bar);
  __syncthreads();  // the taps and the barrier
  // the segment starts halo samples before the tile: staged at its offset
  // mod 16 in device memory, so that bulk copies take it whole
  const long long start = wrap(t0 - (L.len - tl), n);
  Tin* xs = stage_for(base + L.x, x + start);
  stage_segment(xs, x, start, L.len, n, bar);
  __syncthreads();  // the plain-loaded parts
  jw::mbar_wait(bar, 0);
  Tout* vout = orow + (long long)levels * n + t0;
  float* vscr = vrow ? vrow + t0 : nullptr;
  int valid = L.len;  // samples of V_{j-1} held, ending with the tile
  for (int j = j0; j <= j1; ++j) {
    const int gap = 1 << (j - 1);
    const bool odd = (j - j0) & 1;
    const float* fin = odd ? f0 : f1;  // V_{j-1} for j > j0
    Tout* wdst = orow + (long long)(j - 1) * n + t0;
    Tout* w = stage_for(base + (odd ? L.w1 : L.w0), wdst);
    if (j < j1) {
      float* fout = odd ? f1 : f0;
      if (j == j0) fwd_level(xs, fout, w, tl, valid, gap, m, g, h);
      else fwd_level(fin, fout, w, tl, valid, gap, m, g, h);
    } else if (to_out) {
      Tout* v = stage_for(base + L.v, vout);
      if (j == j0) fwd_level(xs, v, w, tl, valid, gap, m, g, h);
      else fwd_level(fin, v, w, tl, valid, gap, m, g, h);
    } else {
      float* v = stage_for(base + L.v, vscr);
      if (j == j0) fwd_level(xs, v, w, tl, valid, gap, m, g, h);
      else fwd_level(fin, v, w, tl, valid, gap, m, g, h);
    }
    valid -= (m - 1) * gap;
    jw::fence_async_smem();
    // level j-1's store has read its stage, which level j+1 writes next
    if (threadIdx.x == 0) jw::bulk_wait_read<0>();
    __syncthreads();
    store_segment(wdst, w, tl);
    if (j == j1) {
      if (to_out) store_segment(vout, stage_for(base + L.v, vout), tl);
      else store_segment(vscr, stage_for(base + L.v, vscr), tl);
    }
    if (threadIdx.x == 0) jw::bulk_commit();
  }
  if (threadIdx.x == 0) jw::bulk_wait_read<0>();  // the stages outlive the stores
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
__global__ void __launch_bounds__(kThreads)
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
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + kTapBytes);  // 0: V_j1, 1 + j1 - j: W_j
  const Tv* v0 = reinterpret_cast<const Tv*>(base + L.v0);
  float* cur = reinterpret_cast<float*>(base + L.f1);  // V_j for j < j1
  float* nxt = reinterpret_cast<float*>(base + L.f0);
  if (threadIdx.x == 0)
    for (int q = 0; q <= j1 - j0 + 1; ++q) jw::mbar_init(&bars[q]);
  __syncthreads();
  stage_segment(reinterpret_cast<Tv*>(base + L.v0), vsrc + row * vstride, t0, L.len, n, &bars[0]);
  for (int j = j1, off = L.w; j >= j0; off += round16(seg_len(tl, m, j0, j) * sizeof(Tc)), --j)
    stage_segment(reinterpret_cast<Tc*>(base + off), crow + (long long)(j - 1) * n, t0,
                  seg_len(tl, m, j0, j), n, &bars[1 + j1 - j]);
  __syncthreads();  // the plain-loaded parts of every stage
  jw::mbar_wait(&bars[0], 0);
  int valid = L.len;  // V_j is valid on [0, valid)
  for (int j = j1, off = L.w; j >= j0; off += round16(seg_len(tl, m, j0, j) * sizeof(Tc)), --j) {
    const int gap = 1 << (j - 1);
    const Tc* wj = reinterpret_cast<const Tc*>(base + off);
    jw::mbar_wait(&bars[1 + j1 - j], 0);
    if (j == j1)
      cascade_level<true>(v0, wj, nxt, static_cast<float*>(nullptr), 0, valid, gap, m, g, h);
    else
      cascade_level<true>(static_cast<const float*>(cur), wj, nxt, static_cast<float*>(nullptr),
                          0, valid, gap, m, g, h);
    __syncthreads();
    valid -= (m - 1) * gap;
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (j0 == 1) store_tile(out + row * n + t0, static_cast<const float*>(cur), tl);
  else store_tile(vnext + row * n + t0, static_cast<const float*>(cur), tl);
}

template <typename Tin, typename Tout>
int launch_fwd(const void* src, void* out, void* vnext, const void* taps, int rows, int n,
               int m, int levels, int j0, int j1, int tile, int staged, void* stream) {
  cudaGetLastError();
  const int tiles = (n + tile - 1) / tile;
  const int smem = staged ? fwd_layout(tile < n ? tile : n, m, j0, j1, sizeof(Tin), sizeof(Tout),
                                       j1 == levels ? sizeof(Tout) : sizeof(float)).bytes
                          : kTapBytes;
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
                          : kTapBytes;
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
