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
// 65536 f32: 33.5 MB, 10 us at 3.35 TB/s; the same bytes moved by torch
// copies take 17.6 us). Beside it, the arithmetic: ~2cM flops a sample,
// 216 M FMAs a launch at db4 L6, 7 us at the float32 rate with no other
// instruction; and the levels' shared-memory traffic, every level about as
// wide as the tile (K8 keeps ~4500, 4500, ..., 4096 outputs an item at db4
// L6, ~26,400 in all; K9 makes 4352 ... 4096), ~12 bytes of shared loads
// and stores an output, ~325 MB a launch, ~10 us at the SMs' ~33 TB/s.
// Where the first design (one item a block) spent its time, from a throwaway
// copy stamping %globaltimer in each block (PERF.md, section 6): at
// 64 x 65536 db4 L6 the 528 blocks of the first wave (four an SM) waited
// 4.6 us (K8) and 5.4 us (K9) for their copies, ran the levels for 10.8 and
// 8.2 us with no copy in flight and stored for 1 us; the 496 of the second
// wave started at ~17.7 us and did the same; the whole-row chunks likewise.
// The design:
//  - Work items, one wave of persistent blocks. A row longer than the tile
//    T (4096 output samples; T >= 8S) is cut into items of P = T / S
//    positions of every subband; rows of at most T run T / h whole rows an
//    item, the last item shorter (at full depth on 65536: 4 rows of 1024,
//    256 of 16). The host launches min(items, SMs x blocks an SM) blocks
//    (the occupancy calculator's count, asked once a plan:
//    ops/cuda_wpt.py::wpt_grid; four an SM); block b takes items b, b +
//    grid, ... in that order.
//  - K8's item stages the contiguous window x[(S i0 + k) mod h], k < T +
//    (M-1)(S-1), which holds every sample its outputs read, and runs the
//    levels on it without a wrap: level l keeps the (T >> l) + (M-1)(2^(c-l)
//    - 1) outputs of each of its 2^l packets that later levels read
//    (k8_count). K9's item owns T output samples of a row and stages the
//    dependency cone of each of the S subbands (half of the level below and
//    ceil(M/2) - 1 more to the left, its ends rounded out to multiples of 8
//    as K7's cones are, or the whole packet, then read circularly). Whole
//    rows run every level circularly within their packets, however short
//    (rows of 16 at c = 4 read 105 taps mod 16).
//  - A producer warp, the block's last, stages item k + 1 into stage set
//    (k + 1) & 1 once the consumers have released item k - 1 there (an
//    "empty" mbarrier): bulk copies (TMA) of the parts 16-byte aligned on
//    both sides, plain loads of the rest; one run (a window, whole rows, the
//    interleaved raw run) is the warp's, its lane 0 starting the copies, and
//    K9's S cone runs are a lane's each. A "full" mbarrier a set takes the
//    32 lanes' arrivals and the bytes, and K9's cone tables ride in the set.
//    So item k + 1's copies fly while the compute threads run item k.
//  - 128 compute threads (a named barrier, which the producer is not in,
//    after each level) run the levels from the stage set into one level
//    buffer and back: the set is released only after the item's last level,
//    so a level may write it, and a block holds three window-sized buffers
//    (55,072 and 55,760 bytes at db4 L6: four blocks an SM). Before the set
//    is released its writers fence it for the next bulk copies.
//  - The levels are bound by instruction throughput, not by shared-memory
//    banks (a thread's group of four output pairs is 64 FMAs beside its
//    loads, stores and index arithmetic), so the rest was cut: the taps are a
//    kernel parameter (constant-bank operands of the FMAs: no registers, no
//    loads), a thread's (packet, group) steps by constants found with two
//    divisions a level (a division a group cost as much as its loads), and
//    tiled items read their windows with no wrap mask. A thread makes four
//    consecutive output pairs of one packet from float4 reads (db4's and
//    Haar's taps unrolled) and writes them as float4s; other banks and
//    packets shorter than 8 take a pair a thread, unrolled for db4 and Haar.
//  - K8's last level stores straight to the output in the subband layout
//    (S runs of P floats, float4 stores); the interleaved layout lands in
//    shared memory and leaves as one contiguous run of S P floats. K9 reads
//    the interleaved layout as one contiguous run and transposes it in
//    shared memory; its level 1 stores straight to the output.
// On the H100 ("NVIDIA H100 80GB HBM3, 700.00 W"; tools/ab_times.py, the first design's
// tree in the same process, PERF.md section 6) 64 x 65536 db4 L6 takes
// 0.0301 ms in K8 and 0.0310 in K9 (the first design: 0.0385, 0.0418), 4096 rows of
// 1024 at L6 0.0284 and 0.0272, 262144 rows of 16 at L4 0.0310 and 0.0311.
// Left out, each an A/B in one process on the card (PERF.md, section 6):
// reading a group's float4s in another order on lanes 4-7 of each
// quarter-warp (no bank conflict; 72 registers, K8 +4% at 128 threads);
// the levels after the first kept in two phases, even samples before odd
// (conflict-free float4 reads and float2 writes; K8 0.0313 against 0.0311
// ms); K9's two float4 stores in turns (+6%); two groups a thread a pass
// (96 registers, +8%); warps owning their packets' subtrees with no block
// barrier (packets move between levels in a tiled item: a race; whole rows
// only: -6% to -9% at rows of 16, +2% to +12% at 1024); 256 compute
// threads (K8 +4%, K9 +9%); tiles of 2048 (+18%); the 56 registers that
// __launch_bounds__ gave with no blocks-an-SM floor (16-24 bytes of spills;
// K8 +3%, K9 +4%); two levels in registers a pass (not tried: a third more
// FMAs where the FMAs already take most of the levels' instructions).
// Mirrored by ops/cuda_wpt.py (wpt_plan, wpt_layout, k8_count, k9_cones,
// wpt_grid, wpt_analysis_tiled_torch, wpt_synthesis_tiled_torch).
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kMaxTaps = 64;
constexpr int kMaxThreads = 256;             // compute threads
constexpr int kMaxBlock = kMaxThreads + 32;  // and the producer warp
constexpr int kMaxLevels = 12;
constexpr int kMeta = 16;   // ints of each cone table (levels 1 .. kMaxLevels + 1)
constexpr int kSlack = 16;  // floats past a tiled K8 buffer that a group's reads may reach
// shared floats before the stage sets: each set's two mbarriers (it is
// full, it is empty) and its three cone tables (K9)
constexpr int kHead = 2 * 2 * 2 + 2 * 3 * kMeta;

// The taps [lo | hi] with the gain folded in, zero past m: a kernel
// parameter, so that the unrolled levels read them as constant-bank operands
// of their FMAs (no registers, no loads).
struct Taps {
  float lo[kMaxTaps], hi[kMaxTaps];
};

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

// Floats of a stage set and of the level buffer; a block holds the head,
// two sets and the buffer. Level l reads the set (l odd) or the buffer and
// writes the other. Whole rows: T / h rows, T floats (and the round-up of a
// staged run) each. K8 tiled: the window and the even levels' 2^l packets
// at a stride of round4(k8_count) in a set, the odd levels' in the buffer,
// each with kSlack behind. K9 tiled: the S staged cones (or the interleaved
// layout's raw run) and each level's 2^(l-1) cones at a stride of
// round4(count), in either (the transposed cones of the interleaved layout
// move the parity by one); level 1 stores to the output.
struct WptLayout {
  int set, buf, floats;
};

__host__ __device__ inline WptLayout k8_layout(int h, int tile, int levels, int m) {
  WptLayout L;
  if (h <= tile) {
    L.set = L.buf = tile + 4;
  } else {
    int set = round4(k8_count(tile, levels, m, 0)), buf = 0;
    for (int l = 1; l <= levels; ++l) {
      const int f = (1 << l) * round4(k8_count(tile, levels, m, l));
      if (l & 1) buf = max(buf, f);
      else set = max(set, f);
    }
    L.set = set + kSlack, L.buf = buf + kSlack;
  }
  L.floats = kHead + 2 * L.set + L.buf;
  return L;
}

__host__ __device__ inline WptLayout k9_layout(int h, int tile, int levels, int m) {
  WptLayout L;
  if (h <= tile) {
    L.set = L.buf = tile + 4;
  } else {
    const int mh = (m + 1) / 2;
    int s = 0, cnt = tile, whole = 0, f = 0;
    for (int l = 1; l <= levels; ++l) {
      if (l >= 2) f = max(f, (1 << (l - 1)) * round4(cnt));
      k9_cone_next(s, cnt, whole, h >> l, mh);
    }
    L.set = L.buf = max(f, max((1 << levels) * round4(cnt), round4(cnt << levels) + 4));
  }
  L.floats = kHead + 2 * L.set + L.buf;
  return L;
}

// The barriers: each set's "full" for the producer's 32 arrivals and its
// bytes, its "empty" for the consumers' one; the caller's __syncthreads
// publishes them.
__device__ void k89_setup(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;\n" ::"r"(jw::smem_addr(full + s))
                   : "memory");
      jw::mbar_init(empty + s);
    }
  }
}

// The compute threads' barrier: named barrier 1 over the nthr threads before
// the producer warp.
__device__ __forceinline__ void consumers_sync(int nthr) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nthr) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(jw::smem_addr(bar))
               : "memory");
}

// q = idx / d and r = idx % d for 0 <= idx < 2^20, inv = 1.f / d: the float
// quotient is off by at most one, which the remainder's sign corrects.
__device__ __forceinline__ void divmod(int idx, int d, float inv, int& q, int& r) {
  q = __float2int_rz(__int2float_rn(idx) * inv);
  r = idx - q * d;
  if (r < 0) {
    q -= 1, r += d;
  } else if (r >= d) {
    q += 1, r -= d;
  }
}

// A thread's work units of a level, idx = tid, tid + nthr, ... < nb * n as
// (b, u) = (idx / n, idx % n): two divisions a level, then a step of (nthr /
// n, nthr % n) a unit (a division a unit cost as much as its loads).
struct Walk {
  int b, u, db, du;
  __device__ __forceinline__ Walk(int tid, int nthr, int n) {
    const float inv = 1.f / n;
    divmod(tid, n, inv, b, u);
    divmod(nthr, n, inv, db, du);
  }
  __device__ __forceinline__ void step(int n) {
    u += du, b += db;
    if (u >= n) u -= n, ++b;
  }
};

// One run of a stage, as jw::stage_segment cuts it: samples [t0, t0 + cnt)
// mod n of `row` into dst[0, round4(cnt)) (dst 16-byte aligned), one piece a
// pass over the row, the parts 16-byte aligned on both sides by bulk
// copies. kPlain: threads tid, tid + nthr, ... load the rest plainly;
// kBulk: start the copies (one thread). Either returns the copies' bytes.
enum StageStep { kPlain, kBulk };

__device__ __forceinline__ uint32_t stage_run(StageStep step, float* dst, const float* row,
                                              long long t0, int cnt, int n, uint64_t* bar,
                                              int tid, int nthr) {
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
    bulk_bytes += body * sizeof(float);
    if (step == kBulk) {
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

// The producer warp's staging of one item: `runs` runs, run k samples [t0,
// t0 + cnt) mod n of row + k * rstride into dst + k * dstride. One run is
// the warp's (every lane loads a share of its plain parts, lane 0 starts its
// copies); of several runs lane j takes runs j, j + 32, ... whole. Each lane
// then arrives on `full` once, announcing the bytes of the copies it starts
// next (its plain loads before the arrival, which releases them).
__device__ __forceinline__ void produce(float* dst, int dstride, const float* row,
                                        long long rstride, int runs, long long t0, int cnt, int n,
                                        uint64_t* full, int lane) {
  uint32_t bytes = 0;
  if (runs == 1) {
    bytes = stage_run(kPlain, dst, row, t0, cnt, n, full, lane, 32);
    if (lane != 0) bytes = 0;
  } else {
    for (int k = lane; k < runs; k += 32)
      bytes += stage_run(kPlain, dst + k * dstride, row + k * rstride, t0, cnt, n, full, 0, 1);
  }
  jw::mbar_expect(full, bytes);
  if (runs == 1) {
    if (lane == 0) stage_run(kBulk, dst, row, t0, cnt, n, full, 0, 1);
  } else {
    for (int k = lane; k < runs; k += 32)
      stage_run(kBulk, dst + k * dstride, row + k * rstride, t0, cnt, n, full, 0, 1);
  }
}

// ---- K8: one analysis level ----
// Input packet b (b < nb) at in + b * is, read at (2u + j) & mask (mask: the
// packet's length - 1 where packets are whole, read circularly; else -1);
// its a and d of nout outputs go to packets 2b and 2b + 1 at out + k * os
// (shared memory, or the output row for the last level).
struct K8Level {
  const float* in;
  float* out;
  int nb, is, os, nout, mask;
};

// MT > 0: m known at compile time (db4: 8, Haar: 2), the taps constant-bank
// operands; Wrap: packets read circularly (whole rows), else v.mask is -1.
template <int MT, bool Wrap>
__device__ __forceinline__ void k8_level(const K8Level& v, int m, const Taps& tp, int tid,
                                         int nthr) {
  const uintptr_t al = reinterpret_cast<uintptr_t>(v.in) | reinterpret_cast<uintptr_t>(v.out);
  if (MT > 0 && (al & 15) == 0 && ((v.is | v.os) & 3) == 0 && (!Wrap || v.mask >= 7)) {
    constexpr int R = MT > 0 ? MT : 1;
    constexpr int NV = (R + 6 + 3) / 4;  // float4s a group of four pairs reads: 4 (db4), 2 (Haar)
    const int ng = (v.nout + 3) >> 2;
    for (Walk w(tid, nthr, ng); w.b < v.nb; w.step(ng)) {
      const float* ib = v.in + w.b * v.is;
      float x[4 * NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int i = 8 * w.u + 4 * k;
        const float4 q = *reinterpret_cast<const float4*>(ib + (Wrap ? i & v.mask : i));
        x[4 * k] = q.x, x[4 * k + 1] = q.y, x[4 * k + 2] = q.z, x[4 * k + 3] = q.w;
      }
      float a[4], d[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float sa = 0.f, sd = 0.f;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          sa = fmaf(tp.lo[j], x[2 * p + j], sa);
          sd = fmaf(tp.hi[j], x[2 * p + j], sd);
        }
        a[p] = sa, d[p] = sd;
      }
      float* ob = v.out + 2 * w.b * v.os + 4 * w.u;
      *reinterpret_cast<float4*>(ob) = make_float4(a[0], a[1], a[2], a[3]);
      *reinterpret_cast<float4*>(ob + v.os) = make_float4(d[0], d[1], d[2], d[3]);
    }
    return;
  }
  const int mm = MT > 0 ? MT : m;
  for (Walk w(tid, nthr, v.nout); w.b < v.nb; w.step(v.nout)) {
    const float* ib = v.in + w.b * v.is;
    float sa = 0.f, sd = 0.f;
#pragma unroll
    for (int j = 0; j < mm; ++j) {
      const float x = ib[(2 * w.u + j) & v.mask];
      sa = fmaf(tp.lo[j], x, sa);
      sd = fmaf(tp.hi[j], x, sd);
    }
    v.out[2 * w.b * v.os + w.u] = sa;
    v.out[(2 * w.b + 1) * v.os + w.u] = sd;
  }
}

// K8: `levels` analysis levels of the packets of each row of (rows, h); a
// grid of persistent blocks over the work items, block b taking items b, b +
// gridDim.x, ...; the last warp stages, the blockDim.x - 32 threads before
// it compute (see the header).
template <int MT>
__global__ void __launch_bounds__(kMaxBlock, 1)
wpt_analysis_kernel(const float* __restrict__ src, float* __restrict__ out,
                    const __grid_constant__ Taps tp, int rows, int h, int tile, int levels, int m,
                    int interleaved) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + 2;
  const WptLayout L = k8_layout(h, tile, levels, m);
  float* buf = smem + kHead + 2 * L.set;
  const int S = 1 << levels, hc = h >> levels;
  const bool whole = h <= tile;
  const int rb = whole ? tile / h : 1;  // rows an item
  const int tiles = whole ? 1 : h / tile;
  const int P = whole ? hc : tile >> levels;
  const long long items = whole ? ((long long)rows + rb - 1) / rb : (long long)rows * tiles;
  const int tid = threadIdx.x, nthr = blockDim.x - 32;
  k89_setup(full, empty);
  __syncthreads();

  if (tid >= nthr) {
    // the producer warp: item k into set k & 1 once item k - 2 has left it
    const int lane = tid - nthr;
    int k = 0;
    for (long long item = blockIdx.x; item < items; item += gridDim.x, ++k) {
      const int s = k & 1;
      if (k >= 2) jw::mbar_wait(empty + s, ((k - 2) >> 1) & 1);
      float* set = smem + kHead + s * L.set;
      if (whole) {
        const long long r0 = item * rb;
        const int cnt = (int)min((long long)rb, rows - r0) * h;
        produce(set, 0, src + r0 * h, 0, 1, 0, cnt, cnt, full + s, lane);
      } else {
        produce(set, 0, src + (item / tiles) * h, 0, 1, (item % tiles) * (long long)tile,
                k8_count(tile, levels, m, 0), h, full + s, lane);
      }
    }
    return;
  }

  int k = 0;
  for (long long item = blockIdx.x; item < items; item += gridDim.x, ++k) {
    const int s = k & 1;
    float* set = smem + kHead + s * L.set;
    const long long r0 = whole ? item * rb : item / tiles;
    const int nr = whole ? (int)min((long long)rb, rows - r0) : 1;
    const int i0 = whole ? 0 : (int)(item % tiles) * P;
    float* orow = out + r0 * h;
    jw::mbar_wait(full + s, (k >> 1) & 1);
    for (int l = 1; l <= levels; ++l) {
      K8Level v;
      v.in = (l & 1) ? set : buf;
      v.out = (l & 1) ? buf : set;
      v.nb = nr << (l - 1);
      if (whole) {
        v.is = h >> (l - 1), v.os = v.nout = h >> l, v.mask = (h >> (l - 1)) - 1;
      } else {
        v.is = round4(k8_count(tile, levels, m, l - 1));
        v.nout = k8_count(tile, levels, m, l);
        v.os = round4(v.nout);
        v.mask = -1;
      }
      // subband: the last level's packet j is subband j & (S-1) of row r0 +
      // (j >> levels), at orow + i0 + j hc
      if (l == levels && !interleaved) v.out = orow + i0, v.os = hc;
      if (whole)
        k8_level<MT, true>(v, m, tp, tid, nthr);
      else
        k8_level<MT, false>(v, m, tp, tid, nthr);
      if (l == levels) jw::fence_async_smem();  // the set's writes before its next bulk copies
      consumers_sync(nthr);
    }
    if (interleaved) {
      // packet (q, s) of the last level: P outputs at F + (q S + s) P
      const float* F = (levels & 1) ? buf : set;
      const int lg = __ffs(P * S) - 1;  // a run: S P floats, a power of two
      const int total = nr << lg;
      for (int idx = tid; idx < total; idx += nthr) {
        const int q = idx >> lg, e = idx & ((1 << lg) - 1);  // e = p S + s
        orow[(long long)q * h + (long long)i0 * S + e] =
            F[(q * S + (e & (S - 1))) * P + (e >> levels)];
      }
      consumers_sync(nthr);
    }
    if (tid == 0) mbar_arrive(empty + s);  // every compute thread is past the item
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

// MH > 0: ceil(m/2) known at compile time (db4: 4, Haar: 1), the taps
// constant-bank operands; Wrap: some input packet is read circularly (a
// whole packet or whole rows), else v.mask is -1.
template <int MH, bool Wrap>
__device__ __forceinline__ void k9_level(const K9Level& v, int mh, const Taps& tp, int tid,
                                         int nthr) {
  const uintptr_t al = reinterpret_cast<uintptr_t>(v.in) | reinterpret_cast<uintptr_t>(v.out);
  if (MH > 0 && (al & 15) == 0 && ((v.is | v.os | v.npairs | v.off) & 3) == 0 &&
      (!Wrap || v.half >= 4)) {
    static_assert(MH <= 5, "one float4 of window before the group");
    constexpr int R = MH > 0 ? MH : 1;
    constexpr int W = R > 1 ? 4 : 0;  // window samples before the group
    const int ng = v.npairs >> 2;
    for (Walk w(tid, nthr, ng); w.b < v.nb; w.step(ng)) {
      const int i0 = v.off + 4 * w.u;  // a multiple of 4; below 0 only where the input wraps
      const float* ar = v.in + 2 * w.b * v.is;
      const float* dr = ar + v.is;
      float av[W + 4], dv[W + 4];
      if constexpr (W > 0) {
        const int i = Wrap ? (i0 - 4) & v.mask : i0 - 4;
        const float4 wa = *reinterpret_cast<const float4*>(ar + i);
        const float4 wd = *reinterpret_cast<const float4*>(dr + i);
        av[0] = wa.x, av[1] = wa.y, av[2] = wa.z, av[3] = wa.w;
        dv[0] = wd.x, dv[1] = wd.y, dv[2] = wd.z, dv[3] = wd.w;
      }
      const int i = Wrap ? i0 & v.mask : i0;
      const float4 ca = *reinterpret_cast<const float4*>(ar + i);
      const float4 cd = *reinterpret_cast<const float4*>(dr + i);
      av[W] = ca.x, av[W + 1] = ca.y, av[W + 2] = ca.z, av[W + 3] = ca.w;
      dv[W] = cd.x, dv[W + 1] = cd.y, dv[W + 2] = cd.z, dv[W + 3] = cd.w;
      float o[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x0 = 0.f, x1 = 0.f;
#pragma unroll
        for (int t = 0; t < R; ++t) {
          x0 = fmaf(tp.hi[2 * t], dv[W + j - t], fmaf(tp.lo[2 * t], av[W + j - t], x0));
          x1 = fmaf(tp.hi[2 * t + 1], dv[W + j - t], fmaf(tp.lo[2 * t + 1], av[W + j - t], x1));
        }
        o[2 * j] = x0, o[2 * j + 1] = x1;
      }
      float4* xr = reinterpret_cast<float4*>(v.out + (long long)w.b * v.os + 8 * w.u);
      xr[0] = make_float4(o[0], o[1], o[2], o[3]);
      xr[1] = make_float4(o[4], o[5], o[6], o[7]);
    }
    return;
  }
  for (Walk w(tid, nthr, v.npairs); w.b < v.nb; w.step(v.npairs)) {
    const int c = v.off + w.u;
    const float* ar = v.in + 2 * w.b * v.is;
    const float* dr = ar + v.is;
    float x0 = 0.f, x1 = 0.f;
#pragma unroll
    for (int t = 0; t < (MH > 0 ? MH : mh); ++t) {
      const int i = (c - t) & v.mask;
      const float a = ar[i], d = dr[i];
      x0 = fmaf(tp.hi[2 * t], d, fmaf(tp.lo[2 * t], a, x0));
      x1 = fmaf(tp.hi[2 * t + 1], d, fmaf(tp.lo[2 * t + 1], a, x1));
    }
    float* xo = v.out + (long long)w.b * v.os + 2 * w.u;
    xo[0] = x0;
    xo[1] = x1;
  }
}

// K9: `levels` synthesis levels of the packets of each row of (rows, h),
// coarsest first; persistent blocks and a producer warp as K8's (see the
// header).
template <int MH>
__global__ void __launch_bounds__(kMaxBlock, 1)
wpt_synthesis_kernel(const float* __restrict__ src, float* __restrict__ out,
                     const __grid_constant__ Taps tp, int rows, int h, int tile, int levels, int m,
                     int interleaved) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + 2;
  // set s's cone tables: R_l's start, count and whether it is its whole
  // packet (l = 1 .. levels + 1), written by the producer with the item
  int* tabs = reinterpret_cast<int*>(empty + 2);  // set s's at tabs + 3 s kMeta
  const WptLayout L = k9_layout(h, tile, levels, m);
  float* buf = smem + kHead + 2 * L.set;
  const int S = 1 << levels, hc = h >> levels, mh = (m + 1) / 2;
  const bool whole = h <= tile;
  const int rb = whole ? tile / h : 1;
  const int tiles = whole ? 1 : h / tile;
  const long long items = whole ? ((long long)rows + rb - 1) / rb : (long long)rows * tiles;
  const int tid = threadIdx.x, nthr = blockDim.x - 32;
  k89_setup(full, empty);
  __syncthreads();

  if (tid >= nthr) {
    const int lane = tid - nthr;
    int k = 0;
    for (long long item = blockIdx.x; item < items; item += gridDim.x, ++k) {
      const int s = k & 1;
      if (k >= 2) jw::mbar_wait(empty + s, ((k - 2) >> 1) & 1);
      float* set = smem + kHead + s * L.set;
      if (whole) {
        const long long r0 = item * rb;
        const int cnt = (int)min((long long)rb, rows - r0) * h;
        produce(set, 0, src + r0 * h, 0, 1, 0, cnt, cnt, full + s, lane);
        continue;
      }
      int* cs = tabs + 3 * s * kMeta;
      int* cn = cs + kMeta;
      int* cf = cn + kMeta;
      int st = (int)(item % tiles) * tile, cnt = tile, wh = 0;
      if (lane == 0) cs[1] = st, cn[1] = cnt, cf[1] = 0;
      for (int l = 1; l <= levels; ++l) {
        k9_cone_next(st, cnt, wh, h >> l, mh);
        if (lane == 0) cs[l + 1] = st, cn[l + 1] = cnt, cf[l + 1] = wh;
      }
      const float* row = src + (item / tiles) * h;
      const int sc = st & (hc - 1);  // the coarsest cone's start in each subband
      if (interleaved)
        produce(set, 0, row, 0, 1, (long long)sc * S, cnt * S, h, full + s, lane);
      else
        produce(set, round4(cnt), row, hc, S, sc, cnt, hc, full + s, lane);
    }
    return;
  }

  int k = 0;
  for (long long item = blockIdx.x; item < items; item += gridDim.x, ++k) {
    const int s = k & 1;
    float* set = smem + kHead + s * L.set;
    const int* cs = tabs + 3 * s * kMeta;
    const int* cn = cs + kMeta;
    const int* cf = cn + kMeta;
    const long long r0 = whole ? item * rb : item / tiles;
    const int nr = whole ? (int)min((long long)rb, rows - r0) : 1;
    const int t0 = whole ? 0 : (int)(item % tiles) * tile;
    jw::mbar_wait(full + s, (k >> 1) & 1);  // the item's stage and its tables
    // the coarsest level's packets: nc samples of each at a stride of cstride
    const int nc = whole ? hc : cn[levels + 1];
    const int cstride = whole ? hc : round4(nc);
    float* cur = set;
    float* other = buf;
    if (interleaved) {
      // raw: element (q, s, i) at q h + i S + s (whole rows) or i S + s
      const int per = S * nc, total = nr * per;
      const float inv_per = 1.f / per, inv_nc = 1.f / nc;
      for (int idx = tid; idx < total; idx += nthr) {
        int q, e, sb, i;
        divmod(idx, per, inv_per, q, e);
        divmod(e, nc, inv_nc, sb, i);
        buf[(q * S + sb) * cstride + i] = set[q * h + i * S + sb];
      }
      consumers_sync(nthr);
      cur = buf, other = set;
    }
    for (int l = levels; l >= 1; --l) {
      K9Level v;
      v.in = cur;
      v.out = l == 1 ? out + r0 * h + t0 : other;
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
      if (v.mask != -1)
        k9_level<MH, true>(v, mh, tp, tid, nthr);
      else
        k9_level<MH, false>(v, mh, tp, tid, nthr);
      if (l == 1) jw::fence_async_smem();  // the set's writes before its next bulk copies
      consumers_sync(nthr);
      float* t = cur;
      cur = other, other = t;
    }
    if (tid == 0) mbar_arrive(empty + s);
  }
}

// A launch of `grid` blocks of `threads` compute threads and the producer
// warp, or (blocks_per_sm non-null) the blocks an SM holds, launching nothing.
template <typename K>
int launch(K kern, int smem, int grid, int threads, int* blocks_per_sm, cudaStream_t stream,
           const float* src, float* out, const float* taps, int rows, int h, int tile, int levels,
           int m, int interleaved) {
  Taps tp;
  for (int j = 0; j < kMaxTaps; ++j) {
    tp.lo[j] = taps != nullptr && j < m ? taps[j] : 0.f;
    tp.hi[j] = taps != nullptr && j < m ? taps[m + j] : 0.f;
  }
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (blocks_per_sm != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern, threads + 32,
                                                              smem);
  kern<<<grid, threads + 32, smem, stream>>>(src, out, tp, rows, h, tile, levels, m,
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

bool refused(long long items, int grid, const int* blocks_per_sm) {
  return items < 1 || items >= (1LL << 31) || (blocks_per_sm == nullptr && grid < 1);
}

}  // namespace

extern "C" {

const char* jw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K8: `levels` fused analysis levels (1 .. kMaxLevels) of each row of (rows,
// h), h a power of two, into out, subband-major or (interleaved) at i S + s;
// work items of `tile` samples (a power of two, tile >> levels >= 8 where
// h > tile) or tile / h whole rows, taken by `grid` persistent blocks of
// `threads` compute threads (a multiple of 32, at most 256) and a producer
// warp; `taps`: 2m floats [lo | hi] in host memory, the gain folded in
// (passed by value); db4's 8 taps and Haar's 2 unroll at compile time. With
// `blocks_per_sm` non-null it launches nothing and writes the blocks an SM
// holds.
int jw_wpt_analysis(const void* src, void* out, const void* taps, int rows, int h, int tile,
                    int levels, int m, int interleaved, int threads, int grid,
                    int* blocks_per_sm, void* stream) {
  cudaGetLastError();
  if (refused(items_of(rows, h, tile, levels, m, threads), grid, blocks_per_sm))
    return (int)cudaErrorInvalidValue;
  const int smem = k8_layout(h, tile, levels, m).floats * (int)sizeof(float);
  auto kern = m == 8 ? wpt_analysis_kernel<8> : m == 2 ? wpt_analysis_kernel<2>
                                                       : wpt_analysis_kernel<0>;
  return launch(kern, smem, grid, threads, blocks_per_sm, (cudaStream_t)stream,
                (const float*)src, (float*)out, (const float*)taps, rows, h, tile, levels, m,
                interleaved);
}

// K9: the adjoint of K8 with the same arguments (its input in K8's layout).
int jw_wpt_synthesis(const void* src, void* out, const void* taps, int rows, int h, int tile,
                     int levels, int m, int interleaved, int threads, int grid,
                     int* blocks_per_sm, void* stream) {
  cudaGetLastError();
  if (refused(items_of(rows, h, tile, levels, m, threads), grid, blocks_per_sm))
    return (int)cudaErrorInvalidValue;
  const int smem = k9_layout(h, tile, levels, m).floats * (int)sizeof(float);
  auto kern = m == 8 ? wpt_synthesis_kernel<4> : m == 2 ? wpt_synthesis_kernel<1>
                                                        : wpt_synthesis_kernel<0>;
  return launch(kern, smem, grid, threads, blocks_per_sm, (cudaStream_t)stream,
                (const float*)src, (float*)out, (const float*)taps, rows, h, tile, levels, m,
                interleaved);
}

}  // extern "C"
