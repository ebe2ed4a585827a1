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
// The rotated forms of K8 and K9 (no TPU kernel: the 2D packet transform's
// axis passes, transforms/wpt.py::wpt2d and iwpt2d, which ran each pass in
// place and brought the other axis last by a transposing copy, two thirds
// of the packet cell's device time). Each takes (F group, n) full rows and
// stores (F, n, group): each group of rows transposed, so that on a stack of
// (H, W) frames the pass along W leaves (W, H) and the pass along H (H, W)
// again, with no copy. The same kernels with a template flag Rot (the
// in-place instantiations compile as before): whole rows of n <= 4096 (2^lg_g
// rows of h, the chunk's packets, a full row), two levels or more, items of
// rbf = 8 full rows (fewer where a block would not fit: 4 at 4096), so that
// each column run is a 32-byte sector. The level before the last (K9: level
// 2) writes each full row padded (rot_pad), and the last (k8_last_rotated;
// K9's level 1, k9_first_rotated) reads it a row a thread, neighbouring
// threads on neighbouring rows at one position, and stores from registers
// straight to the columns, as csrc/pyramid.cu's rotated K3 and K7 do. At 8
// rows of 2048 a block holds three 64 KB buffers (197,456 bytes): one block
// an SM, 256 compute threads. On the H100 (700 W; 16384 rows of 2048 in
// groups of 2048, db4 L6, device time after an L2 flush, the variants in one
// process; rows and threads: tools/ab_times.py --wpt-rot-plans): the
// rotated K8 0.2040 ms and K9 0.1796 (K8 then .contiguous(), the route
// before: 0.4291 and 0.4200); K8 (K9) in place with the same 8-row items, one
// block an SM, 0.1802 (0.1674), against 0.1512 (0.1428) at the in-place
// plan's 2-row items and four blocks an SM: a single block's barrier stalls,
// then ~0.02 ms of column stores. Left out, each an A/B in one process: 128
// compute threads (K8 0.2223, K9 0.2070); 384 and 512 (a build that took
// them: K8 0.2076, 0.2084; K9 0.1784, 0.1773); items of 4 rows, 16-byte runs (two blocks an SM:
// 0.4033, 0.4000; one block of 512: 0.3118, 0.3423), of 2 rows (0.64, 0.62)
// and of 1 row (0.88, 0.87), these with a store pass; the last level into
// shared memory and a store pass after it, by the compute threads (K8
// 0.2114, K9 0.1987) or by 1, 2 or 4 store warps while the compute threads
// go on (0.2351, 0.2103, 0.2064; 0.2279, 0.2013, 0.2002); the in-place
// plan's 2-row items with a block's 4 consecutive items gathered in a store
// buffer before one 8-row store (two blocks an SM, 115,280 bytes: 0.2341,
// 0.2269), 8 of them a 16-row store (64-byte runs, one block: 0.3296,
// 0.3217), and 1-row items, 8 a store (0.3122, 0.3069).
// Mirrored by ops/cuda_wpt.py (wpt_plan, wpt_layout, k8_count, k9_cones,
// wpt_grid, wpt_analysis_tiled_torch, wpt_synthesis_tiled_torch;
// wpt_rotated_plan, rot_pad, wpt_rotated_tiled_torch).
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

// The rotated forms take whole rows alone: an item is rbf = tile / n full
// rows of n samples (2^lg_g rows of h, the packets of the chunk, each), and
// the buffer that the level before the last (K9: level 2) writes holds full
// row q at q (n + rot_pad(rbf)): the rbf rows that one phase of a warp's
// 16-byte loads reads at one position, and the positions 4 apart beside
// them, fall on distinct banks.
__host__ __device__ inline int rot_pad(int rbf) { return rbf >= 8 ? 4 : 32 / rbf; }

__host__ __device__ inline WptLayout rot_layout(WptLayout L, int rbf) {
  const int p = rbf * rot_pad(rbf);
  L.set += p, L.buf += p, L.floats += 3 * p;
  return L;
}

// Full row R0 of the rotated forms' output (F, n, group), frame R0 / group:
// position k of full row R0 + q (an item stays in one frame) at the result +
// k group + q.
__device__ __forceinline__ float* rot_column(float* out, int n, int group, long long R0) {
  return out + (R0 / group) * n * (long long)group + R0 % group;
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
  int pad, pshift;  // Pad: pad floats more after each 2^pshift input packets' outputs
};

// MT > 0: m known at compile time (db4: 8, Haar: 2), the taps constant-bank
// operands; Wrap: packets read circularly (whole rows), else v.mask is -1;
// Pad (the rotated form's last level, into shared memory): the outputs of
// input packet b land v.pad * (b >> v.pshift) floats further, a row's pad.
template <int MT, bool Wrap, bool Pad = false>
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
      if constexpr (Pad) ob += v.pad * (w.b >> v.pshift);
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
    float* o = v.out;
    if constexpr (Pad) o += v.pad * (w.b >> v.pshift);
    o[2 * w.b * v.os + w.u] = sa;
    o[(2 * w.b + 1) * v.os + w.u] = sd;
  }
}

// The last level of K8's rotated form: v.in holds the item's full rows at a
// stride of ns floats (rot_pad), each 2^v.pshift input packets of v.is
// samples read circularly (v.mask); a and d of input packet bf of full row q
// are positions 2 bf hc + i and hc further of that row, stored to column q
// of ob (ob + pos group + q). A thread takes unit u, row q = u mod rbf, so
// the threads of a warp hold neighbouring rows at one position: each store
// writes contiguous runs of rbf floats of a few columns (32 bytes at rbf =
// 8), and the 16-byte loads of the padded rows are conflict-free. Groups of
// four output pairs as k8_level makes them, or a pair a unit.
template <int MT>
__device__ __forceinline__ void k8_last_rotated(const K8Level& v, int m, const Taps& tp, int tid,
                                                int nthr, int ns, int lg_rbf, int nf, float* ob,
                                                int group) {
  const int rmask = (1 << lg_rbf) - 1, hc = v.nout, lg_hc = __ffs(hc) - 1;
  if (MT > 0 && (reinterpret_cast<uintptr_t>(v.in) & 15) == 0 && ((v.is | ns) & 3) == 0 &&
      v.mask >= 7) {
    constexpr int R = MT > 0 ? MT : 1;
    constexpr int NV = (R + 6 + 3) / 4;  // float4s a group of four pairs reads
    const int lg_ng = lg_hc - 2;         // groups of four pairs an input packet
    for (int idx = tid; idx < 1 << (v.pshift + lg_ng + lg_rbf); idx += nthr) {
      const int q = idx & rmask, rest = idx >> lg_rbf;
      const int bf = rest >> lg_ng, u = rest & ((1 << lg_ng) - 1);
      if (q >= nf) continue;
      const float* ib = v.in + q * ns + bf * v.is;
      float x[4 * NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const float4 t = *reinterpret_cast<const float4*>(ib + ((8 * u + 4 * k) & v.mask));
        x[4 * k] = t.x, x[4 * k + 1] = t.y, x[4 * k + 2] = t.z, x[4 * k + 3] = t.w;
      }
      float* o = ob + (long long)(2 * bf * hc + 4 * u) * group + q;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float sa = 0.f, sd = 0.f;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          sa = fmaf(tp.lo[j], x[2 * p + j], sa);
          sd = fmaf(tp.hi[j], x[2 * p + j], sd);
        }
        o[(long long)p * group] = sa;
        o[(long long)(hc + p) * group] = sd;
      }
    }
    return;
  }
  const int mm = MT > 0 ? MT : m;
  for (int idx = tid; idx < 1 << (v.pshift + lg_hc + lg_rbf); idx += nthr) {
    const int q = idx & rmask, rest = idx >> lg_rbf;
    const int bf = rest >> lg_hc, u = rest & (hc - 1);
    if (q >= nf) continue;
    const float* ib = v.in + q * ns + bf * v.is;
    float sa = 0.f, sd = 0.f;
#pragma unroll
    for (int j = 0; j < mm; ++j) {
      const float x = ib[(2 * u + j) & v.mask];
      sa = fmaf(tp.lo[j], x, sa);
      sd = fmaf(tp.hi[j], x, sd);
    }
    float* o = ob + (long long)(2 * bf * hc + u) * group + q;
    o[0] = sa;
    o[(long long)hc * group] = sd;
  }
}

// K8: `levels` analysis levels of the packets of each row of (rows, h); a
// grid of persistent blocks over the work items, block b taking items b, b +
// gridDim.x, ...; the last warp stages, the blockDim.x - 32 threads before
// it compute (see the header). Rot, the rotated form: whole rows, 2^lg_g of
// them a full row of n = h 2^lg_g, tile / n full rows an item, at least two
// levels; the last level (k8_last_rotated) writes full row R of frame f = R
// / group to out (F, n, group) as its column R mod group (group, lg_g and
// interleaved are 0 in place).
template <int MT, bool Rot>
__global__ void __launch_bounds__(kMaxBlock, 1)
wpt_analysis_kernel(const float* __restrict__ src, float* __restrict__ out,
                    const __grid_constant__ Taps tp, int rows, int h, int tile, int levels, int m,
                    int interleaved, int group, int lg_g) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + 2;
  const int rbf = Rot ? tile / (h << lg_g) : 1;  // full rows an item
  const WptLayout L = Rot ? rot_layout(k8_layout(h, tile, levels, m), rbf)
                          : k8_layout(h, tile, levels, m);
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
      if constexpr (Rot) {
        // level levels - 1 lands with each full row padded (input packet b
        // in full row b >> (l - 1 + lg_g)), and the last level reads it a
        // row a thread and stores to the columns
        v.pad = rot_pad(rbf), v.pshift = l - 1 + lg_g;
        if (l == levels)
          k8_last_rotated<MT>(v, m, tp, tid, nthr, (h << lg_g) + v.pad, __ffs(rbf) - 1,
                              nr >> lg_g, rot_column(out, h << lg_g, group, r0 >> lg_g), group);
        else if (l == levels - 1)
          k8_level<MT, true, true>(v, m, tp, tid, nthr);
        else
          k8_level<MT, true>(v, m, tp, tid, nthr);
      } else {
        // subband: the last level's packet j is subband j & (S-1) of row r0 +
        // (j >> levels), at orow + i0 + j hc
        if (l == levels && !interleaved) v.out = orow + i0, v.os = hc;
        if (whole)
          k8_level<MT, true>(v, m, tp, tid, nthr);
        else
          k8_level<MT, false>(v, m, tp, tid, nthr);
      }
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
  int pad, pshift;  // Pad: pad floats more after each 2^pshift output packets
};

// MH > 0: ceil(m/2) known at compile time (db4: 4, Haar: 1), the taps
// constant-bank operands; Wrap: some input packet is read circularly (a
// whole packet or whole rows), else v.mask is -1; Pad (the rotated form's
// level 1, into shared memory): output packet b lands v.pad * (b >>
// v.pshift) floats further, a row's pad.
template <int MH, bool Wrap, bool Pad = false>
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
      float* ob = v.out + (long long)w.b * v.os + 8 * w.u;
      if constexpr (Pad) ob += v.pad * (w.b >> v.pshift);
      float4* xr = reinterpret_cast<float4*>(ob);
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
    if constexpr (Pad) xo += v.pad * (w.b >> v.pshift);
    xo[0] = x0;
    xo[1] = x1;
  }
}

// Level 1 of K9's rotated form: v.in holds the item's full rows at a stride
// of ns floats (rot_pad), each 2^v.pshift rows of h = 2 v.half, a row's a
// and d halves side by side; pair c of row kr of full row q is positions kr
// h + 2c and + 1 of that row, stored to column q of ob (ob + pos group + q).
// A thread takes unit u, row q = u mod rbf, as k8_last_rotated does. Groups
// of four pairs as k9_level makes them, or a pair a unit.
template <int MH>
__device__ __forceinline__ void k9_first_rotated(const K9Level& v, int mh, const Taps& tp,
                                                 int tid, int nthr, int ns, int lg_rbf, int nf,
                                                 float* ob, int group) {
  const int rmask = (1 << lg_rbf) - 1, half = v.half, lg_half = __ffs(half) - 1;
  if (MH > 0 && (reinterpret_cast<uintptr_t>(v.in) & 15) == 0 && (ns & 3) == 0 && half >= 4) {
    constexpr int R = MH > 0 ? MH : 1;
    constexpr int W = R > 1 ? 4 : 0;  // window samples before the group
    const int lg_ng = lg_half - 2;    // groups of four pairs a row of h
    for (int idx = tid; idx < 1 << (v.pshift + lg_ng + lg_rbf); idx += nthr) {
      const int q = idx & rmask, rest = idx >> lg_rbf;
      const int kr = rest >> lg_ng, u = rest & ((1 << lg_ng) - 1);
      if (q >= nf) continue;
      const float* ar = v.in + q * ns + 2 * kr * half;
      const float* dr = ar + half;
      float av[W + 4], dv[W + 4];
      if constexpr (W > 0) {
        const int i = (4 * u - 4) & v.mask;
        const float4 wa = *reinterpret_cast<const float4*>(ar + i);
        const float4 wd = *reinterpret_cast<const float4*>(dr + i);
        av[0] = wa.x, av[1] = wa.y, av[2] = wa.z, av[3] = wa.w;
        dv[0] = wd.x, dv[1] = wd.y, dv[2] = wd.z, dv[3] = wd.w;
      }
      const float4 ca = *reinterpret_cast<const float4*>(ar + 4 * u);
      const float4 cd = *reinterpret_cast<const float4*>(dr + 4 * u);
      av[W] = ca.x, av[W + 1] = ca.y, av[W + 2] = ca.z, av[W + 3] = ca.w;
      dv[W] = cd.x, dv[W + 1] = cd.y, dv[W + 2] = cd.z, dv[W + 3] = cd.w;
      float* o = ob + (long long)(2 * kr * half + 8 * u) * group + q;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x0 = 0.f, x1 = 0.f;
#pragma unroll
        for (int t = 0; t < R; ++t) {
          x0 = fmaf(tp.hi[2 * t], dv[W + j - t], fmaf(tp.lo[2 * t], av[W + j - t], x0));
          x1 = fmaf(tp.hi[2 * t + 1], dv[W + j - t], fmaf(tp.lo[2 * t + 1], av[W + j - t], x1));
        }
        o[(long long)(2 * j) * group] = x0;
        o[(long long)(2 * j + 1) * group] = x1;
      }
    }
    return;
  }
  for (int idx = tid; idx < 1 << (v.pshift + lg_half + lg_rbf); idx += nthr) {
    const int q = idx & rmask, rest = idx >> lg_rbf;
    const int kr = rest >> lg_half, c = rest & (half - 1);
    if (q >= nf) continue;
    const float* ar = v.in + q * ns + 2 * kr * half;
    const float* dr = ar + half;
    float x0 = 0.f, x1 = 0.f;
#pragma unroll
    for (int t = 0; t < (MH > 0 ? MH : mh); ++t) {
      const int i = (c - t) & v.mask;
      const float a = ar[i], d = dr[i];
      x0 = fmaf(tp.hi[2 * t], d, fmaf(tp.lo[2 * t], a, x0));
      x1 = fmaf(tp.hi[2 * t + 1], d, fmaf(tp.lo[2 * t + 1], a, x1));
    }
    float* o = ob + (long long)(2 * kr * half + 2 * c) * group + q;
    o[0] = x0;
    o[group] = x1;
  }
}

// K9: `levels` synthesis levels of the packets of each row of (rows, h),
// coarsest first; persistent blocks and a producer warp as K8's (see the
// header). Rot, the rotated form, as K8's: level 1 (k9_first_rotated) writes
// the full rows to their columns.
template <int MH, bool Rot>
__global__ void __launch_bounds__(kMaxBlock, 1)
wpt_synthesis_kernel(const float* __restrict__ src, float* __restrict__ out,
                     const __grid_constant__ Taps tp, int rows, int h, int tile, int levels, int m,
                     int interleaved, int group, int lg_g) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + 2;
  // set s's cone tables: R_l's start, count and whether it is its whole
  // packet (l = 1 .. levels + 1), written by the producer with the item
  int* tabs = reinterpret_cast<int*>(empty + 2);  // set s's at tabs + 3 s kMeta
  const int rbf = Rot ? tile / (h << lg_g) : 1;  // full rows an item
  const WptLayout L = Rot ? rot_layout(k9_layout(h, tile, levels, m), rbf)
                          : k9_layout(h, tile, levels, m);
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
      if constexpr (Rot) {
        // level 2 lands with each full row padded (its output packet b in
        // full row b >> (1 + lg_g)), and level 1 reads it a row a thread and
        // stores to the columns
        v.pad = rot_pad(rbf), v.pshift = l - 1 + lg_g;
        if (l == 1)
          k9_first_rotated<MH>(v, mh, tp, tid, nthr, (h << lg_g) + v.pad, __ffs(rbf) - 1,
                               nr >> lg_g, rot_column(out, h << lg_g, group, r0 >> lg_g),
                               group);
        else if (l == 2)
          k9_level<MH, true, true>(v, mh, tp, tid, nthr);
        else
          k9_level<MH, true>(v, mh, tp, tid, nthr);
      } else {
        if (v.mask != -1)
          k9_level<MH, true>(v, mh, tp, tid, nthr);
        else
          k9_level<MH, false>(v, mh, tp, tid, nthr);
      }
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
           int m, int interleaved, int group = 0, int lg_g = 0) {
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
                                             interleaved, group, lg_g);
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

// The rotated forms' arguments besides those: rows of h, 2^lg_g a full row
// of n (at least 4), tile = rbf n with rbf a power of two up to 32 that
// divides group, and whole groups of full rows.
bool rot_refused(int rows, int h, int tile, int group, int lg_g) {
  if (lg_g < 0 || lg_g > 20 || h < 1 || group < 1 || (rows & ((1 << lg_g) - 1))) return true;
  const long long n = (long long)h << lg_g;
  if (n < 4 || n > tile || tile % n) return true;
  const int rbf = (int)(tile / n);
  return !pow2(rbf) || rbf > 32 || group % rbf || (rows >> lg_g) % group;
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
  auto kern = m == 8 ? wpt_analysis_kernel<8, false> : m == 2 ? wpt_analysis_kernel<2, false>
                                                              : wpt_analysis_kernel<0, false>;
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
  auto kern = m == 8 ? wpt_synthesis_kernel<4, false> : m == 2 ? wpt_synthesis_kernel<1, false>
                                                               : wpt_synthesis_kernel<0, false>;
  return launch(kern, smem, grid, threads, blocks_per_sm, (cudaStream_t)stream,
                (const float*)src, (float*)out, (const float*)taps, rows, h, tile, levels, m,
                interleaved);
}

// The rotated forms of K8 and K9: the same levels on rows of h, subband-major
// (no interleaved layout), with (rows / 2^lg_g, n = h 2^lg_g) full rows
// stored rotated within each group of `group`: (F group, n) as (F, n,
// group); tile = rbf n, rbf full rows an item (rot_refused has the rule).
int jw_wpt_analysis_rotated(const void* src, void* out, const void* taps, int rows, int h,
                            int tile, int levels, int m, int threads, int grid, int group,
                            int lg_g, int* blocks_per_sm, void* stream) {
  cudaGetLastError();
  if (rot_refused(rows, h, tile, group, lg_g) || levels < 2 ||
      refused(items_of(rows, h, tile, levels, m, threads), grid, blocks_per_sm))
    return (int)cudaErrorInvalidValue;
  const int smem = rot_layout(k8_layout(h, tile, levels, m), tile / (h << lg_g)).floats *
                   (int)sizeof(float);
  auto kern = m == 8 ? wpt_analysis_kernel<8, true> : m == 2 ? wpt_analysis_kernel<2, true>
                                                             : wpt_analysis_kernel<0, true>;
  return launch(kern, smem, grid, threads, blocks_per_sm, (cudaStream_t)stream,
                (const float*)src, (float*)out, (const float*)taps, rows, h, tile, levels, m, 0,
                group, lg_g);
}

int jw_wpt_synthesis_rotated(const void* src, void* out, const void* taps, int rows, int h,
                             int tile, int levels, int m, int threads, int grid, int group,
                             int lg_g, int* blocks_per_sm, void* stream) {
  cudaGetLastError();
  if (rot_refused(rows, h, tile, group, lg_g) || levels < 2 ||
      refused(items_of(rows, h, tile, levels, m, threads), grid, blocks_per_sm))
    return (int)cudaErrorInvalidValue;
  const int smem = rot_layout(k9_layout(h, tile, levels, m), tile / (h << lg_g)).floats *
                   (int)sizeof(float);
  auto kern = m == 8 ? wpt_synthesis_kernel<4, true> : m == 2 ? wpt_synthesis_kernel<1, true>
                                                              : wpt_synthesis_kernel<0, true>;
  return launch(kern, smem, grid, threads, blocks_per_sm, (cudaStream_t)stream,
                (const float*)src, (float*)out, (const float*)taps, rows, h, tile, levels, m, 0,
                group, lg_g);
}

}  // extern "C"
