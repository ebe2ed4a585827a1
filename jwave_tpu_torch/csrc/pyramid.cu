// K3 and K4: the whole FWT pyramid along each row, for Hopper (sm_90a); K5
// and K7 its inverse.
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
// backward of ifwt2d. K3 takes its gain folded into the taps by the host
// (ops/cuda_pyramid.py::_gained_taps), the same scaling: with K7's filters
// and gain it is K7's adjoint, and K7 with K3's is K3's.
//
// Bound on this card: bytes. The pyramid does about 4M FMAs per sample in
// all (2M at level 1, halving after), against one read and one write of the
// row. The Pallas kernel's pair-tile matmuls exist for the TPU's MXU; here
// the butterfly is a direct FMA loop.
//
// K3's design: a row is spread over many blocks, by tiles with a halo.
// Output i of level l reads level-0 samples 2^l i .. 2^l i + (2^l - 1)(M - 1),
// circularly, so a block that owns `tile` samples of one row (a power of
// two, its start a multiple of it) runs the first lt levels on its own from
// tile + (2^lt - 1)(M - 1) samples, the halo lying to the right and wrapping
// mod N. The host picks the plan (ops/cuda_pyramid.py::k3_plan): tiles of
// 8192 samples, 256 threads, and the most levels whose halo stays within a
// quarter of the tile: all 8 levels of db4 L8 (halo 1785, 93 KB a block, two
// blocks an SM, 512 blocks at 64 x 65536). The first version ran one block
// of 192 KB a row (64 blocks on 132 SMs), read level 1 tap by tap from
// device memory and stored details 4 bytes a thread as they were made.
//  - The segment is staged before any arithmetic by bulk copies (TMA) at its
//    start's offset mod 16 (stage_segment, shared with K1: one copy a
//    wrapped piece, the ragged edges by plain loads); a start that is not
//    8-byte aligned takes plain loads, since the levels read float2.
//  - A level reads one shared buffer and writes another, linearly: the halo
//    is staged, so nothing wraps inside a tile, and only the outputs whose
//    window stays inside the staged samples are made (after level l,
//    tile/2^l + (2^(lt-l) - 1)(M - 1) approximations and the tile's tile/2^l
//    details). A float2 pair a tap pair (2i + k is even: conflict-free; the
//    taps past M are zero); db4's 8 taps are unrolled with a thread making
//    two outputs from 16-byte reads. One barrier a level.
//  - Level l's tile/2^l details are contiguous in out. Each level has a
//    stage of its own in shared memory (none is written twice, so no level
//    waits for a store), staged at its destination's offset mod 16, and one
//    thread sends it by a bulk store while the next level computes; the
//    ragged edges of an unaligned destination leave by plain stores.
//  - The tail. Where lt < levels (62 taps at L8: 5 tiled levels; or more
//    levels than a tile halves), the approximations of level lt go to a
//    scratch row by plain stores, and the block of a row that finishes last
//    (a counter a row, __threadfence and atomicAdd; that block zeroes it
//    again) runs the levels left on the row's h >> lt samples in its own
//    shared memory, circularly: one launch. A head left longer than a tile
//    (rows of 2^22 and more at db4) takes a further tiled pass on the
//    scratch row, and rows of at most 4096 samples run one block a row
//    (pyramid_tail_kernel), so rows of any length fit.
// On the H100 (PERF.md, "NVIDIA H100 80GB HBM3, 700.00 W") 64 x 65536 db4 L8
// takes 0.0260 ms (the first version 0.0524) against a bound of 0.0100
// (33.5 MB over 3.35 TB/s) and 0.0174 for a copy of the same rows by
// clone(); all 16 levels (a tail of 8 in the same launch) take 0.0313.
// Tiles of 4096 (four blocks an SM) and 16384 (one) took 0.027 at their best
// block size, tiles of 2048 0.029; 128 to 256 threads a block differ by
// under 2% at tiles of 8192, 512 threads cost 9%.
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
//
// K7 replaces jwave_tpu/ops/mxu_pyramid.py::fwt_inverse_fused (:159, no
// pallas_call: XLA matmuls; ifwt routes there at transforms/fwt.py:111-112,
// and fwt1d_fused's VJP at pallas_pyramid.py:460-470 is its linear
// transpose): the inverse pyramid of each row, output (R, N), any
// power-of-two N, K5's arithmetic with the gain folded into the taps. Per
// row, for heads h = N >> (L-1), ..., N, on a = y[:h/2], d = y[h/2:h]:
//   x[2c + q] = sum_t (lo[2t+q] a[(c-t) mod h/2] + hi[2t+q] d[(c-t) mod h/2])
// for q = 0, 1; x overwrites y[:h].
// Bound on this card: bytes, as for K3 (64 x 65536 f32 read once and written
// once: 33.5 MB, 10 us at 3.35 TB/s; ~4M FMAs a sample). JAX's dense head
// matrix and split matmuls exist for the MXU and are not carried over.
// Where the first design's time went (one block a tile of 8192, 512 blocks,
// three an SM; a throwaway copy stamping %globaltimer and clock64 in each
// block, PERF.md, section 6): at 64 x 65536 db4 L8 the 396 blocks of the first
// wave waited 5.9 us for their cones, then spent 9.2 us in the levels with
// no copy in flight, and the 116 of the second wave, starting at 14 us,
// repeated both; a level cost ~0.4 us however few its pairs. The design:
//  - Work items, one wave of persistent blocks. An item is a tile of 4096
//    output samples of a row longer than that, with its dependency cone, or
//    4096 / n whole rows of rows of at most that (16 rows of 256, 2 of 2048,
//    2048 of 2), the last item shorter where they do not divide the batch;
//    2048 for one level, which has no chain of levels to spread an item's
//    set-up over. The host launches min(items, SMs x blocks an SM) blocks
//    (the occupancy calculator's count, cached a plan: four an SM at 48 KB);
//    block b takes items b, b + grid, ... in that order.
//  - Cones. Synthesis reads (c - t), to the left, so the cone R_l at level l
//    (head h_l) is half of R_{l-1} and at most ceil(M/2) + 10 samples more,
//    its ends rounded out to multiples of 8 (so each level's pairs start and
//    end on groups of four), or the whole head once it would cover it (then
//    read circularly): 2056, 1040, ..., 32 samples of A_8 at db4 L8.
//  - A producer warp, the block's last. Item k's cone tables and every stage
//    of it (A_L's cone, then each level's details, coarsest first) go into
//    stage set k & 1 by bulk copies (TMA) at the start's offset mod 16, the
//    lanes plain-loading what is not 16-byte aligned on both sides, once the
//    consumers have released item k - 2 there (an "empty" mbarrier); one
//    "full" mbarrier a set takes the 32 lanes' arrivals and the bytes. So
//    item k + 1's copies fly while item k computes. A compute thread issuing
//    them held its block ~3.4 us an item: a bulk copy's issue waits for room
//    in the memory system.
//  - 64 compute threads run the levels from the coarsest up in shared
//    memory, each level writing the buffer of its parity (even, odd), level
//    1 storing to the output. The coarse levels, those of at most 64 groups
//    of four pairs at the plan's bounds (levels 5-8 of db4 L8), run in warp
//    0 alone with __syncwarp; one named barrier (the producer is not in it)
//    follows each wide level.
//  - A thread makes four consecutive pairs from windows of a and d read as
//    float4s (the group's and, for db4, the one before it: two loads of each
//    for four pairs, where a pair a thread read eight scalars), db4's and
//    Haar's taps in registers, and writes its 8 outputs as two float4s.
//    Other banks, heads shorter than 8 and unaligned sources take a pair a
//    thread.
//  - Rows of at most the tile: an item's rows lie together, so one bulk copy
//    stages them, and each level runs over all of its rows at once (the pair
//    index runs over rows x pairs): on 65536 rows of 256 (ifwt3d's) K7 takes
//    a fifth of the time of the one-block-a-row design (PERF.md, section 6).
// Left out, each slower at the main shape in A/B runs in turns on the card
// (PERF.md, section 6): level 1 through a shared stage and a bulk store (its
// 16 KB cost a block an SM); a coarse warp running item k + 1's coarse
// levels while the others ran item k's wide ones (that one warp became the
// slowest stage); the producer waiting for item k's copies to land before
// issuing item k + 1's; tighter register caps for more blocks an SM. The
// tile and the compute threads come from `tools/ab_times.py --k7-plans`.
//
// The rotated forms of K3 and K7 (no TPU kernel: the volume's axis passes,
// transforms/fwt.py::fwt3d and ifwt3d, which ran each pass in place and
// brought the next axis last by a transposing copy, 61% of the volume's
// device time). Each takes (rows, n) and stores (n, rows): on a (P Q, R)
// view that turns (P, Q, R) into (R, P, Q), so three passes bring a volume
// back to its layout with no copy. Bound on this card: bytes, one read and
// one write of the rows, as for K3 and K7 in place.
//  - Whole rows of n <= 2048, rb an item (a power of two: 4096 / n, at
//    least 8, so that each column piece is at least a 32-byte sector; at
//    2048 a block's two stage sets and its buffer take 165 KB, the most
//    that one SM holds at 8 rows), one wave of persistent blocks, a
//    producer warp staging item k + 1 into the second of two stage sets
//    while the compute threads run item k, as K7 does. The rows are staged
//    one bulk copy a row at a stride of n + 4 floats, so that the rows q ..
//    q + 7 read at one column by one phase of 16-byte loads fall on all
//    banks.
//  - A compute thread takes row u mod rb of unit u: the threads of a warp
//    hold neighbouring rows at one output position, so each store to a
//    column of (n, rows) is a contiguous run of rb floats (64 bytes at rb =
//    16), stored straight from registers.
//  - K3 (pyramid_tail_kernel<MT>): every level in shared memory, odd
//    levels reading the staged rows and writing the approximations to a
//    buffer of rb half rows, even levels the other way round; db4's window
//    read as two float4s and a float2 mod the head; every level's details
//    go straight to their columns, the last level's approximations too.
//  - K7 (ipyramid_tile_kernel<MH, true>): the levels as in place, each
//    buffer row padded by 4 floats; level 1 stores its pairs to their
//    columns (k7_level_rotated) instead of to the rows.
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kMaxTaps = 64;

// The taps into shared lo[0, kMaxTaps), hi[0, kMaxTaps), zero past m (K4
// reads taps in pairs).
__device__ void load_taps(const float* taps, int m, float* lo, float* hi) {
  for (int i = threadIdx.x; i < kMaxTaps; i += blockDim.x) {
    lo[i] = i < m ? taps[i] : 0.f;
    hi[i] = i < m ? taps[m + i] : 0.f;
  }
  __syncthreads();
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

// ---- K3: tiles with a halo, then a tail. Mirrored by ops/cuda_pyramid.py
// (k3_plan, k3_smem_bytes, k3_tail_smem_bytes). ----
constexpr int kK3Threads = 512;

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Float offsets of a tile block's buffers; each starts 16-byte aligned and
// has 4 floats of room for a stage's offset mod 16 (stage_for).
struct K3Layout {
  int halo;   // (2^lt - 1)(m - 1) samples right of the tile
  int x;      // the staged segment, tile + halo samples; later the a of even levels
  int a;      // the a of odd levels: tile/2 + (2^(lt-1) - 1)(m - 1) samples
  int d;      // the stages of what leaves: the details of levels 1..lt (tile >> l
              // samples each), then the last approximation (tile >> lt), one
              // after another; k3_stage_floats() apart
  int floats;
};

// floats a stage of cnt samples takes in the block's shared memory
__host__ __device__ inline int k3_stage_floats(int cnt) { return round4(cnt) + 4; }

__host__ __device__ inline K3Layout k3_layout(int tile, int lt, int m) {
  K3Layout L;
  L.halo = ((1 << lt) - 1) * (m - 1);
  L.x = kRowsHead;
  L.a = L.x + round4(tile + L.halo) + 4;
  L.d = L.a + round4((tile >> 1) + ((1 << (lt - 1)) - 1) * (m - 1)) + 4;
  L.floats = L.d + k3_stage_floats(tile >> lt);
  for (int l = 1; l <= lt; ++l) L.floats += k3_stage_floats(tile >> l);
  return L;
}

// One level on a staged, linear segment: a[i] for i < na and d[i] for
// i < nd <= na from in[2i .. 2i + m - 1] (the taps past m are zero, and the
// last sample read lies inside the valid samples of `in`, see the header).
// MT = 0 takes any filter length, a float2 pair (2i + k is even) a tap
// pair. MT > 0 is the filter length known at compile time and needs `in`
// 16-byte aligned: the taps sit in registers and a thread makes the outputs
// 2p and 2p + 1 from the MT + 2 samples in[4p ..], read 16 bytes at a time
// (neighbouring threads 16 bytes apart: conflict-free, and 5 loads for two
// outputs where pairs take 8).
template <int MT>
__device__ __forceinline__ void k3_level(const float* in, float* a, float* d, int na, int nd,
                                         int m, const float* lo, const float* hi) {
  if constexpr (MT > 0) {
    static_assert(MT % 4 == 0, "the window is read as float4s and one float2");
    float l[MT], h[MT];
#pragma unroll
    for (int k = 0; k < MT; ++k) {
      l[k] = lo[k];
      h[k] = hi[k];
    }
    for (int p = threadIdx.x; 2 * p < na; p += blockDim.x) {
      float x[MT + 2];
#pragma unroll
      for (int q = 0; q < MT / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(in + 4 * p)[q];
        x[4 * q] = v.x, x[4 * q + 1] = v.y, x[4 * q + 2] = v.z, x[4 * q + 3] = v.w;
      }
      const float2 w = *reinterpret_cast<const float2*>(in + 4 * p + MT);
      x[MT] = w.x, x[MT + 1] = w.y;
      float a0 = 0.f, a1 = 0.f, d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int k = 0; k < MT; ++k) {
        a0 = fmaf(l[k], x[k], a0);
        d0 = fmaf(h[k], x[k], d0);
        a1 = fmaf(l[k], x[k + 2], a1);
        d1 = fmaf(h[k], x[k + 2], d1);
      }
      const int i = 2 * p;
      a[i] = a0;
      if (i < nd) d[i] = d0;
      if (i + 1 < na) a[i + 1] = a1;
      if (i + 1 < nd) d[i + 1] = d1;
    }
  } else {
    for (int i = threadIdx.x; i < na; i += blockDim.x) {
      const float2* p = reinterpret_cast<const float2*>(in + 2 * i);
      float sa = 0.f, sd = 0.f;
      for (int k = 0; k < m; k += 2) {
        const float2 v = p[k / 2];
        sa = fmaf(lo[k + 1], v.y, fmaf(lo[k], v.x, sa));
        sd = fmaf(hi[k + 1], v.y, fmaf(hi[k], v.x, sd));
      }
      a[i] = sa;
      if (i < nd) d[i] = sd;
    }
  }
}

// `levels` levels on a head of hh samples staged in P (P and Q, of hh and
// hh/2 floats, hold the approximations in turns), circularly: sample
// (2i + k) mod hh, a float2 pair at a time (2i + k and hh are even).
// Details go to `orow` at their in-place index, the last approximation to
// its start. Every thread of the block calls it, after a barrier.
__device__ void tail_levels(float* P, float* Q, float* orow, int hh, int levels, int m,
                            const float* lo, const float* hi) {
  const float* in = P;
  for (int l = 1; l <= levels; ++l, hh >>= 1) {
    const int half = hh >> 1;
    const bool last = l == levels;
    float* a = (l & 1) ? Q : P;
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      float sa = 0.f, sd = 0.f;
      for (int k = 0; k < m; k += 2) {
        const float2 v = *reinterpret_cast<const float2*>(in + ((2 * i + k) & (hh - 1)));
        sa = fmaf(lo[k + 1], v.y, fmaf(lo[k], v.x, sa));
        sd = fmaf(hi[k + 1], v.y, fmaf(hi[k], v.x, sd));
      }
      orow[half + i] = sd;
      if (last) orow[i] = sa;
      else a[i] = sa;
    }
    __syncthreads();
    in = a;
  }
}

// K3, the tiled levels: one block per (row, tile) of the head [0, h) of
// each row of `src`. Runs levels 1..lt of that head on the tile's samples
// and its right halo; level l's tile >> l details go to row r of `out` at
// their in-place index h/2^l + ti * (tile >> l), the tile >> lt
// approximations of level lt to row r of `a_out` at ti * (tile >> lt).
// With tail_lv > 0, `a_out` is a scratch row and the block of a row that
// finishes last (a counter a row in `counters`, zero before the launch and
// zero again after it) runs that row's remaining tail_lv levels on the
// h >> lt approximations, in the shared memory of its segment.
// See the header for the design.
template <int MT>
__global__ void __launch_bounds__(kK3Threads)
pyramid_tile_kernel(const float* __restrict__ src, long long src_stride, float* __restrict__ out,
                    long long out_stride, float* __restrict__ a_out, long long a_stride,
                    const float* __restrict__ taps, int h, int tile, int lt, int tail_lv,
                    int* __restrict__ counters, int m) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int finishes_row;
  float* lo = smem;
  float* hi = smem + kMaxTaps;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * kMaxTaps);
  const K3Layout L = k3_layout(tile, lt, m);
  const int tiles = h / tile;
  const long long r = blockIdx.x / tiles;
  const int ti = blockIdx.x - (int)(r * tiles);
  const float* row = src + r * src_stride;
  const long long t0 = (long long)ti * tile;
  if (threadIdx.x == 0) jw::mbar_init(bar);
  load_taps(taps, m, lo, hi);  // its __syncthreads also publishes the barrier
  // the segment [t0, t0 + tile + halo) mod h, staged before any arithmetic:
  // by bulk copies at its start's offset mod 16 (every piece that agrees
  // mod 16 on both sides; the ragged rest by plain loads), or, when the
  // start is not 8-byte aligned (the levels read float2), by plain loads
  const int cnt = tile + L.halo;
  float* xbase = smem + L.x;
  const float* in;
  if ((reinterpret_cast<uintptr_t>(row + t0) & 7) == 0) {
    float* X = jw::stage_for(reinterpret_cast<unsigned char*>(xbase), row + t0);
    jw::stage_segment(X, row, t0, cnt, h, bar);
    __syncthreads();  // the plain-loaded parts
    jw::mbar_wait(bar, 0);
    in = X;
  } else {
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) xbase[i] = row[(t0 + i) & (h - 1)];
    __syncthreads();
    in = xbase;
  }
  float* orow = out + r * out_stride;
  float* stage = smem + L.d;  // the next level's; none is written twice, so no level waits for a store
  for (int l = 1; l <= lt; ++l) {
    const int nd = tile >> l;                               // this tile's outputs
    const int na = nd + ((1 << (lt - l)) - 1) * (m - 1);    // and the halo the later levels need
    const bool last = l == lt;
    float* ddst = orow + (h >> l) + (long long)ti * nd;
    float* adst = a_out + r * a_stride + (long long)ti * nd;  // the last level's
    float* d = jw::stage_for(reinterpret_cast<unsigned char*>(stage), ddst);
    stage += k3_stage_floats(nd);
    float* a = last ? jw::stage_for(reinterpret_cast<unsigned char*>(stage), adst)
                    : (l & 1) ? smem + L.a : xbase;
    if (MT > 0 && (reinterpret_cast<uintptr_t>(in) & 15) == 0)
      k3_level<MT>(in, a, d, na, nd, m, lo, hi);
    else  // any filter length, or level 1 of a source 8 bytes off 16-byte alignment
      k3_level<0>(in, a, d, na, nd, m, lo, hi);
    jw::fence_async_smem();
    __syncthreads();
    jw::store_segment(ddst, d, nd);
    if (last) {
      if (tail_lv == 0) {
        jw::store_segment(adst, a, nd);
      } else {  // another block may read them: plain stores, fenced before the count
        for (int i = threadIdx.x; i < nd; i += blockDim.x) adst[i] = a[i];
        __threadfence();
      }
    }
    if (threadIdx.x == 0) jw::bulk_commit();
    in = a;
  }
  if (tail_lv > 0) {
    __syncthreads();  // every thread's approximations are stored and fenced
    if (threadIdx.x == 0) {
      finishes_row = atomicAdd(counters + r, 1) == tiles - 1;
      if (finishes_row) counters[r] = 0;  // no other block of the row is left to count
    }
    __syncthreads();
    if (finishes_row) {
      __threadfence();
      const int ht = h >> lt;
      const float* arow = a_out + r * a_stride;
      float* P = xbase;  // the segment and the odd levels' buffer are free: 1.5 ht floats fit
      for (int i = threadIdx.x; i < ht; i += blockDim.x) P[i] = __ldcg(arow + i);
      __syncthreads();
      tail_levels(P, P + ht, orow, ht, tail_lv, m, lo, hi);
    }
  }
  if (threadIdx.x == 0) jw::bulk_wait_read<0>();  // the stages outlive the stores
}

// K3, the tail on its own: one block per row runs `levels` levels on the
// head [0, h) of row r of `src`, staged whole in shared memory
// (tail_levels). With no level it copies the head.
__global__ void __launch_bounds__(1024)
pyramid_tail_kernel(const float* __restrict__ src, long long src_stride, float* __restrict__ out,
                    long long out_stride, const float* __restrict__ taps, int h, int levels,
                    int m) {
  extern __shared__ __align__(16) float smem[];
  const float* row = src + (long long)blockIdx.x * src_stride;
  float* orow = out + (long long)blockIdx.x * out_stride;
  if (levels == 0) {
    for (int i = threadIdx.x; i < h; i += blockDim.x) orow[i] = row[i];
    return;
  }
  float* lo = smem;
  float* hi = smem + kMaxTaps;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * kMaxTaps);
  float* P = smem + kRowsHead;
  float* Q = P + h;
  if (threadIdx.x == 0) jw::mbar_init(bar);
  load_taps(taps, m, lo, hi);  // its __syncthreads also publishes the barrier
  stage_rows(P, row, 1, h, h, bar, h % 4 == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0);
  tail_levels(P, Q, orow, h, levels, m, lo, hi);
}

// ---- The rotated forms of K3 and K7: whole rows of at most a few thousand
// samples, rb of them an item, taken by persistent blocks; (rows, n) in,
// (n, rows) out. Mirrored by ops/cuda_pyramid.py (k3_rotated_plan,
// k3_rotated_smem_bytes, k7_plan(..., rotated=True)). ----
constexpr int kRotMaxBlock = 256 + 32;  // at most 256 compute threads, and the producer warp
// shared floats before K3's rotated stage sets: the taps, each set's two
// mbarriers (it is full, it is empty)
constexpr int kRotHead = 2 * kMaxTaps + 2 * 2 * 2;

// The consumers' barrier: named barrier 1 over the nthr compute threads
// (the producer warp is not in it).
__device__ __forceinline__ void k7_sync(int nthr) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nthr) : "memory");
}

// Float offsets of a rotated K3 block's shared memory: two stage sets of rb
// rows at a stride of ns = n + 4 floats (16 bytes of pad: the rows q .. q +
// 7 that one phase of a warp's 16-byte loads reads at one column fall on
// all 32 banks), then the odd levels' approximations, rb rows of n/2 at a
// stride of na = n/2 + 4; the even levels write theirs over the head of the
// item's staged rows, read by then.
struct K3RotLayout {
  int ns, set, na, a, floats;
};

__host__ __device__ inline K3RotLayout k3_rotated_layout(int n, int rb) {
  K3RotLayout L;
  L.ns = n + 4;
  L.set = round4(rb * L.ns);
  L.na = n / 2 + 4;
  L.a = kRotHead + 2 * L.set;
  L.floats = L.a + round4(rb * L.na);
  return L;
}

// Samples [0, n) of each of the nr rows from `src` (rows of n floats) into
// dst at a stride of ns floats, as k7_stage stages a segment: pass 0, by
// every lane, plain-loads what is not 16-byte aligned on both sides and
// returns the bytes left; pass 1, by one lane, starts one bulk copy a row.
__device__ uint32_t k7_stage(int pass, float* dst, const float* row, long long t0, int cnt,
                             int n, uint64_t* bar, int lane);

__device__ uint32_t stage_rows_padded(int pass, float* dst, int ns, const float* src, int nr,
                                      int n, uint64_t* bar, int lane) {
  uint32_t bytes = 0;
  for (int q = 0; q < nr; ++q)
    bytes += k7_stage(pass, dst + q * ns, src + (long long)q * n, 0, n, n, bar, lane);
  return bytes;
}

// The producer warp of a rotated form: item k (rows [k rb, k rb + rb) of
// src, fewer in the last) into stage set k & 1 (sets `set` floats apart)
// once the consumers have released item k - 2 there; the plain-loaded parts
// by every lane, one arrival a lane on the set's full barrier (lane 0's with
// the bulk bytes), then the bulk copies.
__device__ void produce_rows(const float* src, int rows, int n, int rb, int ns, float* sets,
                             int set, uint64_t* full, uint64_t* empty, int lane) {
  const long long items = ((long long)rows + rb - 1) / rb;
  int k = 0;
  for (long long item = blockIdx.x; item < items; item += gridDim.x, ++k) {
    const int s = k & 1;
    if (k >= 2) jw::mbar_wait(empty + s, ((k - 2) >> 1) & 1);
    const float* first = src + item * rb * (long long)n;
    const int nr = (int)min((long long)rb, rows - item * rb);
    uint32_t bytes = 0;
    for (int pass = 0; pass < 2; ++pass) {
      bytes += stage_rows_padded(pass, sets + s * set, ns, first, nr, n, full + s, lane);
      if (pass == 0) {
        if (lane == 0) {
          jw::mbar_expect(full + s, bytes);
        } else {
          asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(jw::smem_addr(full + s))
                       : "memory");
          break;
        }
      }
    }
  }
}

// The nr staged rows of S (stride ns) as they are to their columns of out:
// column k of the item at out + k * rows + r0. Unit u takes row u mod rb,
// so that neighbouring threads store neighbouring floats of a column.
__device__ void store_rotated(const float* S, int ns, int n, int nr, int lg_rb, float* out,
                              long long rows, long long r0, int tid, int nthr) {
  const int rmask = (1 << lg_rb) - 1;
  for (int u = tid; u < n << lg_rb; u += nthr) {
    const int q = u & rmask, k = u >> lg_rb;
    if (q < nr) out[(long long)k * rows + r0 + q] = S[q * ns + k];
  }
}

// One analysis level of the rotated K3 over the nr rows of an item: the
// head of h samples of row q at in + q * is, read circularly; a and d of
// pair i, d to column h/2 + i of out (out + col * rows + r0 + q), a to
// a_out + q * as, or, on the last level, to column i. A thread takes unit
// u, row q = u mod rb, so the threads of a warp hold neighbouring rows: one
// store instruction writes contiguous runs of a column (rb floats, two
// columns a warp at rb = 16), and their 16-byte loads at one column of the
// padded rows are conflict-free. MT > 0 is the filter length known at
// compile time: a unit makes the pairs 2p and 2p + 1 from the window
// in[4p .. 4p + MT + 2) mod h, read as float4s and a float2 (each 4- or
// 2-aligned, so none straddles the wrap); else a unit is one pair read a
// float2 at a time.
template <int MT>
__device__ __forceinline__ void k3_rotated_level(const float* in, int is, int h, float* a_out,
                                                 int as, bool last, float* out, long long rows,
                                                 long long r0, int nr, int lg_rb, int m,
                                                 const float* lo, const float* hi, int tid,
                                                 int nthr) {
  const int half = h >> 1;
  const int rmask = (1 << lg_rb) - 1;
  float* ocol = out + r0;
  if (MT > 0 && h >= 4 && (is & 3) == 0 && (reinterpret_cast<uintptr_t>(in) & 15) == 0) {
    constexpr int T = MT > 0 ? MT : 4;
    float l[T], g[T];
#pragma unroll
    for (int k = 0; k < T; ++k) {
      l[k] = lo[k];
      g[k] = hi[k];
    }
    for (int u = tid; u < (h >> 2) << lg_rb; u += nthr) {
      const int q = u & rmask, p = u >> lg_rb;
      if (q >= nr) continue;
      const float* row = in + q * is;
      float x[T + 2];
#pragma unroll
      for (int j = 0; j < T / 4; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(row + ((4 * p + 4 * j) & (h - 1)));
        x[4 * j] = v.x, x[4 * j + 1] = v.y, x[4 * j + 2] = v.z, x[4 * j + 3] = v.w;
      }
      const float2 w = *reinterpret_cast<const float2*>(row + ((4 * p + T) & (h - 1)));
      x[T] = w.x, x[T + 1] = w.y;
      float a0 = 0.f, a1 = 0.f, d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int k = 0; k < T; ++k) {
        a0 = fmaf(l[k], x[k], a0);
        d0 = fmaf(g[k], x[k], d0);
        a1 = fmaf(l[k], x[k + 2], a1);
        d1 = fmaf(g[k], x[k + 2], d1);
      }
      const int i = 2 * p;
      float* o = ocol + q;
      o[(long long)(half + i) * rows] = d0;
      o[(long long)(half + i + 1) * rows] = d1;
      if (last) {
        o[(long long)i * rows] = a0;
        o[(long long)(i + 1) * rows] = a1;
      } else {
        *reinterpret_cast<float2*>(a_out + q * as + i) = make_float2(a0, a1);
      }
    }
    return;
  }
  for (int u = tid; u < half << lg_rb; u += nthr) {
    const int q = u & rmask, i = u >> lg_rb;
    if (q >= nr) continue;
    const float* row = in + q * is;
    float sa = 0.f, sd = 0.f;
    for (int k = 0; k < m; k += 2) {
      const float2 v = *reinterpret_cast<const float2*>(row + ((2 * i + k) & (h - 1)));
      sa = fmaf(lo[k + 1], v.y, fmaf(lo[k], v.x, sa));
      sd = fmaf(hi[k + 1], v.y, fmaf(hi[k], v.x, sd));
    }
    float* o = ocol + q;
    o[(long long)(half + i) * rows] = sd;
    if (last) o[(long long)i * rows] = sa;
    else a_out[q * as + i] = sa;
  }
}

// K3's rotated form: a grid of persistent blocks over items of rb whole
// rows of n samples (the last item shorter where rb does not divide rows);
// block b takes items b, b + gridDim.x, ... The last warp (the producer)
// stages item k into set k & 1 (produce_rows); the blockDim.x - 32 threads
// before it run the item's levels in shared memory, odd levels reading the
// staged rows and writing the approximations to the a buffer, even levels
// the other way round, every level storing its details straight to their
// columns of out, the last its approximations too: out is (n, rows). See
// the header.
template <int MT>
__device__ void rows_rotated(float* smem, const float* src, float* out, const float* taps,
                             int rows, int n, int levels, int m, int rb) {
  float* lo = smem;
  float* hi = smem + kMaxTaps;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * kMaxTaps);
  uint64_t* empty = full + 2;
  const K3RotLayout L = k3_rotated_layout(n, rb);
  float* sets = smem + kRotHead;
  const int lg_rb = __ffs(rb) - 1;
  const int tid = threadIdx.x, nthr = blockDim.x - 32;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;\n" ::"r"(jw::smem_addr(full + s))
                   : "memory");
      jw::mbar_init(empty + s);
    }
  }
  load_taps(taps, m, lo, hi);  // its __syncthreads publishes the barriers
  if (tid >= nthr) {
    produce_rows(src, rows, n, rb, L.ns, sets, L.set, full, empty, tid - nthr);
    return;
  }
  const long long items = ((long long)rows + rb - 1) / rb;
  int k = 0;
  for (long long item = blockIdx.x; item < items; item += gridDim.x, ++k) {
    const int s = k & 1;
    jw::mbar_wait(full + s, (k >> 1) & 1);
    const long long r0 = item * rb;
    const int nr = (int)min((long long)rb, rows - r0);
    float* S = sets + s * L.set;
    float* A = smem + L.a;
    if (levels == 0) store_rotated(S, L.ns, n, nr, lg_rb, out, rows, r0, tid, nthr);
    for (int l = 1, h = n; l <= levels; ++l, h >>= 1) {
      const bool odd = l & 1;
      k3_rotated_level<MT>(odd ? S : A, odd ? L.ns : L.na, h, odd ? A : S, odd ? L.na : L.ns,
                           l == levels, out, rows, r0, nr, lg_rb, m, lo, hi, tid, nthr);
      k7_sync(nthr);
    }
    if (levels == 0) k7_sync(nthr);
    // every consumer is past the item: the set and the a buffer are free
    if (tid == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(jw::smem_addr(empty + s))
                   : "memory");
  }
}

// K3's rotated form (rows_rotated: persistent blocks over items of rb whole
// rows, out as (n, rows)), an overload of the in-place tail's name so that a
// trace lists both as K3's (benchmark/roofline.py).
template <int MT>
__global__ void __launch_bounds__(kRotMaxBlock, 3)
pyramid_tail_kernel(const float* __restrict__ src, float* __restrict__ out,
                    const float* __restrict__ taps, int rows, int n, int levels, int m, int rb) {
  extern __shared__ __align__(16) float smem[];
  rows_rotated<MT>(smem, src, out, taps, rows, n, levels, m, rb);
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

// ---- K7: the inverse pyramid in place, persistent blocks over work items.
// Mirrored by ops/cuda_pyramid.py (k7_plan, _k7_layout, k7_cones,
// ipyramid_rows_tiled_torch). ----
constexpr int kK7MaxBlock = 256 + 32;  // at most 256 compute threads, and the producer warp
constexpr int kK7MaxLevels = 31;
constexpr int kK7Meta = 36;       // ints of each table (indices 0 .. kK7MaxLevels + 1)
constexpr int kK7WarpUnits = 64;  // a level of at most this many work units runs in one warp
// shared floats before the stage sets: the taps, each set's two mbarriers (it
// is full, it is empty), the stage offsets within a set, and each set's three
// cone tables
constexpr int kK7Head = 2 * kMaxTaps + 2 * 2 * 2 + kK7Meta + 2 * 3 * kK7Meta;

// B_{l+1} from B_l: the most samples of the cone one level coarser, on a
// head of 2 * half. Its ends rounded out to multiples of 8 add at most 10
// to b/2 + mh where R_l's ends are multiples of 8, 13 where R_1 is a tile
// of 2 or 4 samples.
__host__ __device__ inline int k7_bound_next(int b, int half, int mh) {
  return min(half, (b / 2 + mh + (b < 8 ? 13 : 10)) & ~7);
}

// The finest of the coarse levels: levels above the returned lw make at
// most kK7WarpUnits work units at the plan's bounds (groups of four pairs
// for the banks whose taps unroll, db4 and Haar, else pairs) and run in
// warp 0 alone; lw .. 1 run in every compute thread.
__host__ __device__ inline int k7_wide_levels(int n, int tile, int levels, int m) {
  const int mh = (m + 1) / 2;
  const bool groups = m == 8 || m == 2;
  int lw = 0;
  for (int l = 1, b = tile; l <= levels; ++l) {
    const int pairs = b >> 1;  // at most
    if ((groups ? pairs / 4 : pairs) > kK7WarpUnits) lw = l;
    b = n <= tile ? b / 2 : k7_bound_next(b, n >> l, mh);
  }
  return lw;
}

// Float offsets of a K7 block's shared memory. A stage set holds one work
// item's inputs: where rows are longer than the tile, a stage for each
// level's details D_l over the cone of level l + 1 (bound B_{l+1}, offsets
// in the head's table), then one for A_L over the cone of level L + 1; where
// a row is at most the tile, one stage of tile / n whole rows, or, rotated,
// the rows at a stride of n + 4 floats. Two sets, then the buffers of the
// even and of the odd levels' outputs (2..L; their largest bound each, or
// tile >> (l - 1) for whole rows, 4 floats more a row rotated); level 1
// stores to the output.
struct K7Layout {
  int set;    // floats of a stage set
  int even;   // the even levels' buffer
  int odd;    // the odd levels' buffer
  int floats;
};

__host__ __device__ inline K7Layout k7_layout(int n, int tile, int levels, int m, bool rot) {
  const int mh = (m + 1) / 2;
  const bool whole = n <= tile;
  const int pad = rot ? 4 * (tile / n) : 0;
  K7Layout L;
  int b = tile, even = 0, odd = 0, stages = 0;
  for (int l = 1; l <= levels; ++l) {
    if (l >= 2) {
      if (l & 1) odd = max(odd, b + pad);
      else even = max(even, b + pad);
    }
    b = whole ? b / 2 : k7_bound_next(b, n >> l, mh);
    stages += k3_stage_floats(b);
  }
  L.set = rot     ? round4(tile / n * (n + 4)) + 4
          : whole ? k3_stage_floats(tile)
                  : stages + k3_stage_floats(b);
  L.even = kK7Head + 2 * L.set;
  L.odd = L.even + round4(even);
  L.floats = L.odd + round4(odd);
  return L;
}

// One synthesis level over the pairs (2c, 2c+1) of `rows` rows: pair p of
// row q (p < npairs) reads a and d at i = (off + p - t) & mask, t < mh
// (mask is half - 1 where a and d are whole heads, read circularly, else
// -1), and writes x[2p], x[2p + 1]; rows lie as, ds and xs floats apart.
struct K7Level {
  const float* a;
  const float* d;
  float* x;
  int as, ds, xs;
  int rows, lg;  // lg: log2 of npairs for several rows, 30 for one
  int npairs, off, mask, half;
};

// Whether a level runs in groups of four pairs: a thread reads a and d as
// float4s at the group's start and (MH > 1) the float4 before it, mod the
// head where it wraps, and writes 8 outputs as two float4s.
template <int MH>
__device__ __forceinline__ bool k7_grouped(const K7Level& v) {
  if (MH == 0) return false;
  const uintptr_t al = reinterpret_cast<uintptr_t>(v.a) | reinterpret_cast<uintptr_t>(v.d) |
                       reinterpret_cast<uintptr_t>(v.x);
  return (al & 15) == 0 && ((v.as | v.ds | v.xs | v.npairs | v.off) & 3) == 0 &&
         (v.mask == -1 || v.half >= 4);
}

// The taps of a known mh in registers: the even and odd synthesis taps of
// each pair t < MH, read once a block.
template <int MH>
struct K7Taps {
  static constexpr int R = MH > 0 ? MH : 1;
  float le[R], lod[R], he[R], hod[R];
  __device__ K7Taps(const float* lo, const float* hi) {
#pragma unroll
    for (int t = 0; t < R; ++t)
      le[t] = lo[2 * t], lod[t] = lo[2 * t + 1], he[t] = hi[2 * t], hod[t] = hi[2 * t + 1];
  }
};

// The level's outputs, by threads tid, tid + nthr, ...; the gain is folded
// into the taps. MH > 0 is mh known at compile time (db4: 4, Haar: 1), the
// taps then in registers (tp). Taps past m are zero.
template <int MH>
__device__ __forceinline__ void k7_level(const K7Level& v, int mh, const float* lo,
                                         const float* hi, const K7Taps<MH>& tp, int tid,
                                         int nthr) {
  const float* le = tp.le;
  const float* lod = tp.lod;
  const float* he = tp.he;
  const float* hod = tp.hod;
  const int total = v.rows * v.npairs;
  const int pmask = (1 << v.lg) - 1;
  if (k7_grouped<MH>(v)) {
    constexpr int W = MH > 1 ? 4 : 0;  // window samples before the group
    static_assert(MH <= 5, "one float4 of window before the group");
#pragma unroll 2
    for (int g = 4 * tid; g < total; g += 4 * nthr) {
      const int q = g >> v.lg, p = g & pmask;
      const int i0 = v.off + p;  // a multiple of 4; below 0 only where a and d wrap
      const float* ar = v.a + q * v.as;
      const float* dr = v.d + q * v.ds;
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
        for (int t = 0; t < MH; ++t) {
          x0 = fmaf(he[t], dv[W + j - t], fmaf(le[t], av[W + j - t], x0));
          x1 = fmaf(hod[t], dv[W + j - t], fmaf(lod[t], av[W + j - t], x1));
        }
        o[2 * j] = x0, o[2 * j + 1] = x1;
      }
      float4* xr = reinterpret_cast<float4*>(v.x + q * v.xs + 2 * p);
      xr[0] = make_float4(o[0], o[1], o[2], o[3]);
      xr[1] = make_float4(o[4], o[5], o[6], o[7]);
    }
    return;
  }
  for (int idx = tid; idx < total; idx += nthr) {
    const int q = idx >> v.lg, p = idx & pmask;
    const int c = v.off + p;
    const float* ar = v.a + q * v.as;
    const float* dr = v.d + q * v.ds;
    float x0 = 0.f, x1 = 0.f;
    if constexpr (MH > 0) {
#pragma unroll
      for (int t = 0; t < MH; ++t) {
        const int i = (c - t) & v.mask;
        const float av = ar[i], dv = dr[i];
        x0 = fmaf(he[t], dv, fmaf(le[t], av, x0));
        x1 = fmaf(hod[t], dv, fmaf(lod[t], av, x1));
      }
    } else {
      for (int t = 0; t < mh; ++t) {
        const int i = (c - t) & v.mask;
        const float av = ar[i], dv = dr[i];
        x0 = fmaf(hi[2 * t], dv, fmaf(lo[2 * t], av, x0));
        x1 = fmaf(hi[2 * t + 1], dv, fmaf(lo[2 * t + 1], av, x1));
      }
    }
    *reinterpret_cast<float2*>(v.x + q * v.xs + 2 * p) = make_float2(x0, x1);
  }
}

// Level 1 of K7's rotated form, v over the whole rows of an item: pair p
// of row q to columns 2p and 2p + 1 of out (out + col * rows + r0 + q). A
// thread takes unit u, row q = u mod rb, so the threads of a warp hold
// neighbouring rows: a store instruction writes contiguous runs of a column
// (rb floats, two columns a warp at rb = 16), and the 16-byte loads at one
// column of the padded rows are conflict-free. Groups of four pairs as
// k7_level makes them, or a pair a unit.
template <int MH>
__device__ __forceinline__ void k7_level_rotated(const K7Level& v, int mh, const float* lo,
                                                 const float* hi, const K7Taps<MH>& tp, int tid,
                                                 int nthr, float* out, long long rows,
                                                 long long r0, int lg_rb) {
  const int rmask = (1 << lg_rb) - 1;
  float* ocol = out + r0;
  if (k7_grouped<MH>(v)) {
    constexpr int W = MH > 1 ? 4 : 0;  // window samples before the group
    constexpr int R = MH > 0 ? MH : 1;
    for (int u = tid; u < (v.npairs >> 2) << lg_rb; u += nthr) {
      const int q = u & rmask, p = 4 * (u >> lg_rb);
      if (q >= v.rows) continue;
      const float* ar = v.a + q * v.as;
      const float* dr = v.d + q * v.ds;
      float av[W + 4], dv[W + 4];
      if constexpr (W > 0) {
        const float4 wa = *reinterpret_cast<const float4*>(ar + ((p - 4) & v.mask));
        const float4 wd = *reinterpret_cast<const float4*>(dr + ((p - 4) & v.mask));
        av[0] = wa.x, av[1] = wa.y, av[2] = wa.z, av[3] = wa.w;
        dv[0] = wd.x, dv[1] = wd.y, dv[2] = wd.z, dv[3] = wd.w;
      }
      const float4 ca = *reinterpret_cast<const float4*>(ar + (p & v.mask));
      const float4 cd = *reinterpret_cast<const float4*>(dr + (p & v.mask));
      av[W] = ca.x, av[W + 1] = ca.y, av[W + 2] = ca.z, av[W + 3] = ca.w;
      dv[W] = cd.x, dv[W + 1] = cd.y, dv[W + 2] = cd.z, dv[W + 3] = cd.w;
      float* o = ocol + q + (long long)(2 * p) * rows;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x0 = 0.f, x1 = 0.f;
#pragma unroll
        for (int t = 0; t < R; ++t) {
          x0 = fmaf(tp.he[t], dv[W + j - t], fmaf(tp.le[t], av[W + j - t], x0));
          x1 = fmaf(tp.hod[t], dv[W + j - t], fmaf(tp.lod[t], av[W + j - t], x1));
        }
        o[(long long)(2 * j) * rows] = x0;
        o[(long long)(2 * j + 1) * rows] = x1;
      }
    }
    return;
  }
  for (int u = tid; u < v.npairs << lg_rb; u += nthr) {
    const int q = u & rmask, p = u >> lg_rb;
    if (q >= v.rows) continue;
    const float* ar = v.a + q * v.as;
    const float* dr = v.d + q * v.ds;
    float x0 = 0.f, x1 = 0.f;
    for (int t = 0; t < mh; ++t) {
      const int i = (p - t) & v.mask;
      const float av = ar[i], dv = dr[i];
      x0 = fmaf(hi[2 * t], dv, fmaf(lo[2 * t], av, x0));
      x1 = fmaf(hi[2 * t + 1], dv, fmaf(lo[2 * t + 1], av, x1));
    }
    float* o = ocol + q + (long long)(2 * p) * rows;
    o[0] = x0;
    o[rows] = x1;
  }
}

// The producer warp's staging of samples [t0, t0 + cnt) mod n of `row` into
// dst[0, cnt), as jw::stage_segment cuts it: pass 0, by every lane, loads
// what is not 16-byte aligned on both sides and returns the bytes left to
// the bulk copies; pass 1, by one lane, starts one bulk copy on `bar` per
// aligned piece.
__device__ uint32_t k7_stage(int pass, float* dst, const float* row, long long t0, int cnt,
                             int n, uint64_t* bar, int lane) {
  cnt = (cnt + 3) & ~3;  // whole 16 bytes: no plain-loaded tail where aligned
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
    if (pass == 0) {
      bulk_bytes += body * sizeof(float);
      for (int i = lane; i < len - body; i += 32) {
        const int e = i < head ? i : i + body;
        dst[o + e] = row[s + e];
      }
    } else if (body > 0) {
      jw::bulk_copy(dst + o + head, row + s + head, body * sizeof(float), bar);
    }
    o += len;
    s = 0;
  }
  return bulk_bytes;
}

// K7: a grid of persistent blocks over the work items of rows of n samples;
// block b takes items b, b + gridDim.x, ... (no atomics: a fixed order).
// Rows longer than `tile`: an item is (row, tile of `tile` output samples),
// made from its dependency cone: level l (head h = n >> (l-1), l = levels
// .. 1) makes the outputs of its cone R_l = [s_l, s_l + n_l) (unwrapped; mod
// h) from R_{l+1} of A (the level above's outputs) and of D_l = src[h/2, h);
// R_1 is the tile. Rows of at most `tile`: an item is tile / n whole rows
// (fewer in the last), every cone its whole head. The last warp (the
// producer) stages item k into set k & 1 once the consumers have released
// item k - 2 there; the blockDim.x - 32 threads before it (the consumers)
// compute. kRot, for whole rows alone: the item's rows staged at a stride of
// n + 4 floats (produce_rows) and level 1 stored to the columns of out, (n,
// rows) (k7_level_rotated; with no level the staged rows, store_rotated).
// See the header.
template <int MH, bool kRot>
__global__ void __launch_bounds__(kK7MaxBlock, 2)
ipyramid_tile_kernel(const float* __restrict__ src, float* __restrict__ out,
                     const float* __restrict__ taps, int rows, int n, int tile, int levels,
                     int m) {
  extern __shared__ __align__(16) float smem[];
  float* lo = smem;
  float* hi = smem + kMaxTaps;
  // each set's barriers: it is full (the producer's 32 arrivals and the
  // bytes), it is empty (the consumers' thread 0)
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * kMaxTaps);
  uint64_t* empty = full + 2;
  int* coff = reinterpret_cast<int*>(full + 4);
  // per set: cs[l], cn[l], cf[l] R_l's start, count and whether it is its
  // whole head (l = 1 .. levels + 1)
  int* tabs = coff + kK7Meta;
  const K7Layout L = k7_layout(n, tile, levels, m, kRot);
  const int lw = k7_wide_levels(n, tile, levels, m);
  const int mh = (m + 1) / 2;
  const bool whole = n <= tile;
  const int rb = whole ? tile / n : 1;  // rows an item
  const int tiles = whole ? 1 : n / tile;
  const long long items = whole ? ((long long)rows + rb - 1) / rb : (long long)rows * tiles;
  auto set_of = [&](int s) { return smem + kK7Head + s * L.set; };
  auto tab = [&](int s, int k) { return tabs + (3 * s + k) * kK7Meta; };
  // the stage of A_L (l = 0) or of D_l in set s for row `row`
  auto stage = [&](int s, int l, const float* row) -> float* {
    const int half = l ? n >> l : n >> levels;
    const int* cs = tab(s, 0);
    const float* g = (l ? row + half : row) + (cs[l ? l + 1 : levels + 1] & (half - 1));
    return jw::stage_for(reinterpret_cast<unsigned char*>(set_of(s) + coff[l]), g);
  };

  const int tid = threadIdx.x, nthr = blockDim.x - 32;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;\n" ::"r"(jw::smem_addr(full + s))
                   : "memory");
      jw::mbar_init(empty + s);
    }
    int f = 0, b = tile;
    for (int l = 1; l <= levels && !whole; ++l) {
      b = k7_bound_next(b, n >> l, mh);
      coff[l] = f;
      f += k3_stage_floats(b);
    }
    coff[0] = whole ? 0 : f;
  }
  load_taps(taps, m, lo, hi);  // its __syncthreads publishes the barriers and the offsets

  const int ns = n + 4;  // a row's stride in a rotated stage set
  if (kRot && tid >= nthr) {
    produce_rows(src, rows, n, rb, ns, set_of(0), L.set, full, empty, tid - nthr);
    return;
  }
  if (tid >= nthr) {
    // the producer warp: item k's cone tables (lane 0) and copies into set
    // k & 1 once the consumers have released item k - 2 there: the
    // plain-loaded parts by every lane, one arrival a lane (lane 0's with
    // the bulk bytes), then the bulk copies, the coarsest first
    const int lane = tid - nthr;
    int k = 0;
    for (long long item = blockIdx.x; item < items; item += gridDim.x, ++k) {
      const int s = k & 1;
      if (k >= 2) jw::mbar_wait(empty + s, ((k - 2) >> 1) & 1);
      const float* row;
      int* cs = tab(s, 0);
      int* cn = tab(s, 1);
      if (whole) {
        row = src + item * rb * n;
      } else {
        row = src + (item / tiles) * (long long)n;
        if (lane == 0) {
          int* cf = tab(s, 2);
          int st0 = (int)(item % tiles) * tile, cnt = tile;
          cs[1] = st0, cn[1] = cnt, cf[1] = 0;
          for (int l = 1; l <= levels; ++l) {
            // R_{l+1}: the inputs of pairs [s/2, s/2 + cnt/2) of head n >> (l-1)
            // reach back mh - 1 samples; its ends rounded out to multiples of
            // 8, so that each level's pairs start and end on groups of four
            const int half = n >> l;
            const int u = st0 >> 1;
            const int st = (u - (mh - 1)) & ~7, en = (u + cnt / 2 + 7) & ~7;
            if (en - st >= half) st0 = 0, cnt = half;
            else st0 = st, cnt = en - st;
            cs[l + 1] = st0, cn[l + 1] = cnt, cf[l + 1] = cnt == half;
          }
        }
        __syncwarp();  // the tables; lane 0's arrival publishes them
      }
      uint32_t bytes = 0;
      for (int pass = 0; pass < 2; ++pass) {
        if (whole) {
          const int cnt = (int)min((long long)rb, rows - item * rb) * n;
          bytes += k7_stage(pass, jw::stage_for(reinterpret_cast<unsigned char*>(set_of(s)), row),
                            row, 0, cnt, cnt, full + s, lane);
        } else {
          for (int j = 0; j <= levels; ++j) {
            const int l = j ? levels + 1 - j : 0;  // A_L, then D_L .. D_1
            const int half = l ? n >> l : n >> levels;
            const int c = l ? l + 1 : levels + 1;
            bytes += k7_stage(pass, stage(s, l, row), l ? row + half : row, cs[c] & (half - 1),
                              cn[c], half, full + s, lane);
          }
        }
        if (pass == 0) {
          if (lane == 0) {
            jw::mbar_expect(full + s, bytes);
          } else {
            asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(jw::smem_addr(full + s))
                         : "memory");
            break;
          }
        }
      }
    }
    return;
  }
  // the consumers; the levels above lw run in warp 0 alone
  const K7Taps<MH> tp(lo, hi);
  int k = 0;
  for (long long item = blockIdx.x; item < items; item += gridDim.x, ++k) {
    const int s = k & 1;
    jw::mbar_wait(full + s, (k >> 1) & 1);  // every stage of the item, and its tables
    const long long r0 = whole ? item * rb : item / tiles;
    const int nr = whole ? (int)min((long long)rb, rows - r0) : 1;
    const int* cs = tab(s, 0);
    const int* cn = tab(s, 1);
    const int* cf = tab(s, 2);
    float* dst = out + r0 * n + (whole ? 0 : cs[1]);
    const float* row = src + r0 * n;
    float* staged = kRot    ? set_of(s)
                    : whole ? jw::stage_for(reinterpret_cast<unsigned char*>(set_of(s)), row)
                            : nullptr;  // whole rows' stage
    const int rs = kRot ? ns : n;       // its rows' stride
    const int pad = kRot ? 4 : 0;       // and the buffers' pad a row
    auto operands = [&](int l) {
      K7Level v;
      const int half = n >> l;
      v.half = half;
      v.x = l == 1 ? dst : smem + (l & 1 ? L.odd : L.even);
      if (whole) {
        v.a = l == levels ? staged : smem + ((l + 1) & 1 ? L.odd : L.even);
        v.as = l == levels ? rs : half + pad;
        v.d = staged + half;
        v.ds = rs;
        v.xs = l == 1 ? n : 2 * half + pad;
        v.rows = nr;
        v.lg = __ffs(half) - 1;
        v.npairs = half;
        v.off = 0;
        v.mask = half - 1;
      } else {
        v.a = l == levels ? stage(s, 0, row) : smem + ((l + 1) & 1 ? L.odd : L.even);
        v.d = stage(s, l, row);
        v.as = v.ds = v.xs = 0;
        v.rows = 1;
        v.lg = 30;
        v.npairs = cn[l] >> 1;
        v.off = (cs[l] >> 1) - cs[l + 1];
        v.mask = cf[l + 1] ? half - 1 : -1;
      }
      return v;
    };
    // level l by threads t, t + nt, ...; level 1 of the rotated form to
    // the columns of out
    auto level = [&](int l, int t, int nt) {
      if (kRot && l == 1)
        k7_level_rotated<MH>(operands(1), mh, lo, hi, tp, t, nt, out, rows, r0, __ffs(rb) - 1);
      else
        k7_level<MH>(operands(l), mh, lo, hi, tp, t, nt);
    };
    if (kRot && levels == 0) {
      store_rotated(staged, ns, n, nr, __ffs(rb) - 1, out, rows, r0, tid, nthr);
      k7_sync(nthr);
    }
    if (lw < levels) {
      if (tid < 32) {
        for (int l = levels; l > lw; --l) {
          level(l, tid, 32);
          __syncwarp();
        }
      }
      k7_sync(nthr);
    }
    for (int l = lw; l >= 1; --l) {
      level(l, tid, nthr);
      k7_sync(nthr);
    }
    // every consumer is past the item: the set, its tables and the buffers
    // are free
    if (tid == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(jw::smem_addr(empty + s))
                   : "memory");
  }
}

template <int MH, bool kRot>
int launch_k7(const float* src, float* out, const float* taps, int rows, int n, int tile,
              int levels, int m, int threads, int grid, int* blocks_per_sm, cudaStream_t stream) {
  const int smem = k7_layout(n, tile, levels, m, kRot).floats * (int)sizeof(float);
  auto kern = ipyramid_tile_kernel<MH, kRot>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (blocks_per_sm != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern, threads + 32,
                                                              smem);
  kern<<<grid, threads + 32, smem, stream>>>(src, out, taps, rows, n, tile, levels, m);
  return (int)cudaGetLastError();
}

template <int MT>
int launch_k3_tile(const float* src, long long src_stride, float* out, long long out_stride,
                   float* a_out, long long a_stride, const float* taps, int rows, int h, int tile,
                   int lt, int tail_lv, int* counters, int m, int threads,
                   cudaStream_t stream) {
  const int smem = k3_layout(tile, lt, m).floats * (int)sizeof(float);
  auto kern = pyramid_tile_kernel<MT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)rows * (h / tile), threads, smem, stream>>>(
      src, src_stride, out, out_stride, a_out, a_stride, taps, h, tile, lt, tail_lv, counters, m);
  return (int)cudaGetLastError();
}

template <int MT>
int launch_k3_rotated(const float* src, float* out, const float* taps, int rows, int n,
                      int levels, int m, int rb, int threads, int grid, int* blocks_per_sm,
                      cudaStream_t stream) {
  const int smem = k3_rotated_layout(n, rb).floats * (int)sizeof(float);
  auto kern = pyramid_tail_kernel<MT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (blocks_per_sm != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern, threads + 32,
                                                              smem);
  kern<<<grid, threads + 32, smem, stream>>>(src, out, taps, rows, n, levels, m, rb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* jw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K3's tiled levels 1..lt of the head [0, h) of each row (tile and h powers
// of two, tile <= h, 2^lt <= tile), and with tail_lv > 0 the tail_lv levels
// after them in the same launch (h >> lt <= tile; `counters`: rows zeroed
// ints); db4's 8 taps unroll at compile time.
int jw_pyramid_tile(const void* src, long long src_stride, void* out, long long out_stride,
                    void* a_out, long long a_stride, const void* taps, int rows, int h, int tile,
                    int lt, int tail_lv, void* counters, int m, int threads, void* stream) {
  cudaGetLastError();
  if (lt < 1 || tile > h || (tile >> lt) < 1 || threads > kK3Threads ||
      (tail_lv > 0 && ((h >> lt) > tile || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  auto fn = m == 8 ? launch_k3_tile<8> : launch_k3_tile<0>;
  return fn((const float*)src, src_stride, (float*)out, out_stride, (float*)a_out, a_stride,
            (const float*)taps, rows, h, tile, lt, tail_lv, (int*)counters, m, threads,
            (cudaStream_t)stream);
}

// K3's tail: `levels` levels (0: a copy) on the head [0, h) of each row, one
// block a row.
int jw_pyramid_tail(const void* src, long long src_stride, void* out, long long out_stride,
                    const void* taps, int rows, int h, int levels, int m, int threads,
                    void* stream) {
  cudaGetLastError();
  const int smem = levels ? (kRowsHead + h + h / 2) * (int)sizeof(float) : 0;
  // the in-place overload of the name (the rotated form is a template)
  void (*kern)(const float*, long long, float*, long long, const float*, int, int, int) =
      pyramid_tail_kernel;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<rows, threads, smem, (cudaStream_t)stream>>>(
      (const float*)src, src_stride, (float*)out, out_stride, (const float*)taps, h, levels, m);
  return (int)cudaGetLastError();
}

// K3's rotated form: `levels` levels (0: a transposing copy) of each row of
// (rows, n), n a power of two, into out as (n, rows), by `grid` persistent
// blocks of `threads` compute threads (a multiple of 32, at most 256) and a
// producer warp over items of rb rows (a power of two); db4's 8 taps unroll
// at compile time. With `blocks_per_sm` non-null it launches nothing and
// writes the blocks an SM holds.
int jw_pyramid_rows_rotated(const void* src, void* out, const void* taps, int rows, int n,
                            int levels, int m, int rb, int threads, int grid, int* blocks_per_sm,
                            void* stream) {
  cudaGetLastError();
  if (n < 2 || (n & (n - 1)) || levels < 0 || (n >> levels) < 1 || rb < 1 || (rb & (rb - 1)) ||
      m < 1 || m > kMaxTaps || threads % 32 || threads < 32 || threads + 32 > kRotMaxBlock ||
      (blocks_per_sm == nullptr && grid < 1))
    return (int)cudaErrorInvalidValue;
  auto fn = m == 8 ? launch_k3_rotated<8> : launch_k3_rotated<0>;
  return fn((const float*)src, (float*)out, (const float*)taps, rows, n, levels, m, rb, threads,
            grid, blocks_per_sm, (cudaStream_t)stream);
}

// K7: `levels` synthesis levels (1 .. kK7MaxLevels) of each row of (rows, n),
// into out, by `grid` persistent blocks of `threads` compute threads (a
// multiple of 32, at most 256) and a producer warp over the work items (tiles of `tile` samples, a power of two dividing n, or tile / n
// whole rows where n <= tile); the gain is folded into the taps; db4's 8
// taps and Haar's 2 unroll at compile time. `rotated` (whole rows alone;
// levels from 0) stores out as (n, rows). With `blocks_per_sm` non-null
// it launches nothing and writes the blocks an SM holds.
int jw_ipyramid_tile(const void* src, void* out, const void* taps, int rows, int n, int tile,
                     int levels, int m, int threads, int grid, int rotated, int* blocks_per_sm,
                     void* stream) {
  cudaGetLastError();
  if (levels < (rotated ? 0 : 1) || levels > kK7MaxLevels || (n >> levels) < 1 || tile < 2 ||
      (tile < n ? n % tile : tile % n) || (rotated && tile < n) || m < 1 || m > kMaxTaps ||
      threads % 32 || threads < 32 || threads + 32 > kK7MaxBlock ||
      (blocks_per_sm == nullptr && grid < 1))
    return (int)cudaErrorInvalidValue;
  auto fn = rotated ? (m == 8 ? launch_k7<4, true> : m == 2 ? launch_k7<1, true>
                                                            : launch_k7<0, true>)
                    : (m == 8 ? launch_k7<4, false> : m == 2 ? launch_k7<1, false>
                                                             : launch_k7<0, false>);
  return fn((const float*)src, (float*)out, (const float*)taps, rows, n, tile, levels, m,
            threads, grid, blocks_per_sm, (cudaStream_t)stream);
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
