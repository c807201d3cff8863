// The record fold shared by the visibility kernels of the port: the work
// items, the per-warp reject, the pixel loop and the merge by packed key.
// Included by vis_stream.cu (B1) and vis_lists.cu (B2), which differ only in
// where a tile's ids lie (a `Walk`).
//
// Replaces xr/raster/pallas_smem.py `_raster_scalar_records` with its x_test
// and depth_test options. Coverage is exact int32 plane-form edges
// e_k = a_k*px + b_k*py + c_k (computed in uint32 so the wraparound the
// records rely on is defined), accepted iff e_k >= o_k; depth
// zf = ((e0*inv)*z0 + (e1*inv)*z1) + (e2*inv)*z2 with every product and sum
// rounded on its own (no FMA: built with -fmad=false and written with the
// _rn intrinsics), kept within [0, 1]; the winner is the strict (z, id)
// lexicographic minimum, or the highest id without a depth test.
//
// What bounds the fold on an H100 is instruction rate and latency, not bytes: a
// record is 72 bytes and a frame's records fit the L2 many times over. One
// CTA walking a tile's whole segment lasted as long as the heaviest tile
// (1,415 records at ~0.5 us each on the 1080p terrain, twelve times the
// mean), and 98 % of its per-pixel work was a bbox reject that failed. So:
//
// - Work items. A tile's walk (the large bucket, then its own ids) is cut
//   into chunks of at most kItem records, dealt round-robin (chunk c of n
//   takes records c, c + n, c + 2n, ...: sorted ids are neighbours on
//   screen, and a run of them would land in one warp's footprint); an item
//   is one chunk folded into one slab of at most 32 rows of the 128-wide
//   tile. The prep lists the chunks
//   (item_tile, item_start: xr_torch/raster/records.py `item_table`); the
//   CTAs take items in a fixed stride, so the heaviest tile is spread over
//   as many SMs as it has chunks.
// - Reject by warp. A warp owns 32 columns x 8 rows of the slab and a lane
//   one column of 8 pixels, in registers. While a chunk is staged in shared
//   memory, one thread a record tests its bbox against the sixteen
//   footprints and the warps get their own bit masks of records
//   (__ballot_sync); a warp walks only its set bits (__ffs), each at its own pace. A lane rejects a
//   record on its column once and steps the three edge functions down its
//   rows by addition (exact: the edges are modular). The per-pixel bbox and
//   edge tests still follow, so the result does not change by a bit. This is
//   the coarse / fine split of Laine and Karras, "High-Performance Software
//   Rasterization on GPUs" (HPG 2011).
// - Merge by key. The resolve is a minimum under a total order, so a pixel
//   may be built from partial results over any partition of its records. A
//   slab with one chunk stores its pixels directly. A slab with several
//   merges each chunk's winners into a scratch frame of 64-bit keys with
//   atomicMin (depth: z bits, then id) or atomicMax (painter's order: id);
//   the chunk that arrives last (a counter behind __threadfence) unpacks and
//   stores. A small kernel ahead of the fold clears the keys and the
//   counters of those slabs, so nothing survives from launch to launch.
//
// No tensor cores: the edges are int32 products that rely on wraparound and
// the depth needs every product and sum rounded on its own to keep ties
// exact; neither maps onto wgmma. No TMA for the records: they are gathered
// by id, 72 bytes each, not cut as tiles of an array; the staging is plain
// 8-byte loads, and the two CTAs that share an SM overlap one's staging with
// the other's fold. On the 1080p terrain (59,501 (tile, record) pairs, 794
// chunks; NVIDIA H100 80GB HBM3, 700 W; xr_torch/tools/sweep_visibility.py)
// a launch takes 0.065 ms, of which the pixel work of the fold is 0.043,
// the staging 0.005, the merge 0.003-0.005 and the two launches, the clear
// and the store of the frame 0.014: the fold is bound by instruction rate
// (about 170 instructions for a record in a warp, 2.6 warps a record), so a
// cp.async double buffer for the staging was not built.
//
// The z gate (B1 under z_earlyout: the zmax, band_zmax and chunk options
// of `_raster_scalar_records`), a kernel of its own (zgate_fold_kernel).
// The TPU walks a tile's records in order and bounds the tile's depth once a
// block. Here a tile's chunks run at once on many SMs, each from +inf, and
// a skipped (record, warp) pair saves one record's fold in one warp (~170
// instructions) while the gate's own work is paid by every warp of every
// chunk: on the scenes the presets gate (config5, config7) it finds
// almost nothing to skip, so what bounds it there is its own instructions.
// A first design (each chunk seeded its pixels from the tile's merged
// keys: 32 KB of reads a chunk and four more live values) cost 18 % on
// config5 (xr_torch/tools/sweep_visibility.py, NVIDIA H100 80GB HBM3, 700
// W). What was measured and what the design does about it:
// - A live bound per footprint instead of seeding. One 32-bit word per
//   (tile, slab, warp) holds the order-preserving bits (order_bits) of an
//   upper bound of the final depth of that footprint's pixels inside the
//   frame; the clear kernel sets it to +inf. A warp's own bound is the
//   largest depth of its carry over those pixels (the counterpart of
//   band_zmax over a 32x8 band): any chunk's carry lies above the merged
//   minimum at every pixel, so its maximum bounds them all. A warp starts
//   from the word; at a word of its mask, once it folded kRefresh records
//   since its last bound, it takes its own bound (+inf at once while a
//   pixel is uncovered: no shuffles), publishes it with atomicMin if below
//   the word, and gates on the least of it and the word as read at its
//   last refresh (a relaxed load issued then: waiting for it here cost a
//   latency a refresh). Chunks that run at once so gate each other.
// - The skip test costs no load a record: at each word of the mask one
//   lane tests one record's z_min and a ballot drops those behind the
//   bound, and only while the bound is finite.
// - Chunks are dealt round-robin and staged by the ungated fold's own code
//   (deal_chunk, stage_chunk). Runs of consecutive records (the XR_RUNS
//   probe) give a tile's first chunk its nearest records and skip more
//   where ids run front to back, but land in a few warps' footprints:
//   1.7-1.9x the ungated time on config5.
// - The items in the prep's chunk-major order (item_order), in a stride of
//   the grid as the ungated fold takes them: every tile's first chunk
//   starts before any second one. A queue of items (an atomic counter) was
//   slower than the stride, and the structure without the tests
//   (XR_ZG_NOGATE) is within 2 % of the ungated kernel.
// What the gate costs now: 6-13 % where it skips almost nothing (config5,
// config3 under bin_zorder), 1-9 % on config7, and it saves a third on
// the stacked planes of xr_torch/tools/layers.py (depth complexity 16).
// - kGateWalk: a warp skips a record whose z_min (field 13, deflated by 8
//   ulps and 1e-35) exceeds its bound. Every depth the fold interpolates for
//   the record lies above that z_min (each product and sum rounded on its
//   own: at most ~5 ulps of error), so the record cannot win a pixel there.
// - kGateStage (z_chunk_gate): the staging clears the record's bit in the
//   mask of each warp whose bound at the chunk's start it exceeds, so that
//   warp never reads it: the counterpart of the chunk aggregate, which on
//   the TPU saved scalar instructions that one thread a record does not
//   spend here. It drops only what a tile's earlier chunks published
//   before the chunk started: 36 % of the stacked planes' (record, warp)
//   pairs, none of config5's (its warps start from +inf), where testing
//   each record against 16 bounds costs 8 % more than kGateWalk alone.
// The TPU's y-band mask (`ymask`) has its counterpart in the reject by warp
// footprint (footprint_hits). Only the stream kernel gates. XR_GATE_COUNTS
// (xr_torch/tools/sweep_visibility.py only) counts the (record, warp)
// pairs of footprints inside the frame that the gates skipped.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace xr {

typedef unsigned long long u64;

constexpr int kFields = 18;     // record width (xr_torch/raster/records.py)
// The constants the design was tuned with. xr_torch/tools/sweep_visibility.py
// rebuilds the kernels with other values (-DXR_THREADS=..., -DXR_ITEM=...,
// -DXR_MIN_CTAS=...; exact) and with its probes: XR_RUNS (a chunk is a run
// of consecutive records, in both kernels; exact), XR_ZG_NOGATE (the gated
// kernel without its tests and bounds; exact), XR_GATE_COUNTS (exact) and
// XR_NO_FOLD, XR_NO_MERGE, XR_NO_STAGE (the pixel work, the merge or the
// staging compiled out; these break the output and only show where the
// time goes). Nothing else defines them.
#ifndef XR_THREADS
#define XR_THREADS 512
#endif
#ifndef XR_ITEM
#define XR_ITEM 128
#endif
#ifndef XR_MIN_CTAS
#define XR_MIN_CTAS 2
#endif
constexpr int kThreads = XR_THREADS;   // threads per CTA
constexpr int kMinCtas = XR_MIN_CTAS;  // CTAs an SM must hold: caps the fold at 64 registers
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 128;     // tile width the kernels take
constexpr int kSlabRows = 32;   // rows of a tile one item covers
constexpr int kWarpCols = 32;   // a warp's footprint: one column a lane ...
constexpr int kWarpRows = kSlabRows * kTileW / kThreads;  // ... and the 8 rows a lane owns
constexpr int kColGroups = kTileW / kWarpCols;
constexpr int kRowGroups = kSlabRows / kWarpRows;
constexpr int kItem = XR_ITEM;  // records per item (records.py ITEM_RECORDS)
constexpr int kWords = kItem / 32;
constexpr int kCtasPerSm = 8;   // CTAs launched per SM, at most
constexpr int kBg = 0x7fffffff;
constexpr int kB16 = 32768;
constexpr unsigned kInfBits = 0x7f800000u;
constexpr unsigned kNegInfBits = 0xff800000u;
constexpr int kGateWalk = 1;   // z_earlyout: a warp skips records behind its footprint
constexpr int kGateStage = 2;  // z_chunk_gate: the staging drops them from its walk
// records a gated warp folds before it takes a new bound, at the next word
// of its mask (records.py ZG_REFRESH)
constexpr int kRefresh = 4;

#ifdef XR_GATE_COUNTS
// (record, warp) pairs that meet a footprint inside the frame, dropped at
// staging, skipped in the walk; (chunk, warp) starts of such footprints in
// tiles of several chunks, those that found a bound below +inf published
static __device__ unsigned long long g_gate_counts[5];
#endif

static_assert(kColGroups * kRowGroups == kWarps, "the footprints tile the slab");
static_assert(kItem <= kThreads && kItem % 32 == 0, "one staging thread a record");
static_assert(kFields % 2 == 0, "records are copied as 8-byte words");

// The frame and its tiling, as every kernel here takes it.
struct Frame {
  int height, width, tile_h, ntx, ntiles, nslab, sub, depth_test;
  int pitch;  // columns of the key scratch: ntx * kTileW
};

// Where a tile's own ids lie.
struct StreamWalk {  // B1: the sorted bin segment inside the stream budget
  const int* sid;
  const int* starts;
  const int* run_counts;
  const int* tile_ran;
  __device__ bool ran(int t) const { return tile_ran[t] != 0; }
  __device__ void segment(int t, const int*& ids, int& n) const {
    ids = sid + starts[t];
    n = run_counts[t];
  }
};

struct ListWalk {  // B2: the tile's capped list; every tile runs
  const int* lists;
  const int* counts;
  int cap;
  __device__ bool ran(int) const { return true; }
  __device__ void segment(int t, const int*& ids, int& n) const {
    ids = lists + (size_t)t * cap;
    n = counts[t];
  }
};

// The packed key of xr_torch/raster/records.py `pack_key`. Depth test: z in
// [0, 1] orders by its bits; -0.0 packs as 0.0 so that the key orders as the
// float compare does, and bit 0 keeps its sign for the stored z; the id
// takes bits 1..32; the minimum wins and (+inf, BG) is the cleared key.
// Painter's order: id + 1 above the z bits, the maximum wins, 0 is cleared.
__device__ __forceinline__ u64 clear_key(bool depth_test) {
  return depth_test ? ((u64)kInfBits << 32) | ((u64)(unsigned)kBg << 1) : 0ull;
}

__device__ __forceinline__ u64 pack_key(float z, int id, bool depth_test) {
  const unsigned zb = __float_as_uint(z);
  if (depth_test) {
    const unsigned neg0 = zb == 0x80000000u ? 1u : 0u;
    return ((u64)(neg0 ? 0u : zb) << 32) | ((u64)(unsigned)id << 1) | neg0;
  }
  return ((u64)(unsigned)(id + 1) << 32) | zb;
}

__device__ __forceinline__ void unpack_key(u64 key, bool depth_test, int& id,
                                           float& z) {
  if (depth_test) {
    const unsigned lo = (unsigned)key;
    id = (int)(lo >> 1);
    z = __uint_as_float((lo & 1u) ? 0x80000000u : (unsigned)(key >> 32));
  } else {
    id = (int)(unsigned)(key >> 32) - 1;
    z = __uint_as_float((unsigned)key);
  }
}

// One lane's pixels: a column of at most kWarpRows rows of the slab, with
// the (z, id) carry in registers.
struct Run {
  int row0, col, rows;   // first framebuffer row, column, live rows (may be 0)
  int px, py0, py_last;  // fixed-point centers: the column, first and last live row
  float zb[kWarpRows];
  int tb[kWarpRows];
};

// The first row and the live rows of row group rg of a slab.
__device__ __forceinline__ void row_group(const Frame& f, int t, int slab,
                                          int rg, int& row0, int& rows) {
  const int slab_rows = min(kSlabRows, f.tile_h - slab * kSlabRows);
  row0 = (t / f.ntx) * f.tile_h + slab * kSlabRows + rg * kWarpRows;
  rows = max(0, min(kWarpRows, slab_rows - rg * kWarpRows));
}

// This thread's run in slab `slab` of tile t, cleared to (+inf, BG), or id
// -1 in painter's order.
__device__ __forceinline__ void run_init(Run& s, const Frame& f, int t, int slab) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = f.sub >> 1;
  row_group(f, t, slab, warp / kColGroups, s.row0, s.rows);
  s.col = (t % f.ntx) * kTileW + (warp % kColGroups) * kWarpCols + lane;
  s.px = s.col * f.sub + half;
  s.py0 = s.row0 * f.sub + half;
  s.py_last = s.py0 + (s.rows - 1) * f.sub;
#pragma unroll
  for (int k = 0; k < kWarpRows; ++k) {
    s.zb[k] = __uint_as_float(kInfBits);
    s.tb[k] = f.depth_test ? kBg : -1;
  }
}

// Bit w is set where the bbox packed in (byp, bxp) meets the footprint of
// warp w in slab `slab` of tile t.
__device__ __forceinline__ unsigned footprint_hits(const Frame& f, int t, int slab,
                                                   int byp, int bxp) {
  const int by0 = (byp & 0xFFFF) - kB16, by1 = ((byp >> 16) & 0xFFFF) - kB16;
  const int bx0 = (bxp & 0xFFFF) - kB16, bx1 = ((bxp >> 16) & 0xFFFF) - kB16;
  const int half = f.sub >> 1;
  unsigned cols = 0, hits = 0;
#pragma unroll
  for (int g = 0; g < kColGroups; ++g) {
    const int gx0 = ((t % f.ntx) * kTileW + g * kWarpCols) * f.sub + half;
    const int gx1 = gx0 + (kWarpCols - 1) * f.sub;
    if (bx1 >= gx0 && bx0 <= gx1) cols |= 1u << g;
  }
#pragma unroll
  for (int h = 0; h < kRowGroups; ++h) {
    int row0, rows;
    row_group(f, t, slab, h, row0, rows);
    const int gy0 = row0 * f.sub + half;
    const int gy1 = gy0 + (rows - 1) * f.sub;
    if (rows > 0 && by1 >= gy0 && by0 <= gy1) hits |= cols << (h * kColGroups);
  }
  return hits;
}

// Fold the staged record R into this lane's run.
__device__ __forceinline__ void fold_record(const int* R, Run& s, int sub, bool depth_test) {
  const int byp = R[16], bxp = R[17];
  const int bx0 = (bxp & 0xFFFF) - kB16;
  const int bx1 = ((bxp >> 16) & 0xFFFF) - kB16;
  if (s.px < bx0 || s.px > bx1) return;
  const int by0 = (byp & 0xFFFF) - kB16;
  const int by1 = min(((byp >> 16) & 0xFFFF) - kB16, s.py_last);
  // the edges at the run's first row, stepped down the column by b_k * sub
  const unsigned px = (unsigned)s.px, py = (unsigned)s.py0;
  unsigned e0 = (unsigned)R[0] * px + (unsigned)R[1] * py + (unsigned)R[2];
  unsigned e1 = (unsigned)R[3] * px + (unsigned)R[4] * py + (unsigned)R[5];
  unsigned e2 = (unsigned)R[6] * px + (unsigned)R[7] * py + (unsigned)R[8];
  const unsigned d0 = (unsigned)R[1] * (unsigned)sub;
  const unsigned d1 = (unsigned)R[4] * (unsigned)sub;
  const unsigned d2 = (unsigned)R[7] * (unsigned)sub;
  const float z0 = __int_as_float(R[9]);
  const float z1 = __int_as_float(R[10]);
  const float z2 = __int_as_float(R[11]);
  const float inv = __int_as_float(R[12]);
  const int id = R[14];
  const int of = R[15];
  const int o0 = of & 1, o1 = (of >> 1) & 1, o2 = (of >> 2) & 1;
#pragma unroll
  for (int k = 0; k < kWarpRows; ++k) {
    const int pyk = s.py0 + k * sub;
    if (pyk >= by0 && pyk <= by1) {  // uniform across the warp
      const int i0 = (int)e0, i1 = (int)e1, i2 = (int)e2;
      if (i0 >= o0 && i1 >= o1 && i2 >= o2) {
        const float w0 = __fmul_rn(__fmul_rn(__int2float_rn(i0), inv), z0);
        const float w1 = __fmul_rn(__fmul_rn(__int2float_rn(i1), inv), z1);
        const float w2 = __fmul_rn(__fmul_rn(__int2float_rn(i2), inv), z2);
        const float zf = __fadd_rn(__fadd_rn(w0, w1), w2);
        if (zf >= 0.0f && zf <= 1.0f) {
          const bool better = depth_test
              ? (zf < s.zb[k] || (zf == s.zb[k] && id < s.tb[k]))
              : (id > s.tb[k]);
          if (better) {
            s.zb[k] = zf;
            s.tb[k] = id;
          }
        }
      }
    }
    e0 += d0;
    e1 += d1;
    e2 += d2;
  }
}

// The gate's bound words: a float as 32 bits whose unsigned order is the
// float order (-inf lowest, +inf highest), so that atomicMin keeps the
// least bound; kInfOrdered is +inf's.
constexpr unsigned kInfOrdered = kInfBits | 0x80000000u;

__device__ __forceinline__ unsigned order_bits(float z) {
  const unsigned b = __float_as_uint(z);
  return (b & 0x80000000u) ? ~b : b | 0x80000000u;
}

__device__ __forceinline__ float unorder_bits(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? o & 0x7fffffffu : ~o);
}

// A bound word while other chunks lower it: a relaxed load at device scope,
// which the memory model makes single-copy atomic against their atomicMin
// (a plain load racing with it is a data race). Words only go down, so any
// value read is a bound some chunk published.
__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// Rows of this lane inside the frame.
__device__ __forceinline__ int live_rows(const Run& s, const Frame& f) {
  return s.col < f.width ? min(s.rows, f.height - s.row0) : 0;
}

// Write the run to the (height, width) outputs; every pixel no record won
// is background (BG, +inf).
__device__ __forceinline__ void run_store(const Run& s, const Frame& f,
                                          int* __restrict__ tid_out,
                                          float* __restrict__ z_out) {
  if (s.col >= f.width) return;
#pragma unroll
  for (int k = 0; k < kWarpRows; ++k) {
    const int row = s.row0 + k;
    if (k >= s.rows || row >= f.height) continue;
    int id = s.tb[k];
    float z = s.zb[k];
    if (id < 0) id = kBg;  // painter's order: -1 is "none"
    if (id == kBg) z = __uint_as_float(kInfBits);
    tid_out[(size_t)row * f.width + s.col] = id;
    z_out[(size_t)row * f.width + s.col] = z;
  }
}

// Body of the clear kernel, grid (tile, slab): the keys and the arrival
// counter of every slab whose tile has more than one chunk.
__device__ __forceinline__ void clear_merge_state(const int* __restrict__ item_start,
                                                  u64* __restrict__ keys,
                                                  int* __restrict__ arrivals,
                                                  const Frame& f) {
  const int t = blockIdx.x, slab = blockIdx.y;
  if (item_start[t + 1] - item_start[t] <= 1) return;
  if (threadIdx.x == 0) arrivals[t * f.nslab + slab] = 0;
  Run s;
  run_init(s, f, t, slab);
  const u64 clear = clear_key(f.depth_test != 0);
#pragma unroll
  for (int k = 0; k < kWarpRows; ++k) {
    if (k < s.rows) keys[(size_t)(s.row0 + k) * f.pitch + s.col] = clear;
  }
}

// Store the run, the slab's only chunk, or merge it into the tile's keys:
// the chunk that arrives last unpacks and stores the slab.
__device__ __forceinline__ void finish_run(Run& s, const Frame& f, int t, int slab, int nch,
                                           bool depth_test, u64* keys, int* arrivals,
                                           int& s_last, int* __restrict__ tid_out,
                                           float* __restrict__ z_out) {
#ifdef XR_NO_MERGE
  if (true) {
#else
  if (nch == 1) {  // the slab's only chunk
#endif
    run_store(s, f, tid_out, z_out);
    return;
  }
#pragma unroll
  for (int k = 0; k < kWarpRows; ++k) {
    if (k < s.rows && s.tb[k] != (depth_test ? kBg : -1)) {
      u64* p = keys + (size_t)(s.row0 + k) * f.pitch + s.col;
      const u64 key = pack_key(s.zb[k], s.tb[k], depth_test);
      if (depth_test) {
        atomicMin(p, key);
      } else {
        atomicMax(p, key);
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(arrivals + t * f.nslab + slab, 1) == nch - 1;
  }
  __syncthreads();
  if (s_last) {  // uniform across the CTA
    __threadfence();
#pragma unroll
    for (int k = 0; k < kWarpRows; ++k) {
      if (k < s.rows) {
        const u64 key = __ldcg(keys + (size_t)(s.row0 + k) * f.pitch + s.col);
        unpack_key(key, depth_test, s.tb[k], s.zb[k]);
      }
    }
    run_store(s, f, tid_out, z_out);
  }
}

// The records of chunk c of tile t's walk (the large bucket's nl chunks of
// its L ids, then the tile's own): ids[first + r * stride] for r below the
// count returned, 0 for a tile outside the budget. The chunk takes every
// stride-th record of its walk, from `first`: the ids are sorted and
// neighbours in id are neighbours on screen, so a run of consecutive
// records would land in one warp's footprint.
template <class Walk>
__device__ __forceinline__ int deal_chunk(const Walk& walk, const int* large_ids, int L,
                                          int nl, int t, int c, const int*& ids, int& first,
                                          int& stride) {
  int m;
#ifndef XR_RUNS
  if (c < nl) {
    ids = large_ids;
    first = c;
    stride = nl;
    m = (L - c + nl - 1) / nl;
  } else {
    int n;
    walk.segment(t, ids, n);
    first = c - nl;
    stride = (n + kItem - 1) / kItem;  // chunks of the tile's own ids
    m = stride > 0 ? (n - first + stride - 1) / stride : 0;
  }
#else  // the probe: chunk c is records c * kItem, c * kItem + 1, ...
  int n = L;
  ids = large_ids;
  first = c * kItem;
  if (c >= nl) {
    walk.segment(t, ids, n);
    first = (c - nl) * kItem;
  }
  stride = 1;
  m = min(kItem, n - first);
#endif
  if (!walk.ran(t) || m < 0) m = 0;  // a tile outside the budget folds nothing
  return m;
}

// Stage the chunk's m records in slab `slab` of tile t (s_rec) and give
// each warp its mask of the records whose bbox meets its footprint
// (s_mask), less those that keep(R, hits) clears (the z gate's staging
// drop). Between two __syncthreads of the item. `rec` is not __restrict__
// here and the caller's warp and lane come in: so written, the ungated
// fold compiles to the SASS it had inline (xr_torch/tools/compare_sass.py).
template <class Keep>
__device__ __forceinline__ void stage_chunk(const int* rec, const int* ids,
                                            int first, int stride, int m, const Frame& f,
                                            int t, int slab, int (&s_rec)[kItem][kFields],
                                            unsigned (&s_mask)[kWarps][kWords], int warp,
                                            int lane, Keep keep) {
#ifdef XR_NO_STAGE
  m = 0;
#endif
  for (int e = threadIdx.x; e < m * (kFields / 2); e += kThreads) {
    const int r = e / (kFields / 2);
    const int w = e - r * (kFields / 2);
    reinterpret_cast<int2*>(s_rec[r])[w] =
        reinterpret_cast<const int2*>(rec + (size_t)ids[first + r * stride] * kFields)[w];
  }
  if (threadIdx.x < kItem) {  // whole warps: one thread a record
    unsigned hits = 0;
    if ((int)threadIdx.x < m) {
      const int* R = rec + (size_t)ids[first + threadIdx.x * stride] * kFields;
      hits = keep(R, footprint_hits(f, t, slab, R[16], R[17]));
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned b = __ballot_sync(0xffffffffu, (hits >> w) & 1u);
      if (lane == 0) s_mask[w][warp] = b;
    }
  }
}

// Body of the fold kernel: this CTA's items, in a stride of the grid. Item
// i is chunk i / nslab of the prep's table in slab i % nslab of its tile.
template <class Walk>
__device__ __forceinline__ void fold_items(
    const int* __restrict__ rec, const Walk& walk,
    const int* __restrict__ large_ids, const int* __restrict__ large_count,
    const int* __restrict__ item_tile, const int* __restrict__ item_start,
    int item_bound, u64* keys, int* arrivals,
    int* __restrict__ tid_out, float* __restrict__ z_out, const Frame& f) {
  __shared__ __align__(8) int s_rec[kItem][kFields];
  __shared__ unsigned s_mask[kWarps][kWords];
  __shared__ int s_last;
  const bool depth_test = f.depth_test != 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int L = *large_count;
  const int nl = (L + kItem - 1) / kItem;  // chunks of the large bucket
  const int total = min(item_start[f.ntiles], item_bound) * f.nslab;
  for (int i = blockIdx.x; i < total; i += gridDim.x) {
    const int j = i / f.nslab;
    const int slab = i - j * f.nslab;
    const int t = item_tile[j];
    const int c = j - item_start[t];                    // chunk of the tile's walk
    const int nch = item_start[t + 1] - item_start[t];  // chunks of the tile
    const int* ids;
    int first, stride;
    const int m = deal_chunk(walk, large_ids, L, nl, t, c, ids, first, stride);

    Run s;
    run_init(s, f, t, slab);

    __syncthreads();  // the previous item's records and masks are consumed
    stage_chunk(rec, ids, first, stride, m, f, t, slab, s_rec, s_mask, warp, lane,
                [](const int*, unsigned hits) { return hits; });
    __syncthreads();

    for (int q = 0; q < kWords; ++q) {
      unsigned bits = s_mask[warp][q];
      while (bits) {
        const int r = q * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
#ifdef XR_NO_FOLD
        s.tb[0] ^= s_rec[r][14];  // keeps the walk of the masks alive
#else
        fold_record(s_rec[r], s, f.sub, depth_test);
#endif
      }
    }
    finish_run(s, f, t, slab, nch, depth_test, keys, arrivals, s_last, tid_out, z_out);
  }
}

// Body of the gated fold kernel (kGate: kGateWalk, with or without
// kGateStage; the depth test only): this CTA's items in a stride of the
// grid, as the ungated fold takes them, item i being chunk
// item_order[i / nslab] (the prep's chunk-major order) in slab i % nslab,
// dealt and staged as the ungated fold deals and stages. bounds holds a
// word per (tile, slab, warp), +inf after the clear kernel.
template <class Walk, int kGate>
__device__ __forceinline__ void zgate_fold_items(
    const int* __restrict__ rec, const Walk& walk,
    const int* __restrict__ large_ids, const int* __restrict__ large_count,
    const int* __restrict__ item_tile, const int* __restrict__ item_start,
    const int* __restrict__ item_order, int item_bound, u64* keys, int* arrivals,
    unsigned* bounds, int* __restrict__ tid_out, float* __restrict__ z_out, const Frame& f) {
  __shared__ __align__(8) int s_rec[kItem][kFields];
  __shared__ unsigned s_mask[kWarps][kWords];
  __shared__ int s_last;
  __shared__ float s_wz[kWarps];  // the warps' bounds at the chunk's start (kGateStage)
#ifdef XR_GATE_COUNTS
  __shared__ int s_live[kWarps];  // warps whose footprint holds a pixel of the frame
#endif
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int L = *large_count;
  const int nl = (L + kItem - 1) / kItem;  // chunks of the large bucket
  const int total = min(item_start[f.ntiles], item_bound) * f.nslab;
  for (int i = blockIdx.x; i < total; i += gridDim.x) {
    const int jt = i / f.nslab;
    const int slab = i - jt * f.nslab;
    const int j = item_order[jt];
    const int t = item_tile[j];
    const int c = j - item_start[t];                    // chunk of the tile's walk
    const int nch = item_start[t + 1] - item_start[t];  // chunks of the tile
    const int* ids;
    int first, stride;
    const int m = deal_chunk(walk, large_ids, L, nl, t, c, ids, first, stride);

    Run s;
    run_init(s, f, t, slab);
    // the warp starts from the word its tile's chunks share (a tile of one
    // chunk shares none), read now and used once the chunk is staged; a
    // footprint without a pixel of the frame bounds nothing: -inf
    unsigned* const word = bounds + ((size_t)t * f.nslab + slab) * kWarps + warp;
    const bool shared = nch > 1;
    unsigned seen = shared ? load_relaxed(word) : kInfOrdered;
    const bool live = __any_sync(0xffffffffu, live_rows(s, f) > 0);
    const float open = __uint_as_float(live ? kInfBits : kNegInfBits);
    float wz = open;
    if constexpr ((kGate & kGateStage) != 0) {  // the staging needs it first
      wz = fminf(open, unorder_bits(seen));
      if (lane == 0) s_wz[warp] = wz;
    }
#ifdef XR_GATE_COUNTS
    if (lane == 0) {
      s_live[warp] = live;
      if (live && shared) {
        atomicAdd(&g_gate_counts[3], 1ull);
        if (seen != kInfOrdered) atomicAdd(&g_gate_counts[4], 1ull);
      }
    }
#endif

    // what the staging keeps of a record's hits: under kGateStage not the
    // warps whose start bound it lies behind
    auto keep = [&](const int* R, unsigned hits) {
#ifdef XR_GATE_COUNTS
      unsigned in_frame = 0;
      for (int w = 0; w < kWarps; ++w) in_frame |= s_live[w] ? 1u << w : 0u;
      atomicAdd(&g_gate_counts[0], (unsigned long long)__popc(hits & in_frame));
#endif
      if constexpr ((kGate & kGateStage) != 0) {
        const float zmin = __int_as_float(R[13]);
        unsigned drop = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          if (zmin > s_wz[w]) drop |= 1u << w;
        }
#ifdef XR_GATE_COUNTS
        atomicAdd(&g_gate_counts[1], (unsigned long long)__popc(hits & drop & in_frame));
#endif
        hits &= ~drop;
      }
      return hits;
    };
    __syncthreads();  // the start bounds are in s_wz; the previous item is consumed
    stage_chunk(rec, ids, first, stride, m, f, t, slab, s_rec, s_mask, warp, lane, keep);
    __syncthreads();

    if constexpr ((kGate & kGateStage) == 0) wz = fminf(open, unorder_bits(seen));
    // a new bound: the warp's own (the largest depth of its pixels inside
    // the frame; +inf at once while one of them is uncovered), published
    // if below the word, and the least of it and the word as read at the
    // start or the last refresh (a load's latency would stall the warp
    // here; the word only goes down, so a stale value is a bound too); the
    // word is read again for the next refresh
    auto refresh = [&]() {
      float m = __uint_as_float(kNegInfBits);
      const int nlive = live_rows(s, f);
#pragma unroll
      for (int k = 0; k < kWarpRows; ++k) {
        if (k < nlive) m = fmaxf(m, s.zb[k]);
      }
      if (__any_sync(0xffffffffu, m == __uint_as_float(kInfBits))) {
        m = __uint_as_float(kInfBits);
      } else {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      }
      wz = m;
      if (shared) {
        const unsigned own = order_bits(wz);
        if (own < seen && lane == 0) atomicMin(word, own);
        wz = fminf(wz, unorder_bits(seen));
        seen = load_relaxed(word);
      }
    };
    int since = 0;  // records folded since the bound was taken
#ifdef XR_GATE_COUNTS
    unsigned long long skipped = 0;
#endif
    for (int q = 0; q < kWords; ++q) {
      unsigned bits = s_mask[warp][q];
      if (bits == 0) continue;  // no record of this word meets the footprint
#ifndef XR_ZG_NOGATE
      if (since >= kRefresh) {  // a bound at a word of the walk, if enough was folded since
        since = 0;
        refresh();
      }
      if (wz != __uint_as_float(kInfBits)) {
        // the word's records behind the bound leave the walk: one lane tests
        // one record, the same decision in every lane
        const unsigned drop = bits & __ballot_sync(
            0xffffffffu, __int_as_float(s_rec[q * 32 + lane][13]) > wz);
#ifdef XR_GATE_COUNTS
        skipped += __popc(drop);
#endif
        bits &= ~drop;
      }
      since += __popc(bits);
#endif
      while (bits) {
        const int r = q * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
#ifdef XR_NO_FOLD
        s.tb[0] ^= s_rec[r][14];  // keeps the walk of the masks alive
#else
        fold_record(s_rec[r], s, f.sub, true);
#endif
      }
    }
#ifdef XR_GATE_COUNTS
    if (lane == 0 && live) atomicAdd(&g_gate_counts[2], skipped);
#endif
    finish_run(s, f, t, slab, nch, true, keys, arrivals, s_last, tid_out, z_out);
  }
}

// The frame's description, or ntiles 0 for a shape the kernels do not take.
inline Frame make_frame(int ntiles, int height, int width, int tile_h, int tile_w,
                        int ntx, int sub, int depth_test) {
  Frame f = {};
  if (ntiles <= 0 || tile_w != kTileW || tile_h <= 0 || ntx <= 0) return f;
  f.height = height;
  f.width = width;
  f.tile_h = tile_h;
  f.ntx = ntx;
  f.ntiles = ntiles;
  f.nslab = (tile_h + kSlabRows - 1) / kSlabRows;
  f.sub = sub;
  f.depth_test = depth_test;
  f.pitch = ntx * kTileW;
  return f;
}

// CTAs of the fold kernel: one an item up to kCtasPerSm an SM, or 0 if the
// device cannot be asked.
inline int fold_grid(const Frame& f, int item_bound) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 0;
  }
  const long long items = (long long)item_bound * f.nslab;
  const long long most = (long long)sms * kCtasPerSm;
  return (int)(items < most ? items : most);
}

// The two kernels of a visibility launch, one pair per Walk (the clear
// kernel does not read it; the argument keeps the pairs apart at link time).
template <class Walk>
__global__ void __launch_bounds__(kThreads) clear_kernel(
    const int* __restrict__ item_start, u64* __restrict__ keys,
    int* __restrict__ arrivals, Frame f) {
  clear_merge_state(item_start, keys, arrivals, f);
}

template <class Walk>
__global__ void __launch_bounds__(kThreads, kMinCtas) fold_kernel(
    const int* __restrict__ rec, Walk walk, const int* __restrict__ large_ids,
    const int* __restrict__ large_count, const int* __restrict__ item_tile,
    const int* __restrict__ item_start, int item_bound, u64* keys,
    int* arrivals, int* __restrict__ tid_out, float* __restrict__ z_out,
    Frame f) {
  fold_items<Walk>(rec, walk, large_ids, large_count, item_tile, item_start, item_bound,
                   keys, arrivals, tid_out, z_out, f);
}

// The two kernels of a launch under the z gate, kernels of their own, so
// that the ungated ones keep their parameters and their code: the clear
// kernel also sets every bound word to +inf.
template <class Walk>
__global__ void __launch_bounds__(kThreads) zgate_clear_kernel(
    const int* __restrict__ item_start, u64* __restrict__ keys,
    int* __restrict__ arrivals, unsigned* __restrict__ bounds, Frame f) {
  clear_merge_state(item_start, keys, arrivals, f);
  const int t = blockIdx.x, slab = blockIdx.y;
  if (threadIdx.x < kWarps) {
    bounds[((size_t)t * f.nslab + slab) * kWarps + threadIdx.x] = kInfOrdered;
  }
}

template <class Walk, int kGate>
__global__ void __launch_bounds__(kThreads, kMinCtas) zgate_fold_kernel(
    const int* __restrict__ rec, Walk walk, const int* __restrict__ large_ids,
    const int* __restrict__ large_count, const int* __restrict__ item_tile,
    const int* __restrict__ item_start, int item_bound, u64* keys,
    int* arrivals, int* __restrict__ tid_out, float* __restrict__ z_out,
    Frame f, const int* __restrict__ item_order, unsigned* bounds) {
  zgate_fold_items<Walk, kGate>(rec, walk, large_ids, large_count, item_tile, item_start,
                                item_order, item_bound, keys, arrivals, bounds, tid_out,
                                z_out, f);
}

// Words of the gate's scratch: a bound word per (tile, slab, warp).
inline long long zgate_words(int ntiles, int tile_h) {
  return (long long)ntiles * ((tile_h + kSlabRows - 1) / kSlabRows) * kWarps;
}

// One visibility launch on `stream`: the clear kernel, then the fold kernel
// with gate kGate (the depth test only; item_order: the prep's chunk-major
// order, bounds: zgate_words(ntiles, tile_h) words of scratch, both under
// the gate only). Allocates nothing. Returns the first error, or
// cudaErrorInvalidValue for a shape the kernels do not take (f.ntiles 0, no
// item) or a gate without the depth test or its inputs.
template <class Walk, int kGate>
inline int launch_visibility(const int* rec, const Walk& walk, const int* large_ids,
                             const int* large_count, const int* item_tile,
                             const int* item_start, const int* item_order,
                             int item_bound, u64* keys, int* arrivals, unsigned* bounds,
                             int* tid_out, float* z_out, const Frame& f,
                             cudaStream_t stream) {
  const int grid = f.ntiles > 0 && item_bound >= f.ntiles ? fold_grid(f, item_bound) : 0;
  if (grid <= 0 ||
      (kGate != 0 && (!f.depth_test || item_order == nullptr || bounds == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if constexpr (kGate == 0) {
    clear_kernel<Walk><<<dim3(f.ntiles, f.nslab, 1), kThreads, 0, stream>>>(
        item_start, keys, arrivals, f);
  } else {
    zgate_clear_kernel<Walk><<<dim3(f.ntiles, f.nslab, 1), kThreads, 0, stream>>>(
        item_start, keys, arrivals, bounds, f);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (kGate == 0) {
    fold_kernel<Walk><<<grid, kThreads, 0, stream>>>(
        rec, walk, large_ids, large_count, item_tile, item_start, item_bound, keys,
        arrivals, tid_out, z_out, f);
  } else {
    zgate_fold_kernel<Walk, kGate><<<grid, kThreads, 0, stream>>>(
        rec, walk, large_ids, large_count, item_tile, item_start, item_bound, keys,
        arrivals, tid_out, z_out, f, item_order, bounds);
  }
  return (int)cudaGetLastError();
}

}  // namespace xr
