// The record loop shared by the visibility kernels of the port: one device
// function, included by vis_stream.cu (B1) and vis_lists.cu (B2).
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
// Work split: one CTA of 256 threads owns a slab of at most 32 rows of one
// 128-wide tile (16 pixels a thread, in registers), so a tile of any height
// runs as ceil(tile_h / 32) slabs. Records are staged through
// shared memory in chunks (one coalesced load per record field, broadcast
// reads in the loop) and rejected per pixel on the record's bbox before the
// edge math. The record table is read by id straight from the (C, 18) table.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace xr {

constexpr int kFields = 18;     // record width (xr_torch/raster/records.py)
constexpr int kThreads = 256;   // threads per CTA
constexpr int kTileW = 128;     // tile width the kernels take
constexpr int kSlabRows = 32;   // rows of a tile one CTA owns
constexpr int kMaxPpt = kSlabRows * kTileW / kThreads;  // pixels per thread
constexpr int kChunk = 128;     // records staged in shared memory per pass
constexpr int kBg = 0x7fffffff;
constexpr int kB16 = 32768;
constexpr int kNoPixel = -(1 << 30);  // fails every bbox test

// The pixels of one CTA: the slab's fixed-point bbox and this thread's
// pixel centers, with the (z, id) carry.
struct Slab {
  int row0, col0, rows;      // first framebuffer row/column, rows in the slab
  int px0, px1, py0, py1;    // fixed-point centers of the slab's corner pixels
  int pxs[kMaxPpt], pys[kMaxPpt], tb[kMaxPpt];
  float zb[kMaxPpt];
};

// Slab blockIdx.y of tile blockIdx.x, cleared to (+inf, BG), or id -1 in
// painter's order.
__device__ __forceinline__ void slab_init(Slab& s, int tile_h, int ntx,
                                          int sub, bool depth_test) {
  const int t = blockIdx.x;
  const int half = sub >> 1;
  s.row0 = (t / ntx) * tile_h + blockIdx.y * kSlabRows;
  s.col0 = (t % ntx) * kTileW;
  s.rows = min(kSlabRows, tile_h - (int)blockIdx.y * kSlabRows);
  s.px0 = s.col0 * sub + half;
  s.px1 = (s.col0 + kTileW - 1) * sub + half;
  s.py0 = s.row0 * sub + half;
  s.py1 = (s.row0 + s.rows - 1) * sub + half;
#pragma unroll
  for (int k = 0; k < kMaxPpt; ++k) {
    const int p = threadIdx.x + k * kThreads;
    const int r = p / kTileW;
    const int c = p - r * kTileW;
    const bool live = r < s.rows;
    s.pxs[k] = live ? (s.col0 + c) * sub + half : kNoPixel;
    s.pys[k] = live ? (s.row0 + r) * sub + half : kNoPixel;
    s.zb[k] = __int_as_float(0x7f800000);  // +inf
    s.tb[k] = depth_test ? kBg : -1;
  }
}

// Fold n records whose ids are ids[0..n) into the slab. x_test: whole-record
// bbox reject against the slab first (uniform across the CTA; exact, since
// the per-pixel bbox test follows). It is a template argument because a
// runtime flag cost the stream kernel 18 % on full config3 (0.818 ->
// 0.966 ms on an H100 at 700 W), though the branch is uniform.
template <bool x_test>
__device__ __forceinline__ void fold_records(
    const int* __restrict__ ids, int n,
    const int* __restrict__ rec, int (*s_rec)[kFields], Slab& s,
    bool depth_test) {
  for (int base = 0; base < n; base += kChunk) {
    const int m = min(kChunk, n - base);
    __syncthreads();  // the previous chunk is consumed
    for (int e = threadIdx.x; e < m * kFields; e += kThreads) {
      const int r = e / kFields;
      const int f = e - r * kFields;
      s_rec[r][f] = rec[(size_t)ids[base + r] * kFields + f];
    }
    __syncthreads();
    for (int r = 0; r < m; ++r) {
      const int* R = s_rec[r];
      const int byp = R[16], bxp = R[17];
      const int by0 = (byp & 0xFFFF) - kB16;
      const int by1 = ((byp >> 16) & 0xFFFF) - kB16;
      const int bx0 = (bxp & 0xFFFF) - kB16;
      const int bx1 = ((bxp >> 16) & 0xFFFF) - kB16;
      if (x_test && !(bx1 >= s.px0 && bx0 <= s.px1 && by1 >= s.py0 &&
                      by0 <= s.py1)) {
        continue;
      }
      const unsigned a0 = R[0], b0 = R[1], c0 = R[2];
      const unsigned a1 = R[3], b1 = R[4], c1 = R[5];
      const unsigned a2 = R[6], b2 = R[7], c2 = R[8];
      const float z0 = __int_as_float(R[9]);
      const float z1 = __int_as_float(R[10]);
      const float z2 = __int_as_float(R[11]);
      const float inv = __int_as_float(R[12]);
      const int id = R[14];
      const int of = R[15];
      const int o0 = of & 1, o1 = (of >> 1) & 1, o2 = (of >> 2) & 1;
#pragma unroll
      for (int k = 0; k < kMaxPpt; ++k) {
        const int px = s.pxs[k], py = s.pys[k];
        if (px < bx0 || px > bx1 || py < by0 || py > by1) continue;
        const int e0 = (int)(a0 * (unsigned)px + b0 * (unsigned)py + c0);
        const int e1 = (int)(a1 * (unsigned)px + b1 * (unsigned)py + c1);
        const int e2 = (int)(a2 * (unsigned)px + b2 * (unsigned)py + c2);
        if (e0 < o0 || e1 < o1 || e2 < o2) continue;
        const float w0 = __fmul_rn(__fmul_rn(__int2float_rn(e0), inv), z0);
        const float w1 = __fmul_rn(__fmul_rn(__int2float_rn(e1), inv), z1);
        const float w2 = __fmul_rn(__fmul_rn(__int2float_rn(e2), inv), z2);
        const float zf = __fadd_rn(__fadd_rn(w0, w1), w2);
        if (!(zf >= 0.0f && zf <= 1.0f)) continue;
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
}

// Write the slab to the (height, width) outputs; a tile that did not run,
// and every pixel no record won, is background (BG, +inf).
__device__ __forceinline__ void slab_store(const Slab& s, bool ran,
                                           bool depth_test, int height,
                                           int width, int* __restrict__ tid_out,
                                           float* __restrict__ z_out) {
#pragma unroll
  for (int k = 0; k < kMaxPpt; ++k) {
    const int p = threadIdx.x + k * kThreads;
    const int r = p / kTileW;
    const int row = s.row0 + r;
    const int col = s.col0 + (p - r * kTileW);
    if (r >= s.rows || row >= height || col >= width) continue;
    int id = s.tb[k];
    float z = s.zb[k];
    if (!depth_test && id < 0) id = kBg;  // painter's order: -1 is "none"
    if (id == kBg || !ran) {
      id = kBg;
      z = __int_as_float(0x7f800000);
    }
    tid_out[(size_t)row * width + col] = id;
    z_out[(size_t)row * width + col] = z;
  }
}

// Grid of (tile, slab) CTAs for tile_h rows, or a zero dimension for a
// shape the kernels do not take.
inline dim3 slab_grid(int ntiles, int tile_h, int tile_w) {
  if (ntiles <= 0 || tile_w != kTileW || tile_h <= 0) {
    return dim3(0, 0, 0);
  }
  return dim3(ntiles, (tile_h + kSlabRows - 1) / kSlabRows, 1);
}

}  // namespace xr
