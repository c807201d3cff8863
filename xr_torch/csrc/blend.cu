// The blend stage's kernels for Hopper (sm_90a): xr_blend_slots and
// xr_blend_composite.
//
// They replace no Pallas kernel. They are the port's kernels for an XLA
// stage: the reference's blend composite, xr/shading/blend.py:76-194
// (_src_ordered_ids and composite_transparent), a lax.scan over chunks of
// blend_chunk records, each over the whole frame, which skips dead chunks
// with lax.cond and reads nothing to the host. Their plain versions are
// xr_torch/shading/blend.py live_slots_plain and blend_composite_plain.
//
// xr_blend_slots (slot_table_kernel) builds the live slot table in one
// launch of one block of 512 threads: one pass over the records, each
// thread's loads issued together, counts the transparent ones (valid,
// material alpha < 1) and keeps their keys, (source triangle, record
// index): a stable sort's order. Above the capacity a radix select over
// the 64-bit keys finds the last one taken, and a second pass takes the
// first blend_capacity, exact for any count. It ranks them in shared memory
// and writes one row a slot (the layout of blend.FIELDS, integer fields as
// int32 bits: the snapped vertices, z, 1/w, the face color, the sampler's
// six LOD terms, the material, the pixel box, the attributes), each
// chunk's box, and the meta vector: the live count, the transparent total,
// the overflow and the union of the live boxes cut to the frame. Every f32
// value is the one torch computes (-fmad=false, _sum3's (x0 + x1) + x2);
// rows from the count on are not written.
//
// xr_blend_composite (blend_composite_kernel) composites the live slots in
// place over the shaded color of rows [y_offset, y_offset + height) of the
// frame. A block owns a tile of 32 columns x 8 rows at a time, a thread
// one pixel. The grid is fixed, as many blocks as the SMs keep resident (a
// CUDA graph captures it), and strides over the tiles of the union box,
// read on the device: no block runs for a tile outside it and no pixel
// outside it is read or written. A block stages the live rows in shared
// memory once (in batches only where they pass its budget; their loads go
// out with the meta vector's) with each slot's edge constants (the edges
// as A px + B py + C in int32, the top-left tie bits, the doubled area and
// its reciprocal, which are the same at every pixel), then at each tile
// builds a bitmask of the slots whose box meets the tile, one ballot a
// warp, and each thread walks those slots in source order, j = 0 ..
// count - 1: the reference's chunks only batch this walk, so the per-pixel
// order and the result are the same. For a slot it tests exact int32
// coverage (fp.coverage), the fragment's depth, the depth range and the
// strict test against the opaque depth, then the fragment's color under
// the mode (flat, Gouraud, textured, Phong with every light, the shadow
// test and the trilinear sampler with its analytic LOD) and composites
// out = out * (1 - a) + frag * a. A pixel reads its depth at its first
// covering slot and its color at its first fragment, and writes its color
// only if a fragment landed: every other pixel keeps its bits.
//
// Bit for bit with the plain versions on the card: every operation is the
// one torch runs, in its order, rounded once (-fmad=false); scalar / tensor
// in torch is reciprocal(tensor) * scalar, so it is 1 / x here, times the
// scalar; the clamps propagate NaN as torch's do; every constant is the
// f32 rounding of the double torch is given.
//
// What bounds them: by bytes, the composite moves a few MB at config4b's
// frame (the color of the pixels a fragment lands on, read and written,
// the depth of the covered pixels, the table) and the slot table a few KB.
// Neither reaches that bound. The composite is held by the SMs' issue of
// the fragment math (about a thousand instructions a Phong fragment, most
// of them the IEEE divisions, square roots and powf that bit-exactness
// with torch keeps) and by the latency of its loads; the slot table, one
// block, by the latency of its few dependent loads and its launch.
// No tensor cores, no TMA: the tables are a few KB and the pixels are read
// once.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include <algorithm>

namespace xrb {

// the slot table's columns (xr_torch/shading/blend.py FIELDS)
constexpr int kXs = 0, kYs = 3, kZ = 6, kInvW = 9, kFace = 12, kLod = 15, kAlpha = 21,
              kBase = 22, kKa = 25, kKd = 26, kKs = 27, kShin = 28, kTexId = 29,
              kTexAddr = 30, kTexBase = 31, kMatId = 32, kBox = 33, kAttr = 37;
constexpr int kMaxWidth = kAttr + 3 * 8;  // Phong's 8 attributes
constexpr int kTileW = 32, kTileH = 8, kThreads = kTileW * kTileH;
constexpr int kMaxRows = 256;  // slots a composite block stages at a time, at most
constexpr int kMaskWords = kMaxRows / 32;  // one per warp of a tile
constexpr int kRowBytes = 32 * 1024;  // the staged rows' shared memory, at most
constexpr int kSlotThreads = 512;
constexpr int kFar = 1 << 30;  // past any snapped vertex (blend._FAR)
// the meta vector (kernels.META): count, total, overflow, 0, union y0 y1 x0 x1
constexpr int kMetaCount = 0, kMetaTotal = 1, kMetaOverflow = 2, kMetaUnion = 4;
constexpr int kFlat = 0, kGouraud = 1, kTextured = 2, kPhong = 3;

struct Args {
  const float* table;
  const int* meta;
  const float* consts;  // eye 3, ambient 3, dir dirs, dir colors, point positions,
                        // point colors (3 each), light view-projection 16
  float* color;         // composited in place
  const float* depth;
  const float* shadow;  // (hs, ws), or null: no shadow test
  const int* quads;     // (rows, quad_words), or null: no textures
  const int* level_size;
  const int* level_base;
  int height, width, y_offset, sub, mode, attr_width, table_width, cap, rows;
  int n_dir, n_point, hs, ws, quad_words, levels;
  float bias;
};

__device__ __forceinline__ int ibits(float f) { return __float_as_int(f); }

// torch's clamps on the card keep a NaN input
__device__ __forceinline__ float clamp_min_(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float maximum_(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}
__device__ __forceinline__ float nan_to_zero(float v) {
  return (isnan(v) || isinf(v)) ? 0.f : v;
}

// (x * x + y * y) + z * z, m3.dot / _sum3's order
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// m3.normalize(v, 1e-12): v / max(sqrt(dot(v, v)), eps)
__device__ __forceinline__ void normalize3(float* v) {
  const float n = clamp_min_(sqrtf(dot3(v, v)), (float)1e-12);
  v[0] = v[0] / n;
  v[1] = v[1] / n;
  v[2] = v[2] / n;
}

// (l0 * v0 + l1 * v1) + l2 * v2, the attribute interpolation's order
__device__ __forceinline__ float interp(const float* l, const float* v) {
  return (l[0] * v[0] + l[1] * v[1]) + l[2] * v[2];
}

__device__ __forceinline__ float unpack_ch(int q, int shift) {
  return (float)((q >> shift) & 0xFF) * (float)(1.0 / 255.0);
}

__device__ __forceinline__ float bilerp(float t00, float t01, float t10, float t11, float fu,
                                        float fv) {
  const float top = t00 + (t01 - t00) * fu;
  const float bot = t10 + (t11 - t10) * fu;
  return top + (bot - top) * fv;
}

struct LevelFrac {
  int i, j, s;
  float fu, fv;
};

// sample_trilinear's fractions(lk)
__device__ __forceinline__ LevelFrac level_frac(const Args& a, int tex, int lk, float u,
                                                float v) {
  LevelFrac f;
  f.s = a.level_size[tex * a.levels + lk];
  const float sf = (float)f.s;
  const float tu = u * sf - 0.5f, tv = v * sf - 0.5f;
  const float i0 = floorf(tu), j0 = floorf(tv);
  f.i = (int)i0;
  f.j = (int)j0;
  f.fu = tu - i0;
  f.fv = tv - j0;
  return f;
}

// sm.sample_trilinear at one pixel: the quad row of level l0 (own 2x2 and
// the parent's 3x3), blended across the two levels
__device__ void sample_trilinear(const Args& a, int tex, float u, float v, float lod, int addr,
                                 float out[3]) {
  const int L = a.levels;
  const float lf = clamp_(lod, 0.f, (float)(L - 1));
  const float l0f = floorf(lf);
  const float frac = lf - l0f;
  const int l0 = (int)l0f;
  const int l1 = min(l0 + 1, L - 1);
  const float uw = u - floorf(u), vw = v - floorf(v);
  if (addr == 1) {  // clamp to the coarser level's half-texel interior
    const float half = (1.f / (float)a.level_size[tex * L + l1]) * 0.5f;
    const float hi = 1.f - half;
    u = (isnan(u) ? u : fminf(fmaxf(u, half), hi));
    v = (isnan(v) ? v : fminf(fmaxf(v, half), hi));
  } else {
    u = uw;
    v = vw;
  }
  const LevelFrac f0 = level_frac(a, tex, l0, u, v);
  const unsigned s0 = (unsigned)f0.s;
  const int qidx = (int)((unsigned)a.level_base[tex * L + l0] +
                         ((unsigned)f0.j & (s0 - 1u)) * s0 + ((unsigned)f0.i & (s0 - 1u)));
  const int* row = a.quads + (long long)qidx * a.quad_words;
  int q[13];
#pragma unroll
  for (int c = 0; c < 13; ++c) q[c] = __ldg(row + c);
  const LevelFrac f1 = level_frac(a, tex, l1, u, v);
  const bool di1 = (f1.i - ((f0.i >> 1) - 1)) == 1;
  const bool dj1 = (f1.j - ((f0.j >> 1) - 1)) == 1;
  int p[4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int b = 4 + 3 * r + c;
      const int top = di1 ? q[b + 1] : q[b];
      const int bot = di1 ? q[b + 4] : q[b + 3];
      p[2 * r + c] = dj1 ? bot : top;
    }
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const int shift = 8 * ch;
    const float c0 = bilerp(unpack_ch(q[0], shift), unpack_ch(q[1], shift),
                            unpack_ch(q[2], shift), unpack_ch(q[3], shift), f0.fu, f0.fv);
    const float c1 = bilerp(unpack_ch(p[0], shift), unpack_ch(p[1], shift),
                            unpack_ch(p[2], shift), unpack_ch(p[3], shift), f1.fu, f1.fv);
    out[ch] = c0 + (c1 - c0) * frac;
  }
}

// deferred.sample_texture_at for one slot at one pixel: white without a
// texture
__device__ void sample_texture(const Args& a, const float* r, float u, float v, float denom,
                        float area, float out[3]) {
  out[0] = out[1] = out[2] = 1.f;
  const int tex = ibits(r[kTexId]);
  if (a.levels == 0 || tex < 0) return;
  const float D = denom * area;
  const float invD = 1.f / (D == 0.f ? (float)1e-30 : D);
  const float* lod6 = r + kLod;
  const float dudx = (lod6[2] - u * lod6[0]) * invD;
  const float dudy = (lod6[3] - u * lod6[1]) * invD;
  const float dvdx = (lod6[4] - v * lod6[0]) * invD;
  const float dvdy = (lod6[5] - v * lod6[1]) * invD;
  // sm.lod_from_derivs
  const float s = r[kTexBase], lim = (float)1e18;
  const float cux = clamp_(dudx * s, -lim, lim), cvx = clamp_(dvdx * s, -lim, lim);
  const float cuy = clamp_(dudy * s, -lim, lim), cvy = clamp_(dvdy * s, -lim, lim);
  const float rx = cux * cux + cvx * cvx;
  const float ry = cuy * cuy + cvy * cvy;
  const float rho2 = clamp_min_(maximum_(rx, ry), (float)1e-12);
  const float lod = 0.5f * (logf(rho2) * (float)1.4426950408889634);
  sample_trilinear(a, tex, u, v, lod, ibits(r[kTexAddr]), out);
}

// sm.shadow_test: 1 where lit, 0 where in shadow
__device__ float shadow_test(const Args& a, const float* m, const float* w3) {
  const float p[4] = {w3[0], w3[1], w3[2], 1.f};
  float clip[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float acc = m[4 * r] * p[0];
    acc = acc + m[4 * r + 1] * p[1];
    acc = acc + m[4 * r + 2] * p[2];
    acc = acc + m[4 * r + 3] * p[3];
    clip[r] = acc;
  }
  const float w = clamp_min_(clip[3], (float)1e-12);
  const float ndc_x = clip[0] / w, ndc_y = clip[1] / w, z = clip[2] / w;
  const float sx = nan_to_zero((ndc_x * 0.5f + 0.5f) * (float)a.ws);
  const float sy = nan_to_zero((0.5f - ndc_y * 0.5f) * (float)a.hs);
  const int ix = (int)clamp_(floorf(sx), 0.f, (float)(a.ws - 1));
  const int iy = (int)clamp_(floorf(sy), 0.f, (float)(a.hs - 1));
  const float d = __ldg(a.shadow + (long long)iy * a.ws + ix);
  const bool inside = ndc_x >= -1.f && ndc_x <= 1.f && ndc_y >= -1.f && ndc_y <= 1.f &&
                      z >= 0.f && z <= 1.f;
  return (inside && z - a.bias > d) ? 0.f : 1.f;
}

// one light of sm.shade_phong, added to out
__device__ __forceinline__ void one_light(const float* n, const float* v, const float* base,
                                          float kd, float ks, float shin, const float* l_vec,
                                          const float* l_color, float att, bool shadowed,
                                          float shadow, float out[3]) {
  float l[3] = {l_vec[0], l_vec[1], l_vec[2]};
  normalize3(l);
  const float ndl = clamp_min_(dot3(n, l), 0.f);
  float h[3] = {l[0] + v[0], l[1] + v[1], l[2] + v[2]};
  normalize3(h);
  const float ndh = clamp_min_(dot3(n, h), 0.f);
  const float spec = ndl > 0.f ? powf(ndh, shin) : 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float x = ((kd * base[c]) * ndl + ks * spec) * l_color[c];
    x = x * att;
    if (shadowed) x = x * shadow;
    out[c] = out[c] + x;
  }
}

// blend._fragment_colors for one slot at one covered pixel
__device__ void fragment_color(const Args& a, const float* r, const float* lw, float area,
                               float frag[3]) {
  if (a.mode == kFlat) {
    frag[0] = r[kFace];
    frag[1] = r[kFace + 1];
    frag[2] = r[kFace + 2];
    return;
  }
  const float denom = interp(lw, r + kInvW);
  const float inv_denom = 1.f / clamp_min_(denom, (float)1e-20);
  auto attr = [&](int j) { return interp(lw, r + kAttr + 3 * j) * inv_denom; };
  if (a.mode == kGouraud) {
    frag[0] = attr(0);
    frag[1] = attr(1);
    frag[2] = attr(2);
    return;
  }
  if (a.mode == kTextured) {
    float tex[3];
    sample_texture(a, r, attr(0), attr(1), denom, area, tex);
    frag[0] = tex[0] * attr(2);
    frag[1] = tex[1] * attr(3);
    frag[2] = tex[2] * attr(4);
    return;
  }
  // Phong (sm.shade_phong)
  const float world[3] = {attr(0), attr(1), attr(2)};
  float n[3] = {attr(3), attr(4), attr(5)};
  normalize3(n);
  float tex[3];
  sample_texture(a, r, attr(6), attr(7), denom, area, tex);
  const float base[3] = {r[kBase] * tex[0], r[kBase + 1] * tex[1], r[kBase + 2] * tex[2]};
  const float* eye = a.consts;
  const float* ambient = a.consts + 3;
  const float* light_vp = a.consts + 6 + 6 * (a.n_dir + a.n_point);
  const bool shadowed = a.shadow != nullptr;
  const float shadow = shadowed ? shadow_test(a, light_vp, world) : 1.f;
  float v[3] = {eye[0] - world[0], eye[1] - world[1], eye[2] - world[2]};
  normalize3(v);
  const float ka = r[kKa], kd = r[kKd], ks = r[kKs], shin = r[kShin];
#pragma unroll
  for (int c = 0; c < 3; ++c) frag[c] = (ka * ambient[c]) * base[c];
  const float* dir_dirs = a.consts + 6;
  const float* dir_colors = dir_dirs + 3 * a.n_dir;
  const float* pt_pos = dir_colors + 3 * a.n_dir;
  const float* pt_colors = pt_pos + 3 * a.n_point;
  for (int i = 0; i < a.n_dir; ++i) {
    const float l_vec[3] = {-dir_dirs[3 * i], -dir_dirs[3 * i + 1], -dir_dirs[3 * i + 2]};
    one_light(n, v, base, kd, ks, shin, l_vec, dir_colors + 3 * i, 1.f, shadowed && i == 0,
              shadow, frag);
  }
  for (int i = 0; i < a.n_point; ++i) {
    const float l_vec[3] = {pt_pos[3 * i] - world[0], pt_pos[3 * i + 1] - world[1],
                            pt_pos[3 * i + 2] - world[2]};
    const float att = 1.f / (1.f + (float)0.05 * dot3(l_vec, l_vec));
    one_light(n, v, base, kd, ks, shin, l_vec, pt_colors + 3 * i, att, false, 1.f, frag);
  }
}

// A slot's edges as the composite tests them, made once a staged slot:
// edge m (opposite vertex m) from vertex k = (m + 1) % 3 to k1 = (k + 1) % 3
// is e_m = A (px - X_k) + B (py - Y_k) in int32 with wraparound, A = Y_k1 -
// Y_k, B = X_k - X_k1 (fp.coverage); that is A px + B py + C with C = -(A
// X_k + B Y_k), the same bits. Its word kTopLeft holds the top-left rule's
// tie bit of each edge (A > 0, or A == 0 and B > 0), then the doubled area
// e0 + e1 + e2 (fp.barycentrics_f32: the same at every pixel, since the
// A's and B's each sum to 0, so the C's sum) and its reciprocal, 0 for a
// zero area.
constexpr int kEdgeA = 0, kEdgeB = 3, kEdgeC = 6, kTopLeft = 9, kArea = 10, kInv = 11,
              kEdgeWords = 12;

__device__ __forceinline__ void slot_edges(const float* r, int* E) {
  unsigned sum = 0;
  int tl = 0;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int k = (m + 1) % 3, k1 = (k + 1) % 3;
    const unsigned X = (unsigned)ibits(r[kXs + k]), Y = (unsigned)ibits(r[kYs + k]);
    const unsigned A = (unsigned)ibits(r[kYs + k1]) - Y;
    const unsigned B = X - (unsigned)ibits(r[kXs + k1]);
    const unsigned C = 0u - (A * X + B * Y);
    E[kEdgeA + m] = (int)A;
    E[kEdgeB + m] = (int)B;
    E[kEdgeC + m] = (int)C;
    tl |= ((int)A > 0 || ((int)A == 0 && (int)B > 0)) << m;
    sum += C;
  }
  E[kTopLeft] = tl;
  const float area = (float)(int)sum;
  const float safe = area == 0.f ? 1.f : area;
  E[kArea] = __float_as_int(area);
  E[kInv] = __float_as_int(area != 0.f ? 1.f / safe : 0.f);
}

// fp.coverage of a slot (its edges E, slot_edges) at the fixed-point centre
// (px, py), the top-left rule on ties; then fp.barycentrics_f32's weights
__device__ __forceinline__ bool covers(const int* E, int px, int py, float lw[3]) {
  int e[3];
  bool cov = true;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int ev = (int)((unsigned)E[kEdgeA + m] * (unsigned)px +
                         (unsigned)E[kEdgeB + m] * (unsigned)py + (unsigned)E[kEdgeC + m]);
    cov = cov && (ev > 0 || (ev == 0 && ((E[kTopLeft] >> m) & 1)));
    e[m] = ev;
  }
  if (!cov) return false;
  const float inv = __int_as_float(E[kInv]);
  lw[0] = (float)e[0] * inv;
  lw[1] = (float)e[1] * inv;
  lw[2] = (float)e[2] * inv;
  return true;
}

__device__ __forceinline__ bool box_meets(const float* r, int y0, int y1, int x0, int x1) {
  return ibits(r[kBox]) < y1 && ibits(r[kBox + 1]) > y0 && ibits(r[kBox + 2]) < x1 &&
         ibits(r[kBox + 3]) > x0;
}

// the slots of `mask` (rows of the staged batch, their edges in edges)
// composited over the pixel (x, y) of the full frame, in source order; the
// pixel's depth and color are read together at its first covering slot (one
// trip to memory), and its color is written only if a fragment landed
__device__ __forceinline__ void composite_pixel(const Args& a, const float* rows,
                                                const int (*edges)[kEdgeWords],
                                                const unsigned* mask, int words, int x, int y) {
  const int px = x * a.sub + a.sub / 2, py = y * a.sub + a.sub / 2;
  const long long pix = (long long)(y - a.y_offset) * a.width + x;
  float out[3] = {0.f, 0.f, 0.f}, depth = 0.f;
  bool read = false, wrote = false;
  for (int w = 0; w < words; ++w) {
    for (unsigned m = mask[w]; m; m &= m - 1) {
      const int j = 32 * w + __ffs(m) - 1;
      float lw[3];
      if (!covers(edges[j], px, py, lw)) continue;
      const float* r = rows + j * a.table_width;
      if (!read) {
        depth = a.depth[pix];
        out[0] = a.color[3 * pix];
        out[1] = a.color[3 * pix + 1];
        out[2] = a.color[3 * pix + 2];
        read = true;
      }
      // rc.fragment_depth, the depth range and the strict test against the
      // opaque depth
      const float zf = interp(lw, r + kZ);
      if (!(zf >= 0.f && zf <= 1.f && zf < depth)) continue;
      wrote = true;
      float frag[3];
      fragment_color(a, r, lw, __int_as_float(edges[j][kArea]), frag);
      const float alpha = r[kAlpha];
      const float keep = 1.f - alpha;
#pragma unroll
      for (int c = 0; c < 3; ++c) out[c] = out[c] * keep + frag[c] * alpha;
    }
  }
  if (wrote) {
    a.color[3 * pix] = out[0];
    a.color[3 * pix + 1] = out[1];
    a.color[3 * pix + 2] = out[2];
  }
}

// two blocks a SM at least: ptxas then keeps the fragment math in 80
// registers without a spill (a bare 256-thread bound held it to 64, with
// spills)
__global__ void __launch_bounds__(kThreads, 2) blend_composite_kernel(Args a) {
  extern __shared__ float s_rows[];  // a.rows slots of a.table_width columns
  __shared__ int s_edge[kMaxRows][kEdgeWords];  // each staged slot's edges (slot_edges)
  __shared__ unsigned s_mask[2][kMaskWords];
  const int tid = threadIdx.y * kTileW + threadIdx.x, lane = threadIdx.x, warp = threadIdx.y;
  // the first batch's rows are read before the count is known, so their
  // loads go out with the meta vector's
  for (int i = tid; i < min(a.rows, a.cap) * a.table_width; i += kThreads)
    s_rows[i] = a.table[i];
  const int n = min(max(a.meta[kMetaCount], 0), a.cap);
  // the union of the live boxes (cut to the frame) cut to the band's rows
  const int uy0 = max(a.meta[kMetaUnion], a.y_offset);
  const int uy1 = min(a.meta[kMetaUnion + 1], a.y_offset + a.height);
  const int ux0 = max(a.meta[kMetaUnion + 2], 0), ux1 = min(a.meta[kMetaUnion + 3], a.width);
  if (n == 0 || uy0 >= uy1 || ux0 >= ux1) return;
  // its tiles, in the band's tile grid; the grid holds as many blocks as
  // the SMs keep resident, and each strides over them
  const int ty0 = (uy0 - a.y_offset) / kTileH, tx0 = ux0 / kTileW;
  const int ntx = (ux1 - 1) / kTileW + 1 - tx0;
  const int ntiles = ((uy1 - a.y_offset - 1) / kTileH + 1 - ty0) * ntx;
  if ((int)blockIdx.x >= ntiles) return;
  int parity = 0;
  for (int first = 0; first < n; first += a.rows) {
    const int nb = min(a.rows, n - first), words = (nb + 31) / 32;
    if (first) {  // the next batch, once every thread is done with the last
      __syncthreads();
      const float* src = a.table + (long long)first * a.table_width;
      for (int i = tid; i < nb * a.table_width; i += kThreads) s_rows[i] = src[i];
    }
    __syncthreads();
    for (int j = tid; j < nb; j += kThreads) slot_edges(s_rows + j * a.table_width, s_edge[j]);
    __syncthreads();
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int y0 = a.y_offset + (ty0 + t / ntx) * kTileH;
      const int y1 = min(y0 + kTileH, a.y_offset + a.height);
      const int x0 = (tx0 + t % ntx) * kTileW, x1 = min(x0 + kTileW, a.width);
      // the batch's slots whose box meets the tile; two masks in turn, so
      // one barrier a tile keeps the next tile's from overwriting them
      unsigned* mask = s_mask[parity];
      parity ^= 1;
      if (warp < words) {
        const int j = 32 * warp + lane;
        const bool hit = j < nb && box_meets(s_rows + j * a.table_width, y0, y1, x0, x1);
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (lane == 0) mask[warp] = m;
      }
      __syncthreads();
      const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
      if (x < x1 && y < y1) composite_pixel(a, s_rows, s_edge, mask, words, x, y);
    }
  }
}

// ---- the slot table ----

struct SlotArgs {
  // the setup records (C records): xs, ys (C, 3) i32; z, inv_w, face (C, 3)
  // f32; attr_w (C, 3, attr_width) f32; mat_id, src_id (C,) i32; valid (C,)
  // bool
  const int* xs;
  const int* ys;
  const float* z;
  const float* inv_w;
  const float* face;
  const float* attr_w;
  const int* mat_id;
  const int* src_id;
  const unsigned char* valid;
  // the materials (M rows): alpha, ka, kd, ks, shininess (M,) f32,
  // base_color (M, 3) f32, tex_id (M,) i32, tex_addr (M,) i32 or null (0)
  const float* alpha;
  const float* base_color;
  const float* ka;
  const float* kd;
  const float* ks;
  const float* shin;
  const int* tex_id;
  const int* tex_addr;
  const int* tex_size;  // a ragged pyramid's base size per texture, or null: tex_base
  long long* ids;
  int* boxes;
  float* table;
  int* meta;
  int records, materials, attr_width, uv_slot, sub, cap, chunk, nchunks, height, width;
  float tex_base;
};

// torch.div(v, d, rounding_mode="floor") for d > 0
__device__ __forceinline__ int floor_div(int v, int d) {
  return v >= 0 ? v / d : -((d - 1 - v) / d);
}

// blend._first_center: the first pixel whose centre lies at or past v
__device__ __forceinline__ int first_center(int v, int sub) {
  return -floor_div(sub / 2 - v, sub);
}

// a material index as torch indexes with it (a negative one from the end);
// -1 where it lies outside the table
__device__ __forceinline__ int material(const SlotArgs& a, int m) {
  m = m < 0 ? m + a.materials : m;
  return m >= 0 && m < a.materials ? m : -1;
}

// blend.transparent_mask of record i (its flag and material read together)
__device__ __forceinline__ bool transparent(const SlotArgs& a, int i) {
  const bool valid = a.valid[i];
  const int m = material(a, __ldg(a.mat_id + i));
  return valid && m >= 0 && __ldg(a.alpha + m) < 1.f;
}

// the source order's key of a transparent record: (src_id, record index)
__device__ __forceinline__ unsigned long long slot_key(const SlotArgs& a, int i) {
  return ((unsigned long long)((unsigned)__ldg(a.src_id + i) ^ 0x80000000u) << 32) |
         (unsigned)i;
}

// (a0 * v0 + a1 * v1) + a2 * v2: deferred._sum3 of a product
__device__ __forceinline__ float sum3(const float* a, const float* v) {
  return (a[0] * v[0] + a[1] * v[1]) + a[2] * v[2];
}

// a material's fields as a slot row carries them: alpha, base_color (3),
// ka, kd, ks, shininess, tex_id and tex_addr (int32 bits), and the LOD's
// texel scale (a ragged pyramid's base size of the texture, texture 0's
// where there is none; else the uniform pyramid's)
constexpr int kMatAlpha = 0, kMatBase = 1, kMatKa = 4, kMatKd = 5, kMatKs = 6, kMatShin = 7,
              kMatTexId = 8, kMatTexAddr = 9, kMatTexBase = 10, kMatWords = 11;
constexpr int kSlotMaterials = 256;  // materials a slot-table block keeps in shared memory

__device__ __forceinline__ void material_row(const SlotArgs& a, int m, float* out) {
  out[kMatAlpha] = a.alpha[m];
#pragma unroll
  for (int c = 0; c < 3; ++c) out[kMatBase + c] = a.base_color[3 * m + c];
  out[kMatKa] = a.ka[m];
  out[kMatKd] = a.kd[m];
  out[kMatKs] = a.ks[m];
  out[kMatShin] = a.shin[m];
  const int tex = a.tex_id[m];
  out[kMatTexId] = __int_as_float(tex);
  out[kMatTexAddr] = __int_as_float(a.tex_addr != nullptr ? a.tex_addr[m] : 0);
  out[kMatTexBase] = a.tex_size != nullptr ? (float)a.tex_size[tex >= 0 ? tex : 0] : a.tex_base;
}

// blend.record_slots and pack_slots: record r as row j of the table; its
// material's row from s_mat where the block keeps the materials there
__device__ __forceinline__ void write_row(const SlotArgs& a, int j, int r,
                                          const float (*s_mat)[kMatWords]) {
  const int width = kAttr + 3 * a.attr_width;
  float* row = a.table + (long long)j * width;
  int X[3], Y[3];
  float iw[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    X[k] = a.xs[3 * r + k];
    Y[k] = a.ys[3 * r + k];
    iw[k] = a.inv_w[3 * r + k];
    row[kXs + k] = __int_as_float(X[k]);
    row[kYs + k] = __int_as_float(Y[k]);
    row[kZ + k] = a.z[3 * r + k];
    row[kInvW + k] = iw[k];
    row[kFace + k] = a.face[3 * r + k];
  }
  const float* aw = a.attr_w + (long long)r * 3 * a.attr_width;
  // deferred._lod_terms: the edge opposite vertex k is edge (k + 1) % 3,
  // A_k = Y_{k+1} - Y_k and B_k = X_k - X_{k+1} in int32
  float lod[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (a.uv_slot >= 0) {
    float ao[3], bo[3], uw[3], vw[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int e = (k + 1) % 3, e1 = (e + 1) % 3;
      ao[k] = (float)(int)((unsigned)Y[e1] - (unsigned)Y[e]);
      bo[k] = (float)(int)((unsigned)X[e] - (unsigned)X[e1]);
      uw[k] = aw[k * a.attr_width + a.uv_slot];
      vw[k] = aw[k * a.attr_width + a.uv_slot + 1];
    }
    const float s = (float)a.sub;
    lod[0] = sum3(ao, iw) * s;
    lod[1] = sum3(bo, iw) * s;
    lod[2] = sum3(ao, uw) * s;
    lod[3] = sum3(bo, uw) * s;
    lod[4] = sum3(ao, vw) * s;
    lod[5] = sum3(bo, vw) * s;
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) row[kLod + c] = lod[c];
  const int mid = a.mat_id[r], m = material(a, mid);
  float mat[kMatWords];
  if (a.materials <= kSlotMaterials) {
#pragma unroll
    for (int w = 0; w < kMatWords; ++w) mat[w] = s_mat[m][w];
  } else {
    material_row(a, m, mat);
  }
  row[kAlpha] = mat[kMatAlpha];
#pragma unroll
  for (int c = 0; c < 3; ++c) row[kBase + c] = mat[kMatBase + c];
  row[kKa] = mat[kMatKa];
  row[kKd] = mat[kMatKd];
  row[kKs] = mat[kMatKs];
  row[kShin] = mat[kMatShin];
  row[kTexId] = mat[kMatTexId];
  row[kTexAddr] = mat[kMatTexAddr];
  row[kTexBase] = mat[kMatTexBase];
  row[kMatId] = __int_as_float(mid);
  row[kBox] = __int_as_float(first_center(min(min(Y[0], Y[1]), Y[2]), a.sub));
  row[kBox + 1] = __int_as_float(first_center(max(max(Y[0], Y[1]), Y[2]) + 1, a.sub));
  row[kBox + 2] = __int_as_float(first_center(min(min(X[0], X[1]), X[2]), a.sub));
  row[kBox + 3] = __int_as_float(first_center(max(max(X[0], X[1]), X[2]) + 1, a.sub));
  // attribute-major, vertex-minor
  for (int c = 0; c < a.attr_width; ++c)
#pragma unroll
    for (int k = 0; k < 3; ++k) row[kAttr + 3 * c + k] = aw[k * a.attr_width + c];
}

// the records a slot-table thread reads at a time, their loads issued
// together: one round trip to memory a pass for up to 4,096 records
constexpr int kSlotUnroll = 8;

// no launch bound: with one ptxas held the kernel to 40 registers (32 at
// 1024 threads), with spills; without, it takes 48 and none
__global__ void slot_table_kernel(SlotArgs a) {
  extern __shared__ unsigned long long s_keys[];  // cap keys, then cap record ids
  int* s_ids = reinterpret_cast<int*>(s_keys + a.cap);
  __shared__ int s_total, s_taken, s_need, s_hist[256], s_union[4];
  __shared__ unsigned long long s_prefix;
  __shared__ float s_mat[kSlotMaterials][kMatWords];  // the materials, where they fit
  const int tid = threadIdx.x;
  const bool staged = a.materials <= kSlotMaterials;
  // the first records' loads go out before the materials are staged, so
  // the two trips to memory overlap
  bool valid[kSlotUnroll];
  int mat[kSlotUnroll], src[kSlotUnroll];
  auto load = [&](int base) {
#pragma unroll
    for (int u = 0; u < kSlotUnroll; ++u) {
      const int i = base + u * kSlotThreads;
      valid[u] = i < a.records && a.valid[i];
      mat[u] = i < a.records ? __ldg(a.mat_id + i) : 0;
      src[u] = i < a.records ? __ldg(a.src_id + i) : 0;
    }
  };
  load(tid);
  if (staged)
    for (int m = tid; m < a.materials; m += kSlotThreads) material_row(a, m, s_mat[m]);
  if (tid == 0) {
    s_total = s_taken = 0;
    s_union[0] = s_union[2] = INT_MAX;
    s_union[1] = s_union[3] = INT_MIN;
  }
  __syncthreads();
  // one pass: the transparent total, and the keys of the first cap
  // transparent records met (all of them at or under the capacity)
  int mine = 0;
  for (int base = tid; base < a.records; base += kSlotUnroll * kSlotThreads) {
    if (base != tid) load(base);
#pragma unroll
    for (int u = 0; u < kSlotUnroll; ++u) {
      const int m = material(a, mat[u]);
      if (!valid[u] || m < 0) continue;
      if (!((staged ? s_mat[m][kMatAlpha] : __ldg(a.alpha + m)) < 1.f)) continue;
      ++mine;
      const int at = atomicAdd(&s_taken, 1);
      if (at < a.cap)
        s_keys[at] = ((unsigned long long)((unsigned)src[u] ^ 0x80000000u) << 32) |
                     (unsigned)(base + u * kSlotThreads);
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) mine += __shfl_xor_sync(0xffffffffu, mine, o);
  if ((tid & 31) == 0 && mine) atomicAdd(&s_total, mine);
  __syncthreads();
  const int total = s_total, k = min(total, a.cap);
  if (total > a.cap) {
    // above the capacity the keys taken were the first met, not the
    // smallest: find the k-th smallest key, 8 bits at a time from the
    // top, then take every key at or under it
    if (tid == 0) {
      s_prefix = 0;
      s_need = k;
      s_taken = 0;
    }
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int d = tid; d < 256; d += kSlotThreads) s_hist[d] = 0;
      __syncthreads();
      const unsigned long long prefix = s_prefix;
      const unsigned long long high = shift == 56 ? 0ull : ~0ull << (shift + 8);
      for (int i = tid; i < a.records; i += kSlotThreads) {
        if (!transparent(a, i)) continue;
        const unsigned long long key = slot_key(a, i);
        if ((key & high) == prefix) atomicAdd(&s_hist[(key >> shift) & 255], 1);
      }
      __syncthreads();
      if (tid == 0) {
        int need = s_need, d = 0;
        for (; d < 255 && s_hist[d] < need; ++d) need -= s_hist[d];
        s_need = need;
        s_prefix = prefix | ((unsigned long long)d << shift);
      }
      __syncthreads();
    }
    const unsigned long long last = s_prefix;
    for (int i = tid; i < a.records; i += kSlotThreads) {
      if (!transparent(a, i)) continue;
      const unsigned long long key = slot_key(a, i);
      if (key <= last) s_keys[atomicAdd(&s_taken, 1)] = key;
    }
    __syncthreads();
  }
  // each key's rank among the taken ones is its slot
  for (int e = tid; e < k; e += kSlotThreads) {
    const unsigned long long key = s_keys[e];
    int rank = 0;
    for (int f = 0; f < k; ++f) rank += s_keys[f] < key;
    s_ids[rank] = (int)(unsigned)key;
  }
  __syncthreads();
  for (int j = tid; j < k; j += kSlotThreads) {
    a.ids[j] = s_ids[j];
    write_row(a, j, s_ids[j], s_mat);
  }
  // each chunk's box over its live slots (blend.live_slots' extent)
  for (int c = tid; c < a.nchunks; c += kSlotThreads) {
    int ylo = kFar, yhi = -kFar, xlo = kFar, xhi = -kFar;
    for (int j = c * a.chunk; j < min((c + 1) * a.chunk, k); ++j) {
      const int r = s_ids[j];
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        ylo = min(ylo, a.ys[3 * r + v]);
        yhi = max(yhi, a.ys[3 * r + v]);
        xlo = min(xlo, a.xs[3 * r + v]);
        xhi = max(xhi, a.xs[3 * r + v]);
      }
    }
    const int by0 = first_center(ylo, a.sub), by1 = first_center(yhi + 1, a.sub);
    const int bx0 = first_center(xlo, a.sub), bx1 = first_center(xhi + 1, a.sub);
    a.boxes[4 * c] = by0;
    a.boxes[4 * c + 1] = by1;
    a.boxes[4 * c + 2] = bx0;
    a.boxes[4 * c + 3] = bx1;
    atomicMin(&s_union[0], by0);
    atomicMax(&s_union[1], by1);
    atomicMin(&s_union[2], bx0);
    atomicMax(&s_union[3], bx1);
  }
  __syncthreads();
  if (tid == 0) {
    a.meta[kMetaCount] = k;
    a.meta[kMetaTotal] = total;
    a.meta[kMetaOverflow] = max(total - a.cap, 0);
    a.meta[3] = 0;
    a.meta[kMetaUnion] = min(max(s_union[0], 0), a.height);
    a.meta[kMetaUnion + 1] = min(max(s_union[1], 0), a.height);
    a.meta[kMetaUnion + 2] = min(max(s_union[2], 0), a.width);
    a.meta[kMetaUnion + 3] = min(max(s_union[3], 0), a.width);
  }
}

}  // namespace xrb

// One composite on `stream`, in place; allocates nothing. color (height,
// width, 3) f32, written where a fragment lands; depth (height, width) f32;
// table (cap, table_width) f32; meta the slot table's 8 ints on the device
// (count and union box read there); consts as Args says; shadow (hs, ws)
// f32 or null; quads (rows, quad_words) i32, level_size and level_base
// (ntex * levels) i32, or null with levels 0. Returns the launch status, or
// cudaErrorInvalidValue for a mode or a table the kernel does not take.
extern "C" int xr_blend_composite(
    const float* table, const int* meta, const float* consts, float* color, const float* depth,
    const float* shadow, const int* quads, const int* level_size, const int* level_base,
    int height, int width, int y_offset, int sub, int mode, int attr_width, int table_width,
    int cap, int n_dir, int n_point, int hs, int ws, int quad_words, int levels, float bias,
    void* stream) {
  if (mode < xrb::kFlat || mode > xrb::kPhong || table_width != xrb::kAttr + 3 * attr_width ||
      table_width > xrb::kMaxWidth || (levels > 0 && quad_words < 13) || height <= 0 ||
      width <= 0 || cap < 0)
    return (int)cudaErrorInvalidValue;
  const int rows = max(1, min(min(cap, xrb::kMaxRows),
                              xrb::kRowBytes / (int)(table_width * sizeof(float))));
  const xrb::Args a = {table, meta, consts, color, depth, shadow, quads, level_size,
                       level_base, height, width, y_offset, sub, mode, attr_width, table_width,
                       cap, rows, n_dir, n_point, hs, ws, quad_words, levels, bias};
  // as many blocks as the SMs keep resident: one wave, each block striding
  // over the union box's tiles
  const size_t smem = rows * table_width * sizeof(float);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, xrb::blend_composite_kernel,
                                                        xrb::kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((width + xrb::kTileW - 1) / xrb::kTileW) *
                          ((height + xrb::kTileH - 1) / xrb::kTileH);
  const int grid = (int)std::max(1LL, std::min(tiles, (long long)per_sm * sms));
  xrb::blend_composite_kernel<<<grid, dim3(xrb::kTileW, xrb::kTileH), smem,
                                (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The slot table on `stream`, one block; allocates nothing. The records
// and materials as SlotArgs says (tex_addr, tex_size null where the scene
// has none); uv_slot the attribute of u (v the next) where the mode samples
// a texture, else -1; tex_base the uniform pyramid's base size (0 without
// one). Writes ids (nchunks * chunk) i64, boxes (nchunks, 4) i32 and table
// (cap, 37 + 3 * attr_width) f32 up to the live count, and meta (8) i32.
// Returns the launch status, or cudaErrorInvalidValue for a capacity whose
// keys do not fit in shared memory.
extern "C" int xr_blend_slots(
    const int* xs, const int* ys, const float* z, const float* inv_w, const float* face,
    const float* attr_w, const int* mat_id, const int* src_id, const unsigned char* valid,
    const float* alpha, const float* base_color, const float* ka, const float* kd,
    const float* ks, const float* shin, const int* tex_id, const int* tex_addr,
    const int* tex_size, long long* ids, int* boxes, float* table, int* meta, int records,
    int materials, int attr_width, int uv_slot, int sub, int cap, int chunk, int height,
    int width, float tex_base, void* stream) {
  if (records < 0 || materials <= 0 || attr_width < 0 ||
      xrb::kAttr + 3 * attr_width > xrb::kMaxWidth || cap < 1 || chunk < 1 || sub < 1 ||
      (uv_slot >= 0 && uv_slot + 1 >= attr_width))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)cap * (sizeof(unsigned long long) + sizeof(int));
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        xrb::slot_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int nchunks = (cap + chunk - 1) / chunk;
  const xrb::SlotArgs a = {xs, ys, z, inv_w, face, attr_w, mat_id, src_id, valid, alpha,
                           base_color, ka, kd, ks, shin, tex_id, tex_addr, tex_size, ids,
                           boxes, table, meta, records, materials, attr_width, uv_slot, sub,
                           cap, chunk, nchunks, height, width, tex_base};
  xrb::slot_table_kernel<<<1, xrb::kSlotThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
