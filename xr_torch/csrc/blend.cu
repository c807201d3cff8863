// Blend composite kernel for Hopper (sm_90a): xr_blend_composite.
//
// Replaces no Pallas kernel. It is the port's kernel for an XLA stage: the
// reference's blend composite, xr/shading/blend.py:95-194
// (composite_transparent), a lax.scan over chunks of blend_chunk records,
// each over the whole frame, which skips dead chunks with lax.cond and reads
// nothing to the host. Its torch counterpart had to read the live count and
// the chunks' boxes to the host to crop its shapes; this kernel reads them
// on the device, so the stage is captured in a CUDA graph with the rest of
// the frame. Its plain version is xr_torch/shading/blend.py
// blend_composite_plain.
//
// Inputs: the slot table (blend.live_slots: one row of table_width f32 a
// slot, in source order, the layout of blend.FIELDS, integer fields as
// int32 bits) and the live count (min(total, blend_capacity), on the
// device); the shaded color and the opaque depth of rows [y_offset,
// y_offset + height) of the frame; the frame's constants (eye, lights, the
// light's view-projection); the shadow map; the texture quads and each
// (texture, level)'s texel width and first quad row. Output: a new color.
//
// A block owns a tile of 32 columns x 8 rows, a thread one pixel. The grid
// is fixed by the frame's size; the work is not. A block reads the count,
// checks each live slot's pixel box (the box of the pixel centres in its
// snapped bounding box) against its tile, and copies its tile unchanged if
// none meets it: at config4b's 1080p frame the panes' box is a small share
// of the frame. Otherwise it stages the slots' rows in shared memory, 32 at
// a time, and each thread walks them in source order, j = 0 .. count - 1,
// skipping a slot whose box misses its pixel (no pixel outside the box is
// covered): the reference's chunks only batch this walk, so the per-pixel
// order and the result are the same. For a slot it computes exact int32
// coverage (fp.coverage), the fragment's depth, the depth-range test and
// the strict test against the opaque depth, then the fragment's color
// under the mode (flat, Gouraud, textured, Phong with every light, the
// shadow test and the trilinear sampler with its analytic LOD) and
// composites out = out * (1 - a) + frag * a.
//
// Bit for bit with the plain version on the card: every operation is the
// one torch runs, in its order, rounded once (-fmad=false); scalar / tensor
// in torch is reciprocal(tensor) * scalar, so it is 1 / x here, times the
// scalar; the clamps propagate NaN as torch's do; every constant is the
// f32 rounding of the double torch is given.
//
// What bounds it: at config4b's frame, bytes (the frame's color read and
// written, the depth of the panes' box, the table). The shading of a
// covered pixel is some hundreds of f32 operations a slot over a few
// hundred thousand pixels, a GFLOP at most, far below the card's FP32 rate.
// No tensor cores, no TMA: the table is a few KB and the pixels are read
// once.

#include <cuda_runtime.h>
#include <math.h>

namespace xrb {

// the slot table's columns (xr_torch/shading/blend.py FIELDS)
constexpr int kXs = 0, kYs = 3, kZ = 6, kInvW = 9, kFace = 12, kLod = 15, kAlpha = 21,
              kBase = 22, kKa = 25, kKd = 26, kKs = 27, kShin = 28, kTexId = 29,
              kTexAddr = 30, kTexBase = 31, kMatId = 32, kBox = 33, kAttr = 37;
constexpr int kMaxWidth = kAttr + 3 * 8;  // Phong's 8 attributes
constexpr int kTileW = 32, kTileH = 8, kThreads = kTileW * kTileH;
constexpr int kBatch = 32;  // slots staged in shared memory at a time
constexpr int kFlat = 0, kGouraud = 1, kTextured = 2, kPhong = 3;

struct Args {
  const float* table;
  const int* count;
  const float* consts;  // eye 3, ambient 3, dir dirs, dir colors, point positions,
                        // point colors (3 each), light view-projection 16
  const float* color_in;
  const float* depth;
  float* color_out;
  const float* shadow;  // (hs, ws), or null: no shadow test
  const int* quads;     // (rows, quad_words), or null: no textures
  const int* level_size;
  const int* level_base;
  int height, width, y_offset, sub, mode, attr_width, table_width, cap;
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
  const float* dir_dirs = a.consts + 6;
  const float* dir_colors = dir_dirs + 3 * a.n_dir;
  const float* pt_pos = dir_colors + 3 * a.n_dir;
  const float* pt_colors = pt_pos + 3 * a.n_point;
  const float* light_vp = pt_colors + 3 * a.n_point;
  const bool shadowed = a.shadow != nullptr;
  const float shadow = shadowed ? shadow_test(a, light_vp, world) : 1.f;
  float v[3] = {eye[0] - world[0], eye[1] - world[1], eye[2] - world[2]};
  normalize3(v);
  const float ka = r[kKa], kd = r[kKd], ks = r[kKs], shin = r[kShin];
#pragma unroll
  for (int c = 0; c < 3; ++c) frag[c] = (ka * ambient[c]) * base[c];
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

// one slot at one pixel: coverage, depth, tests, color, composite
__device__ __forceinline__ void composite_slot(const Args& a, const float* r, int px, int py,
                                               float depth, float out[3]) {
  int X[3], Y[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    X[k] = ibits(r[kXs + k]);
    Y[k] = ibits(r[kYs + k]);
  }
  // fp.coverage: edges k = 1, 2, 0 give e0, e1, e2 (opposite vertex 0, 1,
  // 2), int32 with wraparound, the top-left rule on ties
  int e[3];
  bool cov = true;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int k = (m + 1) % 3, k1 = (k + 1) % 3;
    const unsigned A = (unsigned)Y[k1] - (unsigned)Y[k];
    const unsigned B = (unsigned)X[k] - (unsigned)X[k1];
    const int ev = (int)(A * ((unsigned)px - (unsigned)X[k]) + B * ((unsigned)py - (unsigned)Y[k]));
    const int ai = (int)A, bi = (int)B;
    cov = cov && (ev > 0 || (ev == 0 && (ai > 0 || (ai == 0 && bi > 0))));
    e[m] = ev;
  }
  if (!cov) return;
  // fp.barycentrics_f32 and rc.fragment_depth
  const float area = (float)(int)((unsigned)e[0] + (unsigned)e[1] + (unsigned)e[2]);
  const float safe = area == 0.f ? 1.f : area;
  const float inv = area != 0.f ? 1.f / safe : 0.f;
  const float lw[3] = {(float)e[0] * inv, (float)e[1] * inv, (float)e[2] * inv};
  const float zf = interp(lw, r + kZ);
  if (!(zf >= 0.f && zf <= 1.f && zf < depth)) return;
  float frag[3];
  fragment_color(a, r, lw, area, frag);
  const float alpha = r[kAlpha];
  const float keep = 1.f - alpha;
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = out[c] * keep + frag[c] * alpha;
}

__device__ __forceinline__ bool box_meets(const float* r, int y0, int y1, int x0, int x1) {
  return ibits(r[kBox]) < y1 && ibits(r[kBox + 1]) > y0 && ibits(r[kBox + 2]) < x1 &&
         ibits(r[kBox + 3]) > x0;
}

__global__ void __launch_bounds__(kThreads) blend_composite_kernel(Args a) {
  __shared__ float s_rows[kBatch * kMaxWidth];
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int row = blockIdx.y * kTileH + threadIdx.y;
  const bool inside = x < a.width && row < a.height;
  const long long pix = (long long)row * a.width + x;
  float out[3] = {0.f, 0.f, 0.f};
  if (inside) {
    out[0] = a.color_in[3 * pix];
    out[1] = a.color_in[3 * pix + 1];
    out[2] = a.color_in[3 * pix + 2];
  }
  const int n = min(max(*a.count, 0), a.cap);
  // the tile's rows and columns in the full frame
  const int ty0 = a.y_offset + blockIdx.y * kTileH;
  const int ty1 = a.y_offset + min((int)(blockIdx.y + 1) * kTileH, a.height);
  const int tx0 = blockIdx.x * kTileW, tx1 = min(tx0 + kTileW, a.width);
  int hit = 0;
  for (int j = tid; j < n; j += kThreads)
    hit |= box_meets(a.table + (long long)j * a.table_width, ty0, ty1, tx0, tx1);
  if (__syncthreads_or(hit)) {
    const int y = a.y_offset + row;
    const int px = x * a.sub + a.sub / 2, py = y * a.sub + a.sub / 2;
    const float depth = inside ? a.depth[pix] : 0.f;
    for (int first = 0; first < n; first += kBatch) {
      const int nb = min(kBatch, n - first);
      __syncthreads();
      for (int i = tid; i < nb * a.table_width; i += kThreads)
        s_rows[i] = a.table[(long long)first * a.table_width + i];
      __syncthreads();
      if (!inside) continue;
      for (int j = 0; j < nb; ++j) {
        const float* r = s_rows + j * a.table_width;
        if (!box_meets(r, y, y + 1, x, x + 1)) continue;
        composite_slot(a, r, px, py, depth, out);
      }
    }
  }
  if (inside) {
    a.color_out[3 * pix] = out[0];
    a.color_out[3 * pix + 1] = out[1];
    a.color_out[3 * pix + 2] = out[2];
  }
}

}  // namespace xrb

// One composite on `stream`; allocates nothing. color_in, color_out
// (height, width, 3) f32; depth (height, width) f32; table (cap,
// table_width) f32; count one int on the device; consts as Args says;
// shadow (hs, ws) f32 or null; quads (rows, quad_words) i32, level_size and
// level_base (ntex * levels) i32, or null with levels 0. Returns the launch
// status, or cudaErrorInvalidValue for a mode or a table the kernel does
// not take.
extern "C" int xr_blend_composite(
    const float* table, const int* count, const float* consts, const float* color_in,
    const float* depth, float* color_out, const float* shadow, const int* quads,
    const int* level_size, const int* level_base, int height, int width, int y_offset, int sub,
    int mode, int attr_width, int table_width, int cap, int n_dir, int n_point, int hs, int ws,
    int quad_words, int levels, float bias, void* stream) {
  if (mode < xrb::kFlat || mode > xrb::kPhong || table_width != xrb::kAttr + 3 * attr_width ||
      table_width > xrb::kMaxWidth || (levels > 0 && quad_words < 13) || height <= 0 ||
      width <= 0)
    return (int)cudaErrorInvalidValue;
  const xrb::Args a = {table, count, consts, color_in, depth, color_out, shadow, quads,
                       level_size, level_base, height, width, y_offset, sub, mode, attr_width,
                       table_width, cap, n_dir, n_point, hs, ws, quad_words, levels, bias};
  const dim3 grid((width + xrb::kTileW - 1) / xrb::kTileW,
                  (height + xrb::kTileH - 1) / xrb::kTileH);
  xrb::blend_composite_kernel<<<grid, dim3(xrb::kTileW, xrb::kTileH), 0,
                                (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
