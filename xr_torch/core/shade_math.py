"""Shading formulas of the port (port of ``xr/core/shade_math.py``):
Lambert, vertex and flat-face lighting, the analytic mip LOD, trilinear sampling from the packed
quad pyramid (wide fetch, table mip math, repeat addressing) and the u8
resolve. Float32 throughout; the reductions are written out so their order
is the reference's.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def lambert(normal, light_dir):
    """Diffuse factor for a directional light; light_dir is the direction
    the light travels, so shading uses -light_dir."""
    return torch.clamp_min(-(normal * light_dir).sum(-1), 0.0)


def shade_vertex_lit(normal, base_color, kd, lights, world_pos=None):
    """Per-vertex Gouraud color: ambient + directional diffuse (+ point
    lights when world_pos is given). normal/base_color (N,3), kd (N,)."""
    col = lights.ambient[None, :] * base_color
    ld = lights.dir_dirs
    if ld.shape[0]:
        nl = torch.clamp_min(-(normal @ ld.T), 0.0)
        col = col + kd[:, None] * base_color * (nl @ lights.dir_colors)
    if world_pos is not None and lights.pt_pos.shape[0]:
        for i in range(lights.pt_pos.shape[0]):
            l_vec = lights.pt_pos[i] - world_pos
            d2 = (l_vec * l_vec).sum(-1)
            l = l_vec / torch.clamp_min(
                torch.sqrt((l_vec * l_vec).sum(-1, keepdim=True)), 1e-12
            )
            ndl = torch.clamp_min((normal * l).sum(-1), 0.0)
            att = 1.0 / (1.0 + 0.05 * d2)
            col = col + (
                kd[:, None] * base_color * (ndl * att)[:, None]
            ) * lights.pt_colors[i]
    return col.to(F32)


def shade_flat_face(face_normal, base_color, kd, lights, centroid=None):
    """Per-face flat color: the vertex lighting model evaluated once per
    triangle with the geometric normal (point lights, when present, at the
    face centroid)."""
    return shade_vertex_lit(face_normal, base_color, kd, lights, world_pos=centroid)


def lod_from_derivs(dudx, dvdx, dudy, dvdy, base_size):
    """Mip LOD = 0.5 * log2(max(|d(uv*S)/dx|^2, |d(uv*S)/dy|^2)), with the
    derivatives clamped before squaring so background pixels stay finite."""
    s = float(base_size)
    lim = 1e18

    def sq(d):
        c = torch.clamp(d * s, -lim, lim)
        return c * c

    rx = sq(dudx) + sq(dvdx)
    ry = sq(dudy) + sq(dvdy)
    rho2 = torch.clamp_min(torch.maximum(rx, ry), 1e-12)
    return 0.5 * (torch.log(rho2) * (1.0 / math.log(2.0)))


def sample_trilinear(pyramid, tex_id, u, v, lod):
    """Trilinear sample of a TexturePyramid: ONE row gather per pixel from
    the (Ntex*P, 13) quad table (own 2x2 quad + parent 3x3), repeat-wrapped
    uv, per-pixel level tables. Returns (..., 3) f32."""
    L = pyramid.num_levels
    dev = u.device
    lf = torch.clamp(lod, 0.0, float(L - 1))
    l0f = torch.floor(lf)
    frac = lf - l0f
    l0 = l0f.to(torch.int32)
    l1 = torch.clamp_max(l0 + 1, L - 1)

    base = pyramid.base_size
    sizes = torch.tensor([max(base >> k, 1) for k in range(L)], dtype=torch.int32, device=dev)
    offsets = torch.tensor(
        [pyramid.level_offset(k) for k in range(L)], dtype=torch.int32, device=dev
    )
    P = pyramid.quads.shape[1]

    def size_at(lk):
        return sizes[lk.long()]

    def qbase(lk):
        return tex_id * P + offsets[lk.long()]

    inv255 = 1.0 / 255.0
    u = u - torch.floor(u)
    v = v - torch.floor(v)

    def unpack_ch(q, shift):
        c = (q >> shift) & 0xFF if shift else q & 0xFF
        return c.to(F32) * inv255

    def fractions(lk):
        s = size_at(lk)
        sf = s.to(F32)
        tu = u * sf - 0.5
        tv = v * sf - 0.5
        i0 = torch.floor(tu)
        j0 = torch.floor(tv)
        return i0.to(torch.int32), j0.to(torch.int32), tu - i0, tv - j0, s

    def bilerp_ch(t00, t01, t10, t11, fu, fv):
        top = t00 + (t01 - t00) * fu
        bot = t10 + (t11 - t10) * fu
        return top + (bot - top) * fv

    i0, j0, fu0, fv0, s0 = fractions(l0)
    K = pyramid.quads.shape[-1]
    flat_q = pyramid.quads.reshape(-1, K)
    qidx = qbase(l0) + (j0 & (s0 - 1)) * s0 + (i0 & (s0 - 1))
    row = flat_q[qidx.long()]

    def rowc(c):
        return row[..., c]

    # parent level: 3x3 block anchored at (j0//2 - 1, i0//2 - 1); the true
    # bilinear anchor (i1, j1) lies inside it at offset {0, 1}
    i1, j1, fu1, fv1, _ = fractions(l1)
    di1 = (i1 - ((i0 >> 1) - 1)) == 1
    dj1 = (j1 - ((j0 >> 1) - 1)) == 1

    def parent_q(r, c):
        b = 4 + 3 * r + c
        top = torch.where(di1, rowc(b + 1), rowc(b))
        bot = torch.where(di1, rowc(b + 4), rowc(b + 3))
        return torch.where(dj1, bot, top)

    p00, p01, p10, p11 = parent_q(0, 0), parent_q(0, 1), parent_q(1, 0), parent_q(1, 1)
    chans = []
    for shift in (0, 8, 16):
        c0 = bilerp_ch(
            unpack_ch(rowc(0), shift), unpack_ch(rowc(1), shift),
            unpack_ch(rowc(2), shift), unpack_ch(rowc(3), shift),
            fu0, fv0,
        )
        c1 = bilerp_ch(
            unpack_ch(p00, shift), unpack_ch(p01, shift),
            unpack_ch(p10, shift), unpack_ch(p11, shift),
            fu1, fv1,
        )
        chans.append(c0 + (c1 - c0) * frac)
    return torch.stack(chans, dim=-1)


def resolve_u8(color_f32: torch.Tensor) -> torch.Tensor:
    """Linear f32 color -> u8, round half up."""
    c = torch.clamp(color_f32, 0.0, 1.0)
    return torch.floor(c * 255.0 + 0.5).to(torch.uint8)
