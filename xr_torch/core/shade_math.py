"""Shading formulas of the port (port of ``xr/core/shade_math.py``):
Lambert, vertex and flat-face lighting, Blinn-Phong, the shadow-map test,
the analytic mip LOD, trilinear sampling from the packed
quad pyramid (uniform or ragged; wide fetch, table mip math, repeat and
clamp addressing) and the u8 resolve. Float32 throughout; the reductions
are written out so their order is the reference's.
"""

from __future__ import annotations

import math

import torch

from xr_torch.convert import constant
from xr_torch.core import math3d as m3

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


def _unit(v):
    return m3.normalize(v, 1e-12)


def shade_phong(world_pos, normal, view_pos, base_color, ka, kd, ks, shininess,
                lights, shadow_factor=None):
    """Blinn-Phong with every directional and point light
    (``xr/core/shade_math.py:100-160``). Per-pixel args are (..., 3) and
    (...,); shadow_factor (...,) multiplies directional light 0 only — the
    one light the shadow pass is rendered from."""
    n = normal
    v = _unit(view_pos - world_pos)
    out = ka[..., None] * lights.ambient * base_color

    def one_light(l_vec, l_color, att, shadowed):
        l = _unit(l_vec)
        ndl = torch.clamp_min(m3.dot(n, l), 0.0)
        h = _unit(l + v)
        ndh = torch.clamp_min(m3.dot(n, h), 0.0)
        spec = torch.where(ndl > 0.0, torch.pow(ndh, shininess), 0.0)
        c = (kd[..., None] * base_color * ndl[..., None] + (ks * spec)[..., None]) * l_color
        c = c * att[..., None]
        if shadowed is not None:
            c = c * shadowed[..., None]
        return c

    ones = torch.ones(world_pos.shape[:-1], dtype=F32, device=world_pos.device)
    for i in range(lights.dir_dirs.shape[0]):
        l_vec = (-lights.dir_dirs[i]).expand(world_pos.shape)
        out = out + one_light(l_vec, lights.dir_colors[i], ones,
                              shadow_factor if i == 0 else None)
    for i in range(lights.pt_pos.shape[0]):
        l_vec = lights.pt_pos[i] - world_pos
        att = 1.0 / (1.0 + 0.05 * m3.dot(l_vec, l_vec))
        out = out + one_light(l_vec, lights.pt_colors[i], att, None)
    return out


def shadow_test(shadow_depth, world_pos, light_viewproj, bias: float):
    """1.0 where lit, 0.0 where in shadow: nearest-texel compare of the
    world position's light-space depth (``xr/core/shade_math.py:443-496``).

    shadow_depth (Hs, Ws) f32 from the depth-only pass; world_pos (..., 3).
    The world->light transform is m3.matvec (fixed order, the same on every
    device). NaN/inf sample coordinates are zeroed and clipped BEFORE the
    float->int cast (a NaN->int cast differs between backends); the result
    there is masked by `inside` either way. The reference's 8-texel row
    fetch is a TPU gather layout that selects this same texel."""
    hs, ws = shadow_depth.shape
    p4 = torch.cat([world_pos, torch.ones_like(world_pos[..., :1])], dim=-1)
    clip = m3.matvec(light_viewproj, p4)
    w = torch.clamp_min(clip[..., 3], 1e-12)
    ndc_x = clip[..., 0] / w
    ndc_y = clip[..., 1] / w
    z = clip[..., 2] / w
    sx = torch.nan_to_num((ndc_x * 0.5 + 0.5) * ws, nan=0.0, posinf=0.0, neginf=0.0)
    sy = torch.nan_to_num((0.5 - ndc_y * 0.5) * hs, nan=0.0, posinf=0.0, neginf=0.0)
    ix = torch.clamp(torch.floor(sx), 0.0, float(ws - 1)).to(torch.int32)
    iy = torch.clamp(torch.floor(sy), 0.0, float(hs - 1)).to(torch.int32)
    d = shadow_depth.reshape(-1)[(iy * ws + ix).long()]
    inside = (
        (ndc_x >= -1.0) & (ndc_x <= 1.0) & (ndc_y >= -1.0) & (ndc_y <= 1.0)
        & (z >= 0.0) & (z <= 1.0)
    )
    return torch.where(inside & (z - bias > d), 0.0, 1.0)


def lod_from_derivs(dudx, dvdx, dudy, dvdy, base_size):
    """Mip LOD = 0.5 * log2(max(|d(uv*S)/dx|^2, |d(uv*S)/dy|^2)), with the
    derivatives clamped before squaring so background pixels stay finite.
    base_size is a scalar (uniform pyramid) or a per-pixel f32 tensor
    (RaggedPyramid)."""
    s = base_size if isinstance(base_size, torch.Tensor) else float(base_size)
    lim = 1e18

    def sq(d):
        c = torch.clamp(d * s, -lim, lim)
        return c * c

    rx = sq(dudx) + sq(dvdx)
    ry = sq(dudy) + sq(dvdy)
    rho2 = torch.clamp_min(torch.maximum(rx, ry), 1e-12)
    return 0.5 * (torch.log(rho2) * (1.0 / math.log(2.0)))


def sample_trilinear(pyramid, tex_id, u, v, lod, addr=None, mip_math: str = "table"):
    """Trilinear sample of a TexturePyramid or a RaggedPyramid: ONE row
    gather per pixel from the flat (rows, 13) quad table (own 2x2 quad +
    parent 3x3), per-pixel level tables. Returns (..., 3) f32.

    addr: optional (...,) i32 address mode per pixel (Material.tex_addr):
    0 repeats, 1 clamps the sample position to the coarser level's
    half-texel interior, so no bilinear footprint crosses an edge and the
    wrap-packed quad layout stays valid. None is all-repeat.
    mip_math: only checked; "closed" needs one shared power-of-two chain
    and raises ValueError on a RaggedPyramid, as the reference does."""
    L = pyramid.num_levels
    dev = u.device
    lf = torch.clamp(lod, 0.0, float(L - 1))
    l0f = torch.floor(lf)
    frac = lf - l0f
    l0 = l0f.to(torch.int32)
    l1 = torch.clamp_max(l0 + 1, L - 1)

    # index arithmetic stays int32 (the reference's width); only the gather
    # itself widens
    if hasattr(pyramid, "base_size_per_tex"):  # RaggedPyramid
        if mip_math == "closed":
            raise ValueError(
                "mip_math='closed' needs a uniform TexturePyramid (one "
                "shared power-of-two chain); RaggedPyramid sizes/offsets "
                "are per-texture data, not closed-form"
            )
        ls_flat = pyramid.level_size.reshape(-1)
        lo_flat = pyramid.level_offset.reshape(-1)

        def size_at(lk):
            return ls_flat[(tex_id * L + lk).long()]

        def qbase(lk):
            return lo_flat[(tex_id * L + lk).long()]
    else:
        base = pyramid.base_size
        sizes = constant([max(base >> k, 1) for k in range(L)], dev, torch.int32)
        offsets = constant([pyramid.level_offset(k) for k in range(L)], dev, torch.int32)
        P = pyramid.quads.shape[1]

        def size_at(lk):
            return sizes[lk.long()]

        def qbase(lk):
            return tex_id * P + offsets[lk.long()]

    inv255 = 1.0 / 255.0
    uw = u - torch.floor(u)
    vw = v - torch.floor(v)
    if addr is None:
        u, v = uw, vw
    else:
        half = 0.5 / size_at(l1).to(F32)
        clamped = addr == 1
        u = torch.where(clamped, torch.clamp(u, half, 1.0 - half), uw)
        v = torch.where(clamped, torch.clamp(v, half, 1.0 - half), vw)

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


def resolve_u8(color_f32: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Linear f32 color -> u8, round half up; out: a u8 tensor of the
    color's shape to write it into."""
    c = torch.clamp(color_f32, 0.0, 1.0)
    u = torch.floor(c * 255.0 + 0.5)
    return u.to(torch.uint8) if out is None else out.copy_(u)
