"""Deferred shading of the port (port of the flat, Gouraud, textured and
Phong paths of ``xr/shading/deferred.py``): every pixel is shaded exactly
once from the winning triangle's record.

Flat shading reads the triangle's face color. Otherwise one (C, K) f32
record table is gathered per pixel by triangle id: xs(3) ys(3) mat_id(1) as
exact f32 values (post-clip coords are far below 2^24), in textured mode
the six per-record texture-LOD derivative terms, then the attributes
(vertex-major groups of 3) and the 1/w group. Interpolation is perspective
correct with the reference's product set and add order.

A ``shade_hook`` is the custom pixel stage: every mode's color passes
through it before the background is applied, called as
``hook(color (N, 3), scene, mat_id (N,) or None, torch)``, or with a
``frag=Frag`` keyword when the hook declares ``frag`` (or ``**kwargs``).
"""

from __future__ import annotations

import inspect
from typing import Any, NamedTuple, Optional

import torch

from xr_torch import convert
from xr_torch.core import fixedpoint as fp
from xr_torch.core import math3d as m3
from xr_torch.core import shade_math as sm
from xr_torch.core.types import (
    MODE_DEPTH_ONLY,
    MODE_FLAT,
    MODE_GOURAUD,
    MODE_PHONG,
    MODE_TEXTURED,
    RenderConfig,
    Scene,
)
from xr_torch.raster.common import BG_TRI_ID, pixel_grids

F32, I32 = torch.float32, torch.int32


class Frag(NamedTuple):
    """Per-pixel G-buffer a shade_hook with a ``frag`` parameter receives,
    flat (N,) layout on the frame's device; a field is None where the mode
    does not produce it."""

    bg: Any  # (N,) bool background mask
    depth: Optional[Any] = None  # (N,) f32, 1.0 = background
    uv: Optional[Any] = None  # ((N,), (N,)) perspective-correct u, v
    world: Optional[Any] = None  # (N, 3) world position (Phong)
    normal: Optional[Any] = None  # (N, 3) unit world normal (Phong)


def _hook_wants_frag(hook) -> bool:
    try:
        params = inspect.signature(hook).parameters
    except (TypeError, ValueError):
        return False
    return "frag" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


def _sum3(x):
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def _lod_terms(tri, uv_slot: int, config: RenderConfig):
    """The six per-record LOD derivative terms (dD/dx dD/dy dNu/dx dNu/dy
    dNv/dx dNv/dy) as (C,) f32 tensors: constant per triangle, since they
    depend only on edge coefficients and per-vertex u/w, v/w, 1/w."""
    sub = float(config.subpixel)
    a, b = fp.edge_coeffs(tri.xs, tri.ys)
    # the edge opposite vertex k is edge (k+1) % 3
    opp = convert.constant([1, 2, 0], a.device, torch.int64)  # not a list: no copy per call
    a_opp = a[:, opp].to(F32)
    b_opp = b[:, opp].to(F32)
    uw = tri.attr_w[:, :, uv_slot]
    vw = tri.attr_w[:, :, uv_slot + 1]
    iw = tri.inv_w
    return [
        _sum3(a_opp * iw) * sub,
        _sum3(b_opp * iw) * sub,
        _sum3(a_opp * uw) * sub,
        _sum3(b_opp * uw) * sub,
        _sum3(a_opp * vw) * sub,
        _sum3(b_opp * vw) * sub,
    ]


def _pack_records(tri, A: int, config: RenderConfig, uv_slot):
    """The per-pixel record table (C, K) f32 and the column of its first LOD
    term (7)."""
    C = tri.capacity
    cols = [tri.xs.to(F32), tri.ys.to(F32), tri.mat_id.reshape(C, 1).to(F32)]
    if uv_slot is not None:
        cols.append(torch.stack(_lod_terms(tri, uv_slot, config), dim=-1))
    cols.append(tri.attr_w.permute(0, 2, 1).reshape(C, 3 * A))
    cols.append(tri.inv_w)
    return torch.cat(cols, dim=1), 7


def _sample_texture(scene, config, u, v, lod6, e0, e1, e2, denom, mat_id):
    """Trilinear fetch with the analytic per-pixel LOD (sample_texture_at)
    of the materials mat_id, which broadcasts against u. Returns u's shape
    + (3,); white where the material has no texture."""
    pyr = scene.textures
    mats = scene.materials
    tex_id = mats.tex_id[mat_id.long()]
    if hasattr(pyr, "base_size_per_tex"):  # RaggedPyramid: per-pixel scale
        base = pyr.base_size_per_tex[torch.where(tex_id >= 0, tex_id, 0).long()].to(F32)
    else:
        base = pyr.base_size
    addr = None if mats.tex_addr is None else mats.tex_addr[mat_id.long()]
    return sample_texture_at(pyr, config, u, v, lod6, e0, e1, e2, denom, tex_id, base, addr)


def sample_texture_at(pyr, config, u, v, lod6, e0, e1, e2, denom, tex_id, base, addr):
    """Trilinear fetch with the analytic per-pixel LOD: u = Nu/D, so
    du/dx = (dNu/dx - u * dD/dx) / D with D = denom * area2. lod6, tex_id
    (i32, -1 = none), base (the LOD's texel scale: an int, or f32 per
    texture) and addr (i32 address mode, or None: repeat) broadcast against
    u (per pixel in the deferred pass, per record in the blend pass).
    Returns u's shape + (3,); white where tex_id < 0."""
    area2 = (e0 + e1 + e2).to(F32)
    D = denom * area2
    invD = 1.0 / torch.where(D == 0.0, torch.full_like(D, 1e-30), D)
    dudx = (lod6[2] - u * lod6[0]) * invD
    dudy = (lod6[3] - u * lod6[1]) * invD
    dvdx = (lod6[4] - v * lod6[0]) * invD
    dvdy = (lod6[5] - v * lod6[1]) * invD
    has_tex = tex_id >= 0
    tid_safe = torch.where(has_tex, tex_id, 0)
    lod = sm.lod_from_derivs(dudx, dvdx, dudy, dvdy, base)
    texc = sm.sample_trilinear(pyr, tid_safe, u, v, lod, addr=addr,
                               mip_math=config.mip_math)
    return torch.where(has_tex[..., None], texc, 1.0)


def shade_deferred(tri, tid: torch.Tensor, scene: Scene, config: RenderConfig,
                   eye=None, shadow_depth=None, light_viewproj=None, shade_hook=None,
                   depth=None, y_offset: int = 0) -> torch.Tensor:
    """Shade a visibility buffer tid (H, W) i32 (BG_TRI_ID = background)
    into (H, W, 3) f32 linear color. Phong takes the camera's eye (3,) and,
    when the frame has a shadow pass, its depth map (Hs, Ws) and the
    light's view-projection (4, 4). shade_hook: the custom pixel stage (see
    the module doc); depth: the resolved (H, W) depth (1.0 background) its
    Frag carries. y_offset: tid holds rows [y_offset, y_offset + H) of the
    full frame (a screen band); every pixel position is taken there."""
    if config.mode == MODE_DEPTH_ONLY:
        raise ValueError("depth-only pass has no shading")
    H, W = tid.shape
    tid = tid.reshape(-1)
    bg = tid == BG_TRI_ID
    t = torch.where(bg, 0, tid).long()
    bgc = convert.constant(config.bg_color, tid.device)
    wants_frag = shade_hook is not None and _hook_wants_frag(shade_hook)

    def finish(color, mat_id=None, uv=None, world=None, normal=None):
        if shade_hook is not None:
            if wants_frag:
                frag = Frag(bg=bg, depth=None if depth is None else depth.reshape(-1), uv=uv,
                            world=world, normal=normal)
                color = shade_hook(color, scene, mat_id, torch, frag=frag)
            else:
                color = shade_hook(color, scene, mat_id, torch)
        return torch.where(bg[:, None], bgc, color).reshape(H, W, 3)

    if config.mode == MODE_FLAT:
        return finish(tri.face_rgb[t])

    px, py = pixel_grids(W, H, config.subpixel, tid.device)
    px = px.reshape(-1)
    py = py.reshape(-1) + y_offset * config.subpixel
    A = config.attr_width
    pyr = scene.textures
    uv_slot = None
    if pyr is not None and pyr.num_levels > 0:
        uv_slot = {MODE_TEXTURED: 0, MODE_PHONG: 6}.get(config.mode)
    table, lod_base = _pack_records(tri, A, config, uv_slot)
    rec = table[t]  # (N, K)
    xs = rec[:, 0:3].to(I32)
    ys = rec[:, 3:6].to(I32)
    mat_id = rec[:, 6].to(I32)
    _, (e0, e1, e2) = fp.coverage(xs, ys, px, py)
    l0, l1, l2 = fp.barycentrics_f32(e0, e1, e2)
    att0 = lod_base + (6 if uv_slot is not None else 0)

    def interp(g):
        c = att0 + 3 * g
        return (l0 * rec[:, c] + l1 * rec[:, c + 1]) + l2 * rec[:, c + 2]

    denom = interp(A)  # interpolated 1/w
    inv_denom = 1.0 / torch.clamp_min(denom, 1e-20)
    # background pixels read record 0 far outside it; zero their attributes
    inv_denom = torch.where(bg, 0.0, inv_denom)

    def attr(j):
        return interp(j) * inv_denom

    if config.mode == MODE_GOURAUD:
        return finish(torch.stack([attr(0), attr(1), attr(2)], dim=-1))

    def texture(u, v):
        if uv_slot is None:
            return torch.ones(u.shape + (3,), dtype=F32, device=u.device)
        lod6 = tuple(rec[:, lod_base + i] for i in range(6))
        return _sample_texture(scene, config, u, v, lod6, e0, e1, e2, denom, mat_id)

    if config.mode == MODE_TEXTURED:
        u, v = attr(0), attr(1)
        lit = torch.stack([attr(2), attr(3), attr(4)], dim=-1)
        return finish(texture(u, v) * lit, mat_id, uv=(u, v))

    # Phong (xr/shading/deferred.py:275-314); the reference gathers the
    # material table one channel at a time (a TPU layout choice), a row
    # gather here gives the same values
    world = torch.stack([attr(0), attr(1), attr(2)], dim=-1)
    normal = m3.normalize(torch.stack([attr(3), attr(4), attr(5)], dim=-1), 1e-12)
    mats = scene.materials
    mid = mat_id.long()
    u, v = attr(6), attr(7)
    base = mats.base_color[mid] * texture(u, v)
    shadow = None
    if shadow_depth is not None and light_viewproj is not None:
        shadow = sm.shadow_test(shadow_depth, world, light_viewproj, config.shadow_bias)
    eye = convert.tensor(eye, tid.device, F32)
    color = sm.shade_phong(world, normal, eye, base, mats.ka[mid], mats.kd[mid],
                           mats.ks[mid], mats.shininess[mid], scene.lights,
                           shadow_factor=shadow)
    return finish(color, mat_id, uv=(u, v), world=world, normal=normal)
