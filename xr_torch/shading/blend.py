"""Alpha-blended transparency of the port (port of ``xr/shading/blend.py``).

Triangles whose material alpha is below 1 win no pixels and cast no
shadows: every visibility pass runs on ``opaque_valid``. They are
composited afterwards over the shaded frame in SOURCE triangle order (the
application supplies them back to front), ``out = dst * (1 - a) + src * a``,
depth-tested read-only against the opaque depth. Clipped fans carry their
parent's ``src_id``; a stable sort keeps the fan pieces of one source
triangle in record order.

The reference runs the composite as a ``lax.scan`` over chunks of
``blend_chunk`` records, each over the whole frame, and skips dead chunks
with ``lax.cond`` on ``ok.any()``. The live slots are a prefix of the
source-ordered list, so chunk ``c`` is live exactly when ``c * blend_chunk
< min(total, blend_capacity)``. The port reads that count to the host
once per composite, in one transfer with each live chunk's screen box
(``live_records``), and runs each live chunk on its live slots only and
only over the pixels its records can cover: the box of their pixel
centres, cut to the frame and to the band's rows, widened to whole groups
of 32 columns. A fragment's math reads nothing of its neighbours (the
sampler's LOD is analytic per record, the shadow test samples the map
per pixel), so the frame is the whole-frame composite's bit for bit. That
is one device-to-host read per frame on a scene with an alpha column;
scenes without one return before it. Transparent fragments get the
deferred pass's shading model: interpolation, trilinear texturing with
the analytic LOD, Phong and the shadow test.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from xr_torch import convert
from xr_torch.core import fixedpoint as fp
from xr_torch.core import math3d as m3
from xr_torch.core import shade_math as sm
from xr_torch.core.types import (
    MODE_FLAT, MODE_GOURAUD, MODE_PHONG, MODE_TEXTURED, RenderConfig, Scene,
)
from xr_torch.raster import common as rc
from xr_torch.shading.deferred import _lod_terms, _sample_texture

F32, I32 = torch.float32, torch.int32
_FAR = 2**30  # past any snapped vertex: a chunk's extent starts from it
# the crop's columns come in groups of 32: whole 128-byte rows of an f32
# plane on the card, and on the CPU no pixel of a frame whose width is a
# multiple of 32 falls in the scalar remainder of a vector loop, whose
# pow and log may round apart from the vector body's
COLUMNS = 32


def material_alpha(scene: Scene):
    """Per-material alpha (M,) f32, or None when every material is opaque
    by construction (no alpha column)."""
    return scene.materials.alpha


def transparent_mask(tri, scene: Scene) -> torch.Tensor:
    """(C,) bool: valid records whose material blends (alpha < 1)."""
    alpha = material_alpha(scene)
    if alpha is None:
        return torch.zeros_like(tri.valid)
    return tri.valid & (alpha[tri.mat_id.long()] < 1.0)


def opaque_valid(tri, scene: Scene) -> torch.Tensor:
    """Validity mask of the opaque visibility passes under blending."""
    return tri.valid & ~transparent_mask(tri, scene)


class LiveSlots(NamedTuple):
    """The composite's live transparent slots, read to the host in one
    transfer (``live_records``). count: min(total, blend_capacity); boxes:
    per live chunk, (y0, y1, x0, x1), the half-open rows and columns of the
    full frame whose pixel centres lie in the bounding box of the chunk's
    live records, not cut to the frame (empty where y1 <= y0 or x1 <= x0);
    ids: (nchunks * chunk,) int64 record ids in source order on the
    records' device (slots from count on are dead)."""

    count: int
    boxes: list
    ids: torch.Tensor


def live_records(tri, scene: Scene, config: RenderConfig):
    """The live transparent slots and each live chunk's screen box, read
    to the host in one transfer (LiveSlots); None when the scene has no
    alpha column (nothing composites)."""
    if material_alpha(scene) is None:
        return None
    cap = config.blend_capacity
    ch = min(config.blend_chunk, cap)
    nchunks = -(-cap // ch)
    ids, total = _src_ordered_ids(tri, transparent_mask(tri, scene), nchunks * ch)
    ids = ids.long()
    count = torch.clamp_max(total, cap)
    live = (torch.arange(nchunks * ch, device=ids.device) < count)[:, None]

    def extent(v):  # (nchunks,) min and max of the live slots' vertices
        v = v[ids]
        lo = torch.where(live, v, _FAR).view(nchunks, ch * 3).amin(1)
        hi = torch.where(live, v, -_FAR).view(nchunks, ch * 3).amax(1)
        return _first_center(lo, config.subpixel), _first_center(hi + 1, config.subpixel)

    y0, y1 = extent(tri.ys)
    x0, x1 = extent(tri.xs)
    vals = torch.cat([count.view(1), torch.stack([y0, y1, x0, x1], 1).view(-1)]).tolist()
    n = vals[0]
    boxes = [tuple(vals[1 + 4 * c : 5 + 4 * c]) for c in range(-(-n // ch))]
    return LiveSlots(n, boxes, ids)


def _first_center(v, subpixel: int):
    """The first pixel whose centre (fp.pixel_center_fixed) lies at or past
    the fixed-point coordinate v: ceil((v - subpixel // 2) / subpixel)."""
    return -torch.div(subpixel // 2 - v, subpixel, rounding_mode="floor")


def _src_ordered_ids(tri, tmask, cap: int):
    """Record ids of the transparent records in ascending source-triangle
    order (stable: fan pieces of one source triangle keep record order),
    padded to cap. Returns (ids (cap,) i32, total () i32)."""
    C = tmask.shape[0]
    keys = torch.where(tmask, tri.src_id.to(I32), 2**30)
    order = torch.sort(keys, stable=True).indices.to(I32)
    if cap <= C:
        ids = order[:cap]
    else:
        ids = torch.cat([order, order.new_zeros(cap - C)])
    return ids, tmask.sum(dtype=I32)


def _columns(x0: int, x1: int, width: int):
    """[x0, x1) cut to the frame's width and, unless that leaves it empty,
    widened to whole groups of COLUMNS columns."""
    x0, x1 = max(x0, 0), min(x1, width)
    if x0 >= x1:
        return x0, x1
    return x0 // COLUMNS * COLUMNS, min(-(-x1 // COLUMNS) * COLUMNS, width)


def composite_transparent(color, depth, tri, scene: Scene, config: RenderConfig, eye,
                          shadow_depth=None, light_viewproj=None, y_offset: int = 0,
                          live=None):
    """Composite the transparent records over the shaded frame.

    color (H, W, 3) f32 linear, background included; depth (H, W) f32
    opaque depth (1.0 = background); both hold rows [y_offset, y_offset +
    H) of the full frame (a screen band walks the whole transparent list
    against its own rows). live: ``live_records`` of these records when
    the caller has read it already (once per device for all its bands);
    None reads it here. Each of the ceil(live.count / blend_chunk) live
    chunks runs on its live slots over its box cut to these rows; a chunk
    whose box misses them runs nothing. Returns (color, overflow () i32):
    the transparent records past blend_capacity, which strict readback
    raises on."""
    H, W = depth.shape
    dev = depth.device
    cap = config.blend_capacity
    ch = min(config.blend_chunk, cap)
    alpha = material_alpha(scene)
    total = transparent_mask(tri, scene).sum(dtype=I32)
    overflow = torch.clamp_min(total - cap, 0).to(I32)
    if alpha is None:
        return color, overflow
    if live is None:
        live = live_records(tri, scene, config)

    eye = convert.tensor(eye, dev, F32)
    out = None
    for c, (y0, y1, x0, x1) in enumerate(live.boxes):
        y0, y1 = max(y0, y_offset), min(y1, y_offset + H)
        x0, x1 = _columns(x0, x1, W)
        if y0 >= y1 or x0 >= x1:
            continue
        sl = live.ids[c * ch : min((c + 1) * ch, live.count)]
        px = fp.pixel_center_fixed(torch.arange(x0, x1, device=dev), config.subpixel)
        py = fp.pixel_center_fixed(torch.arange(y0, y1, device=dev), config.subpixel)
        rows = slice(y0 - y_offset, y1 - y_offset)
        xs = tri.xs[sl][:, None, None, :]  # (k, 1, 1, 3)
        ys = tri.ys[sl][:, None, None, :]
        cov, (e0, e1, e2) = fp.coverage(xs, ys, px[None, None, :], py[None, :, None])
        zf = rc.fragment_depth(e0, e1, e2, tri.z[sl][:, None, None, :])  # (k, h, w)
        # read-only depth test against the opaque buffer (strict <: a
        # fragment exactly on an opaque surface is occluded)
        mask = cov & rc.depth_range_mask(zf) & (zf < depth[rows, x0:x1][None])
        frag = _fragment_colors(tri, sl, scene, config, eye, e0, e1, e2, mask,
                                shadow_depth, light_viewproj)
        a = alpha[tri.mat_id[sl].long()]  # (k,)
        if out is None:
            out = color.clone()
        box = out[rows, x0:x1]
        # back to front within the chunk too: composite order is semantics
        for j in range(sl.shape[0]):
            box = torch.where(mask[j][..., None], box * (1.0 - a[j]) + frag[j] * a[j], box)
        out[rows, x0:x1] = box
    return (color if out is None else out), overflow


def _fragment_colors(tri, sl, scene: Scene, config: RenderConfig, eye, e0, e1, e2, mask,
                     shadow_depth=None, light_viewproj=None):
    """(k, h, w, 3) linear colors of a chunk's k slots over its (h, w) box
    under the deferred pass's shading model. Uncovered lanes' attributes are zeroed at the
    source (the 1/w underflow guard the deferred pass applies at its
    background pixels)."""
    mode = config.mode
    ch = sl.shape[0]
    H, W = e0.shape[1:]
    if mode == MODE_FLAT:
        return tri.face_rgb[sl][:, None, None, :].expand(ch, H, W, 3)

    l0, l1, l2 = fp.barycentrics_f32(e0, e1, e2)
    aw = tri.attr_w[sl]  # (ch, 3, A)
    iw = tri.inv_w[sl]  # (ch, 3)

    def interp(vals):  # (ch, 3) -> (ch, H, W)
        return (l0 * vals[:, 0, None, None] + l1 * vals[:, 1, None, None]) + l2 * vals[:, 2, None, None]

    denom = interp(iw)
    inv_denom = torch.where(mask, 1.0 / torch.clamp_min(denom, 1e-20), 0.0)

    def attr(j):
        return interp(aw[:, :, j]) * inv_denom

    if mode == MODE_GOURAUD:
        return torch.stack([attr(0), attr(1), attr(2)], dim=-1)

    mid = tri.mat_id[sl].long()  # (ch,)
    if mode == MODE_TEXTURED:
        lit = torch.stack([attr(2), attr(3), attr(4)], dim=-1)
        return _chunk_texture(tri, sl, scene, config, attr(0), attr(1), 0, e0, e1, e2,
                              denom, mid) * lit

    assert mode == MODE_PHONG
    world = torch.stack([attr(0), attr(1), attr(2)], dim=-1)
    normal = m3.normalize(torch.stack([attr(3), attr(4), attr(5)], dim=-1), 1e-12)
    mats = scene.materials
    base = mats.base_color[mid][:, None, None, :] * _chunk_texture(
        tri, sl, scene, config, attr(6), attr(7), 6, e0, e1, e2, denom, mid)
    shadow = None
    if shadow_depth is not None and light_viewproj is not None:
        # world is zeroed at uncovered lanes, so their sample is benign and
        # masked by the composite anyway
        shadow = sm.shadow_test(shadow_depth, world, light_viewproj, config.shadow_bias)
    shape = world.shape[:-1]

    def per_frag(col):
        return col[mid][:, None, None].expand(shape)

    return sm.shade_phong(world, normal, eye, base, per_frag(mats.ka), per_frag(mats.kd),
                          per_frag(mats.ks), per_frag(mats.shininess), scene.lights,
                          shadow_factor=shadow)


def _chunk_texture(tri, sl, scene: Scene, config: RenderConfig, u, v, uv_slot, e0, e1, e2,
                   denom, mid):
    """(k, h, w, 3) trilinear texture colors of a chunk's fragments: the
    deferred pass's sampler with the per-record LOD terms; white where the
    material has no texture. The reference skips the sampler for a chunk
    with no live textured record (``lax.cond``); here it always runs when
    the scene has textures, and the masked composite makes the result the
    same."""
    pyr = scene.textures
    if pyr is None or pyr.num_levels == 0:
        return torch.ones(u.shape + (3,), dtype=F32, device=u.device)
    lod6 = [t[sl][:, None, None] for t in _lod_terms(tri, uv_slot, config)]
    return _sample_texture(scene, config, u, v, lod6, e0, e1, e2, denom,
                           mid[:, None, None])
