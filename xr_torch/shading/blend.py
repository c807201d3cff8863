"""Alpha-blended transparency of the port (port of ``xr/shading/blend.py``).

Triangles whose material alpha is below 1 win no pixels and cast no
shadows: every visibility pass runs on ``opaque_valid``. They are
composited afterwards over the shaded frame in SOURCE triangle order (the
application supplies them back to front), ``out = dst * (1 - a) + src * a``,
depth-tested read-only against the opaque depth. Clipped fans carry their
parent's ``src_id``; a stable sort keeps the fan pieces of one source
triangle in record order.

The reference runs the composite as a ``lax.scan`` over chunks of
``blend_chunk`` records and skips dead chunks with ``lax.cond`` on
``ok.any()``. The live slots are a prefix of the source-ordered list, so
chunk ``c`` is live exactly when ``c * blend_chunk < min(total,
blend_capacity)``: the port reads that count to the host once per
composite (``live_records``) and runs only the live chunks, each with the
same masks as before. That is one device-to-host read per frame on a scene
with an alpha column; scenes without one return before it. Transparent
fragments get the deferred pass's shading model: interpolation, trilinear
texturing with the analytic LOD, Phong and the shadow test.
"""

from __future__ import annotations

import torch

from xr_torch.core import fixedpoint as fp
from xr_torch.core import math3d as m3
from xr_torch.core import shade_math as sm
from xr_torch.core.types import (
    MODE_FLAT, MODE_GOURAUD, MODE_PHONG, MODE_TEXTURED, RenderConfig, Scene,
)
from xr_torch.raster import common as rc
from xr_torch.shading.deferred import _lod_terms, _sample_texture

F32, I32 = torch.float32, torch.int32


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


def live_records(tri, scene: Scene, config: RenderConfig):
    """The live transparent slots, min(total, blend_capacity), read to the
    host; None when the scene has no alpha column (nothing composites)."""
    if material_alpha(scene) is None:
        return None
    return int(torch.clamp_max(transparent_mask(tri, scene).sum(), config.blend_capacity))


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


def composite_transparent(color, depth, tri, scene: Scene, config: RenderConfig, eye,
                          shadow_depth=None, light_viewproj=None, y_offset: int = 0,
                          n_live=None):
    """Composite the transparent records over the shaded frame.

    color (H, W, 3) f32 linear, background included; depth (H, W) f32
    opaque depth (1.0 = background); both hold rows [y_offset, y_offset +
    H) of the full frame (a screen band walks the whole transparent list
    against its own rows). n_live: ``live_records`` of these records when
    the caller has read it already (once per device for all its bands);
    None reads it here. Only the ceil(n_live / blend_chunk) live chunks
    run. Returns (color, overflow () i32): the transparent records past
    blend_capacity, which strict readback raises on."""
    H, W = depth.shape
    dev = depth.device
    cap = config.blend_capacity
    ch = min(config.blend_chunk, cap)
    nchunks = -(-cap // ch)
    alpha = material_alpha(scene)
    tmask = transparent_mask(tri, scene)
    ids, total = _src_ordered_ids(tri, tmask, cap)
    overflow = torch.clamp_min(total - cap, 0).to(I32)
    if alpha is None:
        return color, overflow

    px, py = rc.pixel_grids(W, H, config.subpixel, dev)
    py = py + y_offset * config.subpixel
    slot_valid = torch.arange(nchunks * ch, device=dev) < torch.clamp_max(total, cap)
    ids = torch.cat([ids, ids.new_zeros(nchunks * ch - cap)]).long()
    eye = torch.as_tensor(eye, dtype=F32, device=dev)
    if n_live is None:
        n_live = live_records(tri, scene, config)

    for c in range(-(-n_live // ch)):
        sl = ids[c * ch : (c + 1) * ch]
        ok = slot_valid[c * ch : (c + 1) * ch]
        xs = tri.xs[sl][:, None, None, :]  # (ch, 1, 1, 3)
        ys = tri.ys[sl][:, None, None, :]
        cov, (e0, e1, e2) = fp.coverage(xs, ys, px[None], py[None])
        zf = rc.fragment_depth(e0, e1, e2, tri.z[sl][:, None, None, :])  # (ch, H, W)
        # read-only depth test against the opaque buffer (strict <: a
        # fragment exactly on an opaque surface is occluded)
        mask = cov & rc.depth_range_mask(zf) & ok[:, None, None] & (zf < depth[None])
        frag = _fragment_colors(tri, sl, scene, config, eye, e0, e1, e2, mask,
                                shadow_depth, light_viewproj)
        a = alpha[tri.mat_id[sl].long()]  # (ch,)
        # back to front within the chunk too: composite order is semantics
        for j in range(ch):
            color = torch.where(mask[j][..., None], color * (1.0 - a[j]) + frag[j] * a[j], color)
    return color, overflow


def _fragment_colors(tri, sl, scene: Scene, config: RenderConfig, eye, e0, e1, e2, mask,
                     shadow_depth=None, light_viewproj=None):
    """(ch, H, W, 3) linear colors of a chunk's fragments under the deferred
    pass's shading model. Uncovered lanes' attributes are zeroed at the
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
    """(ch, H, W, 3) trilinear texture colors of a chunk's fragments: the
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
