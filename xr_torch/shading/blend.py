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
with ``lax.cond`` on ``ok.any()``: nothing is read to the host. The live
slots are a prefix of the source-ordered list, so chunk ``c`` is live
exactly when ``c * blend_chunk < min(total, blend_capacity)``. The port
keeps them on the records' device (``live_slots``): the meta vector (the
live count, the transparent total, the overflow and the union of the live
boxes cut to the frame), the source-ordered ids, each chunk's screen box
and the slot table, one row per slot with everything a fragment of it
needs (its snapped vertices, depths, 1/w and attributes, its face color,
the sampler's six LOD terms, its material and its pixel box). On a card
one hand-written kernel builds all of it (``kernels.blend_slots``) and a
second composites the live slots in place (``kernels.blend_composite``,
both ``csrc/blend.cu``) on the tiles of the union box only, reading the
count and the box on the device, so the stage is captured with the rest of
the frame. On the CPU the plain versions run: ``live_slots_plain``
(fixed-shape torch ops), then ``blend_composite_plain``: the count and
boxes read to the host once (``live_records``), then each live chunk on
its live slots only and only over the pixels its records can cover: the
box of their pixel centres, cut to the frame and to the band's rows,
widened to whole groups of 32 columns. A fragment's math reads nothing of
its neighbours (the sampler's LOD is analytic per record, the shadow test
samples the map per pixel), so both equal the whole-frame composite
(``composite_whole_frame``) bit for bit. The composite consumes its color:
both versions write it in place. Transparent fragments get the deferred
pass's shading model: interpolation, trilinear texturing with the analytic
LOD, Phong and the shadow test.
"""

from __future__ import annotations

import dataclasses
import functools
import types
from typing import NamedTuple, Optional

import torch

from xr_torch import convert, kernels
from xr_torch.core import fixedpoint as fp
from xr_torch.core import math3d as m3
from xr_torch.core import shade_math as sm
from xr_torch.core.types import (
    MODE_FLAT, MODE_GOURAUD, MODE_PHONG, MODE_TEXTURED, RenderConfig, Scene,
)
from xr_torch.raster import common as rc
from xr_torch.shading.deferred import _lod_terms, sample_texture_at

F32, I32 = torch.float32, torch.int32
_FAR = 2**30  # past any snapped vertex: a chunk's extent starts from it
# the crop's columns come in groups of 32: whole 128-byte rows of an f32
# plane on the card, and on the CPU no pixel of a frame whose width is a
# multiple of 32 falls in the scalar remainder of a vector loop, whose
# pow and log may round apart from the vector body's
COLUMNS = 32

# The slot table's fields, (name, columns), in column order: f32, the
# integer fields (xs, ys, tex_id, tex_addr, mat_id, box) as int32 bits.
# attr_w holds attribute j of vertex k at column 3 * j + k of its field.
# csrc/blend.cu reads this layout (its k* column constants).
FIELDS = (("xs", 3), ("ys", 3), ("z", 3), ("inv_w", 3), ("face_rgb", 3), ("lod", 6),
          ("alpha", 1), ("base_color", 3), ("ka", 1), ("kd", 1), ("ks", 1),
          ("shininess", 1), ("tex_id", 1), ("tex_addr", 1), ("tex_base", 1), ("mat_id", 1),
          ("box", 4), ("attr_w", None))
_INTS = ("xs", "ys", "tex_id", "tex_addr", "mat_id", "box")


def columns(attr_width: int) -> dict:
    """{field: (first column, columns)} of the slot table, and its width
    under "width"."""
    out, c = {}, 0
    for name, n in FIELDS:
        n = 3 * attr_width if n is None else n
        out[name] = (c, n)
        c += n
    out["width"] = c
    return out


class Slots(NamedTuple):
    """Transparent records as the composite reads them, one row a slot:
    xs, ys (k, 3) i32; z, inv_w, face_rgb (k, 3) f32; lod (k, 6) f32 (the
    sampler's dD/dx dD/dy dNu/dx dNu/dy dNv/dx dNv/dy, zeros without
    textures); alpha, ka, kd, ks, shininess, tex_base (the LOD's texel
    scale) (k,) f32; base_color (k, 3) f32; tex_id, tex_addr, mat_id (k,)
    i32; box (k, 4) i32, the half-open rows and columns (y0, y1, x0, x1) of
    the full frame whose pixel centres lie in the record's bounding box;
    attr_w (k, 3, A) f32."""

    xs: torch.Tensor
    ys: torch.Tensor
    z: torch.Tensor
    inv_w: torch.Tensor
    face_rgb: torch.Tensor
    lod: torch.Tensor
    alpha: torch.Tensor
    base_color: torch.Tensor
    ka: torch.Tensor
    kd: torch.Tensor
    ks: torch.Tensor
    shininess: torch.Tensor
    tex_id: torch.Tensor
    tex_addr: torch.Tensor
    tex_base: torch.Tensor
    mat_id: torch.Tensor
    box: torch.Tensor
    attr_w: torch.Tensor


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


def _uv_slot(scene: Scene, config: RenderConfig):
    """The attribute slot of u (v is the next), where the mode samples a
    texture of the scene; else None."""
    pyr = scene.textures
    if pyr is None or pyr.num_levels == 0:
        return None
    return {MODE_TEXTURED: 0, MODE_PHONG: 6}.get(config.mode)


def record_slots(tri, ids, scene: Scene, config: RenderConfig) -> Slots:
    """The records ids ((k,) int64) as Slots, gathered from the setup
    records and the scene's materials."""
    xs, ys = tri.xs[ids], tri.ys[ids]
    attr_w, inv_w = tri.attr_w[ids], tri.inv_w[ids]
    k, dev = ids.shape[0], ids.device
    uv_slot = _uv_slot(scene, config)
    if uv_slot is None:
        lod = torch.zeros((k, 6), dtype=F32, device=dev)
    else:
        rec = types.SimpleNamespace(xs=xs, ys=ys, attr_w=attr_w, inv_w=inv_w)
        lod = torch.stack(_lod_terms(rec, uv_slot, config), dim=-1)
    mats, pyr = scene.materials, scene.textures
    mid = tri.mat_id[ids]
    m = mid.long()
    tex_id = mats.tex_id[m]
    if pyr is not None and hasattr(pyr, "base_size_per_tex"):
        tex_base = pyr.base_size_per_tex[torch.where(tex_id >= 0, tex_id, 0).long()].to(F32)
    else:
        tex_base = torch.full((k,), float(pyr.base_size if pyr is not None else 0), dtype=F32,
                              device=dev)
    tex_addr = (torch.zeros_like(tex_id) if mats.tex_addr is None else mats.tex_addr[m])
    sub = config.subpixel
    box = torch.stack([_first_center(ys.amin(1), sub), _first_center(ys.amax(1) + 1, sub),
                       _first_center(xs.amin(1), sub), _first_center(xs.amax(1) + 1, sub)], 1)
    return Slots(xs=xs, ys=ys, z=tri.z[ids], inv_w=inv_w, face_rgb=tri.face_rgb[ids], lod=lod,
                 alpha=material_alpha(scene)[m], base_color=mats.base_color[m], ka=mats.ka[m],
                 kd=mats.kd[m], ks=mats.ks[m], shininess=mats.shininess[m],
                 tex_id=tex_id.to(I32), tex_addr=tex_addr.to(I32), tex_base=tex_base,
                 mat_id=mid.to(I32), box=box.to(I32), attr_w=attr_w)


def pack_slots(s: Slots) -> torch.Tensor:
    """The slot table (k, columns(A)["width"]) f32 of Slots s."""
    k = s.xs.shape[0]
    cols = []
    for name, _ in FIELDS:
        t = getattr(s, name)
        if name == "attr_w":
            t = t.permute(0, 2, 1)  # attribute-major, vertex-minor
        t = t.reshape(k, -1).contiguous()
        cols.append(t.view(F32) if name in _INTS else t)
    return torch.cat(cols, dim=1)


def unpack_slots(table: torch.Tensor, attr_width: int) -> Slots:
    """The Slots of table rows (pack_slots' layout)."""
    k = table.shape[0]
    out, cols = {}, columns(attr_width)
    for name, _ in FIELDS:
        c, n = cols[name]
        t = table[:, c : c + n]
        if name in _INTS:
            t = t.view(I32)
        if name == "attr_w":
            t = t.reshape(k, attr_width, 3).permute(0, 2, 1)
        elif n == 1:
            t = t[:, 0]
        out[name] = t
    return Slots(**out)


@dataclasses.dataclass
class SlotTable:
    """The composite's live transparent slots on the records' device
    (``live_slots``): meta (8,) i32, kernels.META's fields (count, total,
    overflow and union, below); ids (nchunks * chunk,) int64 record ids in
    source order (slots from count on are dead, and the kernel leaves them
    unwritten); boxes (nchunks, 4) i32, each chunk's (y0, y1, x0, x1) over
    its live records (empty where y1 <= y0 or x1 <= x0, as for a dead
    chunk), not cut to the frame; table (blend_capacity, width) f32, the
    slot table (pack_slots; rows from count on dead, and unwritten by the
    kernel). host: the plain version's host read of it (``live_records``),
    made once for all the bands it composites."""

    meta: torch.Tensor
    ids: torch.Tensor
    boxes: torch.Tensor
    table: torch.Tensor
    host: Optional["LiveSlots"] = None

    @property
    def count(self) -> torch.Tensor:
        """() i32: the live slots, min(total, blend_capacity)."""
        return self.meta[0]

    @property
    def total(self) -> torch.Tensor:
        """() i32: the transparent records."""
        return self.meta[1]

    @property
    def overflow(self) -> torch.Tensor:
        """() i32: the transparent records past blend_capacity."""
        return self.meta[2]

    @property
    def union(self) -> torch.Tensor:
        """(4,) i32: (y0, y1, x0, x1), the union of the live chunks'
        boxes cut to the frame (empty where y1 <= y0 or x1 <= x0)."""
        return self.meta[4:8]


class LiveSlots(NamedTuple):
    """The live transparent slots read to the host in one transfer
    (``live_records``), as the plain version walks them: count (int);
    boxes, the live chunks' (y0, y1, x0, x1) (SlotTable.boxes); ids and
    table: the SlotTable's."""

    count: int
    boxes: list
    ids: torch.Tensor
    table: torch.Tensor


def live_slots(tri, scene: Scene, config: RenderConfig) -> Optional[SlotTable]:
    """The live transparent slots on the records' device: the slot-table
    kernel (kernels.blend_slots) on CUDA records, its plain version
    (live_slots_plain) on CPU records. Reads nothing to the host (a
    captured frame runs it); None when the scene has no alpha column
    (nothing composites)."""
    if material_alpha(scene) is None:
        return None
    if tri.xs.device.type == "cpu":
        return live_slots_plain(tri, scene, config)
    return SlotTable(*slots_call(tri, scene, config)())


def slots_call(tri, scene: Scene, config: RenderConfig):
    """kernels.blend_slots bound to the frame's records and the scene's
    materials and textures, to call."""
    pyr = scene.textures
    uv_slot = _uv_slot(scene, config)
    ragged = pyr is not None and hasattr(pyr, "base_size_per_tex")
    return functools.partial(
        kernels.blend_slots, tri, scene.materials, pyr.base_size_per_tex if ragged else None,
        tex_base=0.0 if ragged or pyr is None else float(pyr.base_size),
        uv_slot=-1 if uv_slot is None else uv_slot, subpixel=config.subpixel,
        cap=config.blend_capacity, chunk=min(config.blend_chunk, config.blend_capacity),
        height=config.height, width=config.width)


def live_slots_plain(tri, scene: Scene, config: RenderConfig) -> SlotTable:
    """The slot-table kernel's plain version: the live slots from
    fixed-shape torch ops only (the stable sort of the source ids, the
    chunks' extents, record_slots and pack_slots)."""
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
    boxes = torch.stack([y0, y1, x0, x1], 1).to(I32)
    H, W = config.height, config.width
    union = [boxes[:, 0].amin().clamp(0, H), boxes[:, 1].amax().clamp(0, H),
             boxes[:, 2].amin().clamp(0, W), boxes[:, 3].amax().clamp(0, W)]
    meta = torch.stack([count, total, torch.clamp_min(total - cap, 0), torch.zeros_like(total),
                        *union]).to(I32)
    table = pack_slots(record_slots(tri, ids[:cap], scene, config))
    return SlotTable(meta, ids, boxes, table)


def live_records(tri, scene: Scene, config: RenderConfig,
                 slots: Optional[SlotTable] = None) -> Optional[LiveSlots]:
    """The live transparent slots and each live chunk's screen box, read
    to the host in one transfer (LiveSlots): the plain version's read.
    slots: live_slots of these records if made already; the read is kept
    on it. None when the scene has no alpha column."""
    if slots is None:
        slots = live_slots(tri, scene, config)
        if slots is None:
            return None
    if slots.host is None:
        ch = min(config.blend_chunk, config.blend_capacity)
        vals = torch.cat([slots.count.view(1), slots.boxes.view(-1)]).tolist()
        n = vals[0]
        boxes = [tuple(vals[1 + 4 * c : 5 + 4 * c]) for c in range(-(-n // ch))]
        slots.host = LiveSlots(n, boxes, slots.ids, slots.table)
    return slots.host


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
    """Composite the transparent records over the shaded frame: the kernel
    (kernels.blend_composite) on CUDA tensors, the plain version
    (blend_composite_plain) on CPU tensors.

    color (H, W, 3) f32 linear, background included; depth (H, W) f32
    opaque depth (1.0 = background); both hold rows [y_offset, y_offset +
    H) of the full frame (a screen band walks the whole transparent list
    against its own rows). color is consumed: the composite writes it in
    place and returns it, so a caller that needs the color from before the
    blend keeps a copy. live: these records' live_slots when the caller
    has made them already (once per device for all its bands); None makes
    them here. Returns (color, overflow () i32: the transparent records
    past blend_capacity, which strict readback raises on)."""
    if material_alpha(scene) is None:
        return color, convert.constant(0, depth.device, I32)
    slots = live if live is not None else live_slots(tri, scene, config)
    if depth.device.type == "cpu":
        color = blend_composite_plain(color, depth, tri, scene, config, eye, shadow_depth,
                                      light_viewproj, y_offset, slots)
    else:
        color = _launch(color, depth, slots, scene, config, eye, shadow_depth, light_viewproj,
                        y_offset)
    return color, slots.overflow


def _launch(color, depth, slots: SlotTable, scene: Scene, config: RenderConfig, eye,
            shadow_depth, light_viewproj, y_offset: int):
    return kernel_call(color, depth, slots, scene, config, eye, shadow_depth, light_viewproj,
                       y_offset)()


def kernel_call(color, depth, slots: SlotTable, scene: Scene, config: RenderConfig, eye,
                shadow_depth=None, light_viewproj=None, y_offset: int = 0):
    """kernels.blend_composite bound to the frame's tensors, to call (each
    call composites color in place again): the slot table and its meta
    vector, the frame's constants (eye, lights, the light's
    view-projection) in one vector, the shadow map and the texture
    tables."""
    dev = depth.device
    lights = scene.lights
    shadow = shadow_depth is not None and light_viewproj is not None
    consts = [convert.tensor(eye, dev, F32).reshape(3), lights.ambient.reshape(3),
              lights.dir_dirs.reshape(-1), lights.dir_colors.reshape(-1),
              lights.pt_pos.reshape(-1), lights.pt_colors.reshape(-1)]
    if shadow:
        consts.append(light_viewproj.reshape(16))
    quads, level_size, level_base = _texture_tables(scene, config, dev)
    return functools.partial(
        kernels.blend_composite,
        color, depth, slots.table, slots.meta, torch.cat(consts).to(F32).contiguous(),
        shadow_depth.contiguous() if shadow else None, quads, level_size, level_base,
        mode=config.mode, attr_width=config.attr_width, y_offset=y_offset,
        subpixel=config.subpixel, n_dir=lights.dir_dirs.shape[0],
        n_point=lights.pt_pos.shape[0], bias=config.shadow_bias,
        levels=0 if quads is None else scene.textures.num_levels)


def _texture_tables(scene: Scene, config: RenderConfig, dev):
    """The sampler's tables as the kernel reads them: the quad rows (rows,
    13) i32, and each (texture, level)'s texel width and first quad row
    (ntex * levels,) i32 (sm.sample_trilinear's size_at and qbase); Nones
    without textures."""
    pyr = scene.textures
    if pyr is None or pyr.num_levels == 0:
        return None, None, None
    L = pyr.num_levels
    if hasattr(pyr, "base_size_per_tex"):  # RaggedPyramid
        if config.mip_math == "closed":
            raise ValueError("mip_math='closed' needs a uniform TexturePyramid (one shared "
                             "power-of-two chain)")
        return (pyr.quads.reshape(-1, pyr.quads.shape[-1]).contiguous(),
                pyr.level_size.reshape(-1).to(I32).contiguous(),
                pyr.level_offset.reshape(-1).to(I32).contiguous())
    T, P, K = pyr.quads.shape
    sizes = [pyr.level_size(k) for k in range(L)]
    firsts = [t * P + pyr.level_offset(k) for t in range(T) for k in range(L)]
    return (pyr.quads.reshape(-1, K).contiguous(), convert.constant(sizes * T, dev, I32),
            convert.constant(firsts, dev, I32))


def blend_composite_plain(color, depth, tri, scene: Scene, config: RenderConfig, eye,
                          shadow_depth=None, light_viewproj=None, y_offset: int = 0,
                          live: Optional[SlotTable] = None):
    """The kernel's plain version: the composite of the live slots of the
    slot table over color (rows from y_offset), in source order, in place.
    live: these records' live_slots, read to the host here once
    (live_records; the bands of a device share the read), or None (made
    and read here). Each of the ceil(count / blend_chunk) live chunks runs
    on its live slots, from the table, over its box cut to these rows; a
    chunk whose box misses them runs nothing. Returns color."""
    live = live.host if live is not None and live.host is not None else live_records(
        tri, scene, config, live)
    H, W = depth.shape
    dev = depth.device
    ch = min(config.blend_chunk, config.blend_capacity)
    eye = convert.tensor(eye, dev, F32)
    for c, (y0, y1, x0, x1) in enumerate(live.boxes):
        y0, y1 = max(y0, y_offset), min(y1, y_offset + H)
        x0, x1 = _columns(x0, x1, W)
        if y0 >= y1 or x0 >= x1:
            continue
        rec = unpack_slots(live.table[c * ch : min((c + 1) * ch, live.count)],
                           config.attr_width)
        px = fp.pixel_center_fixed(torch.arange(x0, x1, device=dev), config.subpixel)
        py = fp.pixel_center_fixed(torch.arange(y0, y1, device=dev), config.subpixel)
        rows = slice(y0 - y_offset, y1 - y_offset)
        color[rows, x0:x1] = _composite_slots(color[rows, x0:x1], depth[rows, x0:x1], rec,
                                              scene, config, eye, px, py, shadow_depth,
                                              light_viewproj)
    return color


def _composite_slots(box, depth, rec: Slots, scene: Scene, config: RenderConfig, eye, px, py,
                     shadow_depth, light_viewproj, ok=None):
    """The slots rec composited over box (h, w, 3), the pixels at
    fixed-point centres px (w,) and py (h,) with opaque depth (h, w), one
    slot after another; ok: (k,) bool, the slots that are live (default
    all)."""
    mask, (e0, e1, e2) = fragment_mask(rec, px, py, depth)
    if ok is not None:
        mask = mask & ok[:, None, None]
    frag = _fragment_colors(rec, scene, config, eye, e0, e1, e2, mask, shadow_depth,
                            light_viewproj)
    a = rec.alpha
    # back to front within the chunk too: composite order is semantics
    for j in range(rec.xs.shape[0]):
        box = torch.where(mask[j][..., None], box * (1.0 - a[j]) + frag[j] * a[j], box)
    return box


def fragment_mask(rec: Slots, px, py, depth):
    """(mask (k, h, w) bool, (e0, e1, e2)): the slots' fragments at the
    fixed-point centres px (w,) and py (h,) that are covered, inside the
    depth range and in front of the opaque depth (h, w), and the edges."""
    xs = rec.xs[:, None, None, :]  # (k, 1, 1, 3)
    ys = rec.ys[:, None, None, :]
    cov, edges = fp.coverage(xs, ys, px[None, None, :], py[None, :, None])
    zf = rc.fragment_depth(*edges, rec.z[:, None, None, :])  # (k, h, w)
    # read-only depth test against the opaque buffer (strict <: a
    # fragment exactly on an opaque surface is occluded)
    return cov & rc.depth_range_mask(zf) & (zf < depth[None]), edges


def composite_whole_frame(color, depth, tri, scene: Scene, config: RenderConfig, eye,
                          shadow_depth=None, light_viewproj=None, y_offset: int = 0):
    """The composite as the reference runs it, before the crop and without
    the slot table: every live chunk on all its blend_chunk slots, gathered
    from the records, over the whole frame (band), each slot composited by
    a whole-frame torch.where. Reads the live count to the host: the
    yardstick the plain version and the kernel are held to. Returns (color,
    overflow)."""
    H, W = depth.shape
    cap = config.blend_capacity
    ch = min(config.blend_chunk, cap)
    nchunks = -(-cap // ch)
    tmask = transparent_mask(tri, scene)
    ids, total = _src_ordered_ids(tri, tmask, cap)
    overflow = torch.clamp_min(total - cap, 0).to(I32)
    px, py = rc.pixel_grids(W, H, config.subpixel, depth.device)
    slot_valid = torch.arange(nchunks * ch, device=depth.device) < torch.clamp_max(total, cap)
    ids = torch.cat([ids, ids.new_zeros(nchunks * ch - cap)]).long()
    eye = convert.tensor(eye, depth.device, F32)
    n_live = int(torch.clamp_max(tmask.sum(), cap))
    for c in range(-(-n_live // ch)):
        sl = ids[c * ch : (c + 1) * ch]
        color = _composite_slots(color, depth, record_slots(tri, sl, scene, config), scene,
                                 config, eye, px[0], py[:, 0] + y_offset * config.subpixel,
                                 shadow_depth, light_viewproj, ok=slot_valid[c * ch : (c + 1) * ch])
    return color, overflow


def _fragment_colors(rec: Slots, scene: Scene, config: RenderConfig, eye, e0, e1, e2, mask,
                     shadow_depth=None, light_viewproj=None):
    """(k, h, w, 3) linear colors of the k slots rec over an (h, w) box
    under the deferred pass's shading model. Uncovered lanes' attributes
    are zeroed at the source (the 1/w underflow guard the deferred pass
    applies at its background pixels)."""
    mode = config.mode
    k = rec.xs.shape[0]
    H, W = e0.shape[1:]
    if mode == MODE_FLAT:
        return rec.face_rgb[:, None, None, :].expand(k, H, W, 3)

    l0, l1, l2 = fp.barycentrics_f32(e0, e1, e2)
    aw, iw = rec.attr_w, rec.inv_w  # (k, 3, A), (k, 3)

    def interp(vals):  # (k, 3) -> (k, H, W)
        return (l0 * vals[:, 0, None, None] + l1 * vals[:, 1, None, None]) + l2 * vals[:, 2, None, None]

    denom = interp(iw)
    inv_denom = torch.where(mask, 1.0 / torch.clamp_min(denom, 1e-20), 0.0)

    def attr(j):
        return interp(aw[:, :, j]) * inv_denom

    if mode == MODE_GOURAUD:
        return torch.stack([attr(0), attr(1), attr(2)], dim=-1)

    if mode == MODE_TEXTURED:
        lit = torch.stack([attr(2), attr(3), attr(4)], dim=-1)
        return _texture(rec, scene, config, attr(0), attr(1), e0, e1, e2, denom) * lit

    assert mode == MODE_PHONG
    world = torch.stack([attr(0), attr(1), attr(2)], dim=-1)
    normal = m3.normalize(torch.stack([attr(3), attr(4), attr(5)], dim=-1), 1e-12)
    base = rec.base_color[:, None, None, :] * _texture(rec, scene, config, attr(6), attr(7),
                                                       e0, e1, e2, denom)
    shadow = None
    if shadow_depth is not None and light_viewproj is not None:
        # world is zeroed at uncovered lanes, so their sample is benign and
        # masked by the composite anyway
        shadow = sm.shadow_test(shadow_depth, world, light_viewproj, config.shadow_bias)
    shape = world.shape[:-1]

    def per_frag(col):
        return col[:, None, None].expand(shape)

    return sm.shade_phong(world, normal, eye, base, per_frag(rec.ka), per_frag(rec.kd),
                          per_frag(rec.ks), per_frag(rec.shininess), scene.lights,
                          shadow_factor=shadow)


def _texture(rec: Slots, scene: Scene, config: RenderConfig, u, v, e0, e1, e2, denom):
    """(k, h, w, 3) trilinear texture colors of the slots' fragments: the
    deferred pass's sampler with the per-record LOD terms; white where the
    material has no texture. The reference skips the sampler for a chunk
    with no live textured record (``lax.cond``); here it always runs when
    the scene has textures, and the masked composite makes the result the
    same."""
    pyr = scene.textures
    if pyr is None or pyr.num_levels == 0:
        return torch.ones(u.shape + (3,), dtype=F32, device=u.device)
    lod6 = [rec.lod[:, i, None, None] for i in range(6)]

    def per_rec(col):
        return col[:, None, None]

    return sample_texture_at(pyr, config, u, v, lod6, e0, e1, e2, denom, per_rec(rec.tex_id),
                             per_rec(rec.tex_base), per_rec(rec.tex_addr))
