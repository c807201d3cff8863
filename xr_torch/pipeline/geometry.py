"""Geometry stage of the port: vertex transform, near/guard-band clipping,
projection, snapping, culling and order-preserving compaction (port of
``xr/pipeline/geometry.py``).

Static shapes throughout, as in the reference: triangles fully inside all
six clip planes skip Sutherland-Hodgman; only plane-crossing triangles are
compacted into a fixed budget and clipped into fans of at most 7. The
output order is inside triangles (ascending input id), then clipped fans —
the same records in the same slots as the reference, which fixes (z, id)
depth ties. Each torch op rounds its own result, so the f32 op order the
reference pins with optimization barriers holds here by construction.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from xr_torch.convert import constant
from xr_torch.core import fixedpoint as fp
from xr_torch.core import math3d as m3
from xr_torch.core import shade_math as sm
from xr_torch.core.types import (
    MODE_FLAT,
    MODE_GOURAUD,
    MODE_PHONG,
    MODE_TEXTURED,
    RenderConfig,
    Scene,
)

F32, I32 = torch.float32, torch.int32

MAX_CLIP_VERTS = 9  # a triangle clipped by 6 planes has at most 9 vertices
MAX_FAN = MAX_CLIP_VERTS - 2


@dataclasses.dataclass(frozen=True)
class TriBuf:
    """Setup triangles compacted to a static capacity C (structure of arrays).

    xs, ys (C,3) i32 fixed-point screen coords (positive orientation);
    z (C,3) f32 NDC depth; inv_w (C,3) f32; attr_w (C,3,A) f32 attributes
    times 1/w; face_rgb (C,3) f32; mat_id (C,) i32; src_id (C,) i32 source
    triangle (fans carry their parent's); valid (C,) bool; count () i32;
    overflow () i32 triangles dropped for capacity; num_src the static
    source triangle count.
    """

    xs: Any
    ys: Any
    z: Any
    inv_w: Any
    attr_w: Any
    face_rgb: Any
    mat_id: Any
    src_id: Any
    valid: Any
    count: Any
    overflow: Any
    num_src: int = 0

    @property
    def capacity(self) -> int:
        return self.xs.shape[0]

    def replace(self, **changes) -> "TriBuf":
        return dataclasses.replace(self, **changes)


def clip_capacity(num_tris: int, config: RenderConfig) -> int:
    return int(math.ceil(num_tris * config.clip_expand)) + 64


def clip_budget(num_tris: int, config: RenderConfig) -> int:
    """Static Sutherland-Hodgman budget (triangles that cross a plane)."""
    b = config.clip_budget or max(1024, num_tris // 16)
    return min(b, num_tris)


def identity_layout(num_tris: int, config: RenderConfig, capacity: int) -> bool:
    """True where the reference takes its identity record layout."""
    return capacity >= num_tris + clip_budget(num_tris, config) * MAX_FAN


def _plane_vectors(guard: float, device) -> torch.Tensor:
    """The 6 clip planes as (6,4) rows p, kept where dot(p, clip) >= 0 (a
    shared constant of the device: convert.constant)."""
    g = float(guard)
    return constant(
        [
            [0.0, 0.0, 1.0, 0.0],  # near: z >= 0
            [0.0, 0.0, -1.0, 1.0],  # far: w - z >= 0
            [1.0, 0.0, 0.0, g],  # left: x + g*w >= 0
            [-1.0, 0.0, 0.0, g],  # right: g*w - x >= 0
            [0.0, 1.0, 0.0, g],  # y-: y + g*w >= 0
            [0.0, -1.0, 0.0, g],  # y+: g*w - y >= 0
        ],
        device,
    )


def _plane_distances(pos4: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Signed distances (..., P) with a fixed op order: each product
    rounded, then left-associated adds."""
    t = [pos4[..., None, c] * planes[:, c] for c in range(4)]
    return ((t[0] + t[1]) + t[2]) + t[3]


def _row_scatter(dst, cols, src, mask):
    """dst[row, cols] = src where mask; masked writes go to a discard slot."""
    T, n, K = dst.shape
    cols = torch.where(mask, cols, n).long()
    out = torch.cat([dst, dst.new_zeros((T, 1, K))], dim=1)
    out.scatter_(1, cols[:, :, None].expand(T, cols.shape[1], K), src)
    return out[:, :n]


def clip_triangles(pos: torch.Tensor, attr: torch.Tensor, guard: float):
    """Sutherland-Hodgman clip of (T,3,4) clip-space triangles with (T,3,A)
    attributes against the 6 planes. Returns (poly_pos (T,9,4),
    poly_attr (T,9,A), counts (T,)); counts < 3 are clipped away."""
    T, A = pos.shape[0], attr.shape[2]
    dev = pos.device
    poly = torch.zeros((T, MAX_CLIP_VERTS, 4 + A), dtype=F32, device=dev)
    poly[:, :3] = torch.cat([pos, attr], dim=2)
    cnt = torch.full((T,), 3, dtype=I32, device=dev)
    planes = _plane_vectors(guard, dev)
    slot = torch.arange(MAX_CLIP_VERTS, dtype=I32, device=dev)[None, :]

    for p in range(6):
        d = _plane_distances(poly[:, :, :4], planes[p : p + 1])[..., 0]
        live = slot < cnt[:, None]
        # "next" vertex: roll by one, with the wrap fixed at the last live slot
        is_last = slot == (cnt[:, None] - 1)
        d_next = torch.where(is_last, d[:, :1], torch.roll(d, -1, dims=1))
        v_next = torch.where(
            is_last[:, :, None], poly[:, :1], torch.roll(poly, -1, dims=1)
        )
        inside = (d >= 0.0) & live
        crosses = ((d >= 0.0) != (d_next >= 0.0)) & live
        denom = d - d_next
        t = torch.where(
            crosses, d / torch.where(denom == 0.0, torch.ones_like(denom), denom), 0.0
        )
        inter = poly + t[:, :, None] * (v_next - poly)

        emit = inside.to(I32) + crosses.to(I32)
        start = torch.cumsum(emit, dim=1, dtype=I32) - emit
        new_poly = _row_scatter(torch.zeros_like(poly), start, poly, inside)
        poly = _row_scatter(new_poly, start + inside.to(I32), inter, crosses)
        cnt = emit.sum(dim=1, dtype=I32)

    return poly[:, :, :4], poly[:, :, 4:], cnt


def _vert_mat(mesh) -> torch.Tensor:
    """Per-vertex material id: Mesh.vert_mat when the host attached it, else
    the lowest material id among the triangles using the vertex (0 for
    unused vertices) — an order-independent min."""
    if mesh.vert_mat is not None:
        return mesh.vert_mat
    big = 2**30
    out = torch.full((mesh.num_vertices,), big, dtype=I32, device=mesh.indices.device)
    val = mesh.material_id[:, None].expand(-1, 3).reshape(-1)
    out = out.scatter_reduce(0, mesh.indices.reshape(-1).long(), val, "amin")
    return torch.where(out == big, 0, out)


def _vertex_stage(scene: Scene, view, proj, config: RenderConfig):
    """Returns (clip_pos (V,4), attrs (V,A), face_rgb (T,3))."""
    mesh = scene.mesh
    mode = config.mode
    dev = mesh.positions.device
    V = mesh.num_vertices
    mats = scene.model_matrices[mesh.transform_id.long()]  # (V,4,4)
    p4 = torch.cat([mesh.positions, torch.ones((V, 1), dtype=F32, device=dev)], dim=1)
    world = m3.matvec(mats, p4)[:, :3]
    clip = m3.transform_points(world, m3.matmul(proj, view))

    A = config.attr_width
    face_rgb = torch.zeros((mesh.num_triangles, 3), dtype=F32, device=dev)
    attrs = torch.zeros((V, A), dtype=F32, device=dev)
    # point lights (when present) need surface positions
    has_pt = scene.lights.pt_pos.shape[0] > 0
    mat = scene.materials
    if mode == MODE_FLAT:
        ind = mesh.indices.long()
        w0, w1, w2 = world[ind[:, 0]], world[ind[:, 1]], world[ind[:, 2]]
        fn = m3.normalize(m3.cross(w1 - w0, w2 - w0))
        mid = mesh.material_id.long()
        centroid = ((w0 + w1) + w2) * (1.0 / 3.0) if has_pt else None
        face_rgb = sm.shade_flat_face(fn, mat.base_color[mid], mat.kd[mid], scene.lights,
                                      centroid=centroid)
    elif mode in (MODE_GOURAUD, MODE_TEXTURED, MODE_PHONG):
        n_world = m3.normalize(m3.matvec(mats[:, :3, :3], mesh.normals))
        if mode == MODE_PHONG:  # world position, world normal, uv (A = 8)
            return clip, torch.cat([world, n_world, mesh.uvs], dim=1), face_rgb
        vm = _vert_mat(mesh).long()
        lit = sm.shade_vertex_lit(
            n_world,
            mat.base_color[vm],
            mat.kd[vm],
            scene.lights,
            world_pos=world if has_pt else None,
        )
        attrs = lit if mode == MODE_GOURAUD else torch.cat([mesh.uvs, lit], dim=1)
    return clip, attrs, face_rgb


def _swap_v12(arr, flip):
    """Swap vertices 1 and 2 where flip; arr is (..., 3) or (..., 3, A)."""
    swap = constant([0, 2, 1], arr.device, torch.int64)  # an index list would copy per call
    if arr.ndim == flip.ndim + 1:
        return torch.where(flip[..., None], arr[..., swap], arr)
    return torch.where(flip[..., None, None], arr[..., swap, :], arr)


def _project_snap(fpos, fattr, config: RenderConfig):
    """Project (..., 3, 4) clip-space triangles to snapped screen ints plus
    setup culls. Returns (xs, ys, z, inv_w, attr_w, valid)."""
    sub = config.subpixel
    w = torch.clamp_min(fpos[..., 3], 1e-12)
    inv_w = 1.0 / w
    ndc_x = fpos[..., 0] * inv_w
    ndc_y = fpos[..., 1] * inv_w
    z = fpos[..., 2] * inv_w
    sx = (ndc_x * 0.5 + 0.5) * config.width
    sy = (0.5 - ndc_y * 0.5) * config.height
    # the clamp only touches triangles outside the guard band (culled below)
    lim = float(8 * max(config.width, config.height) + 64)
    xs = fp.snap_to_fixed(torch.clamp(sx, -lim, lim), sub)
    ys = fp.snap_to_fixed(torch.clamp(sy, -lim, lim), sub)

    area2 = fp.doubled_area(xs, ys)
    if config.cull_backfaces:
        orient_ok = area2 > 0
        flip = torch.zeros_like(orient_ok)
    else:
        orient_ok = area2 != 0
        flip = area2 < 0
    xs, ys = _swap_v12(xs, flip), _swap_v12(ys, flip)
    z, inv_w = _swap_v12(z, flip), _swap_v12(inv_w, flip)
    if fattr.shape[-1]:
        fattr = _swap_v12(fattr, flip)

    # screen-rect reject (pixel centers at sub/2 + k*sub)
    half = sub // 2
    on_screen = (
        (xs.amax(-1) >= half)
        & (xs.amin(-1) <= (config.width - 1) * sub + half)
        & (ys.amax(-1) >= half)
        & (ys.amin(-1) <= (config.height - 1) * sub + half)
    )
    attr_w = fattr * inv_w[..., None] if fattr.shape[-1] else fattr
    return xs, ys, z, inv_w, attr_w, orient_ok & on_screen


def _sort_compact_ids(mask: torch.Tensor, n_out: int):
    """Ascending indices of True entries of mask, padded to n_out (padding
    points at the last entry; mask separately). Scatter-free: sort of
    (index if set else 2^30). Returns (idx (n_out,), min(count, n_out),
    count)."""
    n = mask.shape[0]
    big = 2**30
    keys = torch.where(mask, torch.arange(n, dtype=I32, device=mask.device), big)
    skeys = torch.sort(keys).values
    if n_out <= n:
        idx = skeys[:n_out]
    else:
        idx = torch.cat([skeys, skeys.new_full((n_out - n,), big)])
    count = mask.sum(dtype=I32)
    return torch.clamp_max(idx, n - 1), torch.clamp_max(count, n_out), count


def geometry(
    scene: Scene,
    view: torch.Tensor,
    proj: torch.Tensor,
    config: RenderConfig,
    capacity: Optional[int] = None,
    stats_out: Optional[dict] = None,
) -> TriBuf:
    """Vertex transform -> classify -> clip (crossing triangles only) ->
    project -> snap -> cull -> compact into capacity C (or, where C holds
    every triangle and every fan, the identity record layout). stats_out
    receives crossing_total, live_records and fan_records."""
    mesh = scene.mesh
    T = mesh.num_triangles
    A = config.attr_width
    C = capacity if capacity is not None else clip_capacity(T, config)
    B = clip_budget(T, config)
    F = MAX_FAN
    dev = mesh.positions.device

    clip, vattrs, face_rgb = _vertex_stage(scene, view, proj, config)
    planes = _plane_vectors(config.guard_band, dev)
    ind = mesh.indices.long()
    tri_pos = clip[ind]  # (T,3,4)
    tri_attr = vattrs[ind]  # (T,3,A)
    d = _plane_distances(tri_pos, planes)  # (T,3,6)
    inside_all = (d >= 0.0).all(dim=2).all(dim=1)
    outside_any = (d < 0.0).all(dim=1).any(dim=1)
    crossing = ~inside_all & ~outside_any

    # ---- path B: Sutherland-Hodgman on the crossing triangles ------------
    sel, _, crossing_total = _sort_compact_ids(crossing, B)
    sel_l = sel.long()
    sel_valid = torch.arange(B, device=dev) < torch.clamp_max(crossing_total, B)
    poly_pos, poly_attr, cnt = clip_triangles(
        tri_pos[sel_l], tri_attr[sel_l], config.guard_band
    )
    cnt = torch.where(sel_valid, cnt, 0)
    k = torch.arange(F, device=dev)
    fan_valid = (k[None, :] + 2) < cnt[:, None]  # (B,F)

    def fan(arr):
        # fan triangle k = polygon vertices (0, k+1, k+2)
        v0 = arr[:, None, 0].expand((B, F) + arr.shape[2:])
        return torch.stack([v0, arr[:, 1 : 1 + F], arr[:, 2 : 2 + F]], dim=2)

    # ---- project/snap/cull both paths -----------------------------------
    xsA, ysA, zA, iwA, awA, validA = _project_snap(tri_pos, tri_attr, config)
    validA = validA & inside_all
    xsB, ysB, zB, iwB, awB, validB = _project_snap(fan(poly_pos), fan(poly_attr), config)
    validB = (validB & fan_valid).reshape(B * F)

    mat = mesh.material_id
    rgbB = face_rgb[sel_l][:, None, :].expand(B, F, 3)
    matB = mat[sel_l][:, None].expand(B, F)
    src_idA = torch.arange(T, dtype=I32, device=dev)
    src_idB = sel[:, None].expand(B, F)

    # ---- identity record layout (capacity covers every triangle) ---------
    # Where C >= T + B*F nothing is compacted: a record's id is its input
    # triangle's, fans are appended at T + fan slot, invalid slots stay
    # masked and the padding is zeros. Ids stay ascending in input order, so
    # (z, id) depth ties resolve as in the compacted layout.
    if identity_layout(T, config, C):
        pad = C - T - B * F

        def cat(a_field, b_field):
            b2 = b_field.reshape((B * F,) + a_field.shape[1:])
            return torch.cat([a_field, b2, a_field.new_zeros((pad,) + a_field.shape[1:])])

        totalA = validA.sum(dtype=I32)
        totalB = validB.sum(dtype=I32)
        if stats_out is not None:
            stats_out["crossing_total"] = crossing_total
            stats_out["live_records"] = totalA + totalB
            stats_out["fan_records"] = totalB
        return TriBuf(
            xs=cat(xsA, xsB),
            ys=cat(ysA, ysB),
            z=cat(zA, zB),
            inv_w=cat(iwA, iwB),
            attr_w=cat(awA, awB),
            face_rgb=cat(face_rgb, rgbB),
            mat_id=cat(mat, matB),
            src_id=cat(src_idA, src_idB),
            valid=cat(validA, validB),
            count=(totalA + totalB).to(I32),
            overflow=torch.clamp_min(crossing_total - B, 0).to(I32),
            num_src=T,
        )

    # ---- order-preserving compaction into capacity C ---------------------
    idxA, countA, totalA = _sort_compact_ids(validA, C)
    idxB, countB, totalB = _sort_compact_ids(validB, C)
    slot = torch.arange(C, dtype=I32, device=dev)
    from_a = slot < countA
    srcB = idxB[torch.clamp(slot - countA, 0, C - 1).long()].long()
    idxA = idxA.long()

    def merge(a_field, b_field):
        b_field = b_field.reshape((B * F,) + b_field.shape[2:])
        fm = from_a.reshape((C,) + (1,) * (a_field.ndim - 1))
        return torch.where(fm, a_field[idxA], b_field[srcB])

    out_count = torch.clamp_max(countA + countB, C)
    overflow = torch.clamp_min(totalA + totalB - C, 0) + torch.clamp_min(
        crossing_total - B, 0
    )
    if stats_out is not None:
        stats_out["crossing_total"] = crossing_total
        stats_out["live_records"] = totalA + totalB
        stats_out["fan_records"] = totalB

    return TriBuf(
        xs=merge(xsA, xsB),
        ys=merge(ysA, ysB),
        z=merge(zA, zB),
        inv_w=merge(iwA, iwB),
        attr_w=merge(awA, awB),
        face_rgb=merge(face_rgb, rgbB),
        mat_id=merge(mat, matB),
        src_id=merge(src_idA, src_idB),
        valid=slot < out_count,
        count=out_count.to(I32),
        overflow=overflow.to(I32),
        num_src=T,
    )
