"""Independent brute-force scalar rasterizer that validates the port's
oracle (port of ``xr/cpu_ref/brute.py``).

It shares no rasterization code with the port's pipeline: coverage is
evaluated per pixel with Python integers (which also checks the int32
budget of the fixed-point edges), the fill rule is re-derived from its
geometric definition, interpolation is float64, and the few math and
lighting helpers it needs are private numpy copies below. Flat and Gouraud
modes only, no clipping (every vertex must lie in front of the camera),
tiny frames: slow by design.

The scalar texture sampler and shadow compare at the end re-derive
``shade_math.sample_trilinear`` and ``shade_math.shadow_test`` in float64
from the raw mip levels, so a bug the oracle shares with the pipeline
cannot hide from them.
"""

from __future__ import annotations

import math

import numpy as np

from xr_torch.core.types import MODE_FLAT, MODE_GOURAUD, RenderConfig, Scene

F32 = np.float32


# ---- private numpy copies of the math and lighting it needs ---------------


def _normalize(v):
    return v / np.maximum(np.sqrt(np.sum(v * v, axis=-1, keepdims=True)), 1e-20)


def _cross(a, b):
    return np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                     a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                     a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], axis=-1)


def _camera_matrices(camera, aspect):
    """(view, proj) f32: the right-handed look-at and the perspective onto
    the D3D clip volume (z = -near -> 0, z = -far -> 1, w = -z_view)."""
    eye, target, up = (np.asarray(getattr(camera, k), F32) for k in ("eye", "target", "up"))
    z = _normalize(eye - target)
    x = _normalize(_cross(up, z))
    y = _cross(z, x)
    view = np.array([[*x, -np.sum(x * eye)], [*y, -np.sum(y * eye)],
                     [*z, -np.sum(z * eye)], [0, 0, 0, 1]], F32)
    f = F32(1.0) / np.tan(np.asarray(camera.fov_y, F32) * F32(0.5))
    near, far = np.asarray(camera.near, F32), np.asarray(camera.far, F32)
    a = far / (near - far)
    b = near * far / (near - far)
    proj = np.array([[f / F32(aspect), 0, 0, 0], [0, f, 0, 0], [0, 0, a, b], [0, 0, -1, 0]], F32)
    return view, proj


def _vertex_lit(normal, base_color, kd, lights, world_pos=None):
    """Ambient + directional diffuse + attenuated point-light diffuse
    (falloff 1 / (1 + 0.05 d^2)), (N, 3) f32."""
    col = lights["ambient"][None, :] * base_color
    ld = lights["dir_dirs"]
    if ld.shape[0]:
        nl = np.maximum(-(normal @ ld.T), 0.0)
        col = col + kd[:, None] * base_color * (nl @ lights["dir_colors"])
    if world_pos is not None:
        for pos, rgb in zip(lights["pt_pos"], lights["pt_colors"]):
            l_vec = pos - world_pos
            d2 = np.sum(l_vec * l_vec, axis=-1)
            l = l_vec / np.maximum(np.sqrt(np.sum(l_vec * l_vec, axis=-1, keepdims=True)), 1e-12)
            ndl = np.maximum(np.sum(normal * l, axis=-1), 0.0)
            att = 1.0 / (1.0 + 0.05 * d2)
            col = col + (kd[:, None] * base_color * (ndl * att)[:, None]) * rgb
    return col.astype(F32)


# ---- the rasterizer -------------------------------------------------------


def _snap(v: float, sub: int) -> int:
    return int(math.floor(v * sub + 0.5))


def _edge(ax, ay, bx, by, px, py):
    """Edge function of edge a->b at p, positive inside a front face
    (world-CCW, y-down screen coordinates); exact Python integers."""
    return (by - ay) * (px - ax) - (bx - ax) * (py - ay)


def _tie_accept(ax, ay, bx, by) -> bool:
    """The top-left rule from its geometric definition. Inside is to the
    positive side, so a TOP edge is horizontal with the inside below it,
    running right to left (ax > bx); a LEFT edge has the inside to its
    right, running downward (by > ay)."""
    if ay == by:
        return ax > bx
    return by > ay


def render(scene: Scene, camera, config: RenderConfig):
    """(color (H, W, 3) u8, depth (H, W) f32 with 1.0 background) of a
    host scene (numpy leaves) whose vertices all lie in front of the
    camera. Opaque triangles win by depth (or draw order without the depth
    test); under ``blend`` the transparent ones are composited afterwards
    in input order, alpha over, tested read-only against the opaque
    depth."""
    H, W, sub = config.height, config.width, config.subpixel
    half = sub // 2
    view, proj = _camera_matrices(camera, W / H)
    vp = (proj @ view).astype(F32)

    mesh = scene.mesh
    positions = np.asarray(mesh.positions, F32)
    normals = np.asarray(mesh.normals, F32)
    indices = np.asarray(mesh.indices, np.int64)
    mat_of_tri = np.asarray(mesh.material_id, np.int64)
    mats = np.asarray(scene.model_matrices, F32)[np.asarray(mesh.transform_id, np.int64)]
    lights = {k: np.asarray(getattr(scene.lights, k), F32)
              for k in ("dir_dirs", "dir_colors", "pt_pos", "pt_colors", "ambient")}
    base = np.asarray(scene.materials.base_color, F32)
    kd = np.asarray(scene.materials.kd, F32)
    alpha_tab = scene.materials.alpha
    has_pt = lights["pt_pos"].shape[0] > 0

    color = np.zeros((H, W, 3), np.float64)
    color[:, :] = np.asarray(config.bg_color, np.float64)
    depth = np.full((H, W), np.inf, np.float64)

    # per-vertex transform in f32 like the pipeline, then an exact snap
    V = positions.shape[0]
    p4 = np.concatenate([positions, np.ones((V, 1), F32)], 1)
    world = np.einsum("vij,vj->vi", mats, p4).astype(F32)
    clip = (world @ vp.T).astype(F32)

    vlit = None
    if config.mode == MODE_GOURAUD:
        vert_mat = np.zeros(V, np.int64)
        vert_mat[indices.reshape(-1)] = np.repeat(mat_of_tri, 3)
        vnorm = _normalize(np.einsum("vij,vj->vi", mats[:, :3, :3], normals)).astype(F32)
        vlit = _vertex_lit(vnorm, base[vert_mat], kd[vert_mat], lights,
                           world[:, :3] if has_pt else None)

    def tri_alpha(t: int) -> float:
        if not config.blend or alpha_tab is None:
            return 1.0
        return float(np.asarray(alpha_tab)[mat_of_tri[t]])

    def setup(t: int):
        """Snapped screen vertices in positive orientation and their vertex
        ids, or None for a degenerate or culled triangle."""
        order = [int(i) for i in indices[t]]
        vs = []
        for vi in order:
            x, y, z, w = (F32(c) for c in clip[vi])
            assert float(w) > 1e-6, "the brute rasterizer needs every vertex in front"
            # the pipeline's f32 op sequence: x * (1 / w), then the viewport
            iw = F32(1.0) / np.maximum(w, F32(1e-12))
            sx = (x * iw * F32(0.5) + F32(0.5)) * F32(W)
            sy = (F32(0.5) - y * iw * F32(0.5)) * F32(H)
            vs.append((_snap(float(sx), sub), _snap(float(sy), sub), float(z * iw)))
        area2 = _edge(*vs[0][:2], *vs[1][:2], *vs[2][:2])
        if area2 == 0:
            return None
        if area2 < 0:
            if config.cull_backfaces:
                return None
            vs[1], vs[2] = vs[2], vs[1]
            order[1], order[2] = order[2], order[1]
            area2 = -area2
        return vs, order, area2

    def flat_rgb(t: int):
        """The face color from the ORIGINAL winding's normal (and, with
        point lights, the face centroid)."""
        a, b, c = (int(i) for i in indices[t])
        fn = np.cross(world[b, :3] - world[a, :3], world[c, :3] - world[a, :3])
        fn = fn / max(np.linalg.norm(fn), 1e-20)
        mid = mat_of_tri[t]
        cen = (((world[a, :3] + world[b, :3]) + world[c, :3]) * F32(1.0 / 3.0))[None, :]
        return _vertex_lit(fn[None, :].astype(F32), base[mid][None, :], kd[mid][None], lights,
                           cen if has_pt else None)[0]

    def fragments(vs, area2):
        """(iy, ix, l0, l1, l2, z) of every covered pixel center whose
        depth lies in [0, 1]."""
        (x0, y0, z0), (x1, y1, z1), (x2, y2, z2) = vs
        edges = ((x1, y1, x2, y2), (x2, y2, x0, y0), (x0, y0, x1, y1))  # opposite v0, v1, v2
        for iy in range(H):
            py = iy * sub + half
            for ix in range(W):
                px = ix * sub + half
                es = [_edge(ax, ay, bx, by, px, py) for ax, ay, bx, by in edges]
                if any(e < 0 or (e == 0 and not _tie_accept(*ab)) for e, ab in zip(es, edges)):
                    continue
                l0, l1, l2 = (e / area2 for e in es)
                z = l0 * z0 + l1 * z1 + l2 * z2
                if 0.0 <= z <= 1.0:
                    yield iy, ix, l0, l1, l2, z

    def gouraud(order, l0, l1, l2):
        """Perspective-correct vertex color in float64."""
        iw = [1.0 / float(clip[i, 3]) for i in order]
        den = l0 * iw[0] + l1 * iw[1] + l2 * iw[2]
        return (l0 * iw[0] * vlit[order[0]].astype(np.float64)
                + l1 * iw[1] * vlit[order[1]].astype(np.float64)
                + l2 * iw[2] * vlit[order[2]].astype(np.float64)) / den

    for t in range(indices.shape[0]):
        if tri_alpha(t) < 1.0:  # transparent under blend: wins no pixels
            continue
        s = setup(t)
        if s is None:
            continue
        vs, order, area2 = s
        rgb = flat_rgb(t) if config.mode == MODE_FLAT else None
        for iy, ix, l0, l1, l2, z in fragments(vs, area2):
            if config.depth_test and z >= depth[iy, ix]:
                continue
            depth[iy, ix] = z
            color[iy, ix] = rgb if rgb is not None else gouraud(order, l0, l1, l2)

    # the transparent triangles in INPUT order, read-only strict depth test
    # against the resolved opaque depth (background 1.0)
    if config.blend and alpha_tab is not None:
        for t in range(indices.shape[0]):
            a = tri_alpha(t)
            if a >= 1.0:
                continue
            s = setup(t)
            if s is None:
                continue
            vs, order, area2 = s
            rgb = flat_rgb(t) if config.mode == MODE_FLAT else None
            for iy, ix, l0, l1, l2, z in fragments(vs, area2):
                d = depth[iy, ix]
                if not z < (1.0 if np.isinf(d) else d):
                    continue
                src = rgb if rgb is not None else gouraud(order, l0, l1, l2)
                color[iy, ix] = color[iy, ix] * (1.0 - a) + src * a

    u8 = np.floor(np.clip(color, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return u8, np.where(np.isinf(depth), 1.0, depth).astype(F32)


# ---- scalar texture sampling and shadow compare ---------------------------


def _quantize_u8(level: np.ndarray) -> np.ndarray:
    """8-bit texel quantization, as the packed quad pyramid stores it."""
    return np.floor(np.clip(level, 0.0, 1.0) * 255.0 + 0.5) / 255.0


def _bilinear_scalar(level: np.ndarray, u: float, v: float) -> np.ndarray:
    """One float64 bilinear tap with repeat wrap, texel centers at +0.5."""
    s = level.shape[0]
    tu = (u - math.floor(u)) * s - 0.5
    tv = (v - math.floor(v)) * s - 0.5
    i0, j0 = math.floor(tu), math.floor(tv)
    fu, fv = tu - i0, tv - j0
    out = np.zeros(3, np.float64)
    for dj, wv in ((0, 1.0 - fv), (1, fv)):
        for di, wu in ((0, 1.0 - fu), (1, fu)):
            out += (wu * wv) * level[(j0 + dj) % s, (i0 + di) % s].astype(np.float64)
    return out


def sample_trilinear_scalar(levels, u: float, v: float, lod: float) -> np.ndarray:
    """Float64 scalar trilinear sample from raw mip level images: levels, a
    list of (s, s, 3) f32 arrays, level 0 first. Returns (3,) f64."""
    L = len(levels)
    lf = min(max(lod, 0.0), float(L - 1))
    l0 = int(math.floor(lf))
    l1 = min(l0 + 1, L - 1)
    frac = lf - l0
    c0 = _bilinear_scalar(_quantize_u8(levels[l0]), u, v)
    c1 = _bilinear_scalar(_quantize_u8(levels[l1]), u, v)
    return c0 * (1.0 - frac) + c1 * frac


def shadow_test_scalar(shadow_depth: np.ndarray, world_pos, light_viewproj, bias: float) -> float:
    """Float64 scalar shadow-map compare, 1.0 lit and 0.0 shadowed: the
    world point through the light's view-projection, NDC to texel
    coordinates (y flipped), the nearest texel, ``z - bias > stored``;
    outside the map is lit."""
    hs, ws = shadow_depth.shape
    p = np.asarray(world_pos, np.float64)
    clip4 = np.asarray(light_viewproj, np.float64) @ np.array([p[0], p[1], p[2], 1.0])
    w = max(float(clip4[3]), 1e-12)
    nx, ny, nz = (float(clip4[k]) / w for k in range(3))
    if not (-1.0 <= nx <= 1.0 and -1.0 <= ny <= 1.0 and 0.0 <= nz <= 1.0):
        return 1.0
    ix = min(max(int(math.floor((nx * 0.5 + 0.5) * ws)), 0), ws - 1)
    iy = min(max(int(math.floor((0.5 - ny * 0.5) * hs)), 0), hs - 1)
    return 0.0 if nz - bias > float(shadow_depth[iy, ix]) else 1.0
