"""Procedural meshes for the port (host numpy; port of the cube, icosphere,
grid, terrain, LOD terrain and mesh-combining parts of
``xr/scene/procedural.py``). They build exactly the reference's arrays,
so the same preset gives both packages the same scene. Front faces are
counter-clockwise viewed from outside."""

from __future__ import annotations

import numpy as np

from xr_torch.core.types import Mesh


def _mesh(pos, nrm, uv, idx, mat=0) -> Mesh:
    pos = np.asarray(pos, np.float32)
    t = np.asarray(idx, np.int32).reshape(-1, 3)
    return Mesh(
        positions=pos,
        normals=np.asarray(nrm, np.float32),
        uvs=np.asarray(uv, np.float32),
        indices=t,
        material_id=np.full(t.shape[0], mat, np.int32),
        transform_id=np.zeros(pos.shape[0], np.int32),
    )


def cube(size: float = 1.0, mat: int = 0) -> Mesh:
    """Axis-aligned cube centered at the origin; 24 vertices (face normals
    and uvs), 12 triangles."""
    s = size * 0.5
    faces = [
        # (normal, tangent(u), bitangent(v))
        ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
        ((0, 0, -1), (-1, 0, 0), (0, 1, 0)),
        ((1, 0, 0), (0, 0, -1), (0, 1, 0)),
        ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),
        ((0, 1, 0), (1, 0, 0), (0, 0, -1)),
        ((0, -1, 0), (1, 0, 0), (0, 0, 1)),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for n, u, v in faces:
        n, u, v = (np.asarray(a, np.float32) for a in (n, u, v))
        base = len(pos)
        # corners CCW viewed from outside: (-u-v), (+u-v), (+u+v), (-u+v)
        for cu, cv, tu, tv in ((-1, -1, 0, 1), (1, -1, 1, 1), (1, 1, 1, 0), (-1, 1, 0, 0)):
            pos.append(n * s + u * (cu * s) + v * (cv * s))
            nrm.append(n)
            uv.append((tu, tv))
        idx += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    return _mesh(pos, nrm, uv, idx, mat)


def icosphere(subdivisions: int = 2, radius: float = 1.0, mat: int = 0) -> Mesh:
    """Icosphere by midpoint subdivision (smooth normals, spherical uvs),
    20 * 4**subdivisions triangles."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
            (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
            (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [tuple(v) for v in verts]
    for _ in range(subdivisions):
        cache = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = np.asarray(verts[a]) + np.asarray(verts[b])
                m /= np.linalg.norm(m)
                cache[key] = len(verts)
                verts.append(tuple(m))
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces

    v = np.asarray(verts, np.float64)
    uv = np.stack(
        [
            0.5 + np.arctan2(v[:, 2], v[:, 0]) / (2 * np.pi),
            0.5 - np.arcsin(np.clip(v[:, 1], -1, 1)) / np.pi,
        ],
        axis=1,
    )
    return _mesh(v * radius, v.copy(), uv, faces, mat)


def grid_plane(nx: int, nz: int, size: float = 1.0, mat: int = 0) -> Mesh:
    """(nx x nz)-cell plane in the XZ plane, +Y up, 2*nx*nz triangles."""
    xs = np.linspace(-0.5, 0.5, nx + 1) * size
    zs = np.linspace(-0.5, 0.5, nz + 1) * size
    gx, gz = np.meshgrid(xs, zs, indexing="xy")
    pos = np.stack([gx, np.zeros_like(gx), gz], axis=-1).reshape(-1, 3)
    nrm = np.tile(np.array([0, 1, 0], np.float32), (pos.shape[0], 1))
    uu, vv = np.meshgrid(
        np.linspace(0, 1, nx + 1), np.linspace(0, 1, nz + 1), indexing="xy"
    )
    uv = np.stack([uu, vv], axis=-1).reshape(-1, 2)
    # two CCW-from-above triangles per cell, (a, c, b) and (b, c, d)
    j, i = np.meshgrid(np.arange(nz), np.arange(nx), indexing="ij")
    a = (j * (nx + 1) + i).reshape(-1)
    b = a + 1
    c = a + (nx + 1)
    d = c + 1
    idx = np.stack([np.stack([a, c, b], 1), np.stack([b, c, d], 1)], 1)
    return _mesh(pos, nrm, uv, idx.reshape(-1, 3), mat)


def _fbm(nx: int, nz: int, octaves: int, seed: int) -> np.ndarray:
    """Fractal value noise on an (nz+1, nx+1) grid, in [-1, 1]."""
    rng = np.random.default_rng(seed)
    h = np.zeros((nz + 1, nx + 1), np.float64)
    amp, freq = 1.0, 4
    total = 0.0
    for _ in range(octaves):
        g = rng.standard_normal((freq + 1, freq + 1))
        yi = np.linspace(0, freq, nz + 1)
        xi = np.linspace(0, freq, nx + 1)
        y0 = np.clip(yi.astype(int), 0, freq - 1)
        x0 = np.clip(xi.astype(int), 0, freq - 1)
        fy = (yi - y0)[:, None]
        fx = (xi - x0)[None, :]
        fy = fy * fy * (3 - 2 * fy)  # smoothstep
        fx = fx * fx * (3 - 2 * fx)
        g00 = g[np.ix_(y0, x0)]
        g01 = g[np.ix_(y0, x0 + 1)]
        g10 = g[np.ix_(y0 + 1, x0)]
        g11 = g[np.ix_(y0 + 1, x0 + 1)]
        h += amp * ((g00 * (1 - fx) + g01 * fx) * (1 - fy) + (g10 * (1 - fx) + g11 * fx) * fy)
        total += amp
        amp *= 0.5
        freq *= 2
    h /= total
    return (h / max(np.abs(h).max(), 1e-9)).astype(np.float64)


def terrain(nx: int = 224, nz: int = 224, size: float = 40.0, height: float = 4.0,
            octaves: int = 5, seed: int = 7, mat: int = 0) -> Mesh:
    """Heightmap terrain, 2*nx*nz triangles, smooth normals from central
    differences. nx = nz = 224 is config3's 100,352 triangles."""
    base = grid_plane(nx, nz, size, mat)
    h = _fbm(nx, nz, octaves, seed) * height
    pos = base.positions.reshape(nz + 1, nx + 1, 3).copy()
    pos[:, :, 1] = h
    gy, gx = np.gradient(h, size / nz, size / nx)
    n = np.stack([-gx, np.ones_like(h), -gy], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return Mesh(
        positions=pos.reshape(-1, 3).astype(np.float32),
        normals=n.reshape(-1, 3).astype(np.float32),
        uvs=base.uvs * np.float32(nx / 16.0),  # tile the texture
        indices=base.indices,
        material_id=base.material_id,
        transform_id=base.transform_id,
    )


def merge_meshes(meshes, transform_ids=None) -> Mesh:
    """Concatenate meshes into one triangle soup; optional per-mesh
    transform ids select rows of Scene.model_matrices."""
    off = 0
    pos, nrm, uv, idx, mid, tid = [], [], [], [], [], []
    for k, m in enumerate(meshes):
        pos.append(m.positions)
        nrm.append(m.normals)
        uv.append(m.uvs)
        idx.append(m.indices + off)
        mid.append(m.material_id)
        t = transform_ids[k] if transform_ids is not None else 0
        tid.append(np.full(m.positions.shape[0], t, np.int32))
        off += m.positions.shape[0]
    return Mesh(
        positions=np.concatenate(pos),
        normals=np.concatenate(nrm),
        uvs=np.concatenate(uv),
        indices=np.concatenate(idx),
        material_id=np.concatenate(mid),
        transform_id=np.concatenate(tid),
    )


def transformed(mesh: Mesh, matrix: np.ndarray) -> Mesh:
    """Bake a rigid or uniform-scale transform into the vertex data."""
    m = np.asarray(matrix, np.float32)
    p4 = np.concatenate(
        [mesh.positions, np.ones((mesh.positions.shape[0], 1), np.float32)], 1
    )
    pos = (p4 @ m.T)[:, :3]
    nrm = mesh.normals @ m[:3, :3].T
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    return mesh.replace(positions=pos.astype(np.float32), normals=nrm.astype(np.float32))


def vert_mat(mesh: Mesh) -> np.ndarray:
    """Per-vertex material id: the lowest material id among the triangles
    using the vertex (0 for unused vertices). Order-independent min."""
    V = mesh.num_vertices
    idx = np.asarray(mesh.indices).reshape(-1)
    val = np.repeat(np.asarray(mesh.material_id), 3).astype(np.int32)
    out = np.full((V,), 2**30, np.int32)
    np.minimum.at(out, idx, val)
    return np.where(out == 2**30, 0, out).astype(np.int32)


def with_vert_mat(mesh: Mesh) -> Mesh:
    """Attach the scene-static per-vertex material id (host precompute)."""
    return mesh.replace(vert_mat=vert_mat(mesh))


def fbm_at(u, v, octaves: int, seed: int):
    """The fractal value noise of _fbm (before its normalization) at
    arbitrary normalized coordinates u, v in [0, 1] (arrays): the lattices
    come from the same rng sequence, so LOD rings of different resolutions
    sample one continuous terrain (terrain_lod)."""
    rng = np.random.default_rng(seed)
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    h = np.zeros(np.broadcast(u, v).shape, np.float64)
    amp, freq = 1.0, 4
    total = 0.0
    for _ in range(octaves):
        g = rng.standard_normal((freq + 1, freq + 1))
        yi = v * freq
        xi = u * freq
        y0 = np.clip(yi.astype(int), 0, freq - 1)
        x0 = np.clip(xi.astype(int), 0, freq - 1)
        fy = yi - y0
        fx = xi - x0
        fy = fy * fy * (3 - 2 * fy)
        fx = fx * fx * (3 - 2 * fx)
        g00 = g[y0, x0]
        g01 = g[y0, x0 + 1]
        g10 = g[y0 + 1, x0]
        g11 = g[y0 + 1, x0 + 1]
        h += amp * (
            (g00 * (1 - fx) + g01 * fx) * (1 - fy)
            + (g10 * (1 - fx) + g11 * fx) * fy
        )
        total += amp
        amp *= 0.5
        freq *= 2
    return h / total


def terrain_lod(
    n0: int = 160,
    size0: float = 30.0,
    rings: int = 3,
    height: float = 5.0,
    octaves: int = 6,
    seed: int = 13,
    mat: int = 0,
) -> Mesh:
    """Chunked heightmap-LOD terrain (config7's mesh; 177,920 triangles at
    the default n0=160, rings=3).

    Geometry-clipmap layout with STATIC shapes (fixed per-ring budgets):
    ring 0 is an n0 x n0 grid over [-size0/2, size0/2]^2; each outer ring
    doubles the covered extent at the same n0 x n0 budget (so its cell
    size doubles) and omits the cells its inner rings already cover. All
    rings sample ONE continuous fbm surface (fbm_at), and every ring's
    outer border grows a downward SKIRT strip that hides the T-junction
    cracks where a fine ring's half-step edge vertices meet the coarser
    ring — the classic clipmap treatment, chosen over edge stitching
    because it keeps every ring an independent fixed-budget chunk.

    Coverage economics (the reason LOD exists): rings=3 covers the
    full-density-equivalent of a (8*n0)^2 grid — ~3.3M triangles at
    n0=160 — in ~170k.
    """
    world = size0 * (2.0**rings)  # full extent of the outermost ring
    pieces = []
    for k in range(rings + 1):
        ext = size0 * (2.0**k)
        cell = ext / n0
        xs = np.linspace(-ext / 2, ext / 2, n0 + 1)
        gx, gz = np.meshgrid(xs, xs, indexing="xy")
        # cell centers inside the previous ring's extent are skipped
        cx = (gx[:-1, :-1] + gx[1:, 1:]) * 0.5
        cz = (gz[:-1, :-1] + gz[1:, 1:]) * 0.5
        if k == 0:
            keep = np.ones_like(cx, bool)
        else:
            inner = size0 * (2.0 ** (k - 1)) / 2
            keep = (np.abs(cx) > inner - 1e-6) | (np.abs(cz) > inner - 1e-6)

        u = gx / world + 0.5
        v = gz / world + 0.5
        hgt = fbm_at(u, v, octaves, seed) * height
        pos = np.stack([gx, hgt, gz], axis=-1).reshape(-1, 3)
        # analytic-ish normals by central differences of the SHARED surface
        eps = cell / world
        hx = (
            fbm_at(np.clip(u + eps, 0, 1), v, octaves, seed)
            - fbm_at(np.clip(u - eps, 0, 1), v, octaves, seed)
        ) * height / (2 * eps * world)
        hz = (
            fbm_at(u, np.clip(v + eps, 0, 1), octaves, seed)
            - fbm_at(u, np.clip(v - eps, 0, 1), octaves, seed)
        ) * height / (2 * eps * world)
        nrm = np.stack([-hx, np.ones_like(hx), -hz], axis=-1)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)

        uv = np.stack([u, v], axis=-1).reshape(-1, 2) * (world / 4.0)

        idx = []
        W = n0 + 1
        jj, ii = np.where(keep)
        for j, i in zip(jj, ii):
            a = j * W + i
            idx += [(a, a + W, a + 1), (a + 1, a + W, a + W + 1)]

        # SKIRTS hide T-junction cracks: at a ring boundary the fine
        # ring's half-step border vertex and the coarse ring's straight
        # edge disagree by the fbm curvature, opening a sliver to either
        # side. A downward strip from the FINE ring's outer border covers
        # slivers where the fine vertex is above the coarse edge; one
        # from the COARSE ring's inner-hole border covers the opposite
        # sign. Both are emitted with both windings (cull_backfaces on).
        pos_l = [pos]
        nrm_l = [nrm.reshape(-1, 3)]
        uv_l = [uv]

        def skirt(edges):
            border = np.unique(
                np.concatenate([np.asarray(e, np.int64) for e in edges])
            )
            bpos = pos[border].copy()
            bpos[:, 1] -= height  # drop below any surface point
            base_n = sum(p.shape[0] for p in pos_l)
            pos_l.append(bpos)
            nrm_l.append(nrm.reshape(-1, 3)[border])
            uv_l.append(uv[border])
            remap = {int(b): base_n + t for t, b in enumerate(border)}
            for edge in edges:
                for t in range(len(edge) - 1):
                    a, b = edge[t], edge[t + 1]
                    da, db = remap[a], remap[b]
                    idx.extend(
                        [(a, b, da), (b, db, da), (a, da, b), (b, da, db)]
                    )

        e = n0
        if k < rings:  # outer border (meets the next-coarser ring)
            skirt(
                [
                    [0 * W + i for i in range(n0 + 1)],
                    [e * W + i for i in range(n0 + 1)],
                    [i * W + 0 for i in range(n0 + 1)],
                    [i * W + e for i in range(n0 + 1)],
                ]
            )
        if k > 0:  # inner-hole border (meets the next-finer ring)
            assert n0 % 4 == 0, "terrain_lod needs n0 divisible by 4"
            lo, hi = n0 // 4, 3 * n0 // 4
            rng_ = range(lo, hi + 1)
            skirt(
                [
                    [lo * W + i for i in rng_],
                    [hi * W + i for i in rng_],
                    [i * W + lo for i in rng_],
                    [i * W + hi for i in rng_],
                ]
            )

        m = _mesh(
            np.concatenate(pos_l),
            np.concatenate(nrm_l),
            np.concatenate(uv_l),
            idx,
            mat,
        )
        pieces.append(m)
    return merge_meshes(pieces)
