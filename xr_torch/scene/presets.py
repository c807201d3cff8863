"""Presets of the port (port of ``xr/scene/presets.py``): config1 (flat
cube), config2 (Gouraud icospheres), config3 (the headline textured
terrain), config4 (Phong with a shadow map), config4b (config4 with two
blended panes) and ``small_preset``. A preset bundles a host-side numpy Scene,
``animate(t)`` returning numpy (Camera, model matrices), and the
RenderConfig; ``xr_torch.convert.scene_to_torch`` moves the scene onto a
device. The host matrix builders give the bits of the reference's numpy
ones."""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np

from xr_torch.core.types import (
    MODE_FLAT,
    MODE_GOURAUD,
    MODE_PHONG,
    MODE_TEXTURED,
    Camera,
    Lights,
    Material,
    RenderConfig,
    Scene,
)
from xr_torch.scene import procedural as proc
from xr_torch.scene import texture as tx


class Preset(NamedTuple):
    name: str
    scene: Scene
    animate: Callable  # t -> (Camera, model_matrices), numpy f32
    config: RenderConfig


def _identity_mats(n=1):
    return np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))


def _mat4(rows) -> np.ndarray:
    return np.stack([np.stack(r) for r in rows]).astype(np.float32)


def rotation_x(angle) -> np.ndarray:
    angle = np.asarray(angle, np.float32)
    c, s = np.cos(angle), np.sin(angle)
    o, i = np.zeros((), np.float32), np.ones((), np.float32)
    return _mat4([[i, o, o, o], [o, c, -s, o], [o, s, c, o], [o, o, o, i]])


def rotation_y(angle) -> np.ndarray:
    angle = np.asarray(angle, np.float32)
    c, s = np.cos(angle), np.sin(angle)
    o, i = np.zeros((), np.float32), np.ones((), np.float32)
    return _mat4([[c, o, s, o], [o, i, o, o], [-s, o, c, o], [o, o, o, i]])


def translation(v) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(v, np.float32)
    return m


def config1_cube() -> Preset:
    """Config 1: a spinning flat-shaded cube (12 triangles), 512x512, depth
    test on; brute-force visibility (capacity 79 <= 2048)."""
    scene = Scene(
        mesh=proc.cube(1.2),
        materials=Material.table([{"base_color": (0.9, 0.35, 0.25)}]),
        textures=None,
        lights=Lights.make(
            dir_dirs=[(-0.5, -0.7, -0.5)],
            dir_colors=[(1.0, 1.0, 1.0)],
            ambient=(0.15, 0.15, 0.15),
        ),
        model_matrices=_identity_mats(),
    )

    def animate(t):
        model = rotation_y(t * 0.9) @ rotation_x(t * 0.37)
        cam = Camera(
            eye=np.asarray((1.9, 1.4, 2.6), np.float32),
            target=np.asarray((0.0, 0.0, 0.0), np.float32),
            up=np.asarray((0.0, 1.0, 0.0), np.float32),
            fov_y=np.asarray(np.deg2rad(50.0), np.float32),
            near=np.asarray(0.1, np.float32),
            far=np.asarray(20.0, np.float32),
        )
        return cam, model[None].astype(np.float32)

    cfg = RenderConfig(width=512, height=512, mode=MODE_FLAT, depth_test=True)
    return Preset("config1_cube", scene, animate, cfg)


def config2_icospheres() -> Preset:
    """Config 2: a 6x6 grid of Gouraud-lit icospheres (11,520 triangles),
    one directional light, 1920x1080, 128x128 tiles, bin_capacity 2048."""
    spheres = []
    for k in range(36):
        gz, gx = divmod(k, 6)
        s = proc.icosphere(2, radius=0.55, mat=k % 4)
        m = translation(((gx - 2.5) * 1.5, 0.0, (gz - 2.5) * 1.5))
        spheres.append(proc.transformed(s, m))
    scene = Scene(
        mesh=proc.with_vert_mat(proc.merge_meshes(spheres)),
        materials=Material.table(
            [
                {"base_color": (0.85, 0.3, 0.3)},
                {"base_color": (0.3, 0.8, 0.4)},
                {"base_color": (0.3, 0.45, 0.9)},
                {"base_color": (0.9, 0.8, 0.3)},
            ]
        ),
        textures=None,
        lights=Lights.make(
            dir_dirs=[(-0.4, -0.8, -0.45)],
            dir_colors=[(1.0, 0.98, 0.9)],
            ambient=(0.12, 0.12, 0.14),
        ),
        model_matrices=_identity_mats(),
    )

    def animate(t):
        ang = np.asarray(t * 0.25, np.float32)
        eye = np.stack(
            [7.5 * np.cos(ang), np.asarray(4.5, np.float32), 7.5 * np.sin(ang)]
        )
        cam = Camera(
            eye=eye.astype(np.float32),
            target=np.asarray((0.0, 0.0, 0.0), np.float32),
            up=np.asarray((0.0, 1.0, 0.0), np.float32),
            fov_y=np.asarray(np.deg2rad(55.0), np.float32),
            near=np.asarray(0.2, np.float32),
            far=np.asarray(60.0, np.float32),
        )
        return cam, _identity_mats()

    cfg = RenderConfig(width=1920, height=1080, mode=MODE_GOURAUD,
                       tile_h=128, tile_w=128, bin_capacity=2048)
    return Preset("config2_icospheres", scene, animate, cfg)


def config3_terrain(nx: int = 224, nz: int = 224) -> Preset:
    """Config 3: a textured heightmap terrain of 2*nx*nz triangles (100,352
    at the default 224x224) with trilinear mip-mapped sampling, 1920x1080,
    32x128 tiles, orbiting camera."""
    mesh = proc.with_vert_mat(proc.terrain(nx, nz, size=40.0, height=4.0))
    pyramid = tx.build_pyramid([tx.checkerboard(256, 16), tx.noise_texture(256)])
    scene = Scene(
        mesh=mesh,
        materials=Material.table([{"base_color": (1.0, 1.0, 1.0), "tex_id": 0}]),
        textures=pyramid,
        lights=Lights.make(
            dir_dirs=[(-0.35, -0.8, -0.5)],
            dir_colors=[(1.0, 0.97, 0.9)],
            ambient=(0.18, 0.18, 0.2),
        ),
        model_matrices=_identity_mats(),
    )

    def animate(t):
        ang = np.asarray(t * 0.12, np.float32)
        tf = np.asarray(t, np.float32)
        eye = np.stack(
            [14.0 * np.cos(ang), np.asarray(7.0, np.float32) + 0.0 * tf, 14.0 * np.sin(ang)]
        )
        cam = Camera(
            eye=eye.astype(np.float32),
            target=np.asarray((0.0, 0.0, 0.0), np.float32),
            up=np.asarray((0.0, 1.0, 0.0), np.float32),
            fov_y=np.asarray(np.deg2rad(55.0), np.float32),
            near=np.asarray(0.3, np.float32),
            far=np.asarray(120.0, np.float32),
        )
        return cam, _identity_mats()

    cfg = RenderConfig(width=1920, height=1080, mode=MODE_TEXTURED,
                       tile_h=32, tile_w=128, bin_capacity=3072,
                       clip_budget=1024, clip_expand=0.50,
                       stream_expand=1.3, stream_block=128)
    return Preset("config3_terrain", scene, animate, cfg)


def config4_phong() -> Preset:
    """Config 4 (``xr/scene/presets.py:174-249``): a 24x24 ground grid with
    four cubes and four icospheres placed by seeded draws (rng 11, resampled
    until no two overlap), four materials, two directional and two point
    lights, Blinn-Phong with a 1024x1024 shadow map; 1920x1080,
    bin_capacity 4096 — a two-pass frame."""
    objs = [proc.grid_plane(24, 24, size=14.0, mat=0)]
    tids = [0]
    rng = np.random.default_rng(11)
    placed: list = []
    for i in range(8):
        # the reference's draws, in its order: a position until it clears
        # every placed one by 2.0, then (cubes) the rotation angle
        while True:
            x, z = rng.uniform(-4.5, 4.5, 2)
            if all((x - qx) ** 2 + (z - qz) ** 2 >= 4.0 for qx, qz in placed):
                break
        placed.append((float(x), float(z)))
        if i % 2 == 0:
            s = proc.cube(1.0, mat=1 + (i % 3))
            m = translation((x, 0.55, z)) @ rotation_y(float(rng.uniform(0, 3.14)))
        else:
            s = proc.icosphere(2, 0.65, mat=1 + (i % 3))
            m = translation((x, 0.7, z))
        objs.append(proc.transformed(s, m))
        tids.append(0)
    scene = Scene(
        mesh=proc.merge_meshes(objs, tids),
        materials=Material.table(
            [
                {"base_color": (0.75, 0.75, 0.78), "ks": 0.1, "shininess": 16.0},
                {"base_color": (0.85, 0.25, 0.2), "ks": 0.6, "shininess": 48.0},
                {"base_color": (0.2, 0.6, 0.85), "ks": 0.6, "shininess": 64.0},
                {"base_color": (0.95, 0.8, 0.25), "ks": 0.8, "shininess": 96.0},
            ]
        ),
        textures=None,
        lights=Lights.make(
            dir_dirs=[(-0.45, -0.75, -0.35), (0.6, -0.5, 0.4)],
            dir_colors=[(0.95, 0.92, 0.85), (0.25, 0.28, 0.35)],
            pt_pos=[(3.0, 3.0, -3.0), (-3.5, 2.5, 3.0)],
            pt_colors=[(0.9, 0.55, 0.3), (0.3, 0.5, 0.9)],
            ambient=(0.08, 0.08, 0.1),
        ),
        model_matrices=_identity_mats(),
    )

    def animate(t):
        ang = np.asarray(0.8 + t * 0.2, np.float32)
        eye = np.stack(
            [11.0 * np.cos(ang), np.asarray(6.0, np.float32), 11.0 * np.sin(ang)]
        )
        cam = Camera(
            eye=eye.astype(np.float32),
            target=np.asarray((0.0, 0.5, 0.0), np.float32),
            up=np.asarray((0.0, 1.0, 0.0), np.float32),
            fov_y=np.asarray(np.deg2rad(50.0), np.float32),
            near=np.asarray(0.2, np.float32),
            far=np.asarray(80.0, np.float32),
        )
        return cam, _identity_mats()

    cfg = RenderConfig(width=1920, height=1080, mode=MODE_PHONG, shadow_map_size=1024,
                       bin_capacity=4096)
    return Preset("config4_phong", scene, animate, cfg)


def config4_blend() -> Preset:
    """Config 4b (``xr/scene/presets.py:252-289``): config4 plus two
    overlapping transparent panes above it (alpha 0.55 and 0.4), appended
    back to front (lower pane first) — source order is composite order;
    blend on, blend_capacity 32."""
    base = config4_phong()
    pane_lo = proc.transformed(proc.grid_plane(1, 1, size=7.0, mat=4),
                               translation((0.5, 1.6, -0.3)))
    pane_hi = proc.transformed(proc.grid_plane(1, 1, size=5.0, mat=5),
                               translation((-0.6, 2.6, 0.4)))
    mesh = proc.merge_meshes([base.scene.mesh, pane_lo, pane_hi], [0, 0, 0])
    mats = base.scene.materials
    rows = [
        {
            "base_color": tuple(np.asarray(mats.base_color[i])),
            "ka": float(mats.ka[i]),
            "kd": float(mats.kd[i]),
            "ks": float(mats.ks[i]),
            "shininess": float(mats.shininess[i]),
            "tex_id": int(mats.tex_id[i]),
        }
        for i in range(mats.base_color.shape[0])
    ] + [
        {"base_color": (0.9, 0.3, 0.25), "ks": 0.3, "shininess": 32.0, "alpha": 0.55},
        {"base_color": (0.25, 0.45, 0.95), "ks": 0.3, "shininess": 32.0, "alpha": 0.4},
    ]
    scene = base.scene.replace(mesh=mesh, materials=Material.table(rows))
    cfg = dataclasses.replace(base.config, blend=True, blend_capacity=32)
    return Preset("config4_blend", scene, base.animate, cfg)


def small_preset(preset: Preset, width=160, height=120, **overrides) -> Preset:
    """Shrink a preset's framebuffer (tests, goldens)."""
    cfg = dataclasses.replace(preset.config, width=width, height=height, **overrides)
    return Preset(preset.name, preset.scene, preset.animate, cfg)


ALL_PRESETS = {
    "config1": config1_cube,
    "config2": config2_icospheres,
    "config3": config3_terrain,
    "config4": config4_phong,
    "config4b": config4_blend,
}
