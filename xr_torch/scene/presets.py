"""Presets of the port (port of ``xr/scene/presets.py``): config1 (flat
cube), config2 (Gouraud icospheres), config3 (the headline textured
terrain), config4 (Phong with a shadow map), config4b (config4 with two
blended panes), config5 (the deep fly-through scene), config6 and
config6cap (the courtyard loaded from its OBJ, MTL and PNG files), config7
(the LOD terrain with measured capacities) and ``small_preset``. A preset
bundles a host-side numpy Scene, ``animate(t)`` returning numpy (Camera,
model matrices), and the RenderConfig; ``xr_torch.convert.scene_to_torch`` moves the scene onto a
device. The host matrix builders give the bits of the reference's numpy
ones."""

from __future__ import annotations

import dataclasses
import os
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
from xr_torch.core import math3d as m3
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


def scaling(v) -> np.ndarray:
    return m3.scaling(v, "cpu").numpy()


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


def config5_flythrough(nx: int = 708, nz: int = 708) -> Preset:
    """Config 5 (``xr/scene/presets.py:292-370``): a fly-through of a deep
    scene, a textured 2*nx*nz-triangle terrain (1,002,528 at the default
    708x708) with 40 scaled boxes on it for occlusion; 1920x1080, 32x128
    tiles, in 4 screen bands (num_shards=4) through
    ``xr_torch.dist.shard.ShardedRenderer``, as the reference shards it."""
    terrain = proc.terrain(nx, nz, size=120.0, height=7.0, octaves=6, seed=13)
    rng = np.random.default_rng(5)
    objs = [terrain]
    for _ in range(40):
        # the reference's draws, in its order: position, height, footprint
        x, z = rng.uniform(-40, 40, 2)
        h = float(rng.uniform(1.5, 6.0))
        b = proc.cube(1.0, mat=1)
        m = translation((x, h * 0.5 + 1.0, z)) @ scaling(
            (rng.uniform(1, 4), h, rng.uniform(1, 4))
        )
        objs.append(proc.transformed(b, m))
    mesh = proc.with_vert_mat(proc.merge_meshes(objs))
    pyramid = tx.build_pyramid([tx.noise_texture(256, seed=9), tx.checkerboard(256, 8)])
    scene = Scene(
        mesh=mesh,
        materials=Material.table(
            [
                {"base_color": (1.0, 1.0, 1.0), "tex_id": 0},
                {"base_color": (0.9, 0.85, 0.8), "tex_id": 1},
            ]
        ),
        textures=pyramid,
        lights=Lights.make(
            dir_dirs=[(-0.3, -0.75, -0.55)],
            dir_colors=[(1.0, 0.96, 0.88)],
            ambient=(0.2, 0.2, 0.22),
        ),
        model_matrices=_identity_mats(),
    )

    def animate(t):
        tf = np.asarray(t, np.float32)
        ang = tf * 0.1
        eye = np.stack(
            [30.0 * np.cos(ang), 9.0 + 2.0 * np.sin(tf * 0.31), 30.0 * np.sin(ang)]
        )
        tgt = np.stack([12.0 * np.cos(ang + 0.7), 2.0 + 0.0 * tf, 12.0 * np.sin(ang + 0.7)])
        cam = Camera(
            eye=eye.astype(np.float32),
            target=tgt.astype(np.float32),
            up=np.asarray((0.0, 1.0, 0.0), np.float32),
            fov_y=np.asarray(np.deg2rad(60.0), np.float32),
            near=np.asarray(0.3, np.float32),
            far=np.asarray(300.0, np.float32),
        )
        return cam, _identity_mats()

    # The camera path is frozen and the record capacity is deliberately
    # tight: the path's peak is ~390k post-cull triangles of 1.0M in,
    # clip_expand 0.43 gives ~431k (about 1.1x). The overflow counters are
    # loud if a retargeted path or mesh exceeds it; then re-measure the peak
    # and keep >= 1.2x headroom. z_earlyout: a deep scene of mostly fully
    # covered tiles (the flags cannot change the output).
    cfg = RenderConfig(
        width=1920, height=1080, mode=MODE_TEXTURED, num_shards=4,
        tile_h=32, tile_w=128, bin_capacity=16384, large_capacity=4096,
        clip_budget=8192, clip_expand=0.43, stream_expand=1.2, stream_block=256,
        z_earlyout=True,
    )
    return Preset("config5_flythrough", scene, animate, cfg)


def _courtyard_dir() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "assets", "courtyard")


def config6_asset(assets_dir: str = None, max_tex_rows: int = None) -> Preset:
    """Config 6 (``xr/scene/presets.py:373-441``): the loaded-asset scene, a
    96,456-triangle multi-material courtyard read from disk through the
    whole asset path (OBJ -> MTL -> map_Kd PNGs of three sizes, one of them
    clamped -> a ragged mip pyramid), Phong with a 1024^2 shadow map,
    1920x1080. The assets are read from `assets_dir` (default: the
    repository's ``assets/courtyard``) and never generated:
    FileNotFoundError if the OBJ is missing. max_tex_rows is the
    texture-area cap of build_ragged_pyramid (None = native quality)."""
    from xr_torch.scene.objio import load_obj_scene

    if assets_dir is None:
        assets_dir = _courtyard_dir()
    obj_path = os.path.join(assets_dir, "courtyard.obj")
    if not os.path.exists(obj_path):
        raise FileNotFoundError(f"courtyard asset not found: {obj_path}")

    scene = load_obj_scene(
        obj_path,
        lights=Lights.make(
            dir_dirs=[(-0.4, -0.85, -0.3), (0.5, -0.4, 0.6)],
            dir_colors=[(1.0, 0.96, 0.88), (0.18, 0.2, 0.26)],
            ambient=(0.16, 0.16, 0.18),
        ),
        max_tex_rows=max_tex_rows,
    )

    def animate(t):
        tf = np.asarray(t, np.float32)
        ang = 0.6 + tf * 0.15
        eye = np.stack(
            [13.0 * np.cos(ang), 5.5 + 0.8 * np.sin(tf * 0.4), 13.0 * np.sin(ang)]
        )
        cam = Camera(
            eye=eye.astype(np.float32),
            target=np.asarray((0.0, 1.8, 0.0), np.float32),
            up=np.asarray((0.0, 1.0, 0.0), np.float32),
            fov_y=np.asarray(np.deg2rad(55.0), np.float32),
            near=np.asarray(0.3, np.float32),
            far=np.asarray(90.0, np.float32),
        )
        return cam, _identity_mats()

    # large_capacity 4096: the light-view depth pass bins the scene again at
    # shadow-map resolution, where more courtyard walls span over 2x2 tiles
    # than the default large bucket (1024) holds
    cfg = RenderConfig(
        width=1920, height=1080, mode=MODE_PHONG, shadow_map_size=1024,
        tile_h=32, tile_w=128, bin_capacity=8192, clip_budget=4096,
        large_capacity=4096, clip_expand=1.0, stream_expand=1.5, stream_block=256,
    )
    return Preset("config6_asset", scene, animate, cfg)


def config6_capped() -> Preset:
    """Config 6 under a texture-area cap of 300,000 quad-table rows: the 512
    map renders from its own first mip, the other two are untouched (the
    reference measured 39.1 dB PSNR against native at 480x270). The pair
    config6/config6cap is the on/off comparison of the cap."""
    p = config6_asset(max_tex_rows=300_000)
    return Preset("config6cap", p.scene, p.animate, p.config)


def config7_terrain_lod(n0: int = 160, rings: int = 3, device="cuda") -> Preset:
    """Config 7 (``xr/scene/presets.py:454-525``): a fly-through of the
    chunked LOD terrain (``procedural.terrain_lod``, 177,920 triangles at
    n0=160, rings=3: clipmap rings that double their cell size outwards,
    with skirts over the ring seams), textured, 1920x1080, 32x128 tiles,
    z_earlyout. The camera flies low through the rings, so near-plane
    clipping and mixed cell sizes meet in one frame; every capacity is
    measured by ``xr_torch.app.autosize`` over t = 0, 13, 26, 39 with margin
    1.6, the dry pass running on `device`."""
    mesh = proc.with_vert_mat(proc.terrain_lod(n0=n0, rings=rings))
    pyramid = tx.build_pyramid([tx.noise_texture(256, seed=21), tx.checkerboard(256, 8)])
    scene = Scene(
        mesh=mesh,
        materials=Material.table([{"base_color": (0.95, 0.95, 0.9), "tex_id": 0}]),
        textures=pyramid,
        lights=Lights.make(
            dir_dirs=[(-0.35, -0.8, -0.5)],
            dir_colors=[(1.0, 0.97, 0.9)],
            ambient=(0.22, 0.22, 0.24),
        ),
        model_matrices=_identity_mats(),
    )
    world = 30.0 * (2.0**rings)

    def animate(t):
        tf = np.asarray(t, np.float32)
        ang = tf * 0.08
        r = 0.36 * world  # inside the outer ring, crossing ring boundaries
        eye = np.stack([r * np.cos(ang), 6.5 + 1.5 * np.sin(tf * 0.23), r * np.sin(ang)])
        tgt = np.stack([0.12 * world * np.cos(ang + 1.1), 1.0 + 0.0 * tf,
                        0.12 * world * np.sin(ang + 1.1)])
        cam = Camera(
            eye=eye.astype(np.float32),
            target=tgt.astype(np.float32),
            up=np.asarray((0.0, 1.0, 0.0), np.float32),
            fov_y=np.asarray(np.deg2rad(62.0), np.float32),
            near=np.asarray(0.3, np.float32),
            far=np.asarray(400.0, np.float32),
        )
        return cam, _identity_mats()

    from xr_torch.app.autosize import autosize_config

    base = RenderConfig(width=1920, height=1080, mode=MODE_TEXTURED, tile_h=32, tile_w=128,
                        z_earlyout=True)
    cams = [animate(t)[0] for t in (0.0, 13.0, 26.0, 39.0)]
    cfg = autosize_config(scene, cams, base, margin=1.6, device=device)
    return Preset("config7_terrain_lod", scene, animate, cfg)


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
    "config5": config5_flythrough,
    "config6": config6_asset,
    "config6cap": config6_capped,
    "config7": config7_terrain_lod,
}
