"""The depth-complexity cases of the z gate's measurement: 16 stacked planes.

``layers16()`` is 16 copies of ``procedural.grid_plane(56, 56, size=40)``
(16 x 6,272 = 100,352 triangles, config3's count) at y = 0, -0.5, ...,
-7.5, merged top plane first, so that ids run front to back, seen from
(0, 10, 0) straight down (up (0, 0, -1)) with config3's 55 degree fov,
near 0.3 and far 120: every plane covers the whole 1920x1080 frame, a
depth complexity of 16. ``layers16(reverse=True)`` merges the planes
bottom first, so ids run back to front: the gate's worst case, with
nothing to skip in id order. Under ``bin_zorder`` the prep sorts each
tile's segment front to back again.

The config is config3's (32x128 tiles, ``stream_block`` 128) with
``z_earlyout``, and two capacities raised from config3's so that every
overflow counter reads 0 at 1920x1080: ``clip_budget`` 1024 -> 1536 (1,344
triangles cross the frustum's sides, 84 a plane) and ``medium_capacity``
2048 -> 14336 (13,812 triangles span more than 2x2 tiles and fewer than
8x8; past the medium class they would ride the large bucket, which holds
1,024). These are tool data for ``sweep_visibility`` and
``chip_smoke.py``, not a preset of the renderer.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from xr_torch.core.types import Camera
from xr_torch.scene import presets
from xr_torch.scene import procedural as proc

PLANES = 16
SPACING = 0.5  # world units between two planes


def layers16(reverse: bool = False) -> presets.Preset:
    """The stacked planes as a Preset (config3's materials, textures and
    lights); ``animate(t)`` ignores t: the camera does not move."""
    base = presets.config3_terrain(8, 8)
    plane = proc.grid_plane(56, 56, size=40.0)
    ys = [-SPACING * k for k in range(PLANES)]
    if reverse:
        ys = ys[::-1]
    mesh = proc.with_vert_mat(proc.merge_meshes(
        [proc.transformed(plane, presets.translation((0.0, y, 0.0))) for y in ys]))
    scene = base.scene.replace(mesh=mesh)

    def animate(t):
        cam = Camera(
            eye=np.asarray((0.0, 10.0, 0.0), np.float32),
            target=np.asarray((0.0, 0.0, 0.0), np.float32),
            up=np.asarray((0.0, 0.0, -1.0), np.float32),
            fov_y=np.asarray(np.deg2rad(55.0), np.float32),
            near=np.asarray(0.3, np.float32),
            far=np.asarray(120.0, np.float32),
        )
        return cam, presets._identity_mats()

    cfg = dataclasses.replace(base.config, z_earlyout=True, clip_budget=1536,
                              medium_capacity=14336)
    name = "layers16_rev" if reverse else "layers16"
    return presets.Preset(name, scene, animate, cfg)
