"""The frame's host matrices: the camera's view and projection, and the
shadow pass's light matrices (port of ``xr/pipeline/shadow.py:17-48``):
the directional light's view and orthographic projection, fit to the
scene's world bounds.

Host numpy on purpose: the matrices are inputs of the frame, computed with
numpy's f32 arithmetic in the reference's op order, so they equal the
reference's bit for bit and every device renders from the same bits.
(``torch.tan`` on the CPU, on CUDA and numpy's ``tan`` differ by an ulp at
some angles, config5's 60 and config7's 62 degree fov among them, and one
ulp in the projection moves snapped vertices: F12.) The depth-only pass
itself is the normal pipeline in MODE_DEPTH_ONLY seen from the light.
"""

from __future__ import annotations

import numpy as np

from xr_torch.convert import to_numpy
from xr_torch.core import math3d as m3
from xr_torch.core.types import Scene


def _normalize(v, eps=1e-20):
    n = np.sqrt(np.sum(v * v, axis=-1, keepdims=True))
    return v / np.maximum(n, eps)


def _cross(a, b):
    return np.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def look_at_np(eye, target, up) -> np.ndarray:
    """numpy ``look_at`` (``xr/core/math3d.py:57``) with the reference's
    f32 op order."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    z = _normalize(eye - target)
    x = _normalize(_cross(up, z))
    y = _cross(z, x)
    zero, one = np.zeros((), np.float32), np.ones((), np.float32)
    rows = [
        [x[0], x[1], x[2], -np.sum(x * eye, axis=-1)],
        [y[0], y[1], y[2], -np.sum(y * eye, axis=-1)],
        [z[0], z[1], z[2], -np.sum(z * eye, axis=-1)],
        [zero, zero, zero, one],
    ]
    return np.stack([np.stack(r) for r in rows]).astype(np.float32)


def orthographic_np(left, right, bottom, top, near, far) -> np.ndarray:
    """numpy ``orthographic`` (``xr/core/math3d.py:106``)."""
    return m3.orthographic(left, right, bottom, top, near, far, "cpu").numpy()


def perspective_np(fov_y, aspect, near, far) -> np.ndarray:
    """numpy ``perspective`` (``xr/core/math3d.py:81``) with the reference's
    f32 op order."""
    fov_y, near, far = (to_numpy(v, np.float32) for v in (fov_y, near, far))
    f = np.float32(1.0) / np.tan(fov_y * np.float32(0.5))
    a = far / (near - far)
    b = near * far / (near - far)
    z = np.zeros((), np.float32)
    rows = [[f / np.float32(aspect), z, z, z], [z, f, z, z], [z, z, a, b],
            [z, z, -np.ones((), np.float32), z]]
    return np.stack([np.stack(r) for r in rows]).astype(np.float32)


def camera_matrices_np(camera, aspect):
    """(view, proj) of a Camera (array-like or tensor leaves) as numpy f32,
    bit-equal to the reference's numpy camera_matrices."""
    eye, target, up = (to_numpy(getattr(camera, k)) for k in ("eye", "target", "up"))
    return look_at_np(eye, target, up), perspective_np(camera.fov_y, aspect, camera.near,
                                                       camera.far)


def scene_world_bounds(scene: Scene):
    """(center (3,), radius) of the scene in world space (host numpy);
    the scene's leaves may be numpy arrays or tensors on any device."""
    pos = to_numpy(scene.mesh.positions, np.float32)
    tid = to_numpy(scene.mesh.transform_id, np.int32)
    mats = to_numpy(scene.model_matrices, np.float32)
    p4 = np.concatenate([pos, np.ones((pos.shape[0], 1), np.float32)], axis=1)
    world = np.einsum("vij,vj->vi", mats[tid], p4)[:, :3]
    lo = world.min(axis=0)
    hi = world.max(axis=0)
    center = (lo + hi) * 0.5
    radius = float(np.linalg.norm(hi - center)) + 1e-3
    return center.astype(np.float32), radius


def light_matrices_for_scene(scene: Scene, pad: float = 1.05):
    """Orthographic (view, proj) for directional light 0, fit to the scene:
    the light camera sits at 2 * radius along -light_dir from the scene's
    center and sees the whole bounding sphere. Returns numpy f32 (4, 4)."""
    d = to_numpy(scene.lights.dir_dirs, np.float32)
    if d.shape[0] < 1:
        raise ValueError("the shadow pass needs a directional light")
    d = d[0] / max(np.linalg.norm(d[0]), 1e-12)
    center, radius = scene_world_bounds(scene)
    r = radius * pad
    eye = center - d * (2.0 * r)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    if abs(float(np.dot(up, d))) > 0.95:
        up = np.array([1.0, 0.0, 0.0], np.float32)
    view = look_at_np(eye, center, up)
    proj = orthographic_np(-r, r, -r, r, r, 3.0 * r)
    return view.astype(np.float32), proj.astype(np.float32)
