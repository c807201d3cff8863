"""Scene and camera-path files (port of ``xr/core/serialize.py``): host
scenes in one ``.npz``, with the reference's keys and dtypes, so a file
written by either package loads in the other.

A scene file holds the mesh, the material table, the lights, the model
matrices and a uniform texture pyramid (its texel quads as uint32, the
reference's dtype; the port keeps their bits as int32). As in the
reference, the optional per-material alpha and address modes and the
per-vertex material ids are not stored. A ragged pyramid has no format
here (the reference's ``save_scene`` needs ``base_size``), and saving one
raises.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

from xr_torch.convert import to_numpy
from xr_torch.core.types import Camera, Lights, Material, Mesh, Scene, TexturePyramid

MESH_FIELDS = ("positions", "normals", "uvs", "indices", "material_id", "transform_id")
MATERIAL_FIELDS = ("base_color", "ka", "kd", "ks", "shininess", "tex_id")
LIGHT_FIELDS = ("dir_dirs", "dir_colors", "pt_pos", "pt_colors", "ambient")
CAMERA_FIELDS = ("eye", "target", "up", "fov_y", "near", "far")


def save_scene(path: str, scene: Scene) -> None:
    """Write scene (numpy or tensor leaves, on any device) to path."""
    tex = scene.textures
    if tex is not None and hasattr(tex, "base_size_per_tex"):
        raise ValueError("save_scene: a RaggedPyramid has no .npz format (the reference's "
                         "scene files hold a uniform pyramid with one base_size)")
    arrs: Dict[str, np.ndarray] = {}
    for k in MESH_FIELDS:
        arrs[f"mesh_{k}"] = to_numpy(getattr(scene.mesh, k))
    for k in MATERIAL_FIELDS:
        arrs[f"mat_{k}"] = to_numpy(getattr(scene.materials, k))
    for k in LIGHT_FIELDS:
        arrs[f"light_{k}"] = to_numpy(getattr(scene.lights, k))
    arrs["model_matrices"] = to_numpy(scene.model_matrices)
    if tex is not None:
        arrs["tex_data"] = to_numpy(tex.data)
        arrs["tex_quads"] = to_numpy(tex.quads).view(np.uint32)
        arrs["tex_meta"] = np.asarray([tex.base_size, tex.num_levels], np.int64)
    np.savez_compressed(path, **arrs)


def load_scene(path: str) -> Scene:
    """A host Scene (numpy leaves) from a file of either package."""
    with np.load(path) as z:
        tex = None
        if "tex_data" in z:
            base, levels = (int(v) for v in z["tex_meta"])
            tex = TexturePyramid(data=z["tex_data"], quads=z["tex_quads"].view(np.int32),
                                 base_size=base, num_levels=levels)
        return Scene(
            mesh=Mesh(**{k: z[f"mesh_{k}"] for k in MESH_FIELDS}),
            materials=Material(**{k: z[f"mat_{k}"] for k in MATERIAL_FIELDS}),
            textures=tex,
            lights=Lights(**{k: z[f"light_{k}"] for k in LIGHT_FIELDS}),
            model_matrices=z["model_matrices"],
        )


def save_camera_path(path: str, cameras: List[Camera]) -> None:
    """Bake a list of cameras (e.g. samples of a preset's animate) to one
    npz, one stacked f32 array a field."""
    np.savez_compressed(path, **{
        f: np.stack([to_numpy(getattr(c, f), np.float32) for c in cameras])
        for f in CAMERA_FIELDS
    })


def load_camera_path(path: str) -> List[Camera]:
    with np.load(path) as z:
        arrs = {f: z[f] for f in CAMERA_FIELDS}
    return [Camera(**{f: a[i] for f, a in arrs.items()}) for i in range(arrs["eye"].shape[0])]


def bake_camera_path(animate: Callable, times) -> Tuple[List[Camera], List[np.ndarray]]:
    """Sample a preset's animate(t) at fixed times: (cameras, model
    matrices)."""
    cams, mats = [], []
    for t in times:
        c, m = animate(t)
        cams.append(c)
        mats.append(np.asarray(m))
    return cams, mats
