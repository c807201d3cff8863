"""Scene and frame validation of the port (port of ``xr/app/validate.py``):
finite-value and range checks on a scene, with numpy or tensor leaves on
any device, and on a host Frame from ``readback``."""

from __future__ import annotations

import numpy as np

from xr_torch.convert import to_numpy as _np
from xr_torch.core.types import Frame, RenderConfig, Scene


def check_scene(scene: Scene) -> None:
    """Raise ValueError on a malformed scene: non-finite positions or
    normals, indices, material ids, transform ids or texture ids out of
    range."""
    m = scene.mesh
    pos = _np(m.positions)
    idx = _np(m.indices)
    if not np.isfinite(pos).all():
        raise ValueError("mesh positions contain non-finite values")
    if not np.isfinite(_np(m.normals)).all():
        raise ValueError("mesh normals contain non-finite values")
    if idx.size and (idx.min() < 0 or idx.max() >= pos.shape[0]):
        raise ValueError(
            f"indices out of range [0, {pos.shape[0]}): [{idx.min()}, {idx.max()}]")
    mid = _np(m.material_id)
    nmat = _np(scene.materials.base_color).shape[0]
    if mid.size and (mid.min() < 0 or mid.max() >= nmat):
        raise ValueError(f"material_id out of range [0, {nmat})")
    tid = _np(m.transform_id)
    nxf = _np(scene.model_matrices).shape[0]
    if tid.size and (tid.min() < 0 or tid.max() >= nxf):
        raise ValueError(f"transform_id out of range [0, {nxf})")
    if scene.textures is not None:
        if (_np(scene.materials.tex_id) >= scene.textures.num_textures).any():
            raise ValueError("material tex_id exceeds texture count")


def check_frame(frame: Frame, config: RenderConfig) -> None:
    """Raise ValueError on non-finite depth, depth outside [0, 1] or an
    overflow counter that is not zero; the color must be (H, W, 3)."""
    depth = _np(frame.depth)
    if not np.isfinite(depth).all():
        raise ValueError("frame depth contains non-finite values")
    if depth.min() < 0.0 or depth.max() > 1.0:
        raise ValueError(f"depth outside [0,1]: [{depth.min()}, {depth.max()}]")
    for k in ("clip_overflow", "bin_overflow"):
        v = int(_np(frame.stats.get(k, 0)))
        if v:
            raise ValueError(f"{k}={v}: triangles were dropped")
    if _np(frame.color).shape != (config.height, config.width, 3):
        raise ValueError(f"color shape {_np(frame.color).shape}, expected "
                         f"({config.height}, {config.width}, 3)")
