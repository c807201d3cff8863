"""Which pixels of a frame sit within f32 noise of a shadow-test flip (port
of ``xr/cpu_ref/margins.py``).

Coverage is exact integer math on every backend, and the presets keep
depth winners apart by far more than the f32 noise of z, so the one binary
decision that a correct backend may take the other way is the shadow-map
test (``shade_math.shadow_test``): ``z - bias > d`` and the floor() that
picks the texel, both fed by the interpolated world position, whose f32
value differs between CPU and card by ~1e-6 after the matrix and divide
chain. At a shadow's edge such a flip moves a pixel by tens of LSB. The
set of such pixels belongs to the scene, not to the implementation:
``shadow_flip_risk`` computes it with the port's oracle, so a comparison
of a card frame with the oracle can hold every other pixel to 1 LSB and
only bound the count of these.
"""

from __future__ import annotations

import torch

from xr_torch.core import math3d as m3
from xr_torch.core.types import RenderConfig, Scene
from xr_torch.cpu_ref import oracle

NEIGHBOURS = ((0, -1), (0, 1), (-1, 0), (1, 0), (-1, -1), (-1, 1), (1, -1), (1, 1))


def frame_and_risk(scene: Scene, camera, config: RenderConfig, eps_z: float = 5e-5,
                   eps_tex: float = 5e-3):
    """The oracle's frame and its ``shadow_flip_risk`` mask from one render
    (the hook that reads the world positions returns the color as it is,
    so the frame is ``render_frame``'s)."""
    H, W = config.height, config.width
    cap = {}

    def hook(color, scene_, mat_id, xp, frag=None):
        cap["frag"] = frag
        return color

    frame, shadow = oracle.render(scene, camera, config, shade_hook=hook)
    risk = torch.zeros((H, W), dtype=torch.bool)
    if not shadow:
        return frame, risk.numpy()
    world = cap["frag"].world.reshape(H, W, 3)
    bg = cap["frag"].bg.reshape(H, W)
    sd, lvp = shadow["shadow_depth"], shadow["light_viewproj"]

    # the sample math of shade_math.shadow_test, step for step
    hs, ws = sd.shape
    p4 = torch.cat([world, torch.ones_like(world[..., :1])], dim=-1)
    clip = m3.matvec(lvp, p4)
    w = torch.clamp_min(clip[..., 3], 1e-12)
    ndc_x, ndc_y, z = clip[..., 0] / w, clip[..., 1] / w, clip[..., 2] / w
    sx = torch.nan_to_num((ndc_x * 0.5 + 0.5) * ws, nan=0.0, posinf=0.0, neginf=0.0)
    sy = torch.nan_to_num((0.5 - ndc_y * 0.5) * hs, nan=0.0, posinf=0.0, neginf=0.0)
    ix = torch.clamp(torch.floor(sx), 0.0, float(ws - 1)).long()
    iy = torch.clamp(torch.floor(sy), 0.0, float(hs - 1)).long()
    d = sd[iy, ix]
    inside = ((ndc_x >= -1.0) & (ndc_x <= 1.0) & (ndc_y >= -1.0) & (ndc_y <= 1.0)
              & (z >= 0.0) & (z <= 1.0))
    act = inside & ~bg

    zb = z - config.shadow_bias
    risk = act & ((zb - d).abs() < eps_z)
    # texel-selection flips: the sample lies within eps_tex of a texel edge
    # and the texel across that edge decides the compare the other way
    fx, fy = sx - torch.floor(sx), sy - torch.floor(sy)
    lit = zb <= d
    for dy, dx in NEIGHBOURS:
        near = act.clone()
        if dx:
            near &= (fx < eps_tex) if dx < 0 else (fx > 1.0 - eps_tex)
        if dy:
            near &= (fy < eps_tex) if dy < 0 else (fy > 1.0 - eps_tex)
        jx = torch.clamp(ix + dx, 0, ws - 1)
        jy = torch.clamp(iy + dy, 0, hs - 1)
        risk |= near & ((zb <= sd[jy, jx]) != lit)
    return frame, risk.numpy()


def shadow_flip_risk(scene: Scene, camera, config: RenderConfig, eps_z: float = 5e-5,
                     eps_tex: float = 5e-3):
    """(H, W) bool numpy: the pixels whose shadow test can flip under f32
    noise. A pixel is at risk when its compare margin |(z - bias) - d| is
    under eps_z, or its sample coordinate lies within eps_tex texels of an
    edge to a texel that decides the compare the other way. All False when
    the config has no shadow pass. The defaults are the reference's: a
    flip on a correct backend was measured at margin 3.5e-5 on the config6
    courtyard, and texel coordinates carry ~1e-4 texel of noise."""
    return frame_and_risk(scene, camera, config, eps_z, eps_tex)[1]
