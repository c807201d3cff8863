"""The port's CPU oracle (port of ``xr/cpu_ref/oracle.py``): one frame of a
host scene on the CPU, always, whatever devices the machine has.

It composes the port's own stages on CPU tensors:

  * geometry (``xr_torch/pipeline/geometry.py``) and, for shadow-mapped
    Phong, the depth-only pass from the light (``pipeline/shadow.py``'s
    light matrices),
  * visibility by a per-record bounding-box loop (``visibility_bbox``)
    over the exact integer coverage and the (z, id) resolve of
    ``xr_torch/raster/common.py`` and ``core/fixedpoint.py``: no binning,
    no records, no kernel wrapper,
  * deferred shading (``shading/deferred.py``), the blend composite
    (``shading/blend.py``) and the u8 resolve.

Coverage is integer and the shading formulas are the pipeline's, so a
frame rendered on the card matches this one exactly in coverage and to
1 LSB in color, up to the shadow-test flips ``margins.shadow_flip_risk``
marks. The oracle is itself held against the independent scalar
rasterizer in ``brute``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from xr_torch import convert
from xr_torch.core import fixedpoint as fp
from xr_torch.core import math3d as m3
from xr_torch.core import shade_math as sm
from xr_torch.core.types import MODE_DEPTH_ONLY, MODE_PHONG, Frame, RenderConfig, Scene
from xr_torch.pipeline.geometry import geometry
from xr_torch.pipeline.shadow import camera_matrices_np, light_matrices_for_scene
from xr_torch.raster import common as rc
from xr_torch.shading import blend
from xr_torch.shading.deferred import shade_deferred

CPU = torch.device("cpu")
F32, I32 = torch.float32, torch.int32


BLOCK_RECORDS = 256  # records whose fragments one call computes
BLOCK_PIXELS = 1 << 18  # at most this many padded bbox pixels a call


def _blocks(live, bw, bh):
    """The live record ids in order, cut into runs whose bboxes, padded to
    the run's widest and tallest, stay within BLOCK_PIXELS (a record that
    alone exceeds it runs alone)."""
    run, w, h = [], 0, 0
    for i in live:
        w2, h2 = max(w, bw[i]), max(h, bh[i])
        if run and (len(run) == BLOCK_RECORDS or (len(run) + 1) * w2 * h2 > BLOCK_PIXELS):
            yield run, w, h
            run, w2, h2 = [], bw[i], bh[i]
        run.append(i)
        w, h = w2, h2
    if run:
        yield run, w, h


def visibility_bbox(tri, config: RenderConfig):
    """Per-record bbox loop over a TriBuf of CPU tensors: (tid (H, W) i32,
    zbuf (H, W) f32) with BG_TRI_ID and +inf where nothing is visible;
    callers map the background depth to 1.0.

    The loop walks the whole capacity gated on ``valid``: under the
    identity record layout the valid records are not a prefix, so
    ``count`` is a statistic, not a bound. In record order, each record's
    fragments inside its pixel bbox win by the strict (z, id) test, or,
    without the depth test, overwrite (painter's order). The fragments
    (coverage and depth, elementwise per pixel) of a run of records are
    computed by one call on their bboxes padded to a common size; the
    padding lies outside each record's bbox and is cut off before its
    turn."""
    H, W, sub = config.height, config.width, config.subpixel
    half = sub // 2
    zbuf = torch.full((H, W), rc.BG_DEPTH, dtype=F32)
    tid = torch.full((H, W), rc.BG_TRI_ID, dtype=I32)
    # each record's pixel-center bbox, clipped to the frame:
    # ceil((min - half) / sub) .. floor((max - half) / sub)
    x0 = torch.clamp_min(-((half - tri.xs.amin(1)) // sub), 0)
    y0 = torch.clamp_min(-((half - tri.ys.amin(1)) // sub), 0)
    bw = (torch.clamp_max((tri.xs.amax(1) - half) // sub, W - 1) - x0 + 1).tolist()
    bh = (torch.clamp_max((tri.ys.amax(1) - half) // sub, H - 1) - y0 + 1).tolist()
    live = [i for i, v in enumerate(tri.valid.tolist()) if v and bw[i] > 0 and bh[i] > 0]
    ix0, iy0 = x0.tolist(), y0.tolist()
    for run, w, h in _blocks(live, bw, bh):
        ids = torch.tensor(run)
        px = fp.pixel_center_fixed(x0[ids][:, None, None] + torch.arange(w)[None, None, :], sub)
        py = fp.pixel_center_fixed(y0[ids][:, None, None] + torch.arange(h)[None, :, None], sub)
        mask, zf = rc.tri_fragment(tri.xs[ids][:, None, None, :], tri.ys[ids][:, None, None, :],
                                   tri.z[ids][:, None, None, :], px, py)
        for k, i in enumerate(run):
            box = (slice(iy0[i], iy0[i] + bh[i]), slice(ix0[i], ix0[i] + bw[i]))
            m, z = mask[k, : bh[i], : bw[i]], zf[k, : bh[i], : bw[i]]
            zs, ts = zbuf[box], tid[box]  # views: the writes below land in the buffers
            win = m & rc.resolve_better(z, i, zs, ts) if config.depth_test else m
            zs[win] = z[win]
            ts[win] = i
    return tid, zbuf


def _resolved(zbuf: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isinf(zbuf), 1.0, zbuf)


def _shadow(sc: Scene, config: RenderConfig) -> dict:
    """The shadow map from light 0 (shadow-mapped Phong), or {}:
    {"shadow_depth" (S, S) with 1.0 background, "light_viewproj" (4, 4)}."""
    if config.mode != MODE_PHONG or config.shadow_map_size <= 0:
        return {}
    lview, lproj = (convert.tensor(m, CPU, F32) for m in light_matrices_for_scene(sc))
    s_cfg = dataclasses.replace(config, width=config.shadow_map_size,
                                height=config.shadow_map_size, mode=MODE_DEPTH_ONLY,
                                shadow_map_size=0)
    s_tri = geometry(sc, lview, lproj, s_cfg)
    if config.blend:  # transparent records cast no shadows
        s_tri = s_tri.replace(valid=blend.opaque_valid(s_tri, sc))
    _, s_zbuf = visibility_bbox(s_tri, s_cfg)
    return {"shadow_depth": _resolved(s_zbuf), "light_viewproj": m3.matmul(lproj, lview)}


def render(scene: Scene, camera, config: RenderConfig, shade_hook=None):
    """``render_frame``'s frame, plus the shadow pass's tensors it shaded
    with ({} without one; ``margins`` reads them)."""
    sc = convert.scene_to_torch(scene, CPU)
    cam = convert.camera_to_torch(camera, CPU)
    view, proj = (convert.tensor(m, CPU) for m in camera_matrices_np(
        camera, config.width / config.height))
    shadow = _shadow(sc, config)

    tri = geometry(sc, view, proj, config)
    vis_tri = tri
    if config.blend:  # transparent records win no pixels (blend.py)
        vis_tri = tri.replace(valid=blend.opaque_valid(tri, sc))
    tid, zbuf = visibility_bbox(vis_tri, config)
    depth = _resolved(zbuf)

    shaded = config.width * config.height
    if shadow:  # the shadow map's texels count as shaded work
        shaded += config.shadow_map_size * config.shadow_map_size
    stats = {
        "tris_in": sc.mesh.num_triangles,
        "tris_setup": tri.count,
        "clip_overflow": tri.overflow,
        "fragments_shaded": shaded,
        "covered_pixels": (depth < 1.0).sum(),
    }
    if config.mode == MODE_DEPTH_ONLY:
        color = torch.zeros((config.height, config.width, 3), dtype=torch.uint8)
    else:
        rgb = shade_deferred(tri, tid, sc, config, eye=cam.eye, shade_hook=shade_hook,
                             depth=depth, **shadow)
        if config.blend:
            rgb, stats["blend_overflow"] = blend.composite_transparent(
                rgb, depth, tri, sc, config, cam.eye, **shadow)
        color = sm.resolve_u8(rgb)
    frame = Frame(color=color.numpy(), depth=depth.numpy(),
                  stats={k: np.int32(int(v)) for k, v in stats.items()})
    return frame, shadow


def render_frame(scene: Scene, camera, config: RenderConfig,
                 model_time: Optional[float] = None, shade_hook=None) -> Frame:
    """One frame with the CPU oracle, on the CPU: a host Frame (numpy color
    (H, W, 3) u8, depth (H, W) f32 with 1.0 background, stats as
    np.int32). scene: a host scene (numpy leaves, or tensors on any
    device, copied to the CPU); camera: array-likes or tensors. Two passes
    for shadow-mapped Phong, the shadow map first. The stats are the
    reference oracle's keys: tris_in, tris_setup, clip_overflow,
    fragments_shaded (the shadow map's texels included), covered_pixels
    and, under blend, blend_overflow. shade_hook: the pixel stage
    ``hook(color, scene, mat_id, torch[, frag=Frag])``, on CPU tensors.
    model_time is accepted for the reference's signature and unused: the
    scene's model matrices are the frame's."""
    return render(scene, camera, config, shade_hook)[0]
