"""Measured capacity auto-sizing (port of ``xr/app/autosize.py``).

Every variable-size stage is a fixed capacity plus a loud overflow counter
(bin lists, clip fans, stream entries, blend records). ``autosize_config``
derives the capacities from a dry pass over sample cameras instead of hand
tuning: the port's own geometry stage with the clip budget opened wide (the
identity record layout, nothing compacted or dropped), then a mirror of the
bin emission rules through the binning's own ``_tile_ranges`` and
``span_classes``, so the measured counts are the ones the bins hold. The
dry pass runs in torch on the device it is given; its counts are read to
the host once per camera. The config returned equals the reference's field
by field for the same scene and cameras.

The camera matrices of the dry pass are the frame's: built on the host
with numpy in the reference's op order (``pipeline.shadow.
camera_matrices_np``), as the reference's dry pass builds them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from xr_torch import convert
from xr_torch.core.types import RenderConfig, Scene
from xr_torch.pipeline.geometry import MAX_FAN, clip_budget, geometry
from xr_torch.pipeline.shadow import camera_matrices_np
from xr_torch.raster.binning import _tile_ranges, grid_dims, span_classes

I32 = torch.int32


def measure_frame(scene: Scene, camera, config: RenderConfig, model_matrices=None, *,
                  device) -> dict:
    """Exact stage occupancies for one camera: a dict of
      live_records   post-clip setup triangles  -> clip_expand
      crossing       triangles entering clipping -> clip_budget
      fan_records    live records of clipped fans
      per_tile_max   largest per-tile bin list  -> bin_capacity
      total_entries  all (tile, id) bin entries -> stream_entry_cap
      large          large-bucket triangles     -> large_capacity
      medium         medium-eligible triangles  -> medium_capacity
      quad           2x2-spanning smalls        -> bin_quad_capacity
      transparent    alpha < 1 records          -> blend_capacity
    scene: host-side or on any device (moved to `device`); camera: a
    Camera of array-likes or tensors."""
    dev = torch.device(device)
    if model_matrices is not None:
        scene = scene.replace(model_matrices=model_matrices)
    scene = convert.scene_to_torch(scene, dev)
    T = scene.mesh.num_triangles
    view, proj = (convert.tensor(m, dev)
                  for m in camera_matrices_np(camera, config.width / config.height))

    # the clip budget opened until nothing drops (a second pass when the
    # first one's was exceeded): the counts are true occupancies
    budget = clip_budget(T, config)
    for _ in range(2):
        dry = dataclasses.replace(config, clip_budget=budget)
        stats: dict = {}
        tri = geometry(scene, view, proj, dry, capacity=T + budget * MAX_FAN, stats_out=stats)
        crossing = int(stats["crossing_total"])
        if crossing <= budget:
            break
        budget = crossing

    tx0, tx1, ty0, ty1, valid = _tile_ranges(tri, config)
    small, med_ok = span_classes(tx0, tx1, ty0, ty1, valid, config)
    nty, ntx = grid_dims(config)
    ntiles = nty * ntx

    # small class: the distinct tiles of a <= 2x2 span; medium-eligible: every
    # covered tile of the span (all eligible triangles, not only the first
    # medium_capacity, as the reference counts them)
    sm = valid & small
    two_x = tx1 > tx0
    two_y = ty1 > ty0
    tiles = [(ty0 * ntx + tx0)[sm], (ty0 * ntx + tx1)[sm & two_x],
             (ty1 * ntx + tx0)[sm & two_y], (ty1 * ntx + tx1)[sm & two_x & two_y]]
    mi = torch.nonzero(med_ok).squeeze(1)
    o = torch.arange(config.medium_span, dtype=I32, device=dev)
    tlx = tx0[mi][:, None] + o[None]
    tly = ty0[mi][:, None] + o[None]
    mm = (tly <= ty1[mi][:, None])[:, :, None] & (tlx <= tx1[mi][:, None])[:, None, :]
    tiles.append((tly[:, :, None] * ntx + tlx[:, None, :])[mm])
    tiles = torch.cat(tiles).long()
    counts = torch.bincount(tiles, minlength=ntiles)

    transparent = torch.zeros((), dtype=torch.int64, device=dev)
    alpha = scene.materials.alpha
    if alpha is not None:
        transparent = (tri.valid & (alpha[tri.mat_id.long()] < 1.0)).sum()
    vals = torch.stack([
        stats["live_records"].long(), stats["fan_records"].long(),
        counts.max() if ntiles else torch.zeros_like(transparent),
        (valid & ~small & ~med_ok).sum(), med_ok.sum(), (sm & two_x & two_y).sum(),
        transparent.long(),
    ]).tolist()
    return {
        "live_records": vals[0],
        "crossing": crossing,
        "fan_records": vals[1],
        "per_tile_max": vals[2],
        "total_entries": int(tiles.shape[0]),
        "large": vals[3],
        "medium": vals[4],
        "quad": vals[5],
        "transparent": vals[6],
    }


def _as_pairs(cameras):
    for c in cameras:
        yield c if isinstance(c, tuple) else (c, None)


def autosize_config(scene: Scene, cameras, config: RenderConfig, margin: float = 1.5, *,
                    device) -> RenderConfig:
    """`config` with every capacity knob sized to the measured maxima over
    `cameras` (each a Camera or a (Camera, model_matrices) pair, e.g.
    samples of a preset's animate path) times `margin`, plus a floor. The
    overflow counters stay loud for frames the samples did not cover."""
    ms = [measure_frame(scene, c, config, mm, device=device) for c, mm in _as_pairs(cameras)]
    agg = {k: max(m[k] for m in ms) for k in ms[0]}
    T = scene.mesh.num_triangles

    def pad(n, floor=64):
        return int(math.ceil(n * margin)) + floor

    # clip_capacity = ceil(T * clip_expand) + 64 must hold the live records
    clip_expand = max(pad(agg["live_records"]) - 64, 1) / max(T, 1)
    out = dataclasses.replace(
        config,
        clip_expand=float(clip_expand),
        clip_budget=pad(agg["crossing"], floor=16),
        bin_capacity=pad(agg["per_tile_max"], floor=128),
        large_capacity=pad(agg["large"], floor=128),
        stream_entry_cap=pad(agg["total_entries"]),
        bin_quad_capacity=pad(agg["quad"], floor=16),
    )
    if config.medium_capacity > 0:
        out = dataclasses.replace(out, medium_capacity=pad(agg["medium"], floor=16))
    if config.blend:
        out = dataclasses.replace(out, blend_capacity=pad(agg["transparent"], floor=8))
    return out
