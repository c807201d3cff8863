"""Portable visibility paths (port of the brute-force and tile-list parts of
``xr/raster/jnp_backend.py``): plain torch, as they are plain XLA and not
Pallas in the reference. Both evaluate each triangle from the ``TriBuf``
through ``common.tri_fragment`` and resolve with the strict (z, id)
lexicographic minimum (or painter's order), so the order of the chunks does
not change the result.

- ``visibility_brute``: every triangle against every pixel, chunked over
  triangles (config1's path: ``raster_path="auto"`` takes it at capacity
  <= 2048).
- ``visibility_binned``: the ``jnp`` backend, each tile folding the large
  bucket and its capped list.
"""

from __future__ import annotations

from typing import Tuple

import torch

from xr_torch.core.types import RenderConfig
from xr_torch.pipeline.geometry import TriBuf
from xr_torch.raster import common as rc
from xr_torch.raster.binning import bin_triangles, grid_dims, tile_pixels, untile
from xr_torch.raster.records import id_chunks

I32 = torch.int32


def visibility_brute(
    tri: TriBuf, config: RenderConfig, chunk: int = 32, y_offset: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tid (H,W) i32, zbuf (H,W) f32 with +inf background). The
    framebuffer is rows [y_offset, y_offset + H) of the full frame."""
    H, W = config.height, config.width
    dev = tri.xs.device
    px, py = rc.pixel_grids(W, H, config.subpixel, dev)
    py = py + y_offset * config.subpixel
    zb, tb = rc.new_carry((1, H, W), config.depth_test, dev)
    C = tri.capacity
    for s in range(0, C, chunk):
        e = min(s + chunk, C)

        def cut(a):
            return a[s:e, None, None, :]

        mask, zf = rc.tri_fragment(cut(tri.xs), cut(tri.ys), cut(tri.z), px, py)
        mask = mask & tri.valid[s:e, None, None]
        zf = torch.where(mask, zf, rc.BG_DEPTH)[None]  # (1, K, H, W)
        cids = torch.arange(s, e, dtype=I32, device=dev)[None, :, None, None]
        zb, tb = rc.merge_chunk(zb, tb, zf, cids, config.depth_test)
    return rc.final_ids(tb, config.depth_test)[0], zb[0]


def visibility_binned(
    tri: TriBuf, config: RenderConfig, y_offset: int = 0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (tid (H,W) i32, zbuf (H,W) f32 with +inf background,
    bin_overflow () i32): every tile folds the large bucket, then its list
    capped at bin_capacity. The band renders rows [y_offset, y_offset + H)
    of the full frame."""
    nty, ntx = grid_dims(config)
    ntiles = nty * ntx
    dev = tri.xs.device
    C = tri.capacity
    b = bin_triangles(tri, config, y_offset=y_offset)
    px, py = tile_pixels(config, dev, y_offset)
    zb, tb = rc.new_carry((ntiles, config.tile_h, config.tile_w), config.depth_test, dev)

    zero = torch.zeros((1,), dtype=I32, device=dev)
    # the trip counts are the data's (one host read), but under a CUDA
    # graph's capture, which cannot read it, the capacities, as the
    # reference's jitted lax.scan over the lists runs them
    capturing = dev.type == "cuda" and torch.cuda.is_current_stream_capturing()
    segments = (
        (b.large_ids, zero, b.large_count.reshape(1), b.large_ids.shape[0]),
        (b.lists.reshape(-1), torch.arange(ntiles, dtype=I32, device=dev) * b.lists.shape[1],
         b.counts, b.lists.shape[1]),
    )
    for ids, starts, n, cap in segments:
        for cids in id_chunks(ids, starts, n, C, bound=cap if capturing else None):
            safe = torch.clamp_max(cids, C - 1).long()

            def at(a):
                return a[safe][:, :, None, None, :]  # (rows, K, 1, 1, 3)

            mask, zf = rc.tri_fragment(at(tri.xs), at(tri.ys), at(tri.z), px, py)
            mask = mask & (cids < C)[:, :, None, None]
            zf = torch.where(mask, zf, rc.BG_DEPTH)
            zb, tb = rc.merge_chunk(zb, tb, zf, cids[:, :, None, None], config.depth_test)
    tb = rc.final_ids(tb, config.depth_test)
    return untile(tb, config), untile(zb, config), b.dropped
