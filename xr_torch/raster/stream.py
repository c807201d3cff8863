"""Streaming tile visibility (port of ``xr/raster/pallas_stream.py``): the
prep in torch, the wrapper that launches the CUDA kernel
(``xr_torch/csrc/vis_stream.cu``) and the kernel's plain PyTorch version.

Every tile walks its sorted bin segment ``sid[starts[t] : starts[t] +
run_counts[t]]`` after the global large bucket. The reference streams
records in blocks of ``stream_block`` entries under a global block budget
(``stream_blocks``); the port keeps that budget's outcome exactly — the
same tiles run, the same records drop, the same ``dropped`` count — by
computing per tile how many of its records fall inside the budget
(``run_counts``) and which tiles start inside it (``tile_ran``). It also
lists the work items of the kernel: each tile's walk cut into chunks of
``records.ITEM_RECORDS`` (``item_tile``, ``item_start``), computed on the
device without a host read.

Under ``z_earlyout`` (with the depth test) the kernel's z gate runs: a
warp skips a record whose deflated ``z_min`` (field 13) lies behind every
pixel of its 32x8 footprint, by a bound of the footprint that the tile's
chunks share while they run; the prep lists the chunks chunk-major
(``item_order``) so that every tile's first chunk starts first
(``records.fold_plain_items(gated=True)`` is that algorithm in plain
PyTorch); under ``z_chunk_gate`` the staging also drops such records from
a warp's walk before it starts. The plain
version is then the reference's serial gate, ``records.fold_plain_gated``
(blocks of ``stream_block``, ``z_band_gate``'s 8-row bands, ``z_chunk_gate``'s
groups of ``CHUNK_G``). No gate changes (tid, z): a skipped record cannot
win a pixel. Both read ``z_min`` only through a live id, never an empty
slot's fields (the port's empty-slot sentinel is the id itself).

The wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel, and raises if that fails.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional

import torch

from xr_torch import kernels
from xr_torch.core.types import RenderConfig
from xr_torch.pipeline.geometry import MAX_FAN, TriBuf, clip_budget
from xr_torch.raster.binning import bin_triangles, grid_dims
from xr_torch.raster.records import (
    CHUNK_G,
    chunk_major_order,
    fold_plain,
    fold_plain_gated,
    id_chunks,
    item_bound,
    item_table,
    pack_tri_records,
)

I32 = torch.int32


def stream_blocks(config: RenderConfig, num_records: int, num_src: int = 0) -> int:
    """Static block budget: stream_expand entries per live record (live
    records never exceed num_src + clip_budget*(MAX_FAN-1)), plus one pad
    block per tile — or the absolute stream_entry_cap override."""
    nty, ntx = grid_dims(config)
    cap = config.stream_entry_cap
    if not cap:
        bound = num_records
        if num_src:
            bound = min(num_records, num_src + clip_budget(num_src, config) * (MAX_FAN - 1))
        cap = int(bound * config.stream_expand) + 64
    return cap // config.stream_block + nty * ntx + 1


class StreamInputs(NamedTuple):
    """What the visibility kernel and its plain version read."""

    rec: torch.Tensor  # (C, 18) i32 plane-form records
    sid: torch.Tensor  # (S,) i32 ids sorted by (tile, id)
    starts: torch.Tensor  # (ntiles,) i32 segment starts
    run_counts: torch.Tensor  # (ntiles,) i32 records of the tile inside the budget
    tile_ran: torch.Tensor  # (ntiles,) i32 1 where the tile starts inside the budget
    large_ids: torch.Tensor  # (lcap,) i32 large bucket, ascending
    large_count: torch.Tensor  # (1,) i32 live entries of large_ids
    dropped: torch.Tensor  # () i32 dropped_blocks * BLK + large_dropped
    item_tile: torch.Tensor  # (bound,) i32 tile of each chunk of the kernel's walk
    item_start: torch.Tensor  # (ntiles + 1,) i32 first chunk of each tile, then the total
    item_order: Optional[torch.Tensor] = None  # (bound,) i32 chunk-major walk, gated only


def gated(config: RenderConfig) -> bool:
    """Whether the z gate runs: ``z_earlyout`` with the depth test."""
    return config.depth_test and config.z_earlyout


def prepare(tri: TriBuf, config: RenderConfig, y_offset: int = 0) -> StreamInputs:
    """Bin, pack records and apply the reference's block budget; under the
    z gate, also the kernel's chunk-major walk."""
    if config.z_chunk_gate:
        assert config.stream_block % CHUNK_G == 0, "stream_block must be a CHUNK_G multiple"
    b = bin_triangles(tri, config, y_offset=y_offset)
    BLK = config.stream_block
    NB = stream_blocks(config, tri.capacity, tri.num_src)
    counts = b.raw_counts
    nb_t = torch.clamp_min(-(-counts // BLK), 1)  # blocks per tile, >= 1
    bstart_t = torch.cumsum(nb_t, 0, dtype=I32) - nb_t
    nb_total = nb_t.sum(dtype=I32)
    dropped_blocks = torch.clamp_min(nb_total - NB, 0)
    # a tile's blocks beyond the budget never run: it keeps its first
    # (NB - bstart) blocks' records, and a tile starting past it none
    avail = torch.clamp(NB - bstart_t, 0) * BLK
    run_counts = torch.minimum(counts, avail)
    tile_ran = (bstart_t < torch.clamp_max(nb_total, NB)).to(I32)
    large_count = b.large_count.reshape(1)
    bound = item_bound(counts.shape[0], config.large_capacity, b.sid.shape[0])
    item_tile, item_start = item_table(run_counts, tile_ran, large_count, bound)
    return StreamInputs(
        rec=pack_tri_records(tri, y_offset * config.subpixel),
        sid=b.sid,
        starts=b.starts,
        run_counts=run_counts,
        tile_ran=tile_ran,
        large_ids=b.large_ids,
        large_count=large_count,
        dropped=(dropped_blocks * BLK + b.large_dropped).to(I32),
        item_tile=item_tile,
        item_start=item_start,
        item_order=chunk_major_order(item_tile, item_start) if gated(config) else None,
    )


def vis_stream_plain_gated(inp: StreamInputs, config: RenderConfig):
    """The reference's serial z gate on the kernel's inputs
    (``records.fold_plain_gated``). Returns (tid, z, skips)."""
    return fold_plain_gated(inp.rec, inp.large_ids, inp.large_count, inp.sid, inp.starts,
                            inp.run_counts, config, tile_ran=inp.tile_ran)


def vis_stream_plain(inp: StreamInputs, config: RenderConfig):
    """Plain PyTorch version of the kernel on the same inputs: the large
    bucket, then each tile's uncapped segment, folded into every tile at
    once, under the z gate the reference's serial gate; tiles outside the
    budget stay background. Returns (tid (H,W) i32, z (H,W) f32, +inf
    background)."""
    if gated(config):
        return vis_stream_plain_gated(inp, config)[:2]
    C = inp.rec.shape[0]
    zero = torch.zeros((1,), dtype=I32, device=inp.rec.device)
    chunks = itertools.chain(
        id_chunks(inp.large_ids, zero, inp.large_count, C),
        id_chunks(inp.sid, inp.starts, inp.run_counts, C),
    )
    return fold_plain(inp.rec, chunks, config, tile_ran=inp.tile_ran)


def vis_stream(inp: StreamInputs, config: RenderConfig):
    """The visibility kernel: CUDA on CUDA tensors, the plain version on CPU
    tensors. Returns (tid, z)."""
    if inp.rec.device.type == "cpu":
        return vis_stream_plain(inp, config)
    nty, ntx = grid_dims(config)
    return kernels.vis_stream(
        inp.rec, inp.sid, inp.starts, inp.run_counts, inp.tile_ran,
        inp.large_ids, inp.large_count, inp.item_tile, inp.item_start,
        height=config.height, width=config.width, tile_h=config.tile_h,
        tile_w=config.tile_w, ntx=ntx, subpixel=config.subpixel,
        depth_test=config.depth_test, item_order=inp.item_order if gated(config) else None,
        chunk_gate=gated(config) and config.z_chunk_gate,
    )

