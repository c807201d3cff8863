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

``z_earlyout``, ``z_chunk_gate`` and ``z_band_gate`` are accepted and run
the one fold: the reference's gates skip records whose deflated ``z_min``
cannot win, so they never change (tid, z). The fold reads a record only
through a live id, never an empty slot's fields (the port's empty-slot
sentinel is the id itself).

The wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel, and raises if that fails.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Tuple

import torch

from xr_torch import kernels
from xr_torch.core.types import RenderConfig
from xr_torch.pipeline.geometry import MAX_FAN, TriBuf, clip_budget
from xr_torch.raster.binning import bin_triangles, grid_dims
from xr_torch.raster.records import (
    fold_plain,
    id_chunks,
    item_bound,
    item_table,
    pack_tri_records,
)

I32 = torch.int32

CHUNK_G = 8  # records under one aggregate z_min in the reference's chunk gate


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


def prepare(tri: TriBuf, config: RenderConfig, y_offset: int = 0) -> StreamInputs:
    """Bin, pack records and apply the reference's block budget."""
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
    )


def vis_stream_plain(inp: StreamInputs, config: RenderConfig):
    """Plain PyTorch version of the kernel on the same inputs: the large
    bucket, then each tile's uncapped segment, folded into every tile at
    once; tiles outside the budget stay background. Returns (tid (H,W) i32,
    z (H,W) f32, +inf background)."""
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
        depth_test=config.depth_test,
    )


def visibility_binned(
    tri: TriBuf, config: RenderConfig, y_offset: int = 0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (tid (H,W) i32, zbuf (H,W) f32 with +inf background,
    dropped () i32) — the reference's visibility contract."""
    inp = prepare(tri, config, y_offset)
    tid, z = vis_stream(inp, config)
    return tid, z, inp.dropped
