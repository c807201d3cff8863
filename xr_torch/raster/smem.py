"""Per-tile list visibility (port of ``xr/raster/pallas_smem.py``, the
``pallas_smem`` backend): the prep in torch, the wrapper that launches the
CUDA kernel (``xr_torch/csrc/vis_lists.cu``) and the kernel's plain PyTorch
version.

Every tile folds the global large bucket, then its own id list, capped at
``bin_capacity`` by the binning; the entries past a tile's cap are dropped
and counted in ``dropped``. The reference's SMEM record windows are not
needed: the kernel reads records by id from the (C, 18) table. The prep also
lists the work items of the kernel: each tile's walk cut into chunks of
``records.ITEM_RECORDS`` (``item_tile``, ``item_start``), computed on the
device without a host read.

``z_earlyout`` and its gates are accepted and run the one fold: they never
change (tid, z).

The wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel, and raises if that fails.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

from xr_torch import kernels
from xr_torch.core.types import RenderConfig
from xr_torch.pipeline.geometry import TriBuf
from xr_torch.raster.binning import bin_triangles, grid_dims
from xr_torch.raster.records import (
    fold_plain,
    id_chunks,
    item_bound,
    item_table,
    pack_tri_records,
)


class ListsInputs(NamedTuple):
    """What the list kernel and its plain version read."""

    rec: torch.Tensor  # (C, 18) i32 plane-form records
    lists: torch.Tensor  # (ntiles, bin_capacity) i32 ids, ascending
    counts: torch.Tensor  # (ntiles,) i32 live entries of each list
    large_ids: torch.Tensor  # (lcap,) i32 large bucket, ascending
    large_count: torch.Tensor  # (1,) i32 live entries of large_ids
    dropped: torch.Tensor  # () i32 entries past bin_capacity + large overflow
    item_tile: torch.Tensor  # (bound,) i32 tile of each chunk of the kernel's walk
    item_start: torch.Tensor  # (ntiles + 1,) i32 first chunk of each tile, then the total


def prepare_lists(tri: TriBuf, config: RenderConfig, y_offset: int = 0) -> ListsInputs:
    """Bin and pack records (band-translated by y_offset rows)."""
    b = bin_triangles(tri, config, y_offset=y_offset)
    ntiles, cap = b.lists.shape
    large_count = b.large_count.reshape(1)
    bound = item_bound(ntiles, config.large_capacity, ntiles * cap)
    item_tile, item_start = item_table(b.counts, torch.ones_like(b.counts), large_count, bound)
    return ListsInputs(
        rec=pack_tri_records(tri, y_offset * config.subpixel),
        lists=b.lists,
        counts=b.counts,
        large_ids=b.large_ids,
        large_count=large_count,
        dropped=b.dropped,
        item_tile=item_tile,
        item_start=item_start,
    )


def vis_lists_plain(inp: ListsInputs, config: RenderConfig):
    """Plain PyTorch version of the kernel on the same inputs: the large
    bucket, then each tile's capped list, folded into every tile at once.
    Returns (tid (H,W) i32, z (H,W) f32, +inf background)."""
    C = inp.rec.shape[0]
    ntiles, cap = inp.lists.shape
    dev = inp.rec.device
    chunks = itertools.chain(
        id_chunks(inp.large_ids, torch.zeros((1,), dtype=torch.int32, device=dev),
                  inp.large_count, C),
        id_chunks(inp.lists.reshape(-1),
                  torch.arange(ntiles, dtype=torch.int32, device=dev) * cap, inp.counts, C),
    )
    return fold_plain(inp.rec, chunks, config)


def vis_lists(inp: ListsInputs, config: RenderConfig):
    """The list kernel: CUDA on CUDA tensors, the plain version on CPU
    tensors. Returns (tid, z)."""
    if inp.rec.device.type == "cpu":
        return vis_lists_plain(inp, config)
    _, ntx = grid_dims(config)
    return kernels.vis_lists(
        inp.rec, inp.lists, inp.counts, inp.large_ids, inp.large_count,
        inp.item_tile, inp.item_start,
        height=config.height, width=config.width, tile_h=config.tile_h,
        tile_w=config.tile_w, ntx=ntx, subpixel=config.subpixel,
        depth_test=config.depth_test,
    )

