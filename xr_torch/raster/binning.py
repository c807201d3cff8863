"""Sort-based, scatter-free screen-tile binning (port of ``bin_triangles``
and its helpers in ``xr/raster/jnp_backend.py``).

Each small triangle (bbox within 2x2 tiles) emits 4 (tile, id) key slots,
duplicates masked to a sentinel tile; medium triangles (bbox within
medium_span^2 tiles, the first medium_capacity of them) emit one key per
covered tile; the rest go to a global "large" bucket that every tile
scans. Keys (tile << idbits | id) are sorted, so each tile's segment of
``sid`` is contiguous and id-ascending.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from xr_torch.core.types import RenderConfig
from xr_torch.pipeline.geometry import TriBuf, _sort_compact_ids

I32 = torch.int32
LIST_EMPTY = 2**30  # id-list sentinel (any id >= capacity works)


def _pad_to(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def grid_dims(config: RenderConfig) -> Tuple[int, int]:
    """(tile rows, tile columns) covering the framebuffer."""
    return (
        _pad_to(config.height, config.tile_h) // config.tile_h,
        _pad_to(config.width, config.tile_w) // config.tile_w,
    )


def tile_pixels(config: RenderConfig, device, y_offset: int = 0):
    """Fixed-point pixel centers of every tile, px (ntiles, 1, 1, TW) and
    py (ntiles, 1, TH, 1), broadcasting over a chunk axis; rows start at
    y_offset of the full frame."""
    nty, ntx = grid_dims(config)
    TH, TW, sub = config.tile_h, config.tile_w, config.subpixel
    col = torch.arange(ntx * TW, dtype=I32, device=device) * sub + sub // 2
    row = (torch.arange(nty * TH, dtype=I32, device=device) + y_offset) * sub + sub // 2
    px = col.reshape(1, ntx, 1, TW).expand(nty, ntx, 1, TW).reshape(nty * ntx, 1, 1, TW)
    py = row.reshape(nty, 1, TH, 1).expand(nty, ntx, TH, 1).reshape(nty * ntx, 1, TH, 1)
    return px, py


def untile(a: torch.Tensor, config: RenderConfig) -> torch.Tensor:
    """(ntiles, TH, TW) per-tile values -> the (H, W) framebuffer."""
    nty, ntx = grid_dims(config)
    TH, TW = config.tile_h, config.tile_w
    return a.reshape(nty, ntx, TH, TW).permute(0, 2, 1, 3).reshape(nty * TH, ntx * TW)[
        : config.height, : config.width
    ]


class BinResult(NamedTuple):
    """lists (ntiles, bin_capacity) i32: each tile's first bin_capacity ids,
    ascending, LIST_EMPTY-padded; counts (ntiles,) i32 = min(raw_counts,
    bin_capacity). sid: (even length,) i32 ids sorted by (tile, id); tile
    t's segment is sid[starts[t] : starts[t] + raw_counts[t]]. large_ids
    (lcap,) i32 ascending, LIST_EMPTY-padded; large_count () i32 (<= lcap).
    dropped () i32 counts entries over bin_capacity plus large-bucket
    overflow, as the reference's lists path reports it; large_dropped ()
    i32."""

    lists: torch.Tensor
    counts: torch.Tensor
    sid: torch.Tensor
    starts: torch.Tensor
    raw_counts: torch.Tensor
    large_ids: torch.Tensor
    large_count: torch.Tensor
    large_dropped: torch.Tensor
    dropped: torch.Tensor


def _tile_ranges(tri: TriBuf, config: RenderConfig, y_offset: int = 0):
    """Per-triangle tile bbox ranges, clamped to this band's tile grid,
    plus the binnable mask."""
    nty, ntx = grid_dims(config)
    TH, TW = config.tile_h, config.tile_w
    sub = config.subpixel
    half = sub // 2
    min_x, max_x = tri.xs.amin(1), tri.xs.amax(1)
    min_y, max_y = tri.ys.amin(1), tri.ys.amax(1)
    # pixel ranges (ceil division written as -(-a // b)), then tile ranges
    ix0 = -(-(min_x - half) // sub)
    ix1 = (max_x - half) // sub
    iy0 = -(-(min_y - half) // sub) - y_offset
    iy1 = (max_y - half) // sub - y_offset
    tx0 = torch.clamp(ix0 // TW, 0, ntx - 1)
    tx1 = torch.clamp(ix1 // TW, 0, ntx - 1)
    ty0 = torch.clamp(iy0 // TH, 0, nty - 1)
    ty1 = torch.clamp(iy1 // TH, 0, nty - 1)
    valid = (
        tri.valid
        & (ix1 >= torch.clamp_min(ix0, 0))
        & (ix0 <= config.width - 1)
        & (iy1 >= torch.clamp_min(iy0, 0))
        & (iy0 <= config.height - 1)
    )
    return tx0, tx1, ty0, ty1, valid


def span_classes(tx0, tx1, ty0, ty1, valid, config: RenderConfig):
    """small: bbox within 2x2 tiles; med_ok: the medium-eligible set."""
    small = (tx1 <= tx0 + 1) & (ty1 <= ty0 + 1)
    if config.medium_capacity > 0:
        med_ok = (
            valid & ~small
            & (tx1 - tx0 < config.medium_span)
            & (ty1 - ty0 < config.medium_span)
        )
    else:
        med_ok = torch.zeros_like(valid)
    return small, med_ok


def bin_triangles(tri: TriBuf, config: RenderConfig, y_offset: int = 0) -> BinResult:
    """Pair emission -> one key sort -> per-tile segments (searchsorted)
    -> capped per-tile lists (gathers from the sorted ids)."""
    if config.bin_zorder:
        raise NotImplementedError("bin_zorder is not ported yet")
    if config.bin_pairs != 4:
        raise NotImplementedError("bin_pairs=2 is not ported yet")
    nty, ntx = grid_dims(config)
    ntiles = ntx * nty
    lcap = config.large_capacity
    C = tri.capacity
    dev = tri.xs.device

    tx0, tx1, ty0, ty1, valid = _tile_ranges(tri, config, y_offset)
    small, med_ok = span_classes(tx0, tx1, ty0, ty1, valid, config)
    ids = torch.arange(C, dtype=I32, device=dev)
    idbits = max(1, int(C - 1).bit_length())
    assert (ntiles << idbits) < 2**31 - 1, (
        f"sort key overflow: ntiles={ntiles}, capacity={C}"
    )

    # <= 4 (tile, id) pairs per small triangle; sentinel tile ntiles sorts last
    sm = valid & small
    two_x = tx1 > tx0
    two_y = ty1 > ty0
    pair_tile = torch.stack(
        [
            torch.where(sm, ty0 * ntx + tx0, ntiles),
            torch.where(sm & two_x, ty0 * ntx + tx1, ntiles),
            torch.where(sm & two_y, ty1 * ntx + tx0, ntiles),
            torch.where(sm & two_x & two_y, ty1 * ntx + tx1, ntiles),
        ],
        dim=1,
    )
    keys = [((pair_tile << idbits) | ids[:, None]).reshape(-1)]

    # medium class: the first medium_capacity eligible triangles (id order)
    # emit one pair per covered tile; the rest keep the large-bucket route
    span = config.medium_span
    mcap = config.medium_capacity
    medium = torch.zeros_like(valid)
    if mcap > 0:
        mid, _, mtotal = _sort_compact_ids(med_ok, mcap)
        mlive = torch.arange(mcap, device=dev) < torch.clamp_max(mtotal, mcap)
        mrank = torch.cumsum(med_ok.to(I32), 0, dtype=I32) - 1
        medium = med_ok & (mrank < mcap)
        m = mid.long()
        o = torch.arange(span, dtype=I32, device=dev)
        tile_x = tx0[m][:, None] + o[None]
        tile_y = ty0[m][:, None] + o[None]
        okx = tile_x <= tx1[m][:, None]
        oky = tile_y <= ty1[m][:, None]
        mmask = oky[:, :, None] & okx[:, None, :] & mlive[:, None, None]
        mtile = torch.where(mmask, tile_y[:, :, None] * ntx + tile_x[:, None, :], ntiles)
        mpid = torch.where(mmask, mid[:, None, None], 0)
        keys.append(((mtile << idbits) | mpid).reshape(-1))

    merged = torch.cat(keys)
    if merged.shape[0] % 2:
        # keep the key count even, as the reference does
        merged = torch.cat([merged, merged.new_full((1,), ntiles << idbits)])
    skeys = torch.sort(merged).values
    stile = skeys >> idbits
    sid = skeys & ((1 << idbits) - 1)

    tgt = torch.arange(ntiles, dtype=I32, device=dev)
    starts = torch.searchsorted(stile, tgt, right=False, out_int32=True)
    ends = torch.searchsorted(stile, tgt, right=True, out_int32=True)
    raw_counts = ends - starts
    cap = config.bin_capacity
    counts = torch.clamp_max(raw_counts, cap)
    col = torch.arange(cap, dtype=I32, device=dev)
    gidx = torch.clamp(starts[:, None] + col[None, :], 0, sid.shape[0] - 1).long()
    lists = torch.where(col[None, :] < counts[:, None], sid[gidx], LIST_EMPTY)

    # global large bucket, ascending ids
    to_large = valid & ~small & ~medium
    lsorted = torch.sort(torch.where(to_large, ids, LIST_EMPTY)).values
    large_count_raw = to_large.sum(dtype=I32)
    large_count = torch.clamp_max(large_count_raw, lcap)
    if lcap >= C:
        large_ids = torch.cat([lsorted, lsorted.new_full((lcap - C,), LIST_EMPTY)])
    else:
        large_ids = lsorted[:lcap]
    large_dropped = torch.clamp_min(large_count_raw - lcap, 0)
    dropped = (
        torch.clamp_min(raw_counts - cap, 0).sum(dtype=I32)
        + large_dropped
    )
    return BinResult(
        lists=lists, counts=counts, sid=sid, starts=starts, raw_counts=raw_counts, large_ids=large_ids,
        large_count=large_count, large_dropped=large_dropped, dropped=dropped,
    )
