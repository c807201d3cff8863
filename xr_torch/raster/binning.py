"""Sort-based, scatter-free screen-tile binning (port of ``bin_triangles``
and its helpers in ``xr/raster/jnp_backend.py``).

Each small triangle (bbox within 2x2 tiles) emits 4 (tile, id) key slots,
duplicates masked to a sentinel tile (or 2 slots plus a compacted quad row
under ``bin_pairs=2``); medium triangles (bbox within medium_span^2 tiles,
the first medium_capacity of them) emit one key per covered tile; the rest
go to a global "large" bucket that every tile scans. Keys (tile << idbits |
id) are sorted, so each tile's segment of ``sid`` is contiguous and
id-ascending; under ``bin_zorder`` it is ordered front to back by quantized
z_min instead.
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
    """lists (ntiles, bin_capacity) i32: each tile's first bin_capacity ids
    in segment order, LIST_EMPTY-padded; counts (ntiles,) i32 =
    min(raw_counts, bin_capacity). sid: (even length,) i32 ids sorted by
    (tile, id), or by (tile, quantized z_min) under bin_zorder; tile t's
    segment is sid[starts[t] : starts[t] + raw_counts[t]]. large_ids
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
    -> capped per-tile lists (gathers from the sorted ids).

    bin_pairs=2 emits two slots per small triangle (its home tile and, for
    a span of two tiles, the other; t01 for a 2x2 span) and compacts the
    2x2-spanning ones into bin_quad_capacity rows carrying (t10, t11); quad
    overflow goes to the large bucket while its two emitted slots stay
    live, so a tile's walk may hold an id twice (the resolve does not mind).
    bin_zorder sorts each segment by quantized z_min instead of by id: the
    key of a slot is ((tile << zbits) | zq) with the id as payload, sorted
    stably, so ties keep the emission order of the reference."""
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

    zorder = config.bin_zorder
    if zorder:
        zbits = min(16, 30 - int(ntiles).bit_length())
        scale = float(2**zbits - 1)
        # NaN (a non-finite vertex) converts to 0, as XLA converts it
        zq_c = torch.nan_to_num(torch.clamp(tri.z.amin(1) * scale, 0.0, scale), nan=0.0).to(I32)
        shift = zbits
    else:
        shift = idbits

    def keys_of(ptile, pid, rows):
        """One emission class as (sort key, id payload), flattened; rows
        index zq_c for the class's zq (it rides every slot of a row)."""
        pid = pid.expand(ptile.shape)
        if not zorder:
            return ((ptile << idbits) | pid).reshape(-1), None
        zq = zq_c[rows.long()].reshape(rows.shape + (1,) * (ptile.ndim - 1))
        return ((ptile << zbits) | zq).reshape(-1), pid.reshape(-1)

    # small triangles: the tiles of a <= 2x2 span; sentinel tile ntiles
    # sorts last
    sm = valid & small
    t00 = ty0 * ntx + tx0
    t01 = ty0 * ntx + tx1
    t10 = ty1 * ntx + tx0
    t11 = ty1 * ntx + tx1
    two_x = tx1 > tx0
    two_y = ty1 > ty0
    quad = sm & two_x & two_y
    if config.bin_pairs == 2:
        pair_tile = torch.stack(
            [torch.where(sm, t00, ntiles),
             torch.where(sm & (two_x | two_y), torch.where(two_x, t01, t10), ntiles)],
            dim=1,
        )
    else:
        pair_tile = torch.stack(
            [torch.where(sm, t00, ntiles),
             torch.where(sm & two_x, t01, ntiles),
             torch.where(sm & two_y, t10, ntiles),
             torch.where(quad, t11, ntiles)],
            dim=1,
        )
    parts = [keys_of(pair_tile, ids[:, None], ids)]
    in_quad = None
    if config.bin_pairs == 2:
        # the first bin_quad_capacity 2x2 spans carry (t10, t11)
        Q = config.bin_quad_capacity
        qid, _, qtotal = _sort_compact_ids(quad, Q)
        qlive = torch.arange(Q, device=dev) < torch.clamp_max(qtotal, Q)
        qrank = torch.cumsum(quad.to(I32), 0, dtype=I32) - 1
        in_quad = quad & (qrank < Q)  # the rest rides the large bucket
        q = qid.long()
        qtile = torch.where(qlive[:, None], torch.stack([t10[q], t11[q]], dim=1), ntiles)
        parts.append(keys_of(qtile, torch.where(qlive, qid, 0)[:, None], q))

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
        parts.append(keys_of(mtile, mpid, m))

    merged = torch.cat([k for k, _ in parts])
    payload = torch.cat([p for _, p in parts]) if zorder else None
    if merged.shape[0] % 2:
        # keep the key count even, as the reference does
        merged = torch.cat([merged, merged.new_full((1,), ntiles << shift)])
        if zorder:
            payload = torch.cat([payload, payload.new_zeros(1)])
    if zorder:
        skeys, order = torch.sort(merged, stable=True)
        sid = payload[order]
    else:
        skeys = torch.sort(merged).values
        sid = skeys & ((1 << idbits) - 1)
    stile = skeys >> shift

    tgt = torch.arange(ntiles, dtype=I32, device=dev)
    starts = torch.searchsorted(stile, tgt, right=False, out_int32=True)
    ends = torch.searchsorted(stile, tgt, right=True, out_int32=True)
    raw_counts = ends - starts
    cap = config.bin_capacity
    counts = torch.clamp_max(raw_counts, cap)
    col = torch.arange(cap, dtype=I32, device=dev)
    gidx = torch.clamp(starts[:, None] + col[None, :], 0, sid.shape[0] - 1).long()
    lists = torch.where(col[None, :] < counts[:, None], sid[gidx], LIST_EMPTY)

    # global large bucket, ascending ids; bin_pairs=2 adds the quad overflow
    to_large = valid & ~small & ~medium
    if in_quad is not None:
        to_large = to_large | (quad & ~in_quad)
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
