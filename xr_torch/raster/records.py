"""Plane-form setup records of the visibility kernels (port of
``pack_tri_records`` / ``gather_field_records`` in
``xr/raster/pallas_smem.py``), and the record fold of the kernels' plain
PyTorch versions. Everything derivable per record is computed here once, at
capacity scale, so the per-pixel loop only loads.

Field map of the (C, 18) int32 record:
  0..8   a_k, b_k, c_k per edge k (edge opposite vertex k):
         e_k(p) = a_k*px + b_k*py + c_k, exact int32 (modular wraparound
         in the intermediate products is harmless)
  9..11  z0 z1 z2 (f32 bits)
  12     inv_area = 1/area2 (f32 bits, 0 for degenerate) — the value chain
         of fixedpoint.barycentrics_f32, so no pixel loop ever divides
  13     z_min deflated by 8 ulps plus 1e-35 (f32 bits): the z early-out's
         bound, below every depth the fold can interpolate for the record
  14     triangle id
  15     top-left tie offsets o_k in bits 0..2 (accept iff e_k >= o_k)
  16     packed y bbox (by0+32768) | (by1+32768) << 16, band-translated
  17     packed x bbox (bx0+32768) | (bx1+32768) << 16

The CUDA kernels cut every tile's walk (the large bucket, then the tile's
own ids) into chunks of ITEM_RECORDS records, fold each chunk on its own and
merge the partial results of a tile through a packed 64-bit (z, id) key:
``item_table`` lists the chunks for them, ``pack_key`` / ``unpack_key`` are
the key in plain PyTorch and ``fold_plain_items`` is that algorithm on top
of the plain fold (with ``gated=True``, the gated kernel's: bound words
shared by a tile's chunks, in an interleaving a seed chooses).

``fold_plain_gated`` is the fold under the reference's z early-out
(``z_earlyout`` and its refinements): serial in records, as the TPU kernel
runs it, and vectorised over tiles; it counts what each gate skipped.
"""

from __future__ import annotations

import math

import torch

from xr_torch.core.types import RenderConfig
from xr_torch.raster import common as rc
from xr_torch.raster.binning import grid_dims, tile_pixels, untile
from xr_torch.raster.common import BG_TRI_ID

NFIELDS = 18
PLAIN_CHUNK = 8  # records folded per step of the plain version
ITEM_RECORDS = 128  # records per work item of the kernels (csrc/fold_records.cuh kItem)
ZG_REFRESH = 4  # records a gated warp folds before a new bound (fold_records.cuh kRefresh)
WARP_ROWS, WARP_COLS, SLAB_ROWS = 8, 32, 32  # a warp's footprint; rows an item covers
CHUNK_G = 8  # records under one aggregate z_min in the reference's chunk gate
_B16 = 32768
I32, F32 = torch.int32, torch.float32


def _bpack(lo, hi):
    lo = torch.clamp(lo, -_B16, _B16 - 1)
    hi = torch.clamp(hi, -_B16, _B16 - 1)
    return ((lo + _B16) & 0xFFFF) | ((hi + _B16) << 16)


def pack_tri_records(tri, yo: int = 0) -> torch.Tensor:
    """(C, 18) int32 records of a TriBuf; yo = y_offset * subpixel moves the
    records into a band's coordinates."""
    C = tri.capacity
    xs = tri.xs
    ys = tri.ys - yo
    cols = []
    of = torch.zeros((C,), dtype=I32, device=xs.device)
    for k, (i0, i1) in enumerate(((1, 2), (2, 0), (0, 1))):
        # edge opposite vertex k runs v_i0 -> v_i1
        a = ys[:, i1] - ys[:, i0]
        b = xs[:, i0] - xs[:, i1]
        c = -a * xs[:, i0] - b * ys[:, i0]
        cols += [a, b, c]
        tie = (a > 0) | ((a == 0) & (b > 0))
        of = of | (torch.where(tie, 0, 1).to(I32) << k)
    area2f = ((cols[2] + cols[5]) + cols[8]).to(F32)
    safe = torch.where(area2f == 0.0, torch.ones_like(area2f), area2f)
    inva = torch.where(area2f != 0.0, 1.0 / safe, torch.zeros_like(area2f))
    zmin = tri.z.amin(1)
    zmin = zmin * (1.0 - 8.0 * 2.0**-23) - 1e-35
    return torch.cat(
        [torch.stack(cols, dim=1), tri.z.contiguous().view(I32)]
        + [
            v.reshape(C, 1)
            for v in (
                inva.view(I32),
                zmin.view(I32),
                torch.arange(C, dtype=I32, device=xs.device),
                of,
                _bpack(ys.amin(1), ys.amax(1)),
                _bpack(xs.amin(1), xs.amax(1)),
            )
        ],
        dim=1,
    )


def gather_field_records(lists: torch.Tensor, packed: torch.Tensor, C: int) -> torch.Tensor:
    """Records for an id-list array (ids >= C are empty slots): (..., 18)
    int32 rows with the BG sentinel in field 14, the id, of empty slots."""
    rows = packed[torch.clamp_max(lists, C - 1).long()]
    empty = (lists >= C)[..., None]
    is_id = torch.arange(NFIELDS, device=lists.device) == 14
    return torch.where(empty & is_id, BG_TRI_ID, rows)


def _fold_chunk(zb, tb, r, px, py, depth_test: bool, rows=None):
    """Fold (ntiles, K, 18) gathered records (id BG = empty slot) into the
    (ntiles, TH, TW) carry, the kernels' per-pixel test batched over K;
    rows (ntiles, K, TH, 1) bool, if given, masks the rows a record may
    touch."""

    def f(k):
        return r[:, :, k, None, None]

    e = [f(3 * k) * px + f(3 * k + 1) * py + f(3 * k + 2) for k in range(3)]
    of = f(15)
    mask = (e[0] >= (of & 1)) & (e[1] >= ((of >> 1) & 1)) & (e[2] >= ((of >> 2) & 1))
    fz = r[..., 9:13].contiguous().view(F32)
    inv = fz[:, :, 3, None, None]
    zf = (
        (e[0].to(F32) * inv) * fz[:, :, 0, None, None]
        + (e[1].to(F32) * inv) * fz[:, :, 1, None, None]
    ) + (e[2].to(F32) * inv) * fz[:, :, 2, None, None]
    ids = f(14)
    mask = mask & rc.depth_range_mask(zf) & (ids != BG_TRI_ID)
    if rows is not None:
        mask = mask & rows
    return rc.merge_chunk(zb, tb, torch.where(mask, zf, rc.BG_DEPTH), ids, depth_test)


def _fold_carry(rec: torch.Tensor, chunks, config: RenderConfig):
    """Fold id chunks into a cleared (ntiles, TH, TW) carry; returns (zb, tb)."""
    nty, ntx = grid_dims(config)
    ntiles = nty * ntx
    C = rec.shape[0]
    px, py = tile_pixels(config, rec.device)
    zb, tb = rc.new_carry((ntiles, config.tile_h, config.tile_w), config.depth_test, rec.device)
    for ids in chunks:
        r = gather_field_records(ids, rec, C).expand(ntiles, -1, NFIELDS)
        zb, tb = _fold_chunk(zb, tb, r, px, py, config.depth_test)
    return zb, tb


def _finish(zb, tb, config: RenderConfig, tile_ran=None):
    """The folded carry as (tid (H,W) i32, z (H,W) f32, +inf background);
    tiles with tile_ran 0 are background."""
    tb = rc.final_ids(tb, config.depth_test)
    if tile_ran is not None:
        ran = tile_ran[:, None, None] != 0
        tb = torch.where(ran, tb, BG_TRI_ID)
        zb = torch.where(ran, zb, rc.BG_DEPTH)
    return untile(tb, config), untile(zb, config)


def fold_plain(rec: torch.Tensor, chunks, config: RenderConfig, tile_ran=None):
    """The visibility kernels' plain PyTorch version: fold id chunks into
    every tile, batched over tiles. chunks yields (1 or ntiles, K) i32 ids
    (ids >= C are empty slots; one row is shared by every tile, as the
    large bucket is). tile_ran (ntiles,) i32: tiles with 0 stay background.
    Returns (tid (H,W) i32, z (H,W) f32, +inf background)."""
    return _finish(*_fold_carry(rec, chunks, config), config, tile_ran)


def _segment_zmin(rec, sid, starts, n, k):
    """Field-13 z_min of slots k (K,) of every tile's segment, read only
    through a live id: +inf past n[t]. Returns (ids (ntiles, K) with the
    empty slot C past the end, z_min (ntiles, K) f32)."""
    C = rec.shape[0]
    live = k[None, :] < n[:, None]
    gidx = torch.clamp(starts[:, None] + k[None, :], 0, max(sid.shape[0] - 1, 0)).long()
    ids = torch.where(live, sid[gidx], C) if sid.numel() else torch.full_like(gidx, C, dtype=I32)
    zmin = rec[torch.clamp_max(ids, C - 1).long(), 13].contiguous().view(F32)
    return ids, torch.where(live, zmin, float("inf"))


def group_zmin(rec, sid, starts, n) -> torch.Tensor:
    """The chunk gate's aggregates: the least z_min of each CHUNK_G
    consecutive records of every tile's segment sid[starts[t] : starts[t] +
    n[t]], +inf for the slots past its end (the reference's prep,
    ``pallas_stream.py:265-275``). Returns (ntiles, ceil(max n / CHUNK_G))
    f32. One host read of max n."""
    ng = -(-int(n.max()) // CHUNK_G) if n.numel() else 0
    k = torch.arange(ng * CHUNK_G, dtype=I32, device=rec.device)
    return _segment_zmin(rec, sid, starts, n, k)[1].reshape(n.shape[0], ng, CHUNK_G).amin(-1)


def fold_plain_gated(rec, large_ids, large_count, sid, starts, n, config: RenderConfig,
                     tile_ran=None):
    """The reference's z early-out in plain PyTorch (``xr/raster/
    pallas_stream.py:157-179`` over ``pallas_smem.py`` ``_raster_scalar_
    records``): serial in records, vectorised over tiles. The large bucket
    is folded ungated; then each tile's segment sid[starts[t] : starts[t] +
    n[t]] runs in blocks of ``stream_block`` records. Before a block the
    bound is the max of the tile's current z, or under ``z_band_gate`` with
    tile_h > 8 the max of each 8-row band (the tile's is their max). A
    record whose z_min (field 13, read through a live id only) exceeds the
    tile's bound is skipped; under ``z_band_gate`` so is each band whose
    bound it exceeds; under ``z_chunk_gate`` a group of CHUNK_G records
    whose ``group_zmin`` exceeds the bound is skipped whole. The gates are
    off without the depth test or ``z_earlyout``. They never change the
    result: it equals ``fold_plain`` over the same walk bit for bit.

    Returns (tid, z, skips): skips counts the segment records walked
    (``walked``), the records the record gate skipped (``record``), the
    records inside groups the chunk gate skipped (``chunk``), and the
    (record, band) pairs of a record's bbox the band gate skipped
    (``band``), as ints (one host read)."""
    C = rec.shape[0]
    dev = rec.device
    nty, ntx = grid_dims(config)
    ntiles, TH, TW = nty * ntx, config.tile_h, config.tile_w
    px, py = tile_pixels(config, dev)
    zb, tb = rc.new_carry((ntiles, TH, TW), config.depth_test, dev)
    zero = torch.zeros((1,), dtype=I32, device=dev)
    for ids in id_chunks(large_ids, zero, large_count, C):
        r = gather_field_records(ids, rec, C).expand(ntiles, -1, NFIELDS)
        zb, tb = _fold_chunk(zb, tb, r, px, py, config.depth_test)
    gate = config.depth_test and config.z_earlyout
    chunk = gate and config.z_chunk_gate
    nb = TH // 8 if gate and config.z_band_gate and TH > 8 else 0
    blk = config.stream_block
    step = CHUNK_G if chunk else math.gcd(blk, PLAIN_CHUNK)
    if chunk:
        assert blk % CHUNK_G == 0, "stream_block must be a CHUNK_G multiple"
        groups = group_zmin(rec, sid, starts, n)
    skips = dict.fromkeys(("record", "chunk", "band"), torch.zeros((), dtype=torch.int64,
                                                                    device=dev))
    is_id = torch.arange(NFIELDS, device=dev) == 14
    j = torch.arange(step, dtype=I32, device=dev)
    n_max = int(n.max()) if n.numel() else 0
    for s in range(0, n_max, step):
        ids, zmin = _segment_zmin(rec, sid, starts, n, s + j)
        r = gather_field_records(ids, rec, C)
        if gate:
            if s % blk == 0:  # a block starts: the bound from the tile's current z
                if nb:
                    band_z = zb[:, : nb * 8].reshape(ntiles, nb, 8, TW).amax((2, 3))
                    zmax = band_z.amax(1)
                else:
                    zmax = zb.amax((1, 2))
            live = ids < C
            keep = live
            if chunk:
                shut = (groups[:, s // CHUNK_G] > zmax)[:, None]
                skips["chunk"] = skips["chunk"] + (live & shut).sum()
                keep = keep & ~shut
            over = keep & (zmin > zmax[:, None])
            skips["record"] = skips["record"] + over.sum()
            keep = keep & ~over
            rows = None
            if nb:
                ok = zmin[..., None] <= band_z[:, None, :]  # (ntiles, K, nb)
                byp = r[..., 16].long()
                by0, by1 = (byp & 0xFFFF) - _B16, ((byp >> 16) & 0xFFFF) - _B16
                band_py = py[:, 0, : nb * 8 : 8, 0][:, None, :]  # (ntiles, 1, nb) first row
                meets = (by1[..., None] >= band_py) & (by0[..., None] <= band_py + 7 * config.subpixel)
                skips["band"] = skips["band"] + (keep[..., None] & meets & ~ok).sum()
                rows = ok.repeat_interleave(8, dim=2)
                if TH > nb * 8:
                    rows = torch.cat([rows, rows.new_ones(rows.shape[:2] + (TH - nb * 8,))], 2)
                rows = rows[..., None]
            r = torch.where(~keep[..., None] & is_id, BG_TRI_ID, r)
            zb, tb = _fold_chunk(zb, tb, r, px, py, True, rows)
        else:
            zb, tb = _fold_chunk(zb, tb, r, px, py, config.depth_test)
    out = {k: int(v) for k, v in skips.items()}
    out["walked"] = int(n.sum()) if n.numel() else 0
    return (*_finish(zb, tb, config, tile_ran), out)


def id_chunks(ids: torch.Tensor, starts: torch.Tensor, n: torch.Tensor, C: int, stride=1,
              bound=None):
    """The segments ids[starts[i] : starts[i] + n[i]] of a flat id array,
    PLAIN_CHUNK entries at a time: (rows, PLAIN_CHUNK) i32 chunks with the
    empty slot C past each segment's end. With a stride (an int or a (rows,)
    tensor) entry k of row i is ids[starts[i] + k * stride[i]]. The trip
    count is read from the data (one host read), or is ceil(bound /
    PLAIN_CHUNK) where a bound on every n[i] is given: the chunks past the
    longest segment are empty, and folding one changes nothing."""
    n_max = bound if bound is not None else int(n.max()) if n.numel() else 0
    j = torch.arange(PLAIN_CHUNK, dtype=I32, device=ids.device)[None, :]
    if isinstance(stride, torch.Tensor):
        stride = stride[:, None]
    for s in range(0, n_max, PLAIN_CHUNK):
        k = s + j
        gidx = torch.clamp(starts[:, None] + k * stride, 0, ids.shape[0] - 1).long()
        yield torch.where(k < n[:, None], ids[gidx], C)


def item_bound(ntiles: int, large_capacity: int, own_entries: int) -> int:
    """Static bound on the chunks of a launch: every tile walks at most
    ceil(large_capacity / ITEM_RECORDS) chunks of the large bucket, the
    tiles' own ids (own_entries in all) fill at most own_entries /
    ITEM_RECORDS chunks and leave each tile one partial chunk, and a tile
    with nothing to walk still has one (empty) chunk."""
    K = ITEM_RECORDS
    return ntiles * (-(-large_capacity // K) + 2) + own_entries // K


def item_table(n: torch.Tensor, ran: torch.Tensor, large_count: torch.Tensor, bound: int):
    """The chunks of a launch, without a host read. n (ntiles,) i32: own
    records each tile folds; ran (ntiles,): tiles with 0 fold nothing;
    large_count: live entries of the large bucket. A tile that runs has
    ceil(large_count / K) chunks of the large bucket followed by
    ceil(n / K) of its own, K = ITEM_RECORDS, and every tile has at least
    one chunk. Returns (item_tile (bound,) i32: the tile of chunk j, ntiles
    past the last chunk; item_start (ntiles + 1,) i32: first chunk of each
    tile, then the total)."""
    K = ITEM_RECORDS
    nl = -(-large_count.reshape(1).to(I32) // K)
    nch = torch.where(ran != 0, nl + -(-n // K), 0).clamp_min(1)
    ends = torch.cumsum(nch, 0, dtype=I32)
    item_start = torch.cat([ends.new_zeros(1), ends])
    j = torch.arange(bound, dtype=I32, device=n.device)
    item_tile = torch.searchsorted(ends, j, right=True, out_int32=True)
    return item_tile, item_start


def chunk_major_order(item_tile: torch.Tensor, item_start: torch.Tensor) -> torch.Tensor:
    """The order in which the gated kernel takes the chunks of item_table,
    by chunks left to walk: the first chunk of each tile with the most
    chunks first, the last chunk of every tile last. A tile's later chunks
    so start once its earlier ones have merged their depths, and the last
    to start are a mix of light and heavy chunks, not the heaviest tiles'
    alone. Returns (bound,) i32 indices into item_tile, the live chunks
    first."""
    ntiles = item_start.shape[0] - 1
    j = torch.arange(item_tile.shape[0], dtype=torch.int64, device=item_tile.device)
    t = item_tile.long().clamp_max(ntiles - 1)
    first, nch = item_start[t].long(), (item_start[t + 1] - item_start[t]).long()
    left = nch - (j - first)  # chunks of the tile from this one on
    key = torch.where(item_tile < ntiles, -left * ntiles + t, torch.iinfo(torch.int64).max)
    return torch.sort(key, stable=True).indices.to(I32)


def pack_key(z: torch.Tensor, ids: torch.Tensor, depth_test: bool) -> torch.Tensor:
    """The (z, id) carry as one int64 key whose integer order is the
    resolve's: with the depth test the smaller key wins exactly where
    ``common.resolve_better`` holds (z in [0, 1] or +inf orders by its f32
    bits; -0.0 packs as 0.0, as the float compare sees it, and bit 0 keeps
    its sign; the id takes bits 1..32); in painter's order the larger key is
    the higher id (id + 1 above the z bits, so "none", -1, is lowest)."""
    zb = z.contiguous().view(I32).long() & 0xFFFFFFFF
    if depth_test:
        neg0 = zb == 0x80000000
        return (torch.where(neg0, 0, zb) << 32) | (ids.long() << 1) | neg0.long()
    return ((ids.long() + 1) << 32) | zb


def unpack_key(key: torch.Tensor, depth_test: bool):
    """(z f32, ids i32) of pack_key's keys: the winner's own z bits."""
    if depth_test:
        ids = (key >> 1) & 0x7FFFFFFF
        zb = torch.where((key & 1) != 0, -(2**31), key >> 32)
    else:
        ids = (key >> 32) - 1
        zb = key & 0xFFFFFFFF
    return zb.to(I32).view(F32), ids.to(I32)


def merge_keys(a: torch.Tensor, b: torch.Tensor, depth_test: bool) -> torch.Tensor:
    """The better of two keys per element: the merge is commutative and
    associative, so partial results combine in any order."""
    return torch.minimum(a, b) if depth_test else torch.maximum(a, b)


def fold_plain_items(rec, ids, starts, n, large_ids, large_count, config: RenderConfig,
                     tile_ran=None, seed=None, gated=False, slots=None):
    """The kernels' work split in plain PyTorch: every tile's walk (the
    large bucket, then ids[starts[t] : starts[t] + n[t]]) is dealt
    round-robin into its chunks of at most ITEM_RECORDS (chunk c of a walk
    of nch chunks takes records c, c + nch, ...), each chunk is folded from
    a cleared carry, and the partial results are merged through pack_key,
    in chunk order or, with a seed, in a shuffled order. Equals fold_plain
    over the same walk bit for bit. Returns (tid, z, chunks of the longest
    walk).

    gated=True is the gated kernel's split instead (``_fold_items_gated``,
    the depth test only): each warp's walk gated by the bound words its
    tile's chunks share, in an interleaving the seed chooses (and `slots`,
    the items that run at once, if given). Returns (tid, z, what the gate
    counted)."""
    if gated:
        return _fold_items_gated(rec, ids, starts, n, large_ids, large_count, config,
                                 tile_ran, seed or 0, slots)
    K = ITEM_RECORDS
    C = rec.shape[0]
    L = large_count.reshape(1).to(I32)
    nl = -(-int(L) // K)
    items = [(large_ids, torch.full_like(L, c), -(-(L - c) // nl), nl) for c in range(nl)]
    nch = -(-n // K)  # chunks of each tile's own ids
    items += [(ids, starts + c, torch.where(c < nch, -(-(n - c) // nch.clamp_min(1)), 0), nch)
              for c in range(int(nch.max()) if n.numel() else 0)]
    if seed is not None:
        order = torch.randperm(len(items), generator=torch.Generator().manual_seed(seed))
        items = [items[i] for i in order.tolist()]
    nty, ntx = grid_dims(config)
    shape = (nty * ntx, config.tile_h, config.tile_w)
    key = pack_key(*rc.new_carry(shape, config.depth_test, rec.device), config.depth_test)
    for src, first, count, stride in items:
        zb, tb = _fold_carry(rec, id_chunks(src, first, count, C, stride), config)
        key = merge_keys(key, pack_key(zb, tb, config.depth_test), config.depth_test)
    zb, tb = unpack_key(key, config.depth_test)
    return (*_finish(zb, tb, config, tile_ran), len(items))


def _order_bits(z: torch.Tensor) -> torch.Tensor:
    """f32 as int64 in [0, 2**32) whose integer order is the float order
    (the kernel's bound words, fold_records.cuh order_bits)."""
    b = z.contiguous().view(I32).long() & 0xFFFFFFFF
    return torch.where(b >= 2**31, b ^ 0xFFFFFFFF, b | 2**31)


def _unorder_bits(o: torch.Tensor) -> torch.Tensor:
    b = torch.where(o >= 2**31, o & 0x7FFFFFFF, o ^ 0xFFFFFFFF)
    return torch.where(b >= 2**31, b - 2**32, b).to(I32).view(F32)


def _fold_items_gated(rec, ids, starts, n, large_ids, large_count, config: RenderConfig,
                      tile_ran, seed: int, slots=None):
    """The gated kernel's algorithm (csrc/fold_records.cuh
    ``zgate_fold_items``) in plain PyTorch, run as one interleaving of its
    items that the seed chooses.

    Every tile's walk (the large bucket, then its own ids; nothing for a
    tile outside the budget) is dealt round-robin into chunks of at most
    ITEM_RECORDS records, as fold_plain_items deals it. An item is one
    chunk in one 32-row slab; its 16 warps own 32x8 footprints. Items start
    in the kernel's order (``chunk_major_order``) as running ones finish,
    at most `slots` at once (seed 0: all; else drawn from [items / 8,
    items] unless given); at each step each warp of a running item takes
    the next record of its walk (those whose bbox meets its footprint,
    ``footprint_hits``) with its item's chance `pace`. A warp starts from
    the bound word of its (tile, slab, warp) (a tile of one chunk shares
    none) and skips a record whose z_min (field 13) exceeds its bound. When
    its walk enters another word of 32 slots of the chunk (a word of the
    kernel's mask) having folded ZG_REFRESH records or more since its last
    bound, it takes its own bound (the largest depth of its pixels inside
    the frame), publishes it to the word if lower (at the end of the step),
    gates on the least of it and the word as the warp read it at its last
    refresh or start, and reads the word again (as it was before the step).
    Items merge through pack_key. Equals fold_plain over the same walk bit
    for bit.

    Returns (tid, z, counts): counts has ``pairs`` ((record, warp) pairs of
    footprints holding a pixel of the frame), ``skipped`` (those the gate
    skipped), ``items``, ``slots`` and ``steps``, as ints."""
    assert config.depth_test, "the gate runs with the depth test only"
    dev = rec.device
    K = ITEM_RECORDS
    nty, ntx = grid_dims(config)
    ntiles, TH, TW, sub = nty * ntx, config.tile_h, config.tile_w, config.subpixel
    half = sub // 2
    nslab = -(-TH // SLAB_ROWS)
    nwarps = (SLAB_ROWS // WARP_ROWS) * (TW // WARP_COLS)
    C = rec.shape[0]
    ran = torch.ones(ntiles, dtype=I32, device=dev) if tile_ran is None else tile_ran
    L = int(large_count.reshape(()))
    nl = -(-L // K)
    total = int(torch.where(ran != 0, nl + -(-n // K), 0).clamp_min(1).sum())
    item_tile, item_start = item_table(n, ran, large_count.reshape(1), total)
    order = chunk_major_order(item_tile, item_start).long()

    # items (chunk in the kernel's order, slab): tile, run of record ids
    j = order.repeat_interleave(nslab)
    slab = torch.arange(nslab, device=dev).repeat(total)
    t = item_tile.long()[j]
    c = j - item_start.long()[t]
    nch = (item_start[1:] - item_start[:-1]).long()[t]
    k = torch.arange(K, device=dev)
    own = c >= nl
    nt = n.long()[t]
    # chunk c of a walk of nch chunks takes records c, c + nch, ...
    first = torch.where(own, c - nl, c)
    stride = torch.where(own, -(-nt // K), nl)
    walk_n = torch.where(own, nt, L) - first
    length = torch.where(stride > 0, -(-walk_n // stride.clamp_min(1)), 0)
    length = torch.where(ran[t] != 0, length, 0).clamp(0, K)
    at = first[:, None] + k * stride[:, None]

    def pick(a, i):  # a[i], any i where a is empty
        return a.long()[i.clamp(0, a.numel() - 1)] if a.numel() else torch.zeros_like(i)

    src = torch.where(own[:, None], pick(ids, starts.long()[t][:, None] + at), pick(large_ids, at))
    rid = torch.where(k < length[:, None], src, -1)  # (items, K)
    nitems = rid.shape[0]

    # each warp's footprint: its pixels, its rows inside the slab and the frame
    w = torch.arange(nwarps, device=dev)
    rg, cg = w // (TW // WARP_COLS), w % (TW // WARP_COLS)
    slab_rows = (TH - slab * SLAB_ROWS).clamp_max(SLAB_ROWS)
    rows = (slab_rows[:, None] - rg * WARP_ROWS).clamp(0, WARP_ROWS)  # (items, W)
    row0 = (t // ntx * TH + slab * SLAB_ROWS)[:, None] + rg * WARP_ROWS
    col0 = (t % ntx * TW)[:, None] + cg * WARP_COLS  # (items, W)
    lane = torch.arange(WARP_COLS, device=dev)
    kk = torch.arange(WARP_ROWS, device=dev)
    col = col0[..., None, None] + lane  # (items, W, 1, 32)
    row = row0[..., None, None] + kk[:, None]  # (items, W, 8, 1)
    px, py = (col * sub + half).to(I32), (row * sub + half).to(I32)
    in_run = kk[:, None] < rows[..., None, None]  # (items, W, 8, 1)
    live_px = in_run & (row < config.height) & (col < config.width)
    live = live_px.flatten(2).any(2)  # (items, W)

    # the warps' walks: the run's records whose bbox meets the footprint
    r = rec[rid.clamp_min(0)]
    byp, bxp = r[..., 16].long(), r[..., 17].long()
    bx0, bx1 = (bxp & 0xFFFF) - _B16, ((bxp >> 16) & 0xFFFF) - _B16
    by0, by1 = (byp & 0xFFFF) - _B16, ((byp >> 16) & 0xFFFF) - _B16
    gx0 = col0 * sub + half
    gy0 = row0 * sub + half
    gx1, gy1 = gx0 + (WARP_COLS - 1) * sub, gy0 + (rows - 1) * sub
    hit = ((rid >= 0)[:, None, :] & (rows > 0)[..., None]
           & (bx1[:, None, :] >= gx0[..., None]) & (bx0[:, None, :] <= gx1[..., None])
           & (by1[:, None, :] >= gy0[..., None]) & (by0[:, None, :] <= gy1[..., None]))
    walk_len = hit.sum(2)  # (items, W)
    slot_of = torch.sort(torch.where(hit, k, K), dim=2).values  # walk order: record order
    walk = torch.where(slot_of < K, torch.gather(rid[:, None, :].expand_as(hit), 2,
                                                 slot_of.clamp_max(K - 1)), -1)
    word_of = slot_of // 32  # the word of the chunk's mask each walk entry lies in
    pairs = int((hit & live[..., None]).sum())

    gen = torch.Generator().manual_seed(seed)
    drawn = int(torch.randint(max(1, nitems // 8), nitems + 1, (1,), generator=gen))
    slots = slots or (drawn if seed else nitems)
    pace = (0.25 + 0.75 * torch.rand(nitems, generator=gen)).to(dev)
    zmin_of = rec[:, 13].contiguous().view(F32)
    inf = torch.tensor(float("inf"), device=dev)
    zb = torch.full((nitems, nwarps, WARP_ROWS, WARP_COLS), float("inf"), device=dev)
    tb = torch.full(zb.shape, BG_TRI_ID, dtype=I32, device=dev)
    words = torch.full((ntiles * nslab * nwarps,), int(_order_bits(inf)), dtype=torch.int64,
                       device=dev)
    word = ((t * nslab + slab)[:, None] * nwarps + w)  # (items, W)
    shared = (nch > 1)[:, None].expand(-1, nwarps)
    wz = torch.zeros((nitems, nwarps), device=dev)
    seen = torch.zeros((nitems, nwarps), dtype=torch.int64, device=dev)  # the word as last read
    pos = torch.zeros((nitems, nwarps), dtype=torch.int64, device=dev)
    since = torch.zeros_like(pos)
    last_word = torch.zeros_like(pos)
    skipped = 0
    state = torch.zeros(nitems, dtype=torch.int64, device=dev)  # 0 waiting, 1 running, 2 done
    nxt, steps = 0, 0

    def warp_bound(i, ww):  # (A,) walkers -> the largest depth of their live pixels
        z = torch.where(live_px[i, ww], zb[i, ww], -inf)
        return z.flatten(1).amax(1)

    # the tile's keys, and where each item's pixels lie in them
    shape = (ntiles, TH, TW)
    key = pack_key(*rc.new_carry(shape, True, dev), True).flatten()
    trow = (slab[:, None, None, None] * SLAB_ROWS + rg[None, :, None, None] * WARP_ROWS
            + kk[:, None])  # (items, W, 8, 1): row inside the tile
    tcol = cg[None, :, None, None] * WARP_COLS + lane  # (1, W, 1, 32)
    flat = ((t[:, None, None, None] * TH + trow) * TW + tcol).expand_as(zb)
    in_run_px = in_run.expand_as(zb)

    while True:
        running = int((state == 1).sum())
        while running < slots and nxt < nitems:  # an item starts: bound from the words
            state[nxt] = 1
            b = torch.where(live[nxt], inf, -inf)
            seen[nxt] = torch.where(shared[nxt], words[word[nxt]], int(_order_bits(inf)))
            wz[nxt] = torch.minimum(b, _unorder_bits(seen[nxt]))
            nxt += 1
            running += 1
        if running == 0:
            break
        steps += 1
        go = ((state == 1)[:, None] & (pos < walk_len)
              & (torch.rand((nitems, nwarps), generator=gen).to(dev) < pace[:, None]))
        i, ww = go.nonzero(as_tuple=True)
        p = pos[i, ww]
        q = word_of[i, ww, p]
        ref = (q != last_word[i, ww]) & (since[i, ww] >= ZG_REFRESH)
        last_word[i, ww] = q
        if bool(ref.any()):  # a bound at the word: own, published, least with the last read
            a, wa = i[ref], ww[ref]
            since[a, wa] = 0
            b = warp_bound(a, wa)
            sh = shared[a, wa]
            wz[a, wa] = torch.where(sh, torch.minimum(b, _unorder_bits(seen[a, wa])), b)
            seen[a, wa] = torch.where(sh, words[word[a, wa]], seen[a, wa])
            words.scatter_reduce_(0, word[a, wa][sh], _order_bits(b)[sh], "amin")
        rr = walk[i, ww, p]
        pos[i, ww] += 1
        skip = zmin_of[rr] > wz[i, ww]
        skipped += int((skip & live[i, ww]).sum())
        i, ww, rr = i[~skip], ww[~skip], rr[~skip]
        if i.numel():
            f = rec[rr]
            x, y = px[i, ww], py[i, ww]
            e = [f[:, 3 * g, None, None] * x + f[:, 3 * g + 1, None, None] * y
                 + f[:, 3 * g + 2, None, None] for g in range(3)]
            of = f[:, 15, None, None]
            fz = f[:, 9:13].contiguous().view(F32)
            inv = fz[:, 3, None, None]
            zf = ((e[0].to(F32) * inv) * fz[:, 0, None, None]
                  + (e[1].to(F32) * inv) * fz[:, 1, None, None]
                  ) + (e[2].to(F32) * inv) * fz[:, 2, None, None]
            cov = ((e[0] >= (of & 1)) & (e[1] >= ((of >> 1) & 1)) & (e[2] >= ((of >> 2) & 1))
                   & rc.depth_range_mask(zf) & in_run[i, ww])
            idn = f[:, 14, None, None]
            zo, to = zb[i, ww], tb[i, ww]
            better = cov & ((zf < zo) | ((zf == zo) & (idn < to)))
            zb[i, ww] = torch.where(better, zf, zo)
            tb[i, ww] = torch.where(better, idn, to)
            since[i, ww] += 1
        done = (state == 1) & (pos >= walk_len).all(1)
        state[done] = 2
        if bool(done.any()):  # merge through the keys
            d = done.nonzero().flatten()
            m = in_run_px[d]
            key.scatter_reduce_(0, flat[d][m], pack_key(zb[d], tb[d], True)[m], "amin")

    zf, tf = unpack_key(key.reshape(shape), True)
    counts = {"pairs": pairs, "skipped": skipped, "items": nitems, "slots": slots,
              "steps": steps}
    return (*_finish(zf, tf, config, tile_ran), counts)
