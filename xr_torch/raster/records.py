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
  13     z_min deflated by 8 ulps (f32 bits; the reference's occlusion
         early-out bound, kept for layout parity)
  14     triangle id
  15     top-left tie offsets o_k in bits 0..2 (accept iff e_k >= o_k)
  16     packed y bbox (by0+32768) | (by1+32768) << 16, band-translated
  17     packed x bbox (bx0+32768) | (bx1+32768) << 16

The CUDA kernels cut every tile's walk (the large bucket, then the tile's
own ids) into chunks of ITEM_RECORDS records, fold each chunk on its own and
merge the partial results of a tile through a packed 64-bit (z, id) key:
``item_table`` lists the chunks for them, ``pack_key`` / ``unpack_key`` are
the key in plain PyTorch and ``fold_plain_items`` is that algorithm on top
of the plain fold.
"""

from __future__ import annotations

import torch

from xr_torch.core.types import RenderConfig
from xr_torch.raster import common as rc
from xr_torch.raster.binning import grid_dims, tile_pixels, untile
from xr_torch.raster.common import BG_TRI_ID

NFIELDS = 18
PLAIN_CHUNK = 8  # records folded per step of the plain version
ITEM_RECORDS = 128  # records per work item of the kernels (csrc/fold_records.cuh kItem)
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


def _fold_chunk(zb, tb, r, px, py, depth_test: bool):
    """Fold (ntiles, K, 18) gathered records (id BG = empty slot) into the
    (ntiles, TH, TW) carry, the kernels' per-pixel test batched over K."""

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


def id_chunks(ids: torch.Tensor, starts: torch.Tensor, n: torch.Tensor, C: int, stride=1):
    """The segments ids[starts[i] : starts[i] + n[i]] of a flat id array,
    PLAIN_CHUNK entries at a time: (rows, PLAIN_CHUNK) i32 chunks with the
    empty slot C past each segment's end. With a stride (an int or a (rows,)
    tensor) entry k of row i is ids[starts[i] + k * stride[i]]. The trip
    count is read from the data (one host read)."""
    n_max = int(n.max()) if n.numel() else 0
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
                     tile_ran=None, seed=None):
    """The kernels' work split in plain PyTorch: every tile's walk (the
    large bucket, then ids[starts[t] : starts[t] + n[t]]) is dealt
    round-robin into its chunks of at most ITEM_RECORDS (chunk c of a walk
    of nch chunks takes records c, c + nch, ...), each chunk is folded from
    a cleared carry, and the partial results are merged through pack_key,
    in chunk order or, with a seed, in a shuffled order. Equals fold_plain
    over the same walk bit for bit. Returns (tid, z, chunks of the longest
    walk)."""
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
