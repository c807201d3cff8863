"""Binning and the streaming visibility of the port against the reference,
from the reference's own TriBuf (config3 at golden size, t = 0.3).

Bins (sid, starts, raw_counts, large bucket, dropped) must be exact. The
port's visibility on the CPU runs the kernel's plain version; it is held
against the Pallas stream kernel in interpret mode: ids and dropped exact,
depth within 1e-6 (the interpreted kernel is compiled by XLA, which may
contract the depth sum; the port rounds every product, as the CUDA kernel
does). The cases are those that chip_smoke.py runs on the card.

The CUDA kernel cuts a tile's walk into work items and merges their partial
results through a packed 64-bit (z, id) key. That algorithm is held here in
plain PyTorch against the in-order plain version, bit for bit: the key's
order against ``resolve_better`` on hand-made pairs, the item fold in a
shuffled merge order in every case and on a scene where every covered pixel
ties on z, and a hand-made record whose depth is -0.0.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xr.core import math3d as rm3
from xr.pipeline.geometry import geometry as ref_geometry
from xr.raster import jnp_backend as ref_jb
from xr.raster import pallas_stream as ref_stream
from xr.scene import presets as ref_presets
from xr.scene import procedural as ref_proc
from xr_torch import convert, kernels
from xr_torch.raster import binning, dispatch, records, stream
from xr_torch.raster import common as rc

# the suite runs several worker processes on shared cores: one torch
# thread each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

W, H = 192, 108
CASES = {
    "as_is": ({}, 0),
    # 8-row tiles and no medium class: the large bucket is non-empty
    "large_bucket": ({"medium_capacity": 0, "tile_h": 8}, 0),
    "painter": ({"depth_test": False}, 0),
    # a stream budget far too small: whole blocks drop, tiles go to BG
    "stream_overflow": ({"stream_expand": 0.001}, 0),
    # rows [32, 64) as one band of a sharded frame
    "band": ({"height": 32}, 32),
}


def _geometry(p):
    cam, mm = p.animate(0.3, np)
    view, proj = rm3.camera_matrices(cam, W / H, np)
    tri = ref_geometry(p.scene.replace(model_matrices=mm), jnp.asarray(view),
                       jnp.asarray(proj), p.config, xp=jnp)
    return tri, p.config


def _stream_visibility(tri, cfg, y_offset=0):
    """The stream backend's visibility as the port's dispatch runs it:
    (tid, z, dropped)."""
    cfg = dataclasses.replace(cfg, backend="pallas_stream", raster_path="binned")
    return dispatch.visibility(tri, cfg, tri.capacity, y_offset)


@pytest.fixture(scope="module")
def ref_tri():
    return _geometry(ref_presets.small_preset(ref_presets.config3_terrain(48, 48), W, H,
                                              bin_capacity=8192))


@pytest.fixture(scope="module")
def tie_tri():
    """The terrain merged with a copy of itself: every covered pixel ties on
    z between a triangle and its copy, and the lower id must win."""
    p = ref_presets.config3_terrain(48, 48)
    mesh = ref_proc.with_vert_mat(ref_proc.merge_meshes([p.scene.mesh, p.scene.mesh]))
    p = p._replace(scene=p.scene.replace(mesh=mesh))
    return _geometry(ref_presets.small_preset(p, W, H, bin_capacity=8192))


@pytest.mark.parametrize("case", sorted(CASES))
def test_bins_exact(ref_tri, case):
    rtri, base = ref_tri
    over, yo = CASES[case]
    cfg = dataclasses.replace(base, **over)
    rb = ref_jb.bin_triangles(rtri, cfg, y_offset=yo)
    b = binning.bin_triangles(convert.tribuf_to_torch(rtri, "cpu"), convert.config_from(cfg), y_offset=yo)
    for f in ("sid", "starts", "raw_counts", "large_ids", "large_count", "dropped", "large_dropped"):
        a, r = getattr(b, f).numpy(), np.asarray(getattr(rb, f))
        assert a.shape == r.shape and (a == r).all(), f
    if case == "large_bucket":
        assert int(b.large_count) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_visibility_matches_pallas_interpret(ref_tri, case):
    rtri, base = ref_tri
    over, yo = CASES[case]
    cfg = dataclasses.replace(base, **over)
    rt, rz, rd = ref_stream.visibility_binned(rtri, cfg, y_offset=yo, interpret=True)
    kernels.reset_launches()
    t, z, d = _stream_visibility(
        convert.tribuf_to_torch(rtri, "cpu"), convert.config_from(cfg), y_offset=yo
    )
    assert kernels.launches["vis_stream"] == 0  # CPU tensors: the plain version
    rt, rz = np.asarray(rt), np.asarray(rz)
    assert t.dtype == torch.int32 and z.dtype == torch.float32
    assert (t.numpy() == rt).all()
    assert int(d) == int(rd)
    assert (np.isinf(z.numpy()) == np.isinf(rz)).all()
    fin = np.isfinite(rz)
    np.testing.assert_allclose(z.numpy()[fin], rz[fin], rtol=0, atol=1e-6)
    if case == "stream_overflow":
        assert int(d) > 0 and (rt == 2**31 - 1).sum() > (t.shape[0] * t.shape[1]) // 4
    else:
        assert int(d) == 0


def test_band_matches_full_frame(ref_tri):
    """A band at y_offset renders exactly the rows of the full frame."""
    rtri, base = ref_tri
    tri = convert.tribuf_to_torch(rtri, "cpu")
    cfg = convert.config_from(base)
    tf, zf, _ = _stream_visibility(tri, cfg)
    tb, zb, _ = _stream_visibility(tri, cfg.replace(height=32), y_offset=32)
    assert torch.equal(tb, tf[32:64]) and torch.equal(zb, zf[32:64])


def test_stream_blocks_matches_reference(ref_tri):
    rtri, base = ref_tri
    for over, _ in CASES.values():
        cfg = dataclasses.replace(base, **over)
        assert stream.stream_blocks(convert.config_from(cfg), rtri.capacity, rtri.num_src) == \
            ref_stream.stream_blocks(cfg, rtri.capacity, rtri.num_src)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """A tile_w other than 128 raises before anything is built; a CPU
    tensor never reaches a launch."""
    z = torch.zeros((4,), dtype=torch.int32)
    shape = dict(height=64, width=128, tile_h=64, ntx=1, subpixel=4, depth_test=True)
    with pytest.raises(ValueError, match="tile_w"):
        kernels.vis_stream(z, z, z, z, z, z, z[:1], z, z, tile_w=64, **shape)
    with pytest.raises(ValueError, match="tile_w"):
        kernels.vis_lists(z, z[None], z, z, z[:1], z, z, tile_w=256, **shape)
    with pytest.raises(ValueError, match="CUDA"):
        kernels._check("rec", z, torch.int32)
    assert not any(kernels.launches.values())


def _items_match_plain(inp, cfg, seed):
    """The walk cut into items and merged through pack_key in a shuffled
    order against the plain version in order: equal bits. Returns the
    number of chunks of the longest walk."""
    t, z = stream.vis_stream_plain(inp, cfg)
    ti, zi, nchunks = records.fold_plain_items(
        inp.rec, inp.sid, inp.starts, torch.where(inp.tile_ran != 0, inp.run_counts, 0),
        inp.large_ids, inp.large_count, cfg, inp.tile_ran, seed=seed)
    assert torch.equal(ti, t)
    assert torch.equal(zi.view(torch.int32), z.view(torch.int32))
    return nchunks


@pytest.mark.parametrize("case", sorted(CASES) + ["z_tie", "z_tie_painter"])
def test_items_merged_by_key_match_plain(ref_tri, tie_tri, case):
    over, yo = CASES.get(case, ({"depth_test": case == "z_tie"}, 0))
    rtri, base = tie_tri if case.startswith("z_tie") else ref_tri
    cfg = convert.config_from(dataclasses.replace(base, **over))
    inp = stream.prepare(convert.tribuf_to_torch(rtri, "cpu"), cfg, yo)
    nchunks = _items_match_plain(inp, cfg, seed=len(case))
    chunks = inp.item_start[1:] - inp.item_start[:-1]
    assert int(chunks.min()) >= 1 and int(inp.item_start[-1]) <= inp.item_tile.shape[0]
    if case in ("as_is", "painter", "z_tie", "z_tie_painter"):
        assert nchunks >= 3 and int(chunks.max()) == nchunks
    if case == "large_bucket":
        assert int(inp.large_count) > 0
    if case == "stream_overflow":
        assert int((inp.tile_ran == 0).sum()) > 0


def test_item_table_lists_every_chunk_once(ref_tri):
    rtri, base = ref_tri
    for over, yo in CASES.values():
        cfg = convert.config_from(dataclasses.replace(base, **over))
        inp = stream.prepare(convert.tribuf_to_torch(rtri, "cpu"), cfg, yo)
        K = records.ITEM_RECORDS
        nl = -(-int(inp.large_count) // K)
        want = torch.where(inp.tile_ran != 0, nl + -(-inp.run_counts // K), 0).clamp_min(1)
        start, total = inp.item_start, int(inp.item_start[-1])
        assert torch.equal(start[1:] - start[:-1], want)
        assert total <= inp.item_tile.shape[0]
        tile = torch.repeat_interleave(torch.arange(want.shape[0], dtype=torch.int32), want)
        assert torch.equal(inp.item_tile[:total], tile)
        assert bool((inp.item_tile[total:] == want.shape[0]).all())


def test_visibility_z_tie_matches_pallas_interpret(tie_tri):
    """Every covered pixel ties on z: the reference's kernel and the port
    pick the same (lower) id; z within 1e-6 (XLA may contract the sum)."""
    rtri, cfg = tie_tri
    rt, rz, rd = ref_stream.visibility_binned(rtri, cfg, interpret=True)
    t, z, d = _stream_visibility(convert.tribuf_to_torch(rtri, "cpu"), convert.config_from(cfg))
    rt, rz = np.asarray(rt), np.asarray(rz)
    assert (t.numpy() == rt).all() and int(d) == int(rd) == 0
    fin = np.isfinite(rz)
    assert fin.sum() > 1000 and (np.isinf(z.numpy()) == ~fin).all()
    np.testing.assert_allclose(z.numpy()[fin], rz[fin], rtol=0, atol=1e-6)
    # the copy's ids (the upper half) never win a tie
    assert rt[fin].max() < rtri.capacity and (t.numpy()[fin] < rt[fin].max() + 1).all()


INF, BG = float("inf"), rc.BG_TRI_ID
KEY_PAIRS = {
    "z_decides": (0.25, 7, 0.5, 3),
    "equal_z_id_decides": (0.5, 3, 0.5, 7),
    "same": (0.5, 3, 0.5, 3),
    "cleared_loses": (1.0, 2**31 - 2, INF, BG),
    "cleared_both": (INF, BG, INF, BG),
    "zero_and_one": (0.0, 9, 1.0, 0),
    "neg_zero_ties_zero_low_id": (-0.0, 1, 0.0, 2),
    "neg_zero_ties_zero_high_id": (-0.0, 2, 0.0, 1),
    "neg_zero_below_denormal": (-0.0, 5, 1e-45, 0),
    "neg_zero_both": (-0.0, 4, -0.0, 6),
    "adjacent_floats": (0.5, 0, float(np.nextafter(np.float32(0.5), np.float32(1))), 0),
}


@pytest.mark.parametrize("name", sorted(KEY_PAIRS))
def test_pack_key_orders_as_resolve_better(name):
    """The smaller key wins exactly where resolve_better holds, both ways
    round, and unpacking returns each side's own bits."""
    z1, i1, z2, i2 = KEY_PAIRS[name]
    za, zb = torch.tensor([z1], dtype=torch.float32), torch.tensor([z2], dtype=torch.float32)
    ia, ib = torch.tensor([i1], dtype=torch.int32), torch.tensor([i2], dtype=torch.int32)
    ka, kb = records.pack_key(za, ia, True), records.pack_key(zb, ib, True)
    assert bool(ka < kb) == bool(rc.resolve_better(za, ia, zb, ib))
    assert bool(kb < ka) == bool(rc.resolve_better(zb, ib, za, ia))
    for z, i, k in ((za, ia, ka), (zb, ib, kb)):
        uz, ui = records.unpack_key(k, True)
        assert torch.equal(uz.view(torch.int32), z.view(torch.int32)) and torch.equal(ui, i)
    if BG in (i1, i2):  # painter's order clears to -1 and never packs BG
        return
    # painter's order: the higher id is the larger key, "none" (-1) the lowest
    pa, pb = records.pack_key(za, ia, False), records.pack_key(zb, ib, False)
    none = records.pack_key(torch.tensor([INF]), torch.tensor([-1], dtype=torch.int32), False)
    assert bool(pa > pb) == (i1 > i2) and bool(pa > none) and bool(pb > none)
    if i1 != i2:  # ids are unique among a tile's records
        uz, ui = records.unpack_key(records.merge_keys(pa, pb, False), False)
        want = za if i1 > i2 else zb
        assert int(ui) == max(i1, i2)
        assert torch.equal(uz.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("neg_zero_id", [0, 129], ids=["neg_zero_wins", "neg_zero_loses"])
def test_negative_zero_depth_merges_as_the_float_compare(neg_zero_id):
    """A hand-made record whose depth at a pixel is -0.0 (the pixel sits on
    a vertex with z = -0.0, the other two z negative) against one that
    gives 0.0 there, 129 records apart, so they fall into different items:
    the lower id wins and the stored z keeps the winner's own sign."""
    C, sub = 130, 4
    xs = np.zeros((C, 3), np.int32)
    ys = np.zeros((C, 3), np.int32)
    zs = np.zeros((C, 3), np.float32)
    # pixel (8, 8) has its center at 8 * sub + sub / 2; the triangle's
    # vertex 2 sits on it, and the top-left rule accepts both edges there
    c = 8 * sub + sub // 2
    for i in (0, C - 1):
        xs[i], ys[i] = (c + 40, c + 40, c), (c + 40, c, c)
        zs[i] = (-0.25, -0.5, -0.0) if i == neg_zero_id else (0.25, 0.5, 0.0)
    # the records between them are degenerate (zero area: inv = 0) and lie elsewhere
    xs[1 : C - 1], ys[1 : C - 1] = 400, 400
    tri = types.SimpleNamespace(capacity=C, xs=torch.from_numpy(xs), ys=torch.from_numpy(ys),
                                z=torch.from_numpy(zs))
    rec = records.pack_tri_records(tri)
    cfg = convert.config_from(ref_presets.config3_terrain(8, 8).config).replace(
        width=128, height=32, tile_h=32, tile_w=128)
    ids = torch.arange(C, dtype=torch.int32)
    zero = torch.zeros((1,), dtype=torch.int32)
    n = torch.full((1,), C, dtype=torch.int32)
    t, z = records.fold_plain(rec, records.id_chunks(ids, zero, n, C), cfg)
    assert int(t[8, 8]) == 0
    bits = int(z.view(torch.int32)[8, 8])
    assert bits == (-(2**31) if neg_zero_id == 0 else 0)
    for seed in (None, 1, 2):
        ti, zi, nchunks = records.fold_plain_items(rec, ids, zero, n, ids[:0], zero[0], cfg,
                                                   seed=seed)
        assert nchunks == 2
        assert torch.equal(ti, t) and torch.equal(zi.view(torch.int32), z.view(torch.int32))
