"""The lists path of the port against the reference, from the reference's own
TriBuf: the capped per-tile lists of the binning, the list kernel's plain
version (``smem``, the ``pallas_smem`` backend) against the Pallas kernel in
interpret mode, and the portable paths (``lists``: brute force and the
``jnp`` backend) against ``jnp_backend``. Ids, lists, counts and dropped
must be exact; depth within 1e-6, since XLA may contract the reference's
depth sum where the port rounds every product (F3 in ROADMAP.md).

The CUDA list kernel cuts a tile's list into work items and merges their
partial results through a packed 64-bit (z, id) key; that algorithm in plain
PyTorch, merged in a shuffled order, is held here against the in-order plain
version bit for bit, also on a scene where every covered pixel ties on z."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xr.core import math3d as rm3
from xr.pipeline.geometry import geometry as ref_geometry
from xr.raster import dispatch as ref_dispatch
from xr.raster import jnp_backend as ref_jb
from xr.raster import pallas_smem as ref_smem
from xr.scene import presets as ref_presets
from xr.scene import procedural as ref_proc
from xr_torch import convert, kernels
from xr_torch.raster import binning, dispatch, lists, records, smem

# the suite runs several worker processes on shared cores: one torch
# thread each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

PRESETS = {"config1": ref_presets.config1_cube, "config2": ref_presets.config2_icospheres}
CASES = {
    "as_is": ({}, 0),
    "painter": ({"depth_test": False}, 0),
    # lists far too short: entries past the cap are dropped and counted
    "overflow": ({"bin_capacity": 64}, 0),
    # rows [32, 64) as one band of a sharded frame
    "band": ({"height": 32}, 32),
}


def _ref_tri(preset, width, height, t, **over):
    p = ref_presets.small_preset(preset, width, height, **over)
    cam, mm = p.animate(t, np)
    view, proj = rm3.camera_matrices(cam, width / height, np)
    tri = ref_geometry(p.scene.replace(model_matrices=mm), jnp.asarray(view),
                       jnp.asarray(proj), p.config, xp=jnp)
    return tri, p.config


def _lists_visibility(tri, cfg, y_offset=0):
    """The list kernel's visibility, its prep then its launch (the plain
    version on the CPU): (tid, z, dropped). Called directly, as the
    reference's is: dispatch streams instead past the SMEM budget."""
    inp = smem.prepare_lists(tri, cfg, y_offset)
    return (*smem.vis_lists(inp, cfg), inp.dropped)


@pytest.fixture(scope="module")
def small_tris():
    """config1 and config2 at 96x64 with 16-row tiles, as the reference's
    own Pallas tests build them."""
    return {
        name: _ref_tri(fn(), 96, 64, 0.2, tile_h=16, tile_w=128, bin_capacity=8192)
        for name, fn in PRESETS.items()
    }


def _check_vis(got, want):
    t, z, d = got
    rt, rz, rd = (np.asarray(a) for a in want)
    assert t.dtype == torch.int32 and z.dtype == torch.float32
    assert (t.numpy() == rt).all()
    assert int(d) == int(rd)
    assert (np.isinf(z.numpy()) == np.isinf(rz)).all()
    fin = np.isfinite(rz)
    np.testing.assert_allclose(z.numpy()[fin], rz[fin], rtol=0, atol=1e-6)
    return int(d)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_lists_exact(small_tris, preset, case):
    rtri, base = small_tris[preset]
    over, yo = CASES[case]
    cfg = dataclasses.replace(base, **over)
    rb = ref_jb.bin_triangles(rtri, cfg, y_offset=yo)
    b = binning.bin_triangles(convert.tribuf_to_torch(rtri, "cpu"), convert.config_from(cfg),
                              y_offset=yo)
    for f in ("lists", "counts", "dropped"):
        a, r = getattr(b, f).numpy(), np.asarray(getattr(rb, f))
        assert a.dtype == np.int32 and a.shape == r.shape and (a == r).all(), f


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_smem_matches_pallas_interpret(small_tris, preset, case):
    rtri, base = small_tris[preset]
    over, yo = CASES[case]
    cfg = dataclasses.replace(base, **over)
    want = ref_smem.visibility_binned(rtri, cfg, y_offset=yo, interpret=True)
    kernels.reset_launches()
    got = _lists_visibility(convert.tribuf_to_torch(rtri, "cpu"), convert.config_from(cfg),
                            y_offset=yo)
    assert kernels.launches["vis_lists"] == 0  # CPU tensors: the plain version
    d = _check_vis(got, want)
    if case == "overflow" and preset == "config2":
        assert d > 0


def test_smem_large_bucket_matches_pallas_interpret():
    """config3 with no medium class and 8-row tiles: the large bucket is
    non-empty (10 records), so the x_test fold runs."""
    rtri, cfg = _ref_tri(ref_presets.config3_terrain(48, 48), 192, 108, 0.3,
                         bin_capacity=8192, medium_capacity=0, tile_h=8)
    want = ref_smem.visibility_binned(rtri, cfg, interpret=True)
    tri, pcfg = convert.tribuf_to_torch(rtri, "cpu"), convert.config_from(cfg)
    assert int(smem.prepare_lists(tri, pcfg).large_count) > 0
    _check_vis(_lists_visibility(tri, pcfg), want)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_jnp_backend_matches_reference(small_tris, preset):
    rtri, cfg = small_tris[preset]
    for over, yo in ({}, 0), ({"depth_test": False}, 0), ({"height": 32}, 32):
        c = dataclasses.replace(cfg, **over)
        want = ref_jb.visibility_binned(rtri, c, y_offset=yo)
        got = lists.visibility_binned(convert.tribuf_to_torch(rtri, "cpu"), convert.config_from(c),
                                      y_offset=yo)
        _check_vis(got, want)


@pytest.mark.parametrize("depth_test", [True, False], ids=["depth", "painter"])
def test_brute_matches_reference(depth_test):
    """config1 at 160x160, its golden size: brute force over 79 records."""
    rtri, cfg = _ref_tri(ref_presets.config1_cube(), 160, 160, 0.7, depth_test=depth_test)
    rt, rz = (np.asarray(a) for a in ref_jb.visibility_brute(rtri, cfg))
    t, z = lists.visibility_brute(convert.tribuf_to_torch(rtri, "cpu"), convert.config_from(cfg))
    assert (t.numpy() == rt).all()
    assert (np.isinf(z.numpy()) == np.isinf(rz)).all()
    fin = np.isfinite(rz)
    assert fin.sum() > 1000
    np.testing.assert_allclose(z.numpy()[fin], rz[fin], rtol=0, atol=1e-6)


def test_brute_band_matches_full_frame():
    rtri, cfg = _ref_tri(ref_presets.config1_cube(), 160, 160, 0.7)
    tri, pcfg = convert.tribuf_to_torch(rtri, "cpu"), convert.config_from(cfg)
    tf, zf = lists.visibility_brute(tri, pcfg)
    tb, zb = lists.visibility_brute(tri, pcfg.replace(height=32), y_offset=64)
    assert torch.equal(tb, tf[64:96]) and torch.equal(zb, zf[64:96])


@pytest.mark.parametrize("preset", ["config1", "config2", "config3"])
def test_smem_budget_rule_matches_reference(preset):
    """The pallas_smem -> stream rule (SMEM bytes > 900,000) routes each
    config as the reference does: config2 at 1920x1080 runs the list
    kernel, at golden size (bin_capacity 8192) the stream kernel."""
    fn = {"config3": lambda: ref_presets.config3_terrain(8, 8), **PRESETS}[preset]
    for over in ({}, {"bin_capacity": 8192}, {"bin_capacity": 64, "large_capacity": 4096}):
        cfg = dataclasses.replace(fn().config, **over)
        assert dispatch._smem_bytes(convert.config_from(cfg)) == ref_dispatch._smem_bytes(cfg)
    if preset == "config2":
        c2 = convert.config_from(fn().config)
        assert dispatch._smem_bytes(c2) == 368_640 <= dispatch.SMEM_BUDGET
        assert dispatch._smem_bytes(c2.replace(bin_capacity=8192)) == 1_253_376


ITEM_CASES = {
    "as_is": {},
    "painter": {"depth_test": False},
    "large_bucket": {"medium_capacity": 0, "tile_h": 8},
    # lists far too short: each tile folds the first 64 ids of its list
    "lists_overflow": {"bin_capacity": 64},
    "z_tie": {},
    "z_tie_painter": {"depth_test": False},
}


@pytest.fixture(scope="module")
def terrain_tris():
    """config3 at golden size (a tile's list is up to 1,022 ids long), as it
    is and with the terrain merged with a copy of itself, so that every
    covered pixel ties on z between a triangle and its copy."""
    p = ref_presets.config3_terrain(48, 48)
    mesh = ref_proc.with_vert_mat(ref_proc.merge_meshes([p.scene.mesh, p.scene.mesh]))
    tie = p._replace(scene=p.scene.replace(mesh=mesh))
    return {False: _ref_tri(p, 192, 108, 0.3, bin_capacity=8192),
            True: _ref_tri(tie, 192, 108, 0.3, bin_capacity=8192)}


@pytest.mark.parametrize("case", sorted(ITEM_CASES))
def test_list_items_merged_by_key_match_plain(terrain_tris, case):
    """Every tile's list cut into items of ITEM_RECORDS ids, each folded on
    its own and merged through pack_key in a shuffled order, against the
    plain version in order: equal bits."""
    rtri, base = terrain_tris[case.startswith("z_tie")]
    cfg = convert.config_from(dataclasses.replace(base, **ITEM_CASES[case]))
    inp = smem.prepare_lists(convert.tribuf_to_torch(rtri, "cpu"), cfg)
    t, z = smem.vis_lists_plain(inp, cfg)
    ntiles, cap = inp.lists.shape
    ti, zi, nchunks = records.fold_plain_items(
        inp.rec, inp.lists.reshape(-1), torch.arange(ntiles, dtype=torch.int32) * cap,
        inp.counts, inp.large_ids, inp.large_count, cfg, seed=len(case))
    assert torch.equal(ti, t)
    assert torch.equal(zi.view(torch.int32), z.view(torch.int32))
    K = records.ITEM_RECORDS
    chunks = inp.item_start[1:] - inp.item_start[:-1]
    want = (-(-int(inp.large_count) // K) + -(-inp.counts // K)).clamp_min(1)
    assert torch.equal(chunks, want) and int(chunks.max()) == nchunks
    assert int(inp.item_start[-1]) <= inp.item_tile.shape[0]
    if case == "lists_overflow":
        assert int(inp.dropped) > 0 and nchunks == 1
    elif case == "large_bucket":
        assert int(inp.large_count) > 0
    else:
        assert nchunks >= 3 and int(inp.dropped) == 0


def test_smem_z_tie_matches_pallas_interpret(terrain_tris):
    """Every covered pixel ties on z: the reference's list kernel and the
    port pick the same (lower) id."""
    rtri, cfg = terrain_tris[True]
    want = ref_smem.visibility_binned(rtri, cfg, interpret=True)
    got = _lists_visibility(convert.tribuf_to_torch(rtri, "cpu"), convert.config_from(cfg))
    assert _check_vis(got, want) == 0
