"""The z early-out of the stream kernel (B1 under ``z_earlyout``, with the
``z_band_gate`` and ``z_chunk_gate`` refinements) against the reference, on
the CPU, from the reference's own TriBuf at golden size (192x108).

The port's plain version of the gated kernel, ``records.fold_plain_gated``,
runs the reference's serial gate: blocks of ``stream_block`` records, a
bound per tile or per 8-row band, groups of ``CHUNK_G`` records. It is held
against the Pallas stream kernel in interpret mode under each flag set (ids
and dropped exact, z within 1e-6: XLA may contract the interpreted depth
sum, F3) and against the ungated fold bit for bit. At golden size a tile's
bound stays +inf while any of its pixels is sky or off the frame, so the
gate skips records only once blocks turn over inside fully covered tiles:
the cases ``config5_block8`` (config5 at t = 3 under ``bin_zorder``, front
to back) and ``config7_block8`` run blocks of 8 records, and there the
skip count must be positive. The chunk gate's aggregates are rebuilt with
numpy from the reference's records and bins. The gated fold reads z_min
only through a live id (the reference masks field 13 of empty slots where
it means the id, ROADMAP F1): poisoning every record that no live slot
names changes neither the frame nor the skip counts. Painter's order runs
no gate. The stacked planes of ``xr_torch/tools/layers.py`` (depth
complexity 16, ids front to back) run once, under the plain gate alone,
where the serial gate skips most records. Also the reference's math
helpers the port had lacked
(``orthographic``, ``scaling``, ``transform_directions``,
``as_numpy_scene``), bit-equal."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xr.core import math3d as rm3
from xr.core import types as rtypes
from xr.pipeline.geometry import geometry as ref_geometry
from xr.raster import jnp_backend as ref_jb
from xr.raster import pallas_smem as ref_smem
from xr.raster import pallas_stream as ref_stream
from xr.scene import presets as ref_presets
from xr.scene import procedural as ref_proc
from xr_torch import convert, kernels
from xr_torch.core import math3d as m3
from xr_torch.core import types as ttypes
from xr_torch.raster import dispatch, records, stream

from tests.test_torch_zgate_live import ref_layers16

torch.set_num_threads(1)

W, H = 192, 108
FLAGS = {"zmax": {}, "band": {"z_band_gate": True}, "chunk": {"z_chunk_gate": True},
         "band_chunk": {"z_band_gate": True, "z_chunk_gate": True}}
SKIPPING = ("config5_block8", "config7_block8")  # the cases whose gate must skip


def _tie(p):
    mesh = ref_proc.with_vert_mat(ref_proc.merge_meshes([p.scene.mesh, p.scene.mesh]))
    return p._replace(scene=p.scene.replace(mesh=mesh))


# (preset, t, overrides of small_preset)
SCENES = {
    "config5": (lambda: ref_presets.config5_flythrough(64, 64), 1.0, {"num_shards": 1}),
    "config5_block8": (lambda: ref_presets.config5_flythrough(64, 64), 3.0,
                       {"num_shards": 1, "bin_zorder": True, "stream_block": 8}),
    "config7": (lambda: ref_presets.config7_terrain_lod(64), 20.0, {"large_capacity": 2048}),
    "config7_block8": (lambda: ref_presets.config7_terrain_lod(64), 20.0,
                       {"large_capacity": 2048, "stream_block": 8}),
    "config3_zorder": (lambda: ref_presets.config3_terrain(48, 48), 0.3, {"bin_zorder": True}),
    "z_tie": (lambda: _tie(ref_presets.config3_terrain(48, 48)), 0.3, {}),
}


@functools.lru_cache(maxsize=None)
def _preset(make):
    return make()


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(reference TriBuf, reference config with z_earlyout)."""
    make, t, over = SCENES[name]
    p = ref_presets.small_preset(_preset(make), W, H, bin_capacity=8192, **over)
    cam, mm = p.animate(t, np)
    view, proj = rm3.camera_matrices(cam, W / H, np)
    tri = ref_geometry(p.scene.replace(model_matrices=mm), jnp.asarray(view),
                       jnp.asarray(proj), p.config, xp=jnp)
    return tri, dataclasses.replace(p.config, z_earlyout=True)


def _stream_visibility(tri, cfg, y_offset=0):
    """The stream backend's visibility as the port's dispatch runs it:
    (tid, z, dropped)."""
    cfg = dataclasses.replace(cfg, backend="pallas_stream", raster_path="binned")
    return dispatch.visibility(tri, cfg, tri.capacity, y_offset)


def _ref_visibility(rtri, cfg):
    """The reference's stream kernel in interpret mode, traced once under
    jit as its Renderer runs it (eager interpretation of the gated kernel
    takes tens of seconds a call)."""
    return jax.jit(lambda t: ref_stream.visibility_binned(t, cfg, interpret=True))(rtri)


def _config(name, flags, **over):
    return dataclasses.replace(_scene(name)[1], **FLAGS[flags], **over)


@functools.lru_cache(maxsize=None)
def _inputs(name):
    cfg = convert.config_from(_config(name, "zmax"))
    return stream.prepare(convert.tribuf_to_torch(_scene(name)[0], "cpu"), cfg)


@functools.lru_cache(maxsize=None)
def _gated(name, flags):
    return stream.vis_stream_plain_gated(_inputs(name), convert.config_from(_config(name, flags)))


@functools.lru_cache(maxsize=None)
def _ungated(name):
    cfg = convert.config_from(_config(name, "zmax", z_earlyout=False))
    return stream.vis_stream_plain(_inputs(name), cfg)


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("name", sorted(SCENES))
def test_gated_fold_matches_pallas_interpret(name, flags):
    rtri, _ = _scene(name)
    cfg = _config(name, flags)
    rt, rz, rd = _ref_visibility(rtri, cfg)
    kernels.reset_launches()
    t, z, d = _stream_visibility(convert.tribuf_to_torch(rtri, "cpu"), convert.config_from(cfg))
    assert not any(kernels.launches.values())  # CPU tensors: the plain version
    tg, zg, _ = _gated(name, flags)
    assert torch.equal(t, tg) and torch.equal(z.view(torch.int32), zg.view(torch.int32))
    rt, rz = np.asarray(rt), np.asarray(rz)
    assert (t.numpy() == rt).all() and int(d) == int(rd) == 0
    fin = np.isfinite(rz)
    assert fin.sum() > W * H // 4 and (np.isinf(z.numpy()) == ~fin).all()
    np.testing.assert_allclose(z.numpy()[fin], rz[fin], rtol=0, atol=1e-6)


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("name", sorted(SCENES))
def test_gated_fold_equals_ungated_fold(name, flags):
    """The gates skip only records that cannot win: the same bits as the
    fold without them; the skip counts add up."""
    tg, zg, skips = _gated(name, flags)
    tu, zu = _ungated(name)
    assert torch.equal(tg, tu) and torch.equal(zg.view(torch.int32), zu.view(torch.int32))
    inp = _inputs(name)
    assert skips["walked"] == int(inp.run_counts.sum()) > 0
    assert 0 <= skips["record"] + skips["chunk"] <= skips["walked"]
    if "chunk" not in flags:
        assert skips["chunk"] == 0
    if "band" not in flags:
        assert skips["band"] == 0


@pytest.mark.parametrize("name", SKIPPING)
def test_gates_skip_records(name):
    """Not vacuous: the record gate skips records, the chunk gate takes
    over some of them (a chunk's skip is its records'), and the band gate
    skips bands of records that pass; the bound per band never skips fewer
    record-band pairs than the tile's, so record + chunk is one number."""
    got = {f: _gated(name, f)[2] for f in FLAGS}
    assert got["zmax"]["record"] > 0
    total = {f: s["record"] + s["chunk"] for f, s in got.items()}
    assert len(set(total.values())) == 1, got
    if name == "config5_block8":
        assert got["chunk"]["chunk"] > 0 and got["band"]["band"] > 0


def test_layers16_gated_fold_matches_pallas_interpret():
    """The stacked planes of xr_torch/tools/layers.py (16 planes, ids front
    to back, depth complexity 16) at golden size under z_earlyout: the
    reference's gated stream kernel in interpret mode against the port's
    serial gate (ids and dropped exact, z within 1e-6, F3), which equals the
    ungated fold bit for bit and skips most of the walked records."""
    p = ref_presets.small_preset(ref_layers16(), W, H, bin_capacity=8192)
    cam, mm = p.animate(0.0, np)
    view, proj = rm3.camera_matrices(cam, W / H, np)
    rtri = ref_geometry(p.scene.replace(model_matrices=mm), jnp.asarray(view),
                        jnp.asarray(proj), p.config, xp=jnp)
    assert p.config.z_earlyout
    rt, rz, rd = _ref_visibility(rtri, p.config)
    cfg = convert.config_from(p.config)
    inp = stream.prepare(convert.tribuf_to_torch(rtri, "cpu"), cfg)
    t, z, skips = stream.vis_stream_plain_gated(inp, cfg)
    tu, zu = stream.vis_stream_plain(inp, dataclasses.replace(cfg, z_earlyout=False))
    assert torch.equal(t, tu) and torch.equal(z.view(torch.int32), zu.view(torch.int32))
    assert 2 * skips["record"] > skips["walked"] > 0
    rt, rz = np.asarray(rt), np.asarray(rz)
    assert (t.numpy() == rt).all() and int(inp.dropped) == int(rd) == 0
    assert np.isfinite(rz).all()  # every plane covers the frame
    np.testing.assert_allclose(z.numpy(), rz, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["config5_block8", "config3_zorder"])
def test_chunk_aggregates_equal_the_references(name):
    """group_zmin against numpy over the reference's pack_tri_records and
    bin_triangles: the least field-13 z_min of each CHUNK_G consecutive
    records of a tile's segment, +inf past its end."""
    rtri, cfg = _scene(name)
    packed = np.asarray(ref_smem.pack_tri_records(rtri, 0))
    b = ref_jb.bin_triangles(rtri, cfg)
    sid, starts, counts = (np.asarray(x) for x in (b.sid, b.starts, b.raw_counts))
    zmin = packed[:, 13].view(np.float32)
    G = records.CHUNK_G
    ng = -(-counts.max() // G)
    want = np.full((counts.shape[0], ng * G), np.inf, np.float32)
    for t, (s, n) in enumerate(zip(starts, counts)):
        want[t, :n] = zmin[sid[s : s + n]]
    want = want.reshape(-1, ng, G).min(-1)
    inp = _inputs(name)
    got = records.group_zmin(inp.rec, inp.sid, inp.starts, inp.run_counts).numpy()
    assert got.shape == want.shape and (got.view(np.int32) == want.view(np.int32)).all()
    assert np.isfinite(want).any() and np.isinf(want).any()


@pytest.mark.parametrize("poison", [-1.0, 2.0])
def test_zmin_is_read_only_through_a_live_id(poison):
    """F1: poison the z_min of every record that no live slot names (the
    records past the live count, and those behind the budget): the frame
    and the skip counts under every flag set stay the same."""
    name = "config5_block8"
    inp = _inputs(name)
    C = inp.rec.shape[0]
    live = torch.zeros(C, dtype=torch.bool)
    live[inp.large_ids[: int(inp.large_count)].long()] = True
    for s, n in zip(inp.starts.tolist(), inp.run_counts.tolist()):
        live[inp.sid[s : s + n].long()] = True
    assert int((~live).sum()) > 100
    rec = inp.rec.clone()
    rec[~live, 13] = torch.tensor(poison, dtype=torch.float32).view(torch.int32)
    for flags in FLAGS:
        cfg = convert.config_from(_config(name, flags))
        t, z, skips = stream.vis_stream_plain_gated(inp._replace(rec=rec), cfg)
        tg, zg, want = _gated(name, flags)
        assert skips == want
        assert torch.equal(t, tg) and torch.equal(z.view(torch.int32), zg.view(torch.int32))


def test_painters_order_ignores_the_gates():
    """Without the depth test no gate runs, as in the reference: no
    chunk-major walk, no skip, the reference's painter frame."""
    name = "config5_block8"
    rtri, _ = _scene(name)
    cfg = _config(name, "band_chunk", depth_test=False)
    tcfg = convert.config_from(cfg)
    inp = stream.prepare(convert.tribuf_to_torch(rtri, "cpu"), tcfg)
    assert inp.item_order is None and not stream.gated(tcfg)
    t, z, skips = stream.vis_stream_plain_gated(inp, tcfg)
    assert skips["record"] == skips["chunk"] == skips["band"] == 0
    tu, zu = stream.vis_stream_plain(inp, dataclasses.replace(
        tcfg, z_earlyout=False, z_band_gate=False, z_chunk_gate=False))
    assert torch.equal(t, tu) and torch.equal(z.view(torch.int32), zu.view(torch.int32))
    rt, _, _ = _ref_visibility(rtri, cfg)
    assert (t.numpy() == np.asarray(rt)).all()


@pytest.mark.parametrize("name", ["config5", "config7"])
def test_chunk_major_order_lists_every_chunk_once(name):
    """The gated kernel's walk: every live chunk of the item table once, by
    chunks left to walk (most first), tiles ascending among equals; so a
    tile's chunks come in their own order, and every tile's last chunk
    comes after every chunk that has others behind it."""
    inp = _inputs(name)
    total = int(inp.item_start[-1])
    order = inp.item_order
    assert order.dtype == torch.int32 and order.shape == inp.item_tile.shape
    live = order[:total].long()
    assert torch.equal(torch.sort(live).values, torch.arange(total))
    t = inp.item_tile.long()[live]
    start = inp.item_start.long()
    c, nch = live - start[t], start[t + 1] - start[t]
    left = nch - c
    ntiles = inp.starts.shape[0]
    key = -left * ntiles + t
    assert bool((key[1:] > key[:-1]).all()) and int(c.max()) > 0
    for tile in range(ntiles):  # a tile's chunks in their own order
        assert bool((torch.diff(c[t == tile]) == 1).all())
    assert bool((left[-ntiles:] == 1).all()) and int((left == 1).sum()) == ntiles


def test_kernel_wrapper_refuses_a_gate_it_does_not_take():
    """A gate without the depth test, or a chunk gate without the gate's
    walk, raises before anything is built."""
    z = torch.zeros((4,), dtype=torch.int32)
    shape = dict(height=64, width=128, tile_h=64, tile_w=128, ntx=1, subpixel=4)
    with pytest.raises(ValueError, match="depth test"):
        kernels.vis_stream(z, z, z, z, z, z, z[:1], z, z, depth_test=False, item_order=z,
                           **shape)
    with pytest.raises(ValueError, match="item_order"):
        kernels.vis_stream(z, z, z, z, z, z, z[:1], z, z, depth_test=True, chunk_gate=True,
                           **shape)
    assert not any(kernels.launches.values())


ORTHO = [(-2.0, 2.0, -1.5, 1.5, 0.5, 20.0), (-7.3, 7.3, -7.3, 7.3, 7.3, 21.9),
         (0.1, 3.0, -0.2, 0.9, 1.0, 1e4)]


@pytest.mark.parametrize("args", ORTHO, ids=["box", "shadow_fit", "skewed"])
def test_orthographic_equals_reference(args):
    want = rm3.orthographic(*args, xp=np)
    got = m3.orthographic(*args, device="cpu").numpy()
    assert got.dtype == np.float32 and (got.view(np.int32) == want.view(np.int32)).all()


@pytest.mark.parametrize("v", [2.5, (0.5, 3.0, -1.25), np.float32(1.0 / 3.0)],
                         ids=["scalar", "vector", "third"])
def test_scaling_equals_reference(v):
    want = np.asarray(rm3.scaling(v, np), np.float32)
    got = m3.scaling(v, "cpu").numpy()
    assert (got.view(np.int32) == want.view(np.int32)).all()


def test_transform_directions_equals_reference():
    rng = np.random.default_rng(7)
    dirs = rng.standard_normal((257, 3)).astype(np.float32)
    mat = (rm3.rotation_y(0.7, np) @ rm3.rotation_x(-0.3, np)
           @ rm3.scaling(1.7, np) @ rm3.translation((1.0, -2.0, 3.0), np)).astype(np.float32)
    want = rm3.transform_directions(dirs, mat, np)
    got = m3.transform_directions(torch.from_numpy(dirs), torch.from_numpy(mat)).numpy()
    assert (got.view(np.int32) == want.view(np.int32)).all()


@pytest.mark.parametrize("name", ["config3", "config4"])
def test_as_numpy_scene_equals_reference(name):
    """Torch leaves of a converted scene (config3: a texture pyramid;
    config4: lights, no texture) come back as the reference's numpy leaves,
    bit for bit, as copies that share no memory with the scene."""
    p = {"config3": lambda: ref_presets.config3_terrain(16, 16),
         "config4": ref_presets.config4_phong}[name]()
    _, mm = p.animate(0.3, np)
    ref_scene = p.scene.replace(model_matrices=mm)
    scene = convert.scene_to_torch(ref_scene, "cpu")
    got, want = ttypes.as_numpy_scene(scene), rtypes.as_numpy_scene(ref_scene)
    parts = ["mesh", "materials", "lights"] + ([] if want.textures is None else ["textures"])
    assert (got.textures is None) == (want.textures is None)
    for part in parts:
        for f in dataclasses.fields(getattr(got, part)):
            a = getattr(getattr(got, part), f.name)
            b = getattr(getattr(want, part), f.name)
            if a is None:
                assert b is None, f.name
                continue
            if isinstance(a, int):  # static sizes of a pyramid
                assert a == int(b), f.name
                continue
            b = np.asarray(b)
            # the port keeps the quads' u32 words as int32 (torch has no u32)
            assert isinstance(a, np.ndarray) and a.dtype.itemsize == b.dtype.itemsize, f.name
            assert a.dtype == b.dtype or (f.name == "quads" and a.dtype == np.int32), f.name
            assert a.shape == b.shape and a.tobytes() == b.tobytes(), f.name
    assert np.array_equal(got.model_matrices, want.model_matrices)
    got.model_matrices[...] = 0  # a copy, not a view of the tensor
    assert bool(scene.model_matrices.abs().sum() > 0)
