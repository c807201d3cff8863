"""The gated stream kernel's algorithm in plain PyTorch, on the CPU:
``records.fold_plain_items(gated=True)`` runs what ``zgate_fold_kernel``
does (each tile's walk dealt round-robin into chunks; items started in
``chunk_major_order``; a bound word per (tile, slab, warp footprint) that a
warp publishes at each word of its mask and reads a refresh late; a warp
skipping the records whose z_min lies behind its bound) in an interleaving
of the items a seed chooses. Over every seed it must give the bits of the
ungated fold (``fold_plain``) and of the reference's serial gate
(``fold_plain_gated``), on config5 (t = 1), config7 (t = 20), config3
under ``bin_zorder`` and the stacked planes of ``xr_torch/tools/layers.py``
at golden size (192x108). On planes of 6x6 quads (at 192x108 as many
records a tile as layers16 at 1920x1080, two chunks at most) and ids front
to back the gate skips much, back to front little. The planes built from
the reference's meshes are the port's, bit for bit. Also the bound
words' order (``_order_bits``) against the float order."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from xr.core import math3d as rm3
from xr.scene import presets as ref_presets
from xr.scene import procedural as ref_proc
from xr_torch import convert
from xr_torch.pipeline.geometry import geometry
from xr_torch.raster import records, stream
from xr_torch.tools import layers

torch.set_num_threads(1)

W, H = 192, 108
SEEDS = list(range(8))


def ref_layers16(reverse=False, cells=56):
    """``layers.layers16`` built from the reference's procedural meshes;
    with `cells` quads a side a plane (6: at 192x108 a tile holds about as
    many records as layers16's at 1920x1080)."""
    base = ref_presets.config3_terrain(8, 8)
    plane = ref_proc.grid_plane(cells, cells, size=40.0)
    ys = [-layers.SPACING * k for k in range(layers.PLANES)]
    if reverse:
        ys = ys[::-1]
    meshes = []
    for y in ys:
        m = np.eye(4, dtype=np.float32)
        m[1, 3] = y
        meshes.append(ref_proc.transformed(plane, m))
    mesh = ref_proc.with_vert_mat(ref_proc.merge_meshes(meshes))
    port = layers.layers16(reverse)
    cfg = dataclasses.replace(base.config, z_earlyout=True, clip_budget=1536,
                              medium_capacity=14336)
    return ref_presets.Preset(port.name, base.scene.replace(mesh=mesh),
                              lambda t, xp: port.animate(t), cfg)


# (preset, t, overrides of small_preset)
SCENES = {
    "config5": (lambda: ref_presets.config5_flythrough(64, 64), 1.0, {"num_shards": 1}),
    "config7": (lambda: ref_presets.config7_terrain_lod(64), 20.0, {"large_capacity": 2048}),
    "config3_zorder": (lambda: ref_presets.config3_terrain(48, 48), 0.3, {"bin_zorder": True}),
    "layers16": (ref_layers16, 0.0, {}),
    "layers16_rev": (lambda: ref_layers16(True), 0.0, {}),
    "coarse16": (lambda: ref_layers16(cells=6), 0.0, {}),
    "coarse16_rev": (lambda: ref_layers16(True, cells=6), 0.0, {}),
}


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """(StreamInputs, port config with z_earlyout) of the port's geometry
    (the reference's TriBuf bit for bit: tests/test_torch_geometry.py)."""
    make, t, over = SCENES[name]
    p = ref_presets.small_preset(make(), W, H, bin_capacity=8192, **over)
    cam, mm = p.animate(t, np)
    cfg = convert.config_from(dataclasses.replace(p.config, z_earlyout=True))
    scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), "cpu")
    view, proj = (torch.from_numpy(np.asarray(m)) for m in rm3.camera_matrices(cam, W / H, np))
    inp = stream.prepare(geometry(scene, view, proj, cfg), cfg)
    assert int(inp.dropped) == 0 and inp.item_order is not None
    return inp, cfg


@functools.lru_cache(maxsize=None)
def _ungated(name):
    inp, cfg = _inputs(name)
    return stream.vis_stream_plain(inp, dataclasses.replace(cfg, z_earlyout=False))


def _live(name, seed, slots=None):
    inp, cfg = _inputs(name)
    return records.fold_plain_items(inp.rec, inp.sid, inp.starts, inp.run_counts,
                                    inp.large_ids, inp.large_count, cfg,
                                    tile_ran=inp.tile_ran, seed=seed, gated=True, slots=slots)


def _same(a, b):
    return torch.equal(a[0], b[0]) and torch.equal(a[1].view(torch.int32),
                                                   b[1].view(torch.int32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["config5", "config7", "config3_zorder", "layers16"])
def test_live_gate_equals_the_plain_folds(name, seed):
    """Whatever the interleaving, the live gate skips only records that
    cannot win: the ungated fold's bits and the serial gate's."""
    inp, cfg = _inputs(name)
    t, z, counts = _live(name, seed)
    want = _ungated(name)
    assert _same((t, z), want)
    tg, zg, _ = stream.vis_stream_plain_gated(inp, cfg)
    assert _same((tg, zg), want)
    assert counts["pairs"] > 0 and 0 <= counts["skipped"] <= counts["pairs"]
    assert counts["items"] >= int(inp.item_start[-1])


@pytest.mark.parametrize("seed", [1, 2])
def test_live_gate_skips_behind_the_front(seed):
    """Planes of 6x6 quads (two chunks a tile at most, as layers16's at
    1920x1080), a quarter of the items at once. Front to back, the gate
    skips over a third of the (record, warp) pairs; back to front under a
    tenth (the serial gate none). The bits stay the ungated fold's."""
    share = {}
    for name in ("coarse16", "coarse16_rev"):
        nitems = int(_inputs(name)[0].item_start[-1])  # one slab a tile
        assert int((_inputs(name)[0].item_start.diff()).max()) == 2
        t, z, c = _live(name, seed, slots=nitems // 4)
        assert _same((t, z), _ungated(name))
        share[name] = c["skipped"] / c["pairs"]
    assert share["coarse16"] > 1 / 3 and share["coarse16_rev"] < 0.1, share
    inp, cfg = _inputs("coarse16_rev")
    assert stream.vis_stream_plain_gated(inp, cfg)[2]["record"] == 0


def test_layers16_is_the_ports_scene():
    """The reference-built planes are the port's tool scene: the same mesh
    bits, camera and config."""
    for reverse in (False, True):
        port, ref = layers.layers16(reverse), ref_layers16(reverse)
        for f in ("positions", "normals", "uvs", "indices", "material_id", "transform_id"):
            a, b = getattr(port.scene.mesh, f), np.asarray(getattr(ref.scene.mesh, f))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
        assert port.scene.mesh.num_triangles == 16 * 6272
        assert convert.config_from(ref.config) == port.config
    cfg = layers.layers16().config
    base = ref_presets.config3_terrain(8, 8).config
    assert cfg.z_earlyout and (cfg.tile_h, cfg.tile_w, cfg.stream_block) == (32, 128, 128)
    assert (cfg.width, cfg.height, cfg.mode) == (base.width, base.height, base.mode)
    cam, _ = layers.layers16().animate(0.0)
    assert np.array_equal(cam.eye, [0.0, 10.0, 0.0]) and np.array_equal(cam.up, [0.0, 0.0, -1.0])


def test_bound_words_keep_the_float_order():
    """The words' integer order is the float order (-inf < -0.0 < 0.0 <
    ... < +inf) and the mapping is undone bit for bit."""
    rng = np.random.default_rng(11)
    vals = np.concatenate([rng.uniform(0.0, 1.0, 500), rng.standard_normal(200) * 1e3,
                           [0.0, -0.0, np.inf, -np.inf, 1.0, 1e-38, -1e-38]]).astype(np.float32)
    z = torch.from_numpy(vals)
    o = records._order_bits(z)
    assert bool(((o >= 0) & (o < 2**32)).all())
    assert torch.equal(records._unorder_bits(o).view(torch.int32), z.view(torch.int32))
    i, j = torch.triu_indices(len(vals), len(vals), 1)
    a, b = z[i], z[j]
    lt = (a < b) | ((a == b) & (torch.signbit(a) & ~torch.signbit(b)))
    gt = (a > b) | ((a == b) & (~torch.signbit(a) & torch.signbit(b)))
    assert bool((lt == (o[i] < o[j])).all()) and bool((gt == (o[i] > o[j])).all())
