"""The blend pass of the port (config4b: config4 with two transparent panes)
on the CPU, against the reference on the same numpy inputs:
- config4b at golden size against the checked-in golden (the golden rule of
  tests/test_goldens.py:51-58) and against the reference Renderer (the
  shadow-flip rule of tests/test_tpu_device_frames.py:55-85, as in
  test_torch_phong.py), stats equal;
- blend_capacity 2: the reference's blend_overflow, and strict readback
  raises;
- composite order is source-triangle order through clipping: a far pane
  authored first and cut by the near plane (or by the guard band) into fan
  records at the end of the record buffer still composites under the near
  pane, as the reference's oracle does;
- a textured transparent pane in a box's shadow (the reference's
  tests/test_blend.py scene): the sampler and the shadow test run on
  transparent fragments as on the reference's;
- dead chunks are skipped as the reference skips them: the composite runs
  ceil(min(total, blend_capacity) / blend_chunk) chunks (config4b: 1 of 4,
  on its 4 live slots over a box smaller than the frame; in four bands
  only in the bands that box reaches, the count and boxes read once for
  all of them), none when every transparent triangle is culled, all of
  them past blend_capacity; each frame within the rule above against the
  reference;
- the cropped composite (live slots, their screen box) equals, bit for
  bit, the whole-frame composite on all slots of each live chunk
  (blend.composite_whole_frame, the composite before the crop): config4b at
  five t, in four bands (a pane across a band edge, bands no pane
  reaches), a pane cut by the frame's edge, one chunk a record, a live
  record whose box holds no pixel centre, and past blend_capacity.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_phong import check_golden, check_reference, manifest
from xr.app.renderer import Renderer as RefRenderer
from xr.core import math3d as rm3
from xr.core.types import (
    MODE_FLAT, MODE_PHONG, Camera, Lights, Material, Mesh, RenderConfig, Scene,
)
from xr.cpu_ref import render_frame
from xr.cpu_ref.margins import shadow_flip_risk
from xr.scene import presets as ref_presets
from xr.scene import procedural as rproc
from xr.scene import texture as rtx
from xr_torch import Renderer, ShardedRenderer, convert, kernels
from xr_torch.app import renderer
from xr_torch.core import math3d as m3
from xr_torch.dist import shard
from xr_torch.pipeline.geometry import clip_capacity, geometry
from xr_torch.pipeline.shadow import light_matrices_for_scene
from xr_torch.raster import dispatch
from xr_torch.scene import presets
from xr_torch.shading import blend

torch.set_num_threads(1)


def _port(scene_np, cam, cfg, strict=True):
    """One frame of the port on the CPU from the reference's numpy scene."""
    scene = convert.scene_to_torch(scene_np, "cpu")
    r = Renderer(scene, convert.config_from(cfg), "cpu")
    kernels.reset_launches()
    frame = r.readback(r.step(scene, cam), strict=strict)
    assert not any(kernels.launches.values())
    return frame


def test_config4b_matches_golden():
    check_golden("config4b")


@pytest.mark.parametrize("shadow_map_size", [128, 1024])
def test_config4b_matches_reference_renderer(shadow_map_size):
    check_reference("config4b", 0.0, shadow_map_size == 1024, shadow_map_size=shadow_map_size)


def test_blend_overflow_matches_reference():
    m = manifest("config4b")
    p = ref_presets.small_preset(ref_presets.config4_blend(), m["width"], m["height"],
                                 **{**m["overrides"], "blend_capacity": 2})
    cam, mm = p.animate(0.0, np)
    scene = p.scene.replace(model_matrices=mm)
    r = RefRenderer(scene, p.config)
    ref = r.readback(r.step(scene, cam), strict=False)
    got = _port(scene, cam, p.config, strict=False)
    assert int(ref.stats["blend_overflow"]) > 0
    for k in ref.stats:
        assert int(got.stats[k]) == int(ref.stats[k]), k
    diff = np.abs(got.color.astype(int) - ref.color.astype(int)).max(axis=-1)
    risk = shadow_flip_risk(scene, cam, p.config)
    assert (diff * ~risk).max() <= 1 and (diff * risk).max() <= 180
    # the port's own preset, through strict readback
    pp = presets.small_preset(presets.config4_blend(), m["width"], m["height"],
                              **{**m["overrides"], "blend_capacity": 2})
    st = convert.scene_to_torch(pp.scene, "cpu")
    rr = Renderer(st, pp.config, "cpu")
    with pytest.raises(RuntimeError, match="blend_overflow"):
        rr.readback(rr.step(st, cam))


def _pane_scene(far_quad, alphas):
    """Two transparent panes, the far one authored first: far_quad is its
    four corners, the near pane a square at z = 2. The far pane is cut into
    5 strips along its second edge (each strip spans the first edge, so
    every strip meets what the whole pane meets), the near one into 3 x 3
    quads: a scene of fewer than 9 triangles takes the identity record
    layout, which the port does not run."""
    quads = [(far_quad, 1, 5),
             ([(-0.8, -0.9, 2.0), (0.8, -0.9, 2.0), (0.8, 0.9, 2.0), (-0.8, 0.9, 2.0)], 3, 3)]
    pos, idx, mat = [], [], []
    for m, (quad, nu, nv) in enumerate(quads):
        q = np.asarray(quad, np.float64)
        for i in range(nu):
            for j in range(nv):
                b = len(pos)
                for u, v in ((i, j), (i + 1, j), (i + 1, j + 1), (i, j + 1)):
                    u, v = u / nu, v / nv  # bilinear in the quad's corners
                    pos.append(tuple((1 - v) * ((1 - u) * q[0] + u * q[1])
                                     + v * ((1 - u) * q[3] + u * q[2])))
                idx += [(b, b + 1, b + 2), (b, b + 2, b + 3)]
                mat += [m, m]
    v = len(pos)
    mesh = Mesh(
        positions=np.asarray(pos, np.float32),
        normals=np.tile(np.asarray([(0.0, 0.0, 1.0)], np.float32), (v, 1)),
        uvs=np.zeros((v, 2), np.float32),
        indices=np.asarray(idx, np.int32),
        material_id=np.asarray(mat, np.int32),
        transform_id=np.zeros(v, np.int32),
    )
    return Scene(
        mesh=mesh,
        materials=Material.table([{"base_color": (1.0, 0.2, 0.1), "alpha": alphas[0]},
                                  {"base_color": (0.1, 0.3, 1.0), "alpha": alphas[1]}]),
        textures=None,
        lights=Lights.make(ambient=(1.0, 1.0, 1.0)),
        model_matrices=np.eye(4, dtype=np.float32)[None],
    )


FAR_PANES = {
    # tilted from z = -1 up to z = 8, behind the eye: the near plane (z =
    # 4.5) cuts both of its triangles
    "near_plane": [(-1.5, -1.0, -1.0), (1.5, -1.0, -1.0), (1.5, 1.0, 8.0), (-1.5, 1.0, 8.0)],
    # reaches x = -30: both triangles cross the guard band
    # (tests/test_blend.py:105)
    "guard_band": [(-30.0, -1.0, -1.0), (0.8, -1.0, -1.0), (0.8, 1.0, -1.0), (-30.0, 1.0, -1.0)],
}


@pytest.mark.parametrize("case", sorted(FAR_PANES))
def test_blend_order_survives_clipping(case):
    cam = Camera(
        eye=np.asarray((0.0, 0.0, 5.0), np.float32),
        target=np.asarray((0.0, 0.0, 0.0), np.float32),
        up=np.asarray((0.0, 1.0, 0.0), np.float32),
        fov_y=np.asarray(np.deg2rad(60.0), np.float32),
        near=np.asarray(0.5, np.float32),
        far=np.asarray(50.0, np.float32),
    )
    cfg = RenderConfig(width=128, height=80, mode=MODE_FLAT, blend=True, cull_backfaces=False,
                       raster_path="binned", bin_capacity=1024)
    a0, a1 = 0.5, 0.4
    scene = _pane_scene(FAR_PANES[case], (a0, a1))
    got = _port(scene, cam, cfg)
    ref = render_frame(scene, cam, cfg)
    assert np.abs(got.color.astype(int) - ref.color.astype(int)).max() <= 1
    for k in ref.stats:
        assert int(got.stats[k]) == int(ref.stats[k]), k

    def alone(m):  # each pane by itself, opaque: its color and footprint
        s1 = _pane_scene(FAR_PANES[case], (1.0, 1.0))
        keep = np.asarray(s1.mesh.material_id) == m
        s1 = s1.replace(mesh=s1.mesh.replace(indices=np.asarray(s1.mesh.indices)[keep],
                                             material_id=np.asarray(s1.mesh.material_id)[keep]))
        return _port(s1, cam, dataclasses.replace(cfg, blend=False))

    # the far pane really was cut: some of its source triangles are fans
    tri = geometry(convert.scene_to_torch(scene, "cpu"),
                   *m3.camera_matrices(convert.camera_to_torch(cam, "cpu"), 128 / 80, "cpu"),
                   convert.config_from(cfg))
    src = tri.src_id[tri.valid & (tri.mat_id == 0)].tolist()
    assert len(src) > len(set(src)), "the far pane was not clipped"
    f0, f1 = alone(0), alone(1)
    both = (f0.depth < 1.0) & (f1.depth < 1.0)
    assert both.sum() > 100, "the panes do not overlap on screen"
    c0, c1 = f0.color / 255.0, f1.color / 255.0
    want = (c0 * a0) * (1.0 - a1) + c1 * a1  # authored order over black
    wrong = (c1 * a1) * (1.0 - a0) + c0 * a0
    assert np.abs(got.color / 255.0 - want)[both].max() <= 2.5 / 255.0
    assert np.abs(wrong - want)[both].max() > 10.0 / 255.0


def _rich_blend_scene():
    """tests/test_blend.py:235: opaque ground, a tall box west of a textured
    transparent pane, the box's shadow falling onto the pane."""
    ground = rproc.grid_plane(1, 1, size=12.0, mat=0)
    box = rproc.transformed(rproc.cube(1.0, mat=1),
                            rm3.translation((-2.2, 1.2, 0.0), np) @ rm3.scaling((0.5, 2.4, 3.0), np))
    pane = rproc.transformed(rproc.grid_plane(1, 1, size=4.0, mat=2),
                             rm3.translation((0.3, 1.0, 0.0), np))
    return Scene(
        mesh=rproc.merge_meshes([ground, box, pane]),
        materials=Material.table([
            {"base_color": (0.75, 0.75, 0.78), "ks": 0.0},
            {"base_color": (0.8, 0.5, 0.3), "ks": 0.1},
            {"base_color": (1.0, 1.0, 1.0), "ks": 0.0, "alpha": 0.5, "tex_id": 0},
        ]),
        textures=rtx.build_pyramid([rtx.checkerboard(32, 4)]),
        lights=Lights.make(dir_dirs=[(1.0, -1.2, 0.15)], dir_colors=[(0.95, 0.95, 0.9)],
                           ambient=(0.25, 0.25, 0.25)),
        model_matrices=np.eye(4, dtype=np.float32)[None],
    )


def test_textured_shadowed_pane_matches_reference():
    scene = _rich_blend_scene()
    cam = Camera(
        eye=np.asarray((2.5, 6.5, 6.5), np.float32),
        target=np.asarray((0.3, 0.6, 0.0), np.float32),
        up=np.asarray((0.0, 1.0, 0.0), np.float32),
        fov_y=np.asarray(np.deg2rad(55.0), np.float32),
        near=np.asarray(0.5, np.float32),
        far=np.asarray(60.0, np.float32),
    )
    cfg = RenderConfig(width=192, height=120, mode=MODE_PHONG, shadow_map_size=256, blend=True,
                       bin_capacity=4096, raster_path="binned")
    got = _port(scene, cam, cfg)
    ref = render_frame(scene, cam, cfg)
    assert ((got.depth == 1.0) == (ref.depth == 1.0)).all()
    diff = np.abs(got.color.astype(int) - ref.color.astype(int)).max(axis=-1)
    risk = shadow_flip_risk(scene, cam, cfg)
    assert int(risk.sum()) <= diff.size // 1000
    assert (diff * ~risk).max() <= 1 and (diff * risk).max() <= 180
    # the pane is there and textured: without its texture the frame changes
    plain = scene.replace(materials=scene.materials.replace(
        tex_id=np.asarray([-1, -1, -1], np.int32)))
    assert (np.abs(_port(plain, cam, cfg).color.astype(int) - got.color.astype(int)) > 3).sum() > 300


def _count_chunks(monkeypatch, shapes=None):
    """Counts of the composite's chunks (its _fragment_colors calls) and of
    its host reads of the live slot count; shapes, if given, gets each
    chunk's (slots, rows, columns)."""
    calls = {"chunks": 0, "reads": 0}
    frag, live = blend._fragment_colors, blend.live_records

    def counted_frag(*a, **k):
        calls["chunks"] += 1
        if shapes is not None:
            shapes.append(tuple(a[4].shape))  # e0: (slots, rows, columns)
        return frag(*a, **k)

    def counted_live(*a, **k):
        calls["reads"] += 1
        return live(*a, **k)

    monkeypatch.setattr(blend, "_fragment_colors", counted_frag)
    monkeypatch.setattr(blend, "live_records", counted_live)
    return calls


def _live_chunks(scene_np, cam, cfg):
    """(chunks the composite must run, chunks it holds) from the port's
    geometry: ceil(min(total, cap) / ch) of ceil(cap / ch)."""
    scene = convert.scene_to_torch(scene_np, "cpu")
    _, view, proj = renderer.camera_matrices(scene, cam, cfg)
    tri = geometry(scene, view, proj, cfg)
    total = int(blend.transparent_mask(tri, scene).sum())
    ch = min(cfg.blend_chunk, cfg.blend_capacity)
    return -(-min(total, cfg.blend_capacity) // ch), -(-cfg.blend_capacity // ch)


def _pixel_rows(scene_np, cam, cfg):
    """The half-open rows [y0, y1) of the pixel centres within the snapped
    y extent of the transparent records, from the port's geometry."""
    scene = convert.scene_to_torch(scene_np, "cpu")
    _, view, proj = renderer.camera_matrices(scene, cam, cfg)
    tri = geometry(scene, view, proj, cfg)
    ys = tri.ys[blend.transparent_mask(tri, scene)]
    sub, half = cfg.subpixel, cfg.subpixel // 2
    return -((half - int(ys.min())) // sub), (int(ys.max()) - half) // sub + 1


def _check_rule(got, ref, scene, cam, cfg, stats=True):
    """The shadow-flip rule of check_reference, stats equal (stats=False: a
    banded frame, whose pixel counts take the padded height)."""
    assert ((got.depth == 1.0) == (ref.depth == 1.0)).all()
    for k in ref.stats if stats else ():
        assert int(got.stats[k]) == int(ref.stats[k]), k
    diff = np.abs(got.color.astype(int) - ref.color.astype(int)).max(axis=-1)
    risk = shadow_flip_risk(scene, cam, cfg)
    assert (diff * ~risk).max() <= 1 and (diff * risk).max() <= 180


@pytest.mark.parametrize("bands", [1, 4])
def test_config4b_runs_only_its_live_chunks(monkeypatch, bands):
    m = manifest("config4b")
    p = ref_presets.small_preset(ref_presets.config4_blend(), m["width"], m["height"],
                                 **m["overrides"], num_shards=bands)
    cam, mm = p.animate(0.0, np)
    scene = p.scene.replace(model_matrices=mm)
    live, held = _live_chunks(scene, cam, convert.config_from(p.config))
    assert (live, held) == (1, 4)
    shapes = []
    calls = _count_chunks(monkeypatch, shapes)
    st = convert.scene_to_torch(scene, "cpu")
    cfg = convert.config_from(p.config)
    r = Renderer(st, cfg, "cpu") if bands == 1 else ShardedRenderer(st, cfg, devices=["cpu"])
    got = r.readback(r.step(st, cam))
    # the live chunk runs in each band its records' rows reach (config4b's
    # panes: 2 of the 4 bands of 64 rows); the count is read once a device
    _, hb, _ = shard.band_config(cfg, bands)
    y0, y1 = _pixel_rows(scene, cam, cfg)
    reached = sum(y0 < (b + 1) * hb and y1 > b * hb for b in range(bands))
    assert reached == (1 if bands == 1 else 2)
    assert calls == {"chunks": reached * live, "reads": 1}
    # on its 4 live slots of 8, over a box smaller than the frame (band)
    assert all(k == 4 and h * w < cfg.width * min(hb, cfg.height) for k, h, w in shapes)
    rr = RefRenderer(scene, p.config)  # which ignores num_shards
    _check_rule(got, rr.readback(rr.step(scene, cam)), scene, cam, p.config, stats=bands == 1)


@pytest.mark.parametrize("bands", [1, 4])
def test_blend_consumes_the_shaded_color(monkeypatch, bands):
    """The composite writes the shade stage's color in place: on every
    band the tensor it is given is the one it returns, and the panes
    change it. The frame through Renderer (ShardedRenderer in 4 bands) on
    the CPU still holds the reference renderer's under the shadow-flip
    rule: nothing after the blend reads the color from before it."""
    m = manifest("config4b")
    p = ref_presets.small_preset(ref_presets.config4_blend(), m["width"], m["height"],
                                 **m["overrides"], num_shards=bands)
    cam, mm = p.animate(3.0, np)
    scene = p.scene.replace(model_matrices=mm)
    calls = []
    composite = blend.composite_transparent

    def spy(color, *args, **kw):
        before = color.clone()
        out, overflow = composite(color, *args, **kw)
        calls.append((out is color, not torch.equal(color, before)))
        return out, overflow

    monkeypatch.setattr(blend, "composite_transparent", spy)
    st = convert.scene_to_torch(scene, "cpu")
    cfg = convert.config_from(p.config)
    r = Renderer(st, cfg, "cpu") if bands == 1 else ShardedRenderer(st, cfg, devices=["cpu"])
    got = r.readback(r.step(st, cam))
    assert len(calls) == bands and all(same for same, _ in calls)
    assert any(changed for _, changed in calls)
    rr = RefRenderer(scene, p.config)  # which ignores num_shards
    _check_rule(got, rr.readback(rr.step(scene, cam)), scene, cam, p.config, stats=bands == 1)


def test_culled_transparent_triangles_run_no_chunk(monkeypatch):
    """The textured pane moved behind the eye: geometry drops it, so no
    record is live and no chunk runs."""
    scene = _rich_blend_scene()
    pos = np.asarray(scene.mesh.positions).copy()
    mat = np.asarray(scene.mesh.material_id)
    pane = np.unique(np.asarray(scene.mesh.indices)[mat == 2])
    pos[pane] += np.asarray([0.0, 0.0, 40.0], np.float32)
    scene = scene.replace(mesh=scene.mesh.replace(positions=pos))
    cam = Camera(
        eye=np.asarray((2.5, 6.5, 6.5), np.float32),
        target=np.asarray((0.3, 0.6, 0.0), np.float32),
        up=np.asarray((0.0, 1.0, 0.0), np.float32),
        fov_y=np.asarray(np.deg2rad(55.0), np.float32),
        near=np.asarray(0.5, np.float32),
        far=np.asarray(60.0, np.float32),
    )
    cfg = RenderConfig(width=96, height=60, mode=MODE_PHONG, shadow_map_size=128, blend=True,
                       bin_capacity=4096, raster_path="binned")
    assert _live_chunks(scene, cam, cfg)[0] == 0
    calls = _count_chunks(monkeypatch)
    got = _port(scene, cam, cfg)
    assert calls == {"chunks": 0, "reads": 1}
    _check_rule(got, render_frame(scene, cam, cfg), scene, cam, cfg)


def test_over_capacity_runs_every_chunk_and_reports_overflow(monkeypatch):
    m = manifest("config4b")
    p = ref_presets.small_preset(ref_presets.config4_blend(), m["width"], m["height"],
                                 **{**m["overrides"], "blend_capacity": 2, "blend_chunk": 1})
    cam, mm = p.animate(0.0, np)
    scene = p.scene.replace(model_matrices=mm)
    assert _live_chunks(scene, cam, convert.config_from(p.config)) == (2, 2)
    calls = _count_chunks(monkeypatch)
    got = _port(scene, cam, p.config, strict=False)
    assert calls == {"chunks": 2, "reads": 1}
    r = RefRenderer(scene, p.config)
    ref = r.readback(r.step(scene, cam), strict=False)
    assert int(got.stats["blend_overflow"]) == 2
    _check_rule(got, ref, scene, cam, p.config)


def _pane_camera():
    """test_blend_order_survives_clipping's camera: at z = 5 looking down
    -z, 60 degrees of fov_y."""
    return Camera(
        eye=np.asarray((0.0, 0.0, 5.0), np.float32),
        target=np.asarray((0.0, 0.0, 0.0), np.float32),
        up=np.asarray((0.0, 1.0, 0.0), np.float32),
        fov_y=np.asarray(np.deg2rad(60.0), np.float32),
        near=np.asarray(0.5, np.float32),
        far=np.asarray(50.0, np.float32),
    )


PANE_CFG = RenderConfig(width=128, height=80, mode=MODE_FLAT, blend=True, cull_backfaces=False,
                        raster_path="binned", bin_capacity=1024)


def _with_sliver(scene, corners_px, cfg):
    """The scene with one more transparent triangle (material 1) whose
    screen corners are corners_px (pixels), on the plane z = 0 that
    _pane_camera sees from 5 units away."""
    t = np.tan(np.deg2rad(30.0)) * 5.0
    pos = [((2.0 * x / cfg.width - 1.0) * t * cfg.width / cfg.height,
            (1.0 - 2.0 * y / cfg.height) * t, 0.0) for x, y in corners_px]
    m = scene.mesh
    v = m.positions.shape[0]
    mesh = m.replace(
        positions=np.concatenate([m.positions, np.asarray(pos, np.float32)]),
        normals=np.concatenate([m.normals, np.tile(np.float32([[0.0, 0.0, 1.0]]), (3, 1))]),
        uvs=np.concatenate([m.uvs, np.zeros((3, 2), np.float32)]),
        indices=np.concatenate([m.indices, np.asarray([[v, v + 1, v + 2]], np.int32)]),
        material_id=np.concatenate([m.material_id, np.asarray([1], np.int32)]),
        transform_id=np.concatenate([m.transform_id, np.zeros(3, np.int32)]),
    )
    return scene.replace(mesh=mesh)


def _sliver_case():
    """The near-plane panes, one record a chunk, and a live record between
    pixel centres (snapped to x, y in [10.75, 11.25]): its chunk's box is
    empty and runs nothing."""
    scene, cam, cfg, bands = _panes("near_plane", blend_chunk=1)
    corners = [(10.75, 20.75), (11.25, 20.75), (10.75, 21.25)]
    return _with_sliver(scene, corners, cfg), cam, cfg, bands


def _config4b(t, **over):
    m = manifest("config4b")
    p = presets.small_preset(presets.config4_blend(), m["width"], m["height"],
                             **{**m["overrides"], **over})
    cam, mm = p.animate(t)
    return p.scene.replace(model_matrices=mm), cam, p.config, 1


def _panes(case, bands=1, **over):
    return (_pane_scene(FAR_PANES[case], (0.5, 0.4)), _pane_camera(),
            convert.config_from(dataclasses.replace(PANE_CFG, **over)), bands)


CROP_CASES = {
    **{f"config4b-t{t}": (lambda t=t: _config4b(t)) for t in (0.0, 3.0, 6.05, 9.0, 16.0)},
    # 4 bands of 64 rows: the panes' rows 24-68 cross the edge at 64;
    # bands 2 and 3 are reached by no pane
    "config4b-4bands": lambda: _config4b(0.0)[:3] + (4,),
    # the far pane reaches x = -30: its chunk's box is cut at column 0
    "frame_edge": lambda: _panes("guard_band"),
    # one record a chunk, each its own box; and in 4 bands of 32 rows (the
    # panes' rows 17-51 cross the edge at 32; bands 2 and 3 reached by none)
    "chunk1": lambda: _panes("near_plane", blend_chunk=1),
    "chunk1-4bands": lambda: _panes("near_plane", 4, blend_chunk=1, tile_h=16),
    "no_centre": lambda: _sliver_case(),
    # 4 transparent records, 2 held: both chunks of one slot run
    "over_capacity": lambda: _config4b(0.0, blend_capacity=2, blend_chunk=1),
}


@pytest.mark.parametrize("case", list(CROP_CASES))
def test_cropped_composite_is_the_whole_frame_composite(monkeypatch, case):
    scene_np, cam, cfg, bands = CROP_CASES[case]()
    scene = convert.scene_to_torch(scene_np, "cpu")
    cap = clip_capacity(scene.mesh.num_triangles, cfg)
    c, view, proj = renderer.camera_matrices(scene, cam, cfg)
    shadow = {}
    if renderer.has_shadow_pass(cfg):
        shadow, _ = renderer.shadow_pass(scene, cfg, *light_matrices_for_scene(scene), cap)
    tri, vis_tri = renderer.visible_triangles(scene, view, proj, cfg, cap)
    slots = blend.live_slots(tri, scene, cfg)
    live = blend.live_records(tri, scene, cfg, slots)
    ch = min(cfg.blend_chunk, cfg.blend_capacity)
    assert live.count == min(int(blend.transparent_mask(tri, scene).sum()), cfg.blend_capacity)
    assert len(live.boxes) == -(-live.count // ch)
    _, hb, band_cfg = shard.band_config(cfg, bands) if bands > 1 else (0, cfg.height, cfg)
    ran, changed = [], []
    for b in range(bands):
        yo = b * hb
        tid, zbuf, _ = dispatch.visibility(vis_tri, band_cfg, cap, y_offset=yo)
        depth = torch.where(torch.isinf(zbuf), 1.0, zbuf)
        rgb = renderer.shade(tri, tid, scene, band_cfg, c.eye, shadow, None, depth, yo)
        want = blend.composite_whole_frame(rgb, depth, tri, scene, band_cfg, c.eye, y_offset=yo,
                                           **shadow)
        shapes = []
        calls = _count_chunks(monkeypatch, shapes)
        got = blend.composite_transparent(rgb.clone(), depth, tri, scene, band_cfg, c.eye,
                                          y_offset=yo,
                                          live=slots if bands > 1 else None, **shadow)
        monkeypatch.undo()
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)), b
        assert int(got[1]) == int(want[1]) == max(int(blend.transparent_mask(tri, scene).sum())
                                                  - cfg.blend_capacity, 0)
        # a chunk runs where its box meets these rows, on its live slots
        boxes = [(max(y0, yo), min(y1, yo + hb)) + blend._columns(x0, x1, cfg.width)
                 for y0, y1, x0, x1 in live.boxes]
        live_boxes = [(k, bx) for k, bx in enumerate(boxes) if bx[0] < bx[1] and bx[2] < bx[3]]
        assert calls == {"chunks": len(live_boxes), "reads": int(bands == 1)}
        assert shapes == [(min(ch, live.count - k * ch), y1 - y0, x1 - x0)
                          for k, (y0, y1, x0, x1) in live_boxes]
        ran.append(len(live_boxes))
        changed.append(not torch.equal(got[0], rgb))
    assert any(changed), "the panes composite nowhere"
    if case.endswith("4bands"):
        assert 0 in ran and sum(ran) > len(live.boxes), ran  # an unreached band, a crossed edge
    if case == "frame_edge":
        assert min(x0 for _, _, x0, _ in live.boxes) < 0
    if case == "no_centre":
        assert ran[0] < len(live.boxes)
