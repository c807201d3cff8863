"""Measured capacity auto-sizing and config7 in the port, against the
reference (mirrors tests/test_autosize.py; the 1 M-triangle dry pass is not
run here).

The port's emission mirror counts exactly what its own binning builds;
``measure_frame`` equals the reference's dict on two cameras of a ~10k
triangle terrain, ``autosize_config`` the reference's config field by field,
and knobs sized from wrong ones render strict. config7's LOD mesh is
bit-equal to the reference's, and its golden frame (n0=64) matches the
checked-in PNG and the reference Renderer's frame.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from xr.app.autosize import autosize_config as ref_autosize_config
from xr.app.autosize import measure_frame as ref_measure_frame
from xr.app.renderer import Renderer as RefRenderer
from xr.core.types import Camera as RefCamera
from xr.core.types import Lights as RefLights
from xr.core.types import Material as RefMaterial
from xr.core.types import Scene as RefScene
from xr.scene import presets as ref_presets
from xr.scene import procedural as ref_proc
from xr.scene import texture as ref_tx
from xr_torch import Renderer, convert, kernels
from xr_torch.app.autosize import autosize_config, camera_matrices_np, measure_frame
from xr_torch.core.image import read_png
from xr_torch.core.types import MODE_TEXTURED, RenderConfig
from xr_torch.pipeline.geometry import MAX_FAN, clip_budget, geometry
from xr_torch.raster.binning import bin_triangles
from xr_torch.scene import presets
from xr_torch.scene import procedural as proc

# the suite runs several worker processes on shared cores: one torch
# thread each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
CFG = RenderConfig(width=320, height=176, mode=MODE_TEXTURED, tile_h=32, tile_w=128,
                   raster_path="binned", backend="jnp")


def _ref_scene(n):
    """tests/test_autosize.py's terrain: 2 n^2 triangles."""
    return RefScene(
        mesh=ref_proc.terrain(n, n, size=40.0, height=5.0, octaves=4, seed=3),
        materials=RefMaterial.table([{"base_color": (1.0, 1.0, 1.0), "tex_id": 0}]),
        textures=ref_tx.build_pyramid([ref_tx.checkerboard(64, 8)]),
        lights=RefLights.make(dir_dirs=[(-0.4, -0.8, -0.45)], dir_colors=[(1.0, 1.0, 1.0)]),
        model_matrices=np.eye(4, dtype=np.float32)[None],
    )


def _cam(eye=(0.0, 14.0, 26.0)):
    return RefCamera(
        eye=np.asarray(eye, np.float32),
        target=np.asarray((0.0, 0.0, 0.0), np.float32),
        up=np.asarray((0.0, 1.0, 0.0), np.float32),
        fov_y=np.asarray(np.deg2rad(60.0), np.float32),
        near=np.asarray(0.5, np.float32),
        far=np.asarray(120.0, np.float32),
    )


CAMERAS = [_cam(), _cam((18.0, 6.0, 9.0))]


def _ref_config(cfg):
    from xr.core.types import RenderConfig as RefConfig

    return RefConfig(**dataclasses.asdict(cfg))


def test_mirror_matches_the_ports_own_bins():
    """The mirror's totals are the raw occupancies of the port's bins
    (tests/test_autosize.py:57-88): medium capacity large enough that every
    eligible triangle is selected."""
    scene = convert.scene_to_torch(_ref_scene(72), "cpu")
    cfg = dataclasses.replace(CFG, medium_capacity=4096)
    m = measure_frame(scene, CAMERAS[0], cfg, device="cpu")
    T = scene.mesh.num_triangles
    view, proj = (torch.from_numpy(a)
                  for a in camera_matrices_np(CAMERAS[0], cfg.width / cfg.height))
    tri = geometry(scene, view, proj, cfg, capacity=T + clip_budget(T, cfg) * MAX_FAN)
    b = bin_triangles(tri, cfg)
    assert int(b.raw_counts.sum()) == m["total_entries"]
    assert int(b.raw_counts.max()) == m["per_tile_max"]
    assert int(b.large_count) == min(m["large"], cfg.large_capacity)


@pytest.mark.parametrize("cam", [0, 1])
def test_measure_frame_equals_reference(cam):
    scene = _ref_scene(72)
    want = ref_measure_frame(scene, CAMERAS[cam], _ref_config(CFG))
    got = measure_frame(scene, CAMERAS[cam], CFG, device="cpu")
    assert list(got) == list(want) and got == want
    assert all(type(v) is int for v in got.values())


def test_autosize_renders_overflow_free():
    """Zero hand tuning (tests/test_autosize.py:91-115): from knobs that are
    wrong for the scene, Renderer(autosize_cameras=) sizes every capacity
    as the reference does, and the frame reads back strict."""
    scene = _ref_scene(72)
    bad = dataclasses.replace(CFG, bin_capacity=8, large_capacity=8, clip_budget=8,
                              clip_expand=0.01)
    tscene = convert.scene_to_torch(scene, "cpu")
    r = Renderer(tscene, bad, "cpu", autosize_cameras=[CAMERAS[0]], autosize_margin=1.3)
    want = ref_autosize_config(scene, [CAMERAS[0]], _ref_config(bad), margin=1.3)
    for k, v in dataclasses.asdict(want).items():
        got = getattr(r.config, k)
        assert got == v and type(got) is type(v), k
    f = r.readback(r.step(tscene, CAMERAS[0]))  # strict: raises on any overflow
    assert int(f.stats["bin_overflow"]) == 0 and int(f.stats["clip_overflow"]) == 0
    assert (f.depth < 1.0).sum() > 1000
    # one camera, not in a list; and (Camera, model_matrices) pairs
    r1 = Renderer(tscene, bad, "cpu", autosize_cameras=CAMERAS[0], autosize_margin=1.3)
    assert r1.config == r.config
    pairs = [(c, np.eye(4, dtype=np.float32)[None]) for c in CAMERAS]
    assert autosize_config(tscene, pairs, bad, device="cpu") == autosize_config(
        tscene, CAMERAS, bad, device="cpu")


@pytest.mark.parametrize("n0", [64, 160])
def test_config7_mesh_bit_equal(n0):
    got = proc.with_vert_mat(proc.terrain_lod(n0=n0))
    want = ref_proc.with_vert_mat(ref_proc.terrain_lod(n0=n0))
    for f in ("positions", "normals", "uvs", "indices", "material_id", "transform_id",
              "vert_mat"):
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), f
    if n0 == 160:
        assert got.indices.shape[0] == 177_920


def test_config7_config_equals_reference_at_n0_64():
    got = dataclasses.asdict(presets.config7_terrain_lod(n0=64, device="cpu").config)
    want = dataclasses.asdict(ref_presets.config7_terrain_lod(n0=64).config)
    for k in want:
        assert got[k] == want[k] and type(got[k]) is type(want[k]), k


def test_config7_golden_and_reference_frame():
    """The golden (n0=64, the manifest's overrides) within 1 LSB, coverage
    within 1e-6; the reference Renderer's frame by the device-vs-oracle
    rule (coverage exact, depth within 1e-6, color within 1 LSB, equal
    stats)."""
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as fh:
        m = json.load(fh)["config7"]
    p = presets.small_preset(presets.config7_terrain_lod(n0=64, device="cpu"), m["width"],
                             m["height"], **m["overrides"])
    cam, mm = p.animate(m["t"])
    scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), "cpu")
    r = Renderer(scene, p.config, "cpu")
    kernels.reset_launches()
    got = r.readback(r.step(scene, cam))
    assert not any(kernels.launches.values())
    golden = read_png(os.path.join(GOLDEN_DIR, "config7.png"))
    assert np.abs(got.color.astype(int) - golden.astype(int)).max() <= 1
    assert abs(float((got.depth < 1.0).mean()) - m["coverage"]) < 1e-6

    rp = ref_presets.small_preset(ref_presets.config7_terrain_lod(n0=64), m["width"],
                                  m["height"], **m["overrides"])
    rcam, rmm = rp.animate(m["t"], np)
    rscene = rp.scene.replace(model_matrices=rmm)
    rr = RefRenderer(rscene, rp.config)
    ref = rr.readback(rr.step(rscene, rcam))
    assert ((got.depth == 1.0) == (ref.depth == 1.0)).all()
    np.testing.assert_allclose(got.depth, ref.depth, rtol=0, atol=1e-6)
    assert np.abs(got.color.astype(int) - ref.color.astype(int)).max() <= 1
    for k in ref.stats:
        assert int(got.stats[k]) == int(ref.stats[k]), k
