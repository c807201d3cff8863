"""The port's CPU oracle (``xr_torch.cpu_ref``) on the CPU, against the
reference's (``xr/cpu_ref``) on the same inputs:
- ``render_frame`` on the nine presets at golden size: against the
  reference oracle (stats and coverage equal; depth bit-equal, config5's
  too since the camera matrices are the host's numpy ones; color within
  1 LSB outside the pixels ``shadow_flip_risk`` marks, at most 180 LSB on
  them) and against the checked-in golden (the golden rule of
  tests/test_goldens.py);
- ``visibility_bbox`` against the reference's on one TriBuf: tid and z
  exact, with the depth test, in painter's order and under the identity
  record layout;
- ``shadow_flip_risk``: the reference's mask on config4, config4b and
  config6, and the reference's tests/test_margins.py cases;
- the cases of tests/test_oracle_vs_brute.py (modes, cull, occlusion,
  blend, point lights): the port's oracle against the port's independent
  scalar rasterizer, and the port's sampler and shadow test against its
  scalar re-derivations (tests/test_scalar_validators.py);
- ``regen_goldens`` into a temporary directory (and its refusal of
  tests/goldens), and ``xr_torch.render_frame``.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

import xr_torch
from xr.core import math3d as rm3
from xr.core.types import RenderConfig as RefConfig
from xr.cpu_ref import oracle as ref_oracle
from xr.cpu_ref.margins import shadow_flip_risk as ref_shadow_flip_risk
from xr.pipeline.geometry import geometry as ref_geometry
from xr.scene import presets as ref_presets
from xr.shading import blend as ref_blend
from xr_torch import convert
from xr_torch.core import shade_math as sm
from xr_torch.core.image import read_png
from xr_torch.core.types import (
    MODE_FLAT, MODE_GOURAUD, Camera, Lights, Material, Mesh, RenderConfig, Scene,
)
from xr_torch.cpu_ref import brute, oracle
from xr_torch.cpu_ref.margins import frame_and_risk, shadow_flip_risk
from xr_torch.scene import presets
from xr_torch.scene import texture as tx
from xr_torch.tools import regen_goldens

torch.set_num_threads(1)
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
NAMES = ["config1", "config2", "config3", "config4", "config4b", "config5", "config6",
         "config6cap", "config7"]
SHADOWED = ("config4", "config4b", "config6", "config6cap")  # tests/test_goldens.py:51-56
REF = {
    "config1": ref_presets.config1_cube,
    "config2": ref_presets.config2_icospheres,
    "config3": lambda: ref_presets.config3_terrain(48, 48),
    "config4": ref_presets.config4_phong,
    "config4b": ref_presets.config4_blend,
    "config5": lambda: ref_presets.config5_flythrough(64, 64),
    "config6": ref_presets.config6_asset,
    "config6cap": ref_presets.config6_capped,
    "config7": lambda: ref_presets.config7_terrain_lod(n0=64),
}


def _manifest(name):
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as f:
        return json.load(f)[name]


@functools.lru_cache(maxsize=None)
def _ref_case(name):
    """The reference's preset at golden size: (host scene, camera, config)."""
    m = _manifest(name)
    p = ref_presets.small_preset(REF[name](), m["width"], m["height"], **m["overrides"])
    cam, mm = p.animate(m["t"], np)
    return p.scene.replace(model_matrices=mm), cam, p.config


@functools.lru_cache(maxsize=None)
def _port_frame_and_risk(name):
    """The port's oracle frame of the port's own preset at golden size, and
    its shadow-flip mask (one render)."""
    m = _manifest(name)
    p = presets.small_preset(regen_goldens.factories()[name](), m["width"], m["height"],
                             **m["overrides"])
    cam, mm = p.animate(m["t"])
    return frame_and_risk(p.scene.replace(model_matrices=mm), cam, p.config)


@pytest.mark.parametrize("name", NAMES)
def test_render_frame_matches_reference_oracle(name):
    frame, risk = _port_frame_and_risk(name)
    scene, cam, cfg = _ref_case(name)
    ref = ref_oracle.render_frame(scene, cam, cfg)
    assert set(frame.stats) == set(ref.stats)
    for k in ref.stats:
        assert int(frame.stats[k]) == int(ref.stats[k]), k
    assert ((frame.depth == 1.0) == (ref.depth == 1.0)).all(), "coverage mismatch"
    assert np.array_equal(frame.depth, ref.depth), \
        f"{int((frame.depth != ref.depth).sum())} depth pixels differ"
    diff = np.abs(frame.color.astype(int) - ref.color.astype(int)).max(axis=-1)
    assert (diff * ~risk).max() <= 1 and (diff * risk).max() <= 180


@pytest.mark.parametrize("name", NAMES)
def test_render_frame_matches_golden(name):
    frame, _ = _port_frame_and_risk(name)
    m = _manifest(name)
    golden = read_png(os.path.join(GOLDEN_DIR, f"{name}.png"))
    assert frame.color.shape == golden.shape and frame.color.dtype == np.uint8
    bad = int((np.abs(frame.color.astype(int) - golden.astype(int)).max(axis=-1) > 1).sum())
    npix = m["width"] * m["height"]
    assert bad <= (max(2, npix // 1000) if name in SHADOWED else 0), bad
    assert abs(float((frame.depth < 1.0).mean()) - m["coverage"]) < 1e-6


def _ref_tribuf(name, **over):
    """The reference's setup records of a golden-size frame (the camera
    pass; under blend the transparent records invalid, as visibility sees
    them), and the config."""
    scene, cam, cfg = _ref_case(name)
    cfg = dataclasses.replace(cfg, **over)
    view, proj = rm3.camera_matrices(cam, cfg.width / cfg.height, np)
    tri = ref_geometry(scene, view, proj, cfg, xp=np)
    if cfg.blend:
        tri = tri.replace(valid=ref_blend.opaque_valid(tri, scene, np))
    return tri, cfg


@pytest.mark.parametrize("name,over", [(n, {}) for n in NAMES if n != "config6cap"]
                         + [("config3", {"depth_test": False})])
def test_visibility_bbox_matches_reference(name, over):
    tri, cfg = _ref_tribuf(name, **over)
    want_tid, want_z = ref_oracle.visibility_bbox(tri, cfg)
    tid, z = oracle.visibility_bbox(convert.tribuf_to_torch(tri, "cpu"), convert.config_from(cfg))
    assert np.array_equal(tid.numpy(), want_tid)
    assert np.array_equal(z.numpy(), want_z)  # bit for bit, inf included
    assert (want_tid != 2**31 - 1).sum() > 50


def test_visibility_bbox_identity_layout():
    """Fewer than 9 triangles: the identity record layout, whose valid
    records are not a prefix (a culled triangle keeps its slot)."""
    scene, camera = _random_scene(np.random.default_rng(5), 6)
    cfg = RefConfig(width=48, height=40, mode=MODE_FLAT, cull_backfaces=True)
    view, proj = rm3.camera_matrices(camera, 48 / 40, np)
    tri = ref_geometry(scene, view, proj, cfg, xp=np)
    valid = np.asarray(tri.valid)
    assert not valid[: int(tri.count)].all()  # not a prefix
    want_tid, want_z = ref_oracle.visibility_bbox(tri, cfg)
    tid, z = oracle.visibility_bbox(convert.tribuf_to_torch(tri, "cpu"), convert.config_from(cfg))
    assert np.array_equal(tid.numpy(), want_tid) and np.array_equal(z.numpy(), want_z)


@pytest.mark.parametrize("name", ["config4", "config4b", "config6"])
def test_shadow_flip_risk_matches_reference(name):
    _, risk = _port_frame_and_risk(name)
    want = ref_shadow_flip_risk(*_ref_case(name))
    assert risk.dtype == bool and risk.shape == want.shape
    assert np.array_equal(risk, want)
    assert risk.any()


def _risk_480(factory, **kw):
    p = presets.small_preset(factory(), 480, 270)
    cam, mm = p.animate(0.0)
    return shadow_flip_risk(p.scene.replace(model_matrices=mm), cam, p.config, **kw)


def test_no_shadow_config_has_no_risk():
    r = _risk_480(presets.config2_icospheres)
    assert r.shape == (270, 480) and not r.any()


@pytest.mark.parametrize("factory", [presets.config4_phong, presets.config4_blend])
def test_shadowed_risk_is_tiny_but_real(factory):
    n = int(_risk_480(factory).sum())
    assert 0 < n <= 270 * 480 // 1000, n


def test_risk_eps_monotone():
    small = _risk_480(presets.config4_blend, eps_z=1e-7, eps_tex=1e-4)
    big = _risk_480(presets.config4_blend, eps_z=1e-4, eps_tex=2e-2)
    assert (small <= big).all() and big.sum() > small.sum()


# ---- the oracle against the independent scalar rasterizer -----------------


def _random_scene(rng, num_tris):
    """Random triangles fully inside the frustum of a fixed camera
    (tests/test_oracle_vs_brute.py:19)."""
    v = num_tris * 3
    pos = np.stack([rng.uniform(-1.4, 1.4, v), rng.uniform(-1.4, 1.4, v),
                    rng.uniform(-1.0, 1.0, v)], axis=1).astype(np.float32)
    nrm = rng.standard_normal((v, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    mesh = Mesh(
        positions=pos,
        normals=nrm,
        uvs=rng.uniform(0, 1, (v, 2)).astype(np.float32),
        indices=np.arange(v, dtype=np.int32).reshape(-1, 3),
        material_id=(np.arange(num_tris) % 2).astype(np.int32),
        transform_id=np.zeros(v, np.int32),
    )
    scene = Scene(
        mesh=mesh,
        materials=Material.table([{"base_color": (0.9, 0.4, 0.3)},
                                  {"base_color": (0.3, 0.6, 0.9)}]),
        textures=None,
        lights=Lights.make(dir_dirs=[(-0.4, -0.7, -0.6)], dir_colors=[(1.0, 0.95, 0.9)],
                           ambient=(0.15, 0.15, 0.15)),
        model_matrices=np.eye(4, dtype=np.float32)[None],
    )
    return scene, _camera()


def _camera():
    return Camera(
        eye=np.asarray((0.0, 0.0, 5.0), np.float32),
        target=np.asarray((0.0, 0.0, 0.0), np.float32),
        up=np.asarray((0.0, 1.0, 0.0), np.float32),
        fov_y=np.asarray(np.deg2rad(60.0), np.float32),
        near=np.asarray(0.5, np.float32),
        far=np.asarray(20.0, np.float32),
    )


def _against_brute(scene, camera, config):
    """Depth within 1e-5 (brute interpolates in f64), color within 2 LSB
    (Gouraud in f64); returns the oracle's frame."""
    frame = oracle.render_frame(scene, camera, config)
    b_color, b_depth = brute.render(scene, camera, config)
    np.testing.assert_allclose(frame.depth, b_depth, atol=1e-5)
    diff = np.abs(frame.color.astype(int) - b_color.astype(int))
    assert diff.max() <= 2, f"color diff {diff.max()}"
    return frame, b_color, b_depth


@pytest.mark.parametrize("mode", [MODE_FLAT, MODE_GOURAUD])
@pytest.mark.parametrize("cull", [True, False])
def test_oracle_matches_brute(mode, cull):
    rng = np.random.default_rng(42 + mode * 10 + cull)
    for _ in range(4):
        scene, camera = _random_scene(rng, 8)
        cfg = RenderConfig(width=48, height=40, mode=mode, cull_backfaces=cull)
        frame, b_color, b_depth = _against_brute(scene, camera, cfg)
        # which pixels are background must be IDENTICAL
        o_bg = (frame.depth == 1.0) & (frame.color == 0).all(axis=-1)
        b_bg = (b_depth == 1.0) & (b_color == 0).all(axis=-1)
        assert (o_bg == b_bg).all(), "coverage mismatch"


def test_oracle_depth_test_occlusion():
    """The nearer triangle wins whatever the draw order."""
    pos = np.array([[-1.2, -1.2, 0.0], [1.2, -1.2, 0.0], [0.0, 1.4, 0.0],  # far, big
                    [-0.5, -0.5, 1.0], [0.5, -0.5, 1.0], [0.0, 0.6, 1.0]],  # near, small
                   np.float32)
    for order in ([0, 1], [1, 0]):
        tris = np.array([[0, 1, 2], [3, 4, 5]], np.int32)[order]
        mesh = Mesh(positions=pos, normals=np.tile(np.float32([0, 0, 1]), (6, 1)),
                    uvs=np.zeros((6, 2), np.float32), indices=tris,
                    material_id=np.array(order, np.int32), transform_id=np.zeros(6, np.int32))
        scene = Scene(mesh=mesh,
                      materials=Material.table([{"base_color": (1.0, 0.0, 0.0)},
                                                {"base_color": (0.0, 1.0, 0.0)}]),
                      textures=None, lights=Lights.make(ambient=(1.0, 1.0, 1.0)),
                      model_matrices=np.eye(4, dtype=np.float32)[None])
        frame = oracle.render_frame(scene, _camera(), RenderConfig(width=64, height=64,
                                                                   mode=MODE_FLAT))
        assert frame.depth[32, 32] < frame.depth[2, 2] or frame.depth[2, 2] == 1.0
        near_mat = mesh.material_id[int(np.argwhere((tris == 3).any(axis=1))[0, 0])]
        want = np.floor(np.clip(scene.materials.base_color[near_mat], 0, 1) * 255 + 0.5)
        assert (frame.color[32, 32] == want.astype(np.uint8)).all()
        b_color, _ = brute.render(scene, _camera(), RenderConfig(width=64, height=64,
                                                                 mode=MODE_FLAT))
        assert (b_color[32, 32] == frame.color[32, 32]).all()


@pytest.mark.parametrize("mode", [MODE_FLAT, MODE_GOURAUD])
def test_oracle_blend_matches_brute(mode):
    """The oracle's composite (records, src_id order, chunked alpha over)
    against the brute validator's input-order scalar blend pass."""
    rng = np.random.default_rng(97 + mode)
    for _ in range(3):
        scene, camera = _random_scene(rng, 8)
        scene = scene.replace(materials=scene.materials.replace(
            alpha=np.asarray([1.0, 0.45], np.float32)))
        cfg = RenderConfig(width=48, height=40, mode=mode, blend=True, blend_capacity=16)
        frame, _, _ = _against_brute(scene, camera, cfg)
        assert int(frame.stats["blend_overflow"]) == 0


@pytest.mark.parametrize("mode", [MODE_FLAT, MODE_GOURAUD])
def test_point_lights_vertex_lit(mode):
    """Point lights reach the vertex-lit modes (flat at the face centroid,
    Gouraud at the vertex) and fall off with distance."""
    scene, camera = _random_scene(np.random.default_rng(1234 + mode), 8)
    scene = scene.replace(lights=Lights.make(pt_pos=[(0.0, 0.0, 1.5)], pt_colors=[(2.0, 2.0, 2.0)],
                                             ambient=(0.05, 0.05, 0.05)))
    cfg = RenderConfig(width=48, height=40, mode=mode)
    frame, _, _ = _against_brute(scene, camera, cfg)
    amb = oracle.render_frame(scene.replace(lights=Lights.make(ambient=(0.05, 0.05, 0.05))),
                              camera, cfg)
    assert (frame.color.astype(int) - amb.color.astype(int)).max() > 30


def test_brute_shares_no_pipeline_code():
    names = set(vars(brute))
    assert not any(n.startswith(("xr_torch", "torch")) for n in names)
    imported = {v.__name__ for v in vars(brute).values() if type(v).__name__ == "module"}
    assert imported <= {"math", "numpy"}, imported


def test_trilinear_matches_scalar_reference():
    pyr = tx.build_pyramid([tx.checkerboard(64, 8), tx.noise_texture(64, seed=5)])
    rng = np.random.default_rng(42)
    n = 256
    u = rng.uniform(-1.5, 2.5, n).astype(np.float32)
    v = rng.uniform(-1.5, 2.5, n).astype(np.float32)
    lod = rng.uniform(-0.5, pyr.num_levels + 0.5, n).astype(np.float32)
    tex = rng.integers(0, 2, n).astype(np.int32)
    got = sm.sample_trilinear(convert.textures_to_torch(pyr, "cpu"), torch.from_numpy(tex),
                              torch.from_numpy(u), torch.from_numpy(v),
                              torch.from_numpy(lod)).numpy()
    levels = [[np.asarray(pyr.data[t, pyr.level_offset(k): pyr.level_offset(k)
                                   + pyr.level_size(k) ** 2]).reshape(pyr.level_size(k),
                                                                      pyr.level_size(k), 3)
               for k in range(pyr.num_levels)] for t in range(2)]
    for i in range(n):
        want = brute.sample_trilinear_scalar(levels[tex[i]], float(u[i]), float(v[i]),
                                             float(lod[i]))
        assert np.abs(got[i].astype(np.float64) - want).max() <= 2.5 / 255.0, i


def test_shadow_test_matches_scalar_reference():
    rng = np.random.default_rng(7)
    shadow = rng.uniform(0.1, 0.9, (32, 32)).astype(np.float32)
    cam = Camera(eye=np.float32([4.0, 6.0, 3.0]), target=np.zeros(3, np.float32),
                 up=np.float32([0, 1, 0]), fov_y=np.float32(np.deg2rad(70.0)),
                 near=np.float32(0.5), far=np.float32(30.0))
    view, proj = rm3.camera_matrices(cam, 1.0, np)
    lvp = (proj @ view).astype(np.float32)
    pts = rng.uniform(-6, 6, (400, 3)).astype(np.float32)
    got = sm.shadow_test(torch.from_numpy(shadow), torch.from_numpy(pts), torch.from_numpy(lvp),
                         2e-3).numpy()
    # disagreement only within f32/f64 rounding of the compare or a texel edge
    mismatch = sum(float(got[i]) != brute.shadow_test_scalar(shadow, pts[i], lvp, 2e-3)
                   for i in range(pts.shape[0]))
    assert mismatch <= 4, mismatch


# ---- the entry points ------------------------------------------------------


def test_regen_goldens_writes_elsewhere_and_matches(tmp_path):
    out = tmp_path / "goldens"
    manifest = regen_goldens.main(str(out), "config1", "config4b")
    assert sorted(os.listdir(out)) == ["config1.png", "config4b.png", "manifest.json"]
    with open(out / "manifest.json") as f:
        assert json.load(f) == manifest
    for name in ("config1", "config4b"):
        m = _manifest(name)
        assert {k: manifest[name][k] for k in ("width", "height", "t", "overrides")} == \
            {k: m[k] for k in ("width", "height", "t", "overrides")}
        assert abs(manifest[name]["coverage"] - m["coverage"]) < 1e-6
        got = read_png(str(out / f"{name}.png")).astype(int)
        want = read_png(os.path.join(GOLDEN_DIR, f"{name}.png")).astype(int)
        assert np.abs(got - want).max() <= 1
    for bad in (GOLDEN_DIR, os.path.join(GOLDEN_DIR, "sub")):
        with pytest.raises(SystemExit, match="refusing"):
            regen_goldens.main(bad, "config1")
    assert not os.path.exists(os.path.join(GOLDEN_DIR, "sub"))


def test_render_frame_is_exported():
    assert xr_torch.render_frame is oracle.render_frame
    assert "render_frame" in xr_torch.__all__
    from xr_torch import cpu_ref

    assert cpu_ref.render_frame is oracle.render_frame
    assert cpu_ref.visibility_bbox is oracle.visibility_bbox
