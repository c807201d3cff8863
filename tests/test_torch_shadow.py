"""The shadow-map parts of the port against the reference on the same
numpy inputs: the light matrices and the orthographic projection bit for
bit, the shadow test equal at every pixel that ``shadow_flip_risk`` does
not mark (the world->light transform may round differently there: the
port sums in a fixed order, XLA and numpy pick their own), Blinn-Phong
within 1e-6 (``pow`` may differ by ulps between libraries), and the shadow
contract on the port's frames: only directional light 0 casts shadows."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from test_torch_phong import check_reference
from xr.core import math3d as rm3
from xr.core import shade_math as rsm
from xr.cpu_ref.margins import shadow_flip_risk
from xr.cpu_ref.oracle import render_frame, visibility_bbox
from xr.core.types import MODE_DEPTH_ONLY
from xr.pipeline.geometry import geometry as ref_geometry
from xr.pipeline.shadow import light_matrices_for_scene as ref_light_matrices
from xr.scene import presets as ref_presets
from xr_torch import Renderer, convert
from xr_torch.core import shade_math as sm
from xr_torch.pipeline.shadow import light_matrices_for_scene, orthographic_np
from xr_torch.scene import presets

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _manifest(name="config4"):
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as f:
        return json.load(f)[name]


@pytest.mark.parametrize("name", ["config4", "config4b"])
def test_light_matrices_equal_reference(name):
    ref = ref_presets.ALL_PRESETS[name]().scene
    port = presets.ALL_PRESETS[name]().scene
    for a, b in zip(light_matrices_for_scene(port), ref_light_matrices(ref)):
        assert a.dtype == np.float32 and a.tobytes() == np.asarray(b, np.float32).tobytes()
    # also from the scene's tensors on a device, as Renderer fits them
    on_dev = convert.scene_to_torch(port, "cpu")
    for a, b in zip(light_matrices_for_scene(on_dev), ref_light_matrices(ref)):
        assert a.tobytes() == np.asarray(b, np.float32).tobytes()


@pytest.mark.parametrize("args", [(-3.0, 3.0, -2.0, 2.5, 0.7, 41.3), (-1, 1, -1, 1, 1, 3)])
def test_orthographic_equals_reference(args):
    got = orthographic_np(*args)
    assert got.tobytes() == np.asarray(rm3.orthographic(*args, xp=np)).tobytes()


def _world_and_shadow_map(p, cam, scene):
    """The reference frame's per-pixel world positions and its shadow map
    (CPU oracle), with the light's view-projection."""
    cap = {}

    def hook(color, scene_, mat_id, xp, frag=None):
        cap["world"], cap["bg"] = frag.world, frag.bg
        return color

    render_frame(scene, cam, p.config, shade_hook=hook)
    lview, lproj = ref_light_matrices(scene)
    s_cfg = dataclasses.replace(p.config, width=p.config.shadow_map_size,
                                height=p.config.shadow_map_size, mode=MODE_DEPTH_ONLY,
                                shadow_map_size=0)
    _, zbuf = visibility_bbox(ref_geometry(scene, lview, lproj, s_cfg, xp=np), s_cfg)
    sd = np.where(np.isinf(zbuf), 1.0, zbuf).astype(np.float32)
    return np.asarray(cap["world"], np.float32), sd, (lproj @ lview).astype(np.float32)


def test_shadow_test_matches_reference_outside_flip_risk():
    m = _manifest()
    p = ref_presets.small_preset(ref_presets.config4_phong(), m["width"], m["height"],
                                 **m["overrides"])
    cam, mm = p.animate(m["t"], np)
    scene = p.scene.replace(model_matrices=mm)
    world, sd, lvp = _world_and_shadow_map(p, cam, scene)
    want = rsm.shadow_test(sd, world, lvp, p.config.shadow_bias, np)
    T = torch.from_numpy
    got = sm.shadow_test(T(sd), T(world), T(lvp), p.config.shadow_bias).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    risk = shadow_flip_risk(scene, cam, p.config).reshape(-1)
    assert (want == 0.0).sum() > 500, "no shadowed pixels: the test has no teeth"
    assert (got[~risk] == want[~risk]).all()
    # world positions with NaN/inf sample coordinates give the reference's bits
    bad = np.array([[np.nan, 0, 0], [np.inf, 1, 2], [-np.inf, 0, 1], [1e30, -1e30, 0]],
                   np.float32)
    with np.errstate(invalid="ignore"):
        want_bad = rsm.shadow_test(sd, bad, lvp, p.config.shadow_bias, np)
    np.testing.assert_array_equal(
        sm.shadow_test(T(sd), T(bad), T(lvp), p.config.shadow_bias).numpy(), want_bad)


@pytest.mark.parametrize("with_shadow", [False, True])
def test_shade_phong_matches_reference(with_shadow):
    rng = np.random.default_rng(7)
    N = 4096
    lights = ref_presets.config4_phong().scene.lights
    world = rng.uniform(-5, 5, (N, 3)).astype(np.float32)
    normal = rng.normal(size=(N, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    eye = np.asarray((4.0, 6.0, 9.0), np.float32)
    base = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    ka, kd, ks = (rng.uniform(0, 1, N).astype(np.float32) for _ in range(3))
    shin = rng.choice(np.asarray([16.0, 48.0, 64.0, 96.0], np.float32), N)
    shadow = (rng.uniform(size=N) < 0.5).astype(np.float32) if with_shadow else None
    want = rsm.shade_phong(world, normal, eye, base, ka, kd, ks, shin, lights,
                           shadow_factor=shadow, xp=np)
    T = torch.from_numpy
    tl = convert.scene_to_torch(presets.config4_phong().scene, "cpu").lights
    got = sm.shade_phong(T(world), T(normal), T(eye), T(base), T(ka), T(kd), T(ks), T(shin),
                         tl, shadow_factor=None if shadow is None else T(shadow)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_only_light0_casts_shadows():
    """tests/test_textured_phong.py:116 on the port: with light 0's color
    zeroed the shadow pass changes no pixel; with light 0 lit it does."""
    p = presets.small_preset(presets.config4_phong(), 160, 100, bin_capacity=8192,
                             shadow_map_size=256)
    cam, mm = p.animate(0.0)
    scene = p.scene.replace(model_matrices=mm)
    dc = np.asarray(scene.lights.dir_colors, np.float32).copy()
    dc[0] = 0.0
    dark = scene.replace(lights=scene.lights.replace(dir_colors=dc))

    def frame(s, shadows):
        cfg = p.config if shadows else dataclasses.replace(p.config, shadow_map_size=0)
        st = convert.scene_to_torch(s, "cpu")
        r = Renderer(st, cfg, "cpu")
        return r.readback(r.step(st, cam)).color

    assert (frame(dark, True) == frame(dark, False)).all()
    assert (frame(scene, True) != frame(scene, False)).any()


@pytest.mark.parametrize("shadow_map_size", [128, 1024])
def test_config4_matches_reference_renderer_moving_camera(shadow_map_size):
    """config4 seen from the camera at t = 1.3, where other shadow edges
    face it, against the reference Renderer (the rule of
    test_torch_phong.check_reference)."""
    check_reference("config4", 1.3, shadow_map_size == 1024, shadow_map_size=shadow_map_size)
