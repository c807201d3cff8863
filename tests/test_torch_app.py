"""The port's app layer against the reference's tests of it: debug_checks
(tests/test_scalar_validators.py:153-200: a clean frame, a NaN vertex named
at the input stage, a NaN shader named at the shading stage), the
shade_hook custom pixel stage with and without its ``frag`` G-buffer
against the reference's hooked frames within 1 LSB (tests/test_app.py:
121-214), recycle_framebuffers (tests/test_present.py:51),
``validate.check_scene`` / ``check_frame`` (tests/test_app.py:43-64), and
the frame's camera matrices: built on the host, the reference's numpy
matrices bit for bit at every preset's field of view (``torch.tan`` is an
ulp off numpy's at 60 and 62 degrees, and CUDA's is another function).

A reference hook is not always valid torch (``color[..., ::-1]``,
``xp.float32(np.nan)``), so each side gets its own hook computing the same
function."""

import dataclasses

import numpy as np
import pytest
import torch

from xr.app.renderer import Renderer as RefRenderer
from xr.core import math3d as rm3
from xr.scene import presets as ref_presets
from xr_torch import Renderer, convert
from xr_torch.app import renderer, validate
from xr_torch.core.types import MODE_DEPTH_ONLY
from xr_torch.scene import presets

from tests.scenes import random_scene

# the suite runs several worker processes on shared cores: one torch
# thread each keeps them from oversubscribing the CPU
torch.set_num_threads(1)


def _port(preset, t, w, h, **over):
    p = presets.small_preset(preset, w, h, **over)
    cam, mm = p.animate(t)
    return p, cam, convert.scene_to_torch(p.scene.replace(model_matrices=mm), "cpu")


def _ref_frame(preset, t, w, h, shade_hook=None, **over):
    p = ref_presets.small_preset(preset, w, h, **over)
    cam, mm = p.animate(t, np)
    scene = p.scene.replace(model_matrices=mm)
    r = RefRenderer(scene, p.config, shade_hook=shade_hook)
    return r.readback(r.step(scene, cam))


def _sanitizer_setup():
    """A small textured terrain at 96x64 with debug_checks (the reference's
    tests take config2 at 160x96; any scene serves)."""
    p, cam, scene = _port(presets.config3_terrain(16, 16), 0.6, 96, 64)
    return scene, cam, dataclasses.replace(p.config, debug_checks=True)


NF_KEYS = {"nf_0_input", "nf_1_geometry", "nf_2_visibility", "nf_3_shading"}


def test_debug_checks_clean_scene_passes():
    scene, cam, cfg = _sanitizer_setup()
    r = Renderer(scene, cfg, "cpu")
    f = r.readback(r.step(scene, cam))  # strict: must not raise
    nf = {k: int(v) for k, v in f.stats.items() if k.startswith("nf_")}
    assert set(nf) == NF_KEYS and not any(nf.values()), nf
    # a depth-only frame has no shading stage
    r0 = Renderer(scene, dataclasses.replace(cfg, mode=MODE_DEPTH_ONLY), "cpu")
    f0 = r0.readback(r0.step(scene, cam))
    assert {k for k in f0.stats if k.startswith("nf_")} == NF_KEYS - {"nf_3_shading"}
    # without the option the frame has no nf_* counters, and the same pixels
    plain = Renderer(scene, dataclasses.replace(cfg, debug_checks=False), "cpu")
    g = plain.readback(plain.step(scene, cam))
    assert not any(k.startswith("nf_") for k in g.stats)
    assert (g.color == f.color).all() and (g.depth == f.depth).all()


def test_debug_checks_localizes_nan_vertex():
    scene, cam, cfg = _sanitizer_setup()
    pos = scene.mesh.positions.clone()
    pos[7, 1] = float("nan")
    bad = scene.replace(mesh=scene.mesh.replace(positions=pos))
    r = Renderer(scene, cfg, "cpu")
    f = r.step(bad, cam)
    assert int(f.stats["nf_0_input"]) == 1
    with pytest.raises(RuntimeError, match="input stage"):
        r.readback(f)


def test_debug_checks_localizes_shading_nan():
    """A NaN made by the pixel stage is named at shading, every earlier
    stage's counter zero; behind present's copy too."""
    scene, cam, cfg = _sanitizer_setup()

    def nan_hook(color, scene, mat_id, xp):
        return color + float("nan") * color

    r = Renderer(scene, cfg, "cpu", shade_hook=nan_hook)
    f = r.step(scene, cam)
    assert int(f.stats["nf_0_input"]) == 0
    assert int(f.stats["nf_1_geometry"]) == 0
    assert int(f.stats["nf_2_visibility"]) == 0
    assert int(f.stats["nf_3_shading"]) > 0
    with pytest.raises(RuntimeError, match="shading stage"):
        r.readback(f)
    r.present(r.step(scene, cam))
    with pytest.raises(RuntimeError, match="shading stage"):
        r.flush()


def test_shade_hook_custom_pixel_stage():
    """The hook sees the pre-background linear color: the hooked frame
    equals the reference's hooked frame within 1 LSB, and the background
    is untouched."""
    seen = {}

    def hook(color, scene_, mat_id, xp):
        assert xp is torch and mat_id is not None and mat_id.shape == color.shape[:1]
        seen["ok"] = True
        return color.flip(-1) * 0.5

    def ref_hook(color, scene_, mat_id, xp):
        return color[..., ::-1] * 0.5

    p, cam, scene = _port(presets.config3_terrain(16, 16), 0.6, 96, 64)
    plain = Renderer(scene, p.config, "cpu")
    want_plain = plain.readback(plain.step(scene, cam))
    r = Renderer(scene, p.config, "cpu", shade_hook=hook)
    got = r.readback(r.step(scene, cam))
    assert seen.get("ok")
    ref = _ref_frame(ref_presets.config3_terrain(16, 16), 0.6, 96, 64, shade_hook=ref_hook)
    assert np.abs(got.color.astype(int) - ref.color.astype(int)).max() <= 1
    bg = want_plain.depth >= 1.0
    assert bg.any() and (got.color[bg] == want_plain.color[bg]).all()
    assert (got.color != want_plain.color).any()


@pytest.mark.parametrize("kind", ["frag", "kwargs"])
def test_shade_hook_frag_context(kind):
    """A hook declaring ``frag`` (or ``**kwargs``) gets the per-pixel
    G-buffer: Phong gives depth, uv, world and normal; fog by depth equals
    the reference's fogged frame within 1 LSB."""
    seen = {}

    def fog(color, frag):
        assert frag.depth is not None and frag.uv is not None
        assert frag.world is not None and frag.normal is not None
        assert frag.bg.dtype == torch.bool and frag.world.shape == color.shape
        seen["ok"] = True
        f = torch.clamp(frag.depth * 1.5, 0.0, 1.0)[..., None]
        return color * (1.0 - f) + f

    if kind == "frag":
        def hook(color, scene_, mat_id, xp, frag=None):
            return fog(color, frag)
    else:
        def hook(color, scene_, mat_id, xp, **kw):
            return fog(color, kw["frag"])

    def ref_hook(color, scene_, mat_id, xp, frag=None):
        f = xp.clip(frag.depth * 1.5, 0.0, 1.0)[..., None]
        return color * (1.0 - f) + f

    over = {"bin_capacity": 8192, "shadow_map_size": 0}
    p, cam, scene = _port(presets.config4_phong(), 0.0, 96, 64, **over)
    r = Renderer(scene, p.config, "cpu", shade_hook=hook)
    got = r.readback(r.step(scene, cam))
    assert seen.get("ok")
    ref = _ref_frame(ref_presets.config4_phong(), 0.0, 96, 64, shade_hook=ref_hook, **over)
    assert np.abs(got.color.astype(int) - ref.color.astype(int)).max() <= 1
    plain = Renderer(scene, p.config, "cpu")
    base = plain.readback(plain.step(scene, cam))
    cov = base.depth < 1.0
    far = cov & (base.depth > np.median(base.depth[cov]))
    assert got.color[far].astype(int).sum() > base.color[far].astype(int).sum()


def test_shade_hook_frag_fields_follow_the_mode():
    """Textured mode: uv and depth, no world or normal; flat mode: no
    material ids and no uv."""
    got = {}

    def hook(color, scene_, mat_id, xp, frag=None):
        got[len(got)] = (mat_id is not None, frag.uv is not None, frag.world is None,
                         frag.normal is None, frag.depth is not None)
        return color

    for preset, t in ((presets.config3_terrain(16, 16), 0.6), (presets.config1_cube(), 0.7)):
        p, cam, scene = _port(preset, t, 64, 48)
        r = Renderer(scene, p.config, "cpu", shade_hook=hook)
        r.readback(r.step(scene, cam))
    assert got == {0: (True, True, True, True, True), 1: (False, False, True, True, True)}


def test_recycle_framebuffers_off_gives_fresh_buffers_and_the_same_frames():
    p, _, scene = _port(presets.config3_terrain(16, 16), 0.0, 96, 64)
    r = Renderer(scene, p.config, "cpu")
    fresh = Renderer(scene, p.config, "cpu", recycle_framebuffers=False)
    devs, hosts, refs = [], [], []
    for i in range(4):
        cam = p.animate(0.3 * i)[0]
        refs.append(r.readback(r.step(scene, cam)))
        devs.append(fresh.step(scene, cam))  # kept alive: no address is freed
        out = fresh.present(devs[-1])
        if out is not None:
            hosts.append(out)
    hosts.append(fresh.flush())
    assert len({f.color.data_ptr() for f in devs}) == 4 and not fresh._pool  # never pooled
    for got, want in zip(hosts, refs):
        assert (got.color == want.color).all() and (got.depth == want.depth).all()
    # the recycling renderer reuses a retired frame's buffers
    f0 = r.step(scene, p.animate(0.0)[0])
    r.readback(f0)
    assert r.step(scene, p.animate(0.1)[0]).color.data_ptr() == f0.color.data_ptr()


def test_validate_scene_catches_bad_indices():
    scene = random_scene(np.random.default_rng(0), 4)
    for s in (scene, convert.scene_to_torch(scene, "cpu")):
        validate.check_scene(s)  # good scenes pass, host or tensor leaves
    bad = scene.replace(mesh=scene.mesh.replace(indices=np.array([[0, 1, 999]], np.int32),
                                                material_id=np.zeros(1, np.int32)))
    for s in (bad, convert.scene_to_torch(bad, "cpu")):
        with pytest.raises(ValueError, match="indices out of range"):
            validate.check_scene(s)
    nan = scene.replace(mesh=scene.mesh.replace(positions=scene.mesh.positions * np.nan))
    with pytest.raises(ValueError, match="non-finite"):
        validate.check_scene(nan)


def test_validate_frame():
    p, cam, scene = _port(presets.config1_cube(), 0.0, 48, 48)
    validate.check_scene(scene)
    r = Renderer(scene, p.config, "cpu")
    frame = r.readback(r.step(scene, cam))
    validate.check_frame(frame, p.config)
    with pytest.raises(ValueError, match="depth"):
        validate.check_frame(frame.replace(depth=frame.depth * np.nan), p.config)
    with pytest.raises(ValueError, match="bin_overflow"):
        validate.check_frame(frame.replace(stats={**frame.stats, "bin_overflow": 3}), p.config)


@pytest.mark.parametrize("name", sorted(presets.ALL_PRESETS))
def test_camera_matrices_are_the_references(name):
    factory = presets.ALL_PRESETS[name]
    p = factory(16, device="cpu") if name == "config7" else (
        factory(32, 32) if name == "config5" else factory())
    cam, mm = p.animate(1.0)
    scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), "cpu")
    for w, h in ((1920, 1080), (192, 108)):
        _, view, proj = renderer.camera_matrices(scene, cam, dataclasses.replace(
            p.config, width=w, height=h))
        want = rm3.camera_matrices(cam, w / h, np)
        assert np.array_equal(view.numpy(), want[0]) and np.array_equal(proj.numpy(), want[1])
