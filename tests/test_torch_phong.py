"""config4 (Phong, two directional and two point lights, a shadow map) on
the port, on the CPU, at the golden's framebuffer size:
- against the checked-in golden by the golden rule of
  tests/test_goldens.py:51-58 (at most max(2, 0.1 %) pixels more than
  1 LSB off, coverage within 1e-6);
- against the reference Renderer by the rule of
  tests/test_tpu_device_frames.py:55-85: coverage exact, depth within
  1e-6, stats equal, at most 1 LSB at every pixel outside the set that
  ``shadow_flip_risk`` marks, at most 180 LSB inside it, and at most
  max(2, npix / 1000) pixels more than 1 LSB off in all. With the preset's
  own 1024^2 shadow map the flip set itself is no larger than npix / 1000;
  the golden's 128^2 map is so coarse that the set holds 229 pixels
  (1.4 %), so there the count of pixels past 1 LSB is what is bounded;
- the shadow pass's depth map against the reference's (its geometry and
  the CPU oracle's visibility):
  ids exact, z within 2^-23 = 1.1920929e-7, one ulp of 1.0 (the
  reference's XLA may contract its depth sum, F3; measured: 29 of 16,384
  texels differ by exactly that), through both of the port's visibility
  paths.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from xr.app.renderer import Renderer as RefRenderer
from xr.core.types import MODE_DEPTH_ONLY
from xr.cpu_ref.oracle import visibility_bbox
from xr.pipeline.geometry import geometry as ref_geometry
from xr.cpu_ref.margins import shadow_flip_risk
from xr.pipeline.shadow import light_matrices_for_scene as ref_light_matrices
from xr.scene import presets as ref_presets
from xr_torch import Renderer, convert, kernels
from xr_torch.app import renderer
from xr_torch.core.image import read_png
from xr_torch.pipeline.geometry import clip_capacity
from xr_torch.pipeline.shadow import light_matrices_for_scene
from xr_torch.scene import presets

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def manifest(name):
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as f:
        return json.load(f)[name]


def port_frame(name, t, **over):
    m = manifest(name)
    p = presets.small_preset(presets.ALL_PRESETS[name](), m["width"], m["height"],
                             **{**m["overrides"], **over})
    cam, mm = p.animate(t)
    scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), "cpu")
    r = Renderer(scene, p.config, "cpu")
    kernels.reset_launches()
    frame = r.readback(r.step(scene, cam))
    assert not any(kernels.launches.values())  # CPU tensors: the plain versions
    return frame


def check_golden(name):
    m = manifest(name)
    frame = port_frame(name, m["t"])
    golden = read_png(os.path.join(GOLDEN_DIR, f"{name}.png"))
    diff = np.abs(frame.color.astype(int) - golden.astype(int))
    npix = golden.shape[0] * golden.shape[1]
    bad = int((diff.max(axis=-1) > 1).sum())
    assert bad <= max(2, int(npix * 0.001)), f"{bad} px differ > 1 LSB (max {diff.max()})"
    assert abs(float((frame.depth < 1.0).mean()) - m["coverage"]) < 1e-6


def check_reference(name, t, cap_risk, **over):
    m = manifest(name)
    p = ref_presets.small_preset(ref_presets.ALL_PRESETS[name](), m["width"], m["height"],
                                 **{**m["overrides"], **over})
    cam, mm = p.animate(t, np)
    scene = p.scene.replace(model_matrices=mm)
    r = RefRenderer(scene, p.config)
    ref = r.readback(r.step(scene, cam))
    frame = port_frame(name, t, **over)
    assert ((frame.depth == 1.0) == (ref.depth == 1.0)).all(), "coverage mismatch"
    np.testing.assert_allclose(frame.depth, ref.depth, rtol=0, atol=1e-6)
    assert set(frame.stats) == set(ref.stats)
    for k in ref.stats:
        assert int(frame.stats[k]) == int(ref.stats[k]), k
    risk = shadow_flip_risk(scene, cam, p.config)
    n_risk = int(risk.sum())
    if cap_risk:
        assert n_risk <= p.config.width * p.config.height // 1000, n_risk
    diff = np.abs(frame.color.astype(int) - ref.color.astype(int)).max(axis=-1)
    assert (diff * ~risk).max() <= 1, f"{int(((diff * ~risk) > 1).sum())} px > 1 LSB"
    assert (diff * risk).max() <= 180
    npix = p.config.width * p.config.height
    assert int((diff > 1).sum()) <= max(2, npix // 1000), f"{int((diff > 1).sum())} px > 1 LSB"


def test_config4_matches_golden():
    check_golden("config4")


@pytest.mark.parametrize("shadow_map_size", [128, 1024])
def test_config4_matches_reference_renderer(shadow_map_size):
    check_reference("config4", 0.0, shadow_map_size == 1024, shadow_map_size=shadow_map_size)


@pytest.fixture(scope="module")
def ref_shadow_pass():
    """The reference's depth-only pass from the light at the golden's 128^2
    map: its geometry and the CPU oracle's visibility, as
    xr/cpu_ref/oracle.py renders the shadow map (bin_capacity 4096)."""
    m = manifest("config4")
    rp = ref_presets.small_preset(ref_presets.config4_phong(), m["width"], m["height"],
                                  **{**m["overrides"], "bin_capacity": 4096})
    _, mm = rp.animate(0.0, np)
    rscene = rp.scene.replace(model_matrices=mm)
    lv, lp = ref_light_matrices(rscene)
    s_cfg = dataclasses.replace(rp.config, width=128, height=128, mode=MODE_DEPTH_ONLY,
                                shadow_map_size=0)
    cap = clip_capacity(rscene.mesh.num_triangles, s_cfg)
    tid, zbuf = visibility_bbox(ref_geometry(rscene, lv, lp, s_cfg, xp=np, capacity=cap), s_cfg)
    depth = np.where(np.isinf(zbuf), 1.0, zbuf).astype(np.float32)
    return rscene, rp.config, (lv, lp), cap, (tid, depth, 0)


@pytest.mark.parametrize("backend", ["auto", "pallas_smem"])
def test_shadow_pass_depth_map_matches_reference(ref_shadow_pass, backend):
    """The stream kernel's plain version (auto), and the list kernel's
    (pallas_smem: bin_capacity 4096 keeps it inside the SMEM budget, as at
    full size), against the reference's map."""
    rscene, rcfg, (lv, lp), cap, (rtid, rdepth, rof) = ref_shadow_pass
    cfg = dataclasses.replace(convert.config_from(rcfg), backend=backend)
    scene = convert.scene_to_torch(rscene, "cpu")
    _, tid, depth, of = renderer.depth_pass(
        scene, torch.from_numpy(lv), torch.from_numpy(lp), renderer.shadow_config(cfg), cap)
    assert depth.shape == (128, 128)
    assert (tid.numpy() == rtid).all()
    np.testing.assert_allclose(depth.numpy(), rdepth, rtol=0, atol=2.0**-23)
    assert int(of) == rof == 0
    assert (rdepth < 1.0).mean() > 0.3  # the scene fills the map


def test_backends_render_the_same_config4_frame():
    """auto (the stream kernel) and pallas_smem with the preset's
    bin_capacity 4096 (the list kernel, in both passes) give one frame."""
    m = manifest("config4")
    a = port_frame("config4", m["t"], bin_capacity=4096)
    b = port_frame("config4", m["t"], bin_capacity=4096, backend="pallas_smem")
    assert (a.color == b.color).all() and (a.depth == b.depth).all()
    assert all(int(a.stats[k]) == int(b.stats[k]) for k in a.stats)


def test_light_matrices_override():
    """Renderer.step(light_matrices=...) replaces the fitted matrices."""
    m = manifest("config4")
    p = presets.small_preset(presets.config4_phong(), m["width"], m["height"], **m["overrides"])
    cam, mm = p.animate(0.0)
    scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), "cpu")
    r = Renderer(scene, p.config, "cpu")
    fitted = r.readback(r.step(scene, cam))
    same = r.readback(r.step(scene, cam, light_matrices=r._light))
    assert (same.color == fitted.color).all()
    # the matrices of another light 0 direction move the shadows
    dd = np.asarray(p.scene.lights.dir_dirs).copy()
    dd[0] = (0.45, -0.75, 0.35)
    tilted = light_matrices_for_scene(p.scene.replace(lights=p.scene.lights.replace(dir_dirs=dd)))
    other = r.readback(r.step(scene, cam, light_matrices=tilted))
    assert (other.color != fitted.color).any()
    with pytest.raises(ValueError):
        renderer.render_step(scene, cam, p.config)
