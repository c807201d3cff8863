"""Screen bands of the port (``xr_torch.dist.shard``) on the CPU, against
the reference's ``xr.dist.shard.ShardedRenderer`` on the suite's 8-device
virtual CPU mesh (tests/conftest.py) and against the port's own unbanded
Renderer, the cases of tests/test_sharding.py and more:
- config2 at n = 2 and 4, Phong with a shadow map, blend, the stream
  backend (the reference's kernel in interpret mode), a shade_hook, a
  height that is not a multiple of n * tile_h (padding rows, the crop, and
  covered_pixels and fragments_shaded on the padded height), debug_checks
  (no nf_* keys, as in the reference), config5 at golden size with its
  preset's num_shards=4, and framebuffer recycling through present/flush;
- the port's banded frame equals its unbanded frame byte for byte, and the
  reference's banded frame in color and every stat; depth within 1e-6 (F3:
  the reference's jnp depth sum differs by an ulp at a few pixels, as in
  tests/test_torch_frame.py), config5 by the rule of
  test_deep_and_asset_frames_match_reference_renderer (F12);
- make_band_mesh: devices=None raises without a CUDA device, and a list of
  fewer devices than bands serves the bands in turn;
- shade_deferred and composite_transparent with y_offset against the
  reference's on the same records, and against the rows of the port's
  whole frame bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from xr.core import math3d as rm3
from xr.dist.shard import ShardedRenderer as RefShardedRenderer
from xr.pipeline.geometry import geometry as ref_geometry
from xr.scene import presets as ref_presets
from xr.shading.blend import composite_transparent as ref_composite
from xr.shading.deferred import shade_deferred as ref_shade
from xr_torch import Renderer, ShardedRenderer, convert, kernels
from xr_torch.app import renderer
from xr_torch.dist import shard
from xr_torch.pipeline.shadow import light_matrices_for_scene
from xr_torch.raster import dispatch
from xr_torch.scene import presets
from xr_torch.shading.blend import composite_transparent, opaque_valid
from xr_torch.shading.deferred import shade_deferred

torch.set_num_threads(1)

SMALL = {"tile_h": 16, "tile_w": 32, "bin_capacity": 8192, "raster_path": "binned"}
CASES = {
    # name: (preset, n, (width, height), t, overrides, reference-only overrides)
    "config2-n2": ("config2", 2, (96, 64), 0.2, SMALL, {}),
    "config2-n4": ("config2", 4, (96, 64), 0.2, SMALL, {}),
    "phong-shadow": ("config4", 4, (64, 48), 0.2, {**SMALL, "shadow_map_size": 64}, {}),
    "blend": ("config4b", 4, (64, 48), 0.2, {**SMALL, "shadow_map_size": 64}, {}),
    "pallas_stream": ("config2", 4, (128, 64), 0.2,
                      {"tile_h": 16, "tile_w": 128, "bin_capacity": 8192, "raster_path": "binned",
                       "backend": "pallas_stream", "stream_block": 128},
                      {"pallas_interpret": True}),
    "padded-height": ("config2", 4, (96, 70), 0.2, SMALL, {}),
    "debug_checks": ("config2", 2, (96, 64), 0.2, {**SMALL, "debug_checks": True}, {}),
    "config5-golden": ("config5", 4, (192, 108), 1.0, {"bin_capacity": 8192}, {}),
}
PORT = {"config2": presets.config2_icospheres, "config4": presets.config4_phong,
        "config4b": presets.config4_blend, "config5": lambda: presets.config5_flythrough(64, 64)}
REF = {"config2": ref_presets.config2_icospheres, "config4": ref_presets.config4_phong,
       "config4b": ref_presets.config4_blend,
       "config5": lambda: ref_presets.config5_flythrough(64, 64)}


def _flip(color, scene, mat_id, xp):
    return color[..., [2, 1, 0]]  # the same indexing in torch and jax


def _port_case(name, n=None):
    key, nn, (w, h), t, over, _ = CASES[name]
    p = presets.small_preset(PORT[key](), w, h, num_shards=n or nn, **over)
    cam, mm = p.animate(t)
    return p, cam, convert.scene_to_torch(p.scene.replace(model_matrices=mm), "cpu")


def _ref_frame(name, shade_hook=None):
    key, n, (w, h), t, over, ref_over = CASES[name]
    p = ref_presets.small_preset(REF[key](), w, h, num_shards=n, **over, **ref_over)
    cam, mm = p.animate(t, np)
    scene = p.scene.replace(model_matrices=mm)
    r = RefShardedRenderer(scene, p.config, shade_hook=shade_hook)
    return r.readback(r.step(scene, cam), strict=False)


def _port_frames(name, shade_hook=None):
    """(banded frame, unbanded frame) of the port on the CPU."""
    p, cam, scene = _port_case(name)
    kernels.reset_launches()
    s = ShardedRenderer(scene, p.config, devices=["cpu"], shade_hook=shade_hook)
    banded = s.readback(s.step(scene, cam), strict=False)
    r = Renderer(scene, p.config, "cpu", shade_hook=shade_hook)
    single = r.readback(r.step(scene, cam), strict=False)
    assert not any(kernels.launches.values())  # CPU tensors: the plain versions
    return banded, single


def _check(name, banded, single, ref):
    cfg = CASES[name]
    n, (w, h) = cfg[1], cfg[2]
    assert banded.color.shape == (h, w, 3) and banded.depth.shape == (h, w)
    assert banded.color.tobytes() == single.color.tobytes()
    assert banded.depth.tobytes() == single.depth.tobytes()
    assert set(banded.stats) == set(ref.stats)
    for k in ref.stats:
        assert int(banded.stats[k]) == int(ref.stats[k]), k
    for k in ("tris_in", "tris_setup", "clip_overflow", "bin_overflow", "blend_overflow"):
        if k in single.stats:
            assert int(banded.stats[k]) == int(single.stats[k]), k
    assert not any(k.startswith("nf_") for k in banded.stats)
    assert ((banded.depth == 1.0) == (ref.depth == 1.0)).all()
    zdiff = np.abs(banded.depth - ref.depth)
    cdiff = np.abs(banded.color.astype(int) - ref.color.astype(int))
    if name == "config5-golden":
        assert zdiff.max() <= 1e-5 and (zdiff > 1e-6).sum() <= zdiff.size // 1000
        assert cdiff.max() <= 1
    else:
        assert zdiff.max() <= 1e-6
        assert cdiff.max() == 0
    return n, w, h


@pytest.mark.parametrize("name", sorted(CASES))
def test_banded_frame_equals_reference_and_unbanded(name):
    banded, single = _port_frames(name)
    n, w, h = _check(name, banded, single, _ref_frame(name))
    # the stats of the padded height: every band's Hb rows
    p, _, _ = _port_case(name)
    hp, _, _ = shard.band_config(p.config, n)
    shadow = p.config.shadow_map_size ** 2 if renderer.has_shadow_pass(p.config) else 0
    assert int(banded.stats["fragments_shaded"]) == hp * w + shadow
    assert int(banded.stats["covered_pixels"]) >= int(single.stats["covered_pixels"])
    if hp == h:
        assert int(banded.stats["covered_pixels"]) == int(single.stats["covered_pixels"])
    if name == "padded-height":
        assert hp == 128 and hp > h


def test_banded_shade_hook_equals_reference():
    banded, single = _port_frames("config2-n4", shade_hook=_flip)
    _check("config2-n4", banded, single, _ref_frame("config2-n4", shade_hook=_flip))
    plain, _ = _port_frames("config2-n4")
    fg = banded.depth < 1.0
    assert (banded.color[fg] == plain.color[fg][:, ::-1]).all()


def test_banded_recycling_through_present_and_flush():
    """Pooled framebuffers on the first device: present/flush hand back
    each frame's host copy, equal to a renderer without recycling, and a
    retired frame's buffers are reused by a later step."""
    p, _, scene0 = _port_case("config2-n4")
    r = ShardedRenderer(scene0, p.config, devices=["cpu"])
    fresh = ShardedRenderer(scene0, p.config, devices=["cpu"], recycle_framebuffers=False)
    hosts, refs, ptrs = [], [], []
    for i in range(4):
        cam, mm = p.animate(0.1 * i)
        s = scene0.replace(model_matrices=convert.tensor(mm, "cpu", torch.float32))
        f = r.step(s, cam)
        ptrs.append(f.color.data_ptr())
        refs.append(fresh.readback(fresh.step(s, cam)))
        out = r.present(f)
        if out is not None:
            hosts.append(out)
    hosts.append(r.flush())
    assert r.flush() is None
    for got, want in zip(hosts, refs):
        assert got.color.tobytes() == want.color.tobytes()
        assert got.depth.tobytes() == want.depth.tobytes()
    assert ptrs[2] == ptrs[0]  # frame 0's buffers, retired by the second present
    assert len(set(ptrs)) < len(ptrs)


def test_make_band_mesh(monkeypatch):
    assert shard.make_band_mesh(4, ["cpu"]) == [torch.device("cpu")] * 4
    assert shard.make_band_mesh(3, ["cpu", "meta"]) == [torch.device(d)
                                                       for d in ("cpu", "meta", "cpu")]
    assert shard.make_band_mesh(2, ["cpu", "meta", "cpu"]) == [torch.device("cpu"),
                                                               torch.device("meta")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard.make_band_mesh(2)
    p, _, scene = _port_case("config2-n2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedRenderer(scene, p.config)


def _stage_inputs(name):
    """The same setup records, band visibility and shadow map on both
    sides: the reference's numpy geometry, carried into the port."""
    key, n, (w, h), t, over, _ = CASES[name]
    rp = ref_presets.small_preset(REF[key](), w, h, **over)
    cam, mm = rp.animate(t, np)
    rscene = rp.scene.replace(model_matrices=mm)
    view, proj = rm3.camera_matrices(cam, w / h, np)
    rtri = ref_geometry(rscene, view, proj, rp.config, xp=np)
    cfg = convert.config_from(rp.config)
    scene = convert.scene_to_torch(rscene, "cpu")
    tri = convert.tribuf_to_torch(rtri, "cpu")
    vis_tri = tri.replace(valid=opaque_valid(tri, scene)) if cfg.blend else tri
    shadow = {}
    if renderer.has_shadow_pass(cfg):
        lv, lp = light_matrices_for_scene(scene)
        shadow, _ = renderer.shadow_pass(scene, cfg, lv, lp, tri.capacity)
    return rp, rscene, rtri, cam, cfg, scene, tri, vis_tri, shadow


@pytest.mark.parametrize("name", ["blend", "config5-golden"])
def test_band_shading_with_y_offset(name):
    """Band 2 of 4 (and band 3 of config5, rows past the frame included):
    shade_deferred and composite_transparent at the band's y_offset against
    the reference's on the same inputs (Phong with the shadow test and the
    blend composite; the textured LOD), and against the rows of the port's
    whole frame bit for bit."""
    rp, rscene, rtri, cam, cfg, scene, tri, vis_tri, shadow = _stage_inputs(name)
    n = CASES[name][1]
    hp, hb, band_cfg = shard.band_config(cfg, n)
    b = n - 1 if name == "config5-golden" else 2
    yo = b * hb
    tid, zbuf, _ = dispatch.visibility(vis_tri, band_cfg, tri.capacity, y_offset=yo)
    depth = torch.where(torch.isinf(zbuf), 1.0, zbuf)
    eye = torch.as_tensor(cam.eye)
    rgb = shade_deferred(tri, tid, scene, band_cfg, eye=eye, depth=depth, y_offset=yo, **shadow)
    np_shadow = {k: v.numpy() for k, v in shadow.items()}
    rband = dataclasses.replace(rp.config, height=hb, num_shards=1)
    want = ref_shade(rtri, tid.numpy(), rscene, rband, eye=cam.eye, y_offset=yo, xp=np,
                     depth=depth.numpy(), **np_shadow)
    np.testing.assert_allclose(rgb.numpy(), want, rtol=0, atol=2e-6)
    # the whole frame, shaded at y_offset 0, holds the band in its rows
    ftid, fz, _ = dispatch.visibility(vis_tri, cfg, tri.capacity)
    fdepth = torch.where(torch.isinf(fz), 1.0, fz)
    full = shade_deferred(tri, ftid, scene, cfg, eye=eye, depth=fdepth, **shadow)
    rows = slice(yo, min(yo + hb, cfg.height))
    live = rows.stop - rows.start
    assert live > 0 and torch.equal(tid[:live], ftid[rows])
    assert torch.equal(rgb[:live], full[rows])
    if cfg.blend:
        got, of = composite_transparent(rgb.clone(), depth, tri, scene, band_cfg, eye, y_offset=yo,
                                        **shadow)
        ref_rgb, ref_of = ref_composite(want, depth.numpy(), rtri, rscene, rband, cam.eye,
                                        xp=np, y_offset=yo, **np_shadow)
        assert int(of) == int(ref_of) == 0
        np.testing.assert_allclose(got.numpy(), ref_rgb, rtol=0, atol=2e-6)
        fgot, _ = composite_transparent(full, fdepth, tri, scene, cfg, eye, **shadow)
        assert torch.equal(got[:live], fgot[rows])
        assert not torch.equal(got, rgb)  # the panes cover the band
