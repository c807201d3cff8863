"""The two bin options of the port against the reference: ``bin_pairs=2``
(two slots per small triangle plus a compacted quad class, whose overflow
rides the large bucket) and ``bin_zorder`` (each tile's segment front to
back by quantized z_min, a stable key-value sort).

From the reference's own TriBuf, the port's BinResult equals
``xr.raster.jnp_backend.bin_triangles`` field by field (lists, counts, sid,
starts, raw_counts, large bucket, dropped) on config3 at golden size and on
the 300-triangle scene of tests/test_device_vs_oracle.py, under each option,
with the quad budget ample and forced to overflow, and with a full list.
Frames under the options equal the option-free frame byte for byte on every
backend (auto, pallas_stream, pallas_smem, jnp), with the depth test and in
painter's order, and under blending; segments come out front to back.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xr.core import math3d as rm3
from xr.core.types import MODE_GOURAUD
from xr.core.types import RenderConfig as RefConfig
from xr.pipeline.geometry import geometry as ref_geometry
from xr.raster import jnp_backend as ref_jb
from xr.scene import presets as ref_presets
from xr_torch import Renderer, convert, kernels
from xr_torch.core import math3d as m3
from xr_torch.pipeline.geometry import geometry
from xr_torch.raster import binning
from xr_torch.scene import presets

from tests.scenes import fixed_camera, random_scene

# the suite runs several worker processes on shared cores: one torch
# thread each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

OPTIONS = {
    "zorder": {"bin_zorder": True},
    "pairs2": {"bin_pairs": 2},
    "pairs2_quad2": {"bin_pairs": 2, "bin_quad_capacity": 2},
    "zorder_pairs2": {"bin_zorder": True, "bin_pairs": 2},
    "zorder_pairs2_quad2": {"bin_zorder": True, "bin_pairs": 2, "bin_quad_capacity": 2},
    # a list too short for the fullest tiles: under zorder it keeps the
    # nearest entries, and dropped counts the rest
    "zorder_full_list": {"bin_zorder": True, "bin_capacity": 48},
}
FIELDS = ("lists", "counts", "sid", "starts", "raw_counts", "large_ids", "large_count",
          "large_dropped", "dropped")


def _ref_tri(scene, cam, cfg):
    view, proj = rm3.camera_matrices(cam, cfg.width / cfg.height, np)
    return ref_geometry(scene, jnp.asarray(view), jnp.asarray(proj), cfg, xp=jnp)


def _config3():
    p = ref_presets.small_preset(ref_presets.config3_terrain(48, 48), 192, 108,
                                 bin_capacity=8192)
    cam, mm = p.animate(0.3, np)
    return p.scene.replace(model_matrices=mm), cam, p.config


def _random300():
    """tests/test_device_vs_oracle.py:146-170: 16x16 tiles, many spans of
    2x2 tiles and a small medium class."""
    cfg = RefConfig(width=128, height=96, mode=MODE_GOURAUD, raster_path="binned", tile_h=16,
                    tile_w=16, bin_capacity=2048, medium_span=3, medium_capacity=64)
    return random_scene(np.random.default_rng(11), 300), fixed_camera(), cfg


SCENES = {"config3": _config3, "random300": _random300}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene_tri(request):
    scene, cam, cfg = SCENES[request.param]()
    return request.param, _ref_tri(scene, cam, cfg), cfg


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_bins_equal_reference_field_by_field(scene_tri, option):
    name, rtri, base = scene_tri
    cfg = dataclasses.replace(base, **OPTIONS[option])
    rb = ref_jb.bin_triangles(rtri, cfg)
    tri = convert.tribuf_to_torch(rtri, "cpu")
    b = binning.bin_triangles(tri, convert.config_from(cfg))
    for f in FIELDS:
        got, want = getattr(b, f).numpy(), np.asarray(getattr(rb, f))
        assert got.shape == want.shape and (got == want).all(), f
    plain = binning.bin_triangles(tri, convert.config_from(base))
    if option.endswith("quad2"):
        # the quads past the budget of 2 ride the large bucket
        assert int(b.large_count) > int(plain.large_count), name
    if option == "zorder_full_list":
        assert int(b.dropped) > 0


def test_zorder_segments_front_to_back():
    """The property the option exists for (tests/test_zorder.py:70-100):
    within each tile's segment the quantized z_min keys ascend."""
    p = presets.small_preset(presets.config3_terrain(48, 48), 480, 270, bin_capacity=49152,
                             bin_zorder=True)
    cfg = p.config
    cam, mm = p.animate(0.0)
    scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), "cpu")
    view, proj = m3.camera_matrices(convert.camera_to_torch(cam, "cpu"),
                                    cfg.width / cfg.height, "cpu")
    tri = geometry(scene, view, proj, cfg)
    b = binning.bin_triangles(tri, cfg)
    sid, starts, counts = b.sid.numpy(), b.starts.numpy(), b.raw_counts.numpy()
    zmin = tri.z.amin(1).numpy()
    nty, ntx = binning.grid_dims(cfg)
    zbits = min(16, 30 - int(nty * ntx).bit_length())
    scale = np.float32(2**zbits - 1)
    checked = 0
    for t in range(nty * ntx):
        seg = sid[starts[t]: starts[t] + counts[t]]
        if seg.size < 2:
            continue
        zq = np.clip(zmin[seg] * scale, 0.0, scale).astype(np.int64)
        assert (np.diff(zq) >= 0).all(), f"tile {t} not front to back"
        checked += 1
    assert checked > 20


def _frame(p, t, **over):
    cfg = dataclasses.replace(p.config, **over)
    cam, mm = p.animate(t)
    scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), "cpu")
    r = Renderer(scene, cfg, "cpu")
    kernels.reset_launches()
    f = r.readback(r.step(scene, cam))
    assert not any(kernels.launches.values())
    return f


def _same(got, want, label):
    assert got.color.tobytes() == want.color.tobytes(), label
    assert got.depth.tobytes() == want.depth.tobytes(), label
    assert {k: int(v) for k, v in got.stats.items()} == {
        k: int(v) for k, v in want.stats.items()}, label


FRAME_OPTIONS = {
    "zorder": {"bin_zorder": True, "z_earlyout": True},
    "pairs2": {"bin_pairs": 2},
    "pairs2_quad2": {"bin_pairs": 2, "bin_quad_capacity": 2},
    "zorder_pairs2": {"bin_zorder": True, "bin_pairs": 2},
}


@pytest.mark.parametrize("backend", ["auto", "pallas_stream", "pallas_smem", "jnp"])
def test_options_render_the_option_free_frame(backend):
    """config3 at golden size: bin_capacity 4096 keeps pallas_smem inside
    the reference's SMEM budget, so its list kernel's plain version runs."""
    p = presets.small_preset(presets.config3_terrain(48, 48), 192, 108, bin_capacity=4096,
                             backend=backend)
    want = _frame(p, 0.3)
    assert float((want.depth < 1.0).mean()) > 0.3
    for name, over in FRAME_OPTIONS.items():
        _same(_frame(p, 0.3, **over), want, f"{backend} {name}")


def test_options_in_painters_order_and_under_blend():
    """tests/test_zorder.py:48-67: config4b at golden size (blend: the
    options bin the opaque passes only) and without the depth test
    (painter's order keys on id values, so segment order is immaterial)."""
    p = presets.small_preset(presets.config4_blend(), 160, 100, bin_capacity=8192,
                             shadow_map_size=128)
    want = _frame(p, 0.0)
    _same(_frame(p, 0.0, bin_zorder=True, z_earlyout=True), want, "blend zorder")
    nodepth = presets.small_preset(p, 160, 100, depth_test=False, blend=False,
                                   shadow_map_size=0)
    want = _frame(nodepth, 0.0)
    for name, over in FRAME_OPTIONS.items():
        _same(_frame(nodepth, 0.0, **over), want, f"painter {name}")


def test_pairs2_frames_on_the_random_scene():
    """tests/test_device_vs_oracle.py:146-170 in the port: the 300-triangle
    scene through the jnp lists, quad budget ample and 2."""
    scene, cam, cfg = _random300()
    tscene = convert.scene_to_torch(scene, "cpu")
    base = convert.config_from(cfg)
    frames = {}
    for label, over in (("four", {}), ("ample", {"bin_pairs": 2, "bin_quad_capacity": 4096}),
                        ("overflow", {"bin_pairs": 2, "bin_quad_capacity": 2})):
        r = Renderer(tscene, dataclasses.replace(base, backend="jnp", **over), "cpu")
        frames[label] = r.readback(r.step(tscene, cam))
    for label in ("ample", "overflow"):
        _same(frames[label], frames["four"], label)
