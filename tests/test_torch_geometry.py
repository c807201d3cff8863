"""The port's geometry stage against the reference's (XLA on the CPU) on
config3 at golden size, and on config1 and config2 in flat (attr_width 0)
and Gouraud (attr_width 3) mode, given the same numpy view/proj: integer fields,
validity, counts and payload ids exact; z, 1/w and attributes within 1e-6
(the reference's numpy and XLA stages differ by up to 2.4e-7 there). In
the near-plane view 1/w and the attributes reach ~10, where one f32 ulp is
~1e-6, so there the bound is 1e-6 relative above magnitude 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xr.core import math3d as rm3
from xr.core.types import Camera as RefCamera
from xr.pipeline.geometry import geometry as ref_geometry
from xr.scene import presets as ref_presets
from xr_torch import convert
from xr_torch.pipeline.geometry import geometry
from xr_torch.scene import presets

# the suite runs several worker processes on shared cores: one torch
# thread each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

W, H = 192, 108
EXACT = ("xs", "ys", "valid", "count", "overflow", "src_id", "mat_id")
CLOSE = ("z", "inv_w", "attr_w", "face_rgb")


@pytest.fixture(scope="module")
def setup():
    ref = ref_presets.small_preset(ref_presets.config3_terrain(48, 48), W, H, bin_capacity=8192)
    port = presets.small_preset(presets.config3_terrain(48, 48), W, H, bin_capacity=8192)
    return ref, port


def _cameras(ref, t):
    if t is not None:
        return ref.animate(t, np)[0]
    # low over the terrain, looking across it: many triangles cross the
    # near plane and the guard band
    return RefCamera(
        eye=np.asarray((2.0, 1.0, 3.0), np.float32),
        target=np.asarray((-6.0, -1.0, -4.0), np.float32),
        up=np.asarray((0.0, 1.0, 0.0), np.float32),
        fov_y=np.float32(np.deg2rad(70.0)),
        near=np.float32(0.3), far=np.float32(120.0),
    )


@pytest.mark.parametrize("t", [0.3, 1.7, None], ids=["t0.3", "t1.7", "near_plane"])
def test_geometry_matches_reference(setup, t):
    ref, port = setup
    cam = _cameras(ref, t)
    view, proj = rm3.camera_matrices(cam, W / H, np)
    mm = ref.animate(0.3, np)[1]
    rstats = {}
    rtri = ref_geometry(
        ref.scene.replace(model_matrices=mm), jnp.asarray(view), jnp.asarray(proj),
        ref.config, xp=jnp, stats_out=rstats,
    )
    scene = convert.scene_to_torch(port.scene.replace(model_matrices=mm), "cpu")
    stats = {}
    tri = geometry(scene, torch.from_numpy(view), torch.from_numpy(proj), port.config,
                   stats_out=stats)
    assert tri.capacity == rtri.capacity and tri.num_src == rtri.num_src
    for f in EXACT:
        a, b = getattr(tri, f).numpy(), np.asarray(getattr(rtri, f))
        assert a.shape == b.shape and (a == b).all(), f
    rtol = 1e-6 if t is None else 0.0
    for f in CLOSE:
        np.testing.assert_allclose(
            getattr(tri, f).numpy(), np.asarray(getattr(rtri, f)), rtol=rtol, atol=1e-6, err_msg=f
        )
    for k in ("crossing_total", "live_records", "fan_records"):
        assert int(stats[k]) == int(rstats[k]), k
    if t is None:
        assert int(stats["crossing_total"]) > 0
        assert int(stats["fan_records"]) > 0
    else:
        assert int(tri.count) > 1000 and int(tri.overflow) == 0


@pytest.mark.parametrize("name,mode", [
    ("config1_cube", 0), ("config1_cube", 1), ("config2_icospheres", 0), ("config2_icospheres", 1),
], ids=["config1-flat", "config1-gouraud", "config2-flat", "config2-gouraud"])
def test_flat_and_gouraud_geometry_match_reference(name, mode):
    """Flat carries (.., 3, 0) attributes through clipping and snapping;
    config1 has no host vert_mat, so Gouraud takes the device min."""
    ref = ref_presets.small_preset(getattr(ref_presets, name)(), W, H, mode=mode)
    port = presets.small_preset(getattr(presets, name)(), W, H, mode=mode)
    cam, mm = ref.animate(0.7, np)
    view, proj = rm3.camera_matrices(cam, W / H, np)
    rtri = ref_geometry(ref.scene.replace(model_matrices=mm), jnp.asarray(view),
                        jnp.asarray(proj), ref.config, xp=jnp)
    scene = convert.scene_to_torch(port.scene.replace(model_matrices=mm), "cpu")
    tri = geometry(scene, torch.from_numpy(view), torch.from_numpy(proj), port.config)
    assert tri.attr_w.shape[-1] == 3 * mode
    for f in EXACT:
        a, b = getattr(tri, f).numpy(), np.asarray(getattr(rtri, f))
        assert a.shape == b.shape and (a == b).all(), f
    for f in CLOSE:
        a, b = getattr(tri, f).numpy(), np.asarray(getattr(rtri, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=f)
    assert int(tri.count) > 0 and int(tri.overflow) == 0
    if mode == 0:
        assert float(np.abs(tri.face_rgb.numpy()).max()) > 0.1
