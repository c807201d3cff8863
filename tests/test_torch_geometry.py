"""The port's geometry stage against the reference's (XLA on the CPU) on
config3 at golden size, and on config1 and config2 in flat (attr_width 0)
and Gouraud (attr_width 3) mode, given the same numpy view/proj: integer fields,
validity, counts and payload ids exact; z, 1/w and attributes within 1e-6
(the reference's numpy and XLA stages differ by up to 2.4e-7 there). In
the near-plane view 1/w and the attributes reach ~10, where one f32 ulp is
~1e-6, so there the bound is 1e-6 relative above magnitude 1. Also the identity
record layout (a capacity that holds every triangle and every fan) against
the reference's numpy stage, its overflow count, the stream's block budget
under it, and a 2-triangle scene through the Renderer."""

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


# ---- the identity record layout (capacity >= T + clip_budget * 7) ----------


@pytest.mark.parametrize("pad", [0, 10])
@pytest.mark.parametrize("t", [0.3, None], ids=["t0.3", "near_plane"])
def test_identity_layout_matches_reference(t, pad):
    """Where the capacity holds every triangle and every fan the reference
    compacts nothing: records keep input order, fans sit at T + slot, the
    padding is zeros, overflow counts only the clip budget. Against the
    reference's numpy stage, field by field: validity, counts and the
    integer fields of valid records exact, the float fields as above."""
    from xr_torch.pipeline.geometry import MAX_FAN, clip_budget, identity_layout

    ref = ref_presets.small_preset(ref_presets.config3_terrain(8, 8), W, H)
    port = presets.small_preset(presets.config3_terrain(8, 8), W, H)
    T = port.scene.mesh.num_triangles
    B = clip_budget(T, port.config)
    cap = T + B * MAX_FAN + pad
    assert identity_layout(T, port.config, cap) and not identity_layout(T, port.config, cap - pad - 1)
    view, proj = rm3.camera_matrices(_cameras(ref, t), W / H, np)
    mm = ref.animate(0.3, np)[1]
    rstats, stats = {}, {}
    rtri = ref_geometry(ref.scene.replace(model_matrices=mm), view, proj, ref.config, xp=np,
                        capacity=cap, stats_out=rstats)
    scene = convert.scene_to_torch(port.scene.replace(model_matrices=mm), "cpu")
    tri = geometry(scene, torch.from_numpy(view), torch.from_numpy(proj), port.config,
                   capacity=cap, stats_out=stats)
    assert tri.capacity == rtri.capacity == cap and tri.num_src == rtri.num_src == T
    valid = np.asarray(rtri.valid)
    assert (tri.valid.numpy() == valid).all()
    assert int(tri.count) == int(rtri.count) == int(valid.sum())
    assert int(tri.overflow) == int(rtri.overflow) == 0
    for f in ("xs", "ys", "src_id", "mat_id"):
        a, b = getattr(tri, f).numpy(), np.asarray(getattr(rtri, f))
        assert a.shape == b.shape and a.dtype == b.dtype and (a[valid] == b[valid]).all(), f
    for f in CLOSE:
        a, b = getattr(tri, f).numpy(), np.asarray(getattr(rtri, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a[valid], b[valid], rtol=1e-6 if t is None else 0.0, atol=1e-6,
                                   err_msg=f)
    for k in ("crossing_total", "live_records", "fan_records"):
        assert int(stats[k]) == int(rstats[k]), k
    # input order: an inside triangle's record is its own slot, a fan's its
    # parent's id behind the T source slots, the padding all zero
    src = tri.src_id.numpy()
    assert (src[:T] == np.arange(T)).all()
    assert (valid[T + B * MAX_FAN:] == 0).all() and (tri.xs.numpy()[T + B * MAX_FAN:] == 0).all()
    if t is None:
        assert int(stats["fan_records"]) > 0 and valid[T:].any()


def test_identity_layout_counts_only_the_clip_budget_as_overflow():
    """More crossing triangles than the clip budget: the identity layout's
    overflow is max(crossing_total - B, 0), as the reference's."""
    ref = ref_presets.small_preset(ref_presets.config3_terrain(8, 8), W, H, clip_budget=4)
    cfg = convert.config_from(ref.config)
    port = presets.small_preset(presets.config3_terrain(8, 8), W, H, clip_budget=4)
    T = port.scene.mesh.num_triangles
    cap = T + 4 * 7
    view, proj = rm3.camera_matrices(_cameras(ref, None), W / H, np)
    mm = ref.animate(0.3, np)[1]
    rtri = ref_geometry(ref.scene.replace(model_matrices=mm), view, proj, ref.config, xp=np,
                        capacity=cap)
    stats = {}
    tri = geometry(convert.scene_to_torch(port.scene.replace(model_matrices=mm), "cpu"),
                   torch.from_numpy(view), torch.from_numpy(proj), cfg, capacity=cap,
                   stats_out=stats)
    assert int(tri.overflow) == int(rtri.overflow) == int(stats["crossing_total"]) - 4 > 0
    assert (tri.valid.numpy() == np.asarray(rtri.valid)).all()


def test_identity_layout_stream_sizing_bounded_by_source():
    """The reference's test of the same name, on the port's stream_blocks:
    an identity-style capacity far above the live triangles must not
    multiply the stream's block budget, which is bounded by the source
    triangle count (TriBuf.num_src)."""
    import dataclasses

    from xr.raster.pallas_stream import stream_blocks as ref_stream_blocks
    from xr_torch.pipeline.geometry import MAX_FAN, clip_budget, clip_capacity
    from xr_torch.raster.stream import stream_blocks

    p = presets.config1_cube()
    cfg = dataclasses.replace(p.config, backend="pallas_stream", clip_expand=50.0)
    rcfg = dataclasses.replace(ref_presets.config1_cube().config, backend="pallas_stream",
                               clip_expand=50.0)
    num_src, cap = 1_000, 100_000
    nb_inflated = stream_blocks(cfg, cap)
    nb_bounded = stream_blocks(cfg, cap, num_src)
    assert nb_bounded < nb_inflated / 5
    live_bound = num_src + clip_budget(num_src, cfg) * (MAX_FAN - 1)
    assert live_bound < cap and nb_bounded == stream_blocks(cfg, live_bound)
    assert (nb_inflated, nb_bounded) == (ref_stream_blocks(rcfg, cap),
                                         ref_stream_blocks(rcfg, cap, num_src))
    T = p.scene.mesh.num_triangles
    real_cap = clip_capacity(T, cfg)
    assert real_cap > 50 * T
    assert stream_blocks(cfg, real_cap, T) <= stream_blocks(cfg, real_cap)


@pytest.mark.parametrize("raster_path", ["brute", "binned"])
def test_two_triangle_scene_renders(raster_path):
    """A scene under 9 triangles reaches the identity layout at the default
    clip_expand (capacity 67 >= 2 + 2 * 7): it renders the reference's
    frame, through brute force and through the stream's plain version."""
    from xr.app.renderer import Renderer as RefRenderer
    from xr_torch import Renderer
    from xr_torch.core.types import Camera, Lights, Material, RenderConfig, Scene
    from xr_torch.pipeline.geometry import clip_capacity, identity_layout
    from xr_torch.scene.procedural import grid_plane

    cfg = RenderConfig(width=64, height=48, mode=1, raster_path=raster_path, tile_h=16, tile_w=32)
    scene = Scene(mesh=grid_plane(1, 1, size=2.0), materials=Material.table([{}]), textures=None,
                  lights=Lights.make(dir_dirs=[(-0.3, -0.8, -0.5)], dir_colors=[(1.0, 0.9, 0.8)]),
                  model_matrices=np.eye(4, dtype=np.float32)[None])
    assert scene.mesh.num_triangles == 2
    assert identity_layout(2, cfg, clip_capacity(2, cfg))
    cam = Camera(eye=np.asarray((0.4, 0.25, 0.9), np.float32), target=np.zeros(3, np.float32),
                 up=np.asarray((0.0, 1.0, 0.0), np.float32), fov_y=np.float32(1.0),
                 near=np.float32(0.3), far=np.float32(20.0))
    ts = convert.scene_to_torch(scene, "cpu")
    r = Renderer(ts, cfg, "cpu")
    got = r.readback(r.step(ts, cam))
    import xr.core.types as rt

    rscene = rt.Scene(
        mesh=rt.Mesh(**{f: getattr(scene.mesh, f) for f in (
            "positions", "normals", "uvs", "indices", "material_id", "transform_id")}),
        materials=rt.Material.table([{}]), textures=None,
        lights=rt.Lights.make(dir_dirs=[(-0.3, -0.8, -0.5)], dir_colors=[(1.0, 0.9, 0.8)]),
        model_matrices=scene.model_matrices)
    rcam = rt.Camera(**{f: getattr(cam, f) for f in ("eye", "target", "up", "fov_y", "near", "far")})
    rcfg = rt.RenderConfig(width=64, height=48, mode=1, raster_path=raster_path, tile_h=16,
                           tile_w=32)
    rr = RefRenderer(rscene, rcfg)
    ref = rr.readback(rr.step(rscene, rcam))
    assert 0.1 < (got.depth < 1.0).mean() < 0.9  # the plane crosses the near plane and the frame
    assert ((got.depth == 1.0) == (ref.depth == 1.0)).all()
    np.testing.assert_allclose(got.depth, ref.depth, rtol=0, atol=1e-6)
    assert np.abs(got.color.astype(int) - ref.color.astype(int)).max() <= 1
    for k in ref.stats:
        assert int(got.stats[k]) == int(ref.stats[k]), k
