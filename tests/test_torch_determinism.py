"""Determinism of the port, on the CPU against the reference (the
counterpart of tests/test_determinism.py): a frame rendered twice is the
same; the port's CPU oracle and its Renderer are invariant to triangle
order (the (z, id) resolve only relabels ids, and no test triangles are
exactly coplanar); the medium bin class is a pure routing change (on, off,
overflowing and medium_span=16 give the same bits). Each port frame is also
held to the reference's frame of the same scene by the device-vs-oracle
rule (coverage exact, depth within 1e-6, color within 1 LSB), and the
Renderer's checks run with the z early-out on as well, whose frame must be
the one without it byte for byte. The same checks run on the card in
tests/test_torch_cuda.py, where the chunks of a tile merge in a varying
order and, under the z gate, share bounds while they run."""

import dataclasses

import numpy as np
import pytest
import torch

from xr.app.renderer import Renderer as RefRenderer
from xr.core.types import MODE_GOURAUD
from xr.core.types import RenderConfig as RefConfig
from xr.cpu_ref import render_frame as ref_render_frame
from xr.scene import presets as ref_presets
from xr_torch import Renderer, convert, kernels, render_frame

from tests.scenes import fixed_camera, random_scene

torch.set_num_threads(1)


def _permuted(scene, perm):
    mesh = scene.mesh
    return scene.replace(mesh=mesh.replace(indices=np.asarray(mesh.indices)[perm],
                                           material_id=np.asarray(mesh.material_id)[perm]))


def _port_frames(scene, cam, cfg, n=1):
    """n frames of the port's Renderer on the CPU (the plain versions)."""
    tscene = convert.scene_to_torch(scene, "cpu")
    r = Renderer(tscene, convert.config_from(cfg), "cpu")
    kernels.reset_launches()
    frames = [r.readback(r.step(tscene, cam)) for _ in range(n)]
    assert not any(kernels.launches.values())
    return frames


def _ref_frame(scene, cam, cfg):
    r = RefRenderer(scene, cfg)
    return r.readback(r.step(scene, cam))


def _same(a, b):
    assert (a.color == b.color).all() and (a.depth == b.depth).all()
    assert {k: int(v) for k, v in a.stats.items()} == {k: int(v) for k, v in b.stats.items()}


def _near(frame, ref):
    """The device-vs-oracle rule: coverage exact, depth 1e-6, color 1 LSB."""
    assert ((frame.depth == 1.0) == (np.asarray(ref.depth) == 1.0)).all()
    np.testing.assert_allclose(frame.depth, np.asarray(ref.depth), rtol=0, atol=1e-6)
    assert np.abs(frame.color.astype(int) - np.asarray(ref.color).astype(int)).max() <= 1


@pytest.mark.parametrize("z_earlyout", [False, True], ids=["ungated", "z_earlyout"])
def test_render_twice_identical(z_earlyout):
    p = ref_presets.small_preset(ref_presets.config2_icospheres(), 96, 64, bin_capacity=8192)
    cam, mm = p.animate(0.1, np)
    scene = p.scene.replace(model_matrices=mm)
    cfg = dataclasses.replace(p.config, z_earlyout=z_earlyout)
    f1, f2 = _port_frames(scene, cam, cfg, n=2)
    _same(f1, f2)
    _near(f1, _ref_frame(scene, cam, p.config))
    if z_earlyout:
        _same(f1, _port_frames(scene, cam, p.config)[0])


@pytest.mark.parametrize("z_earlyout", [False, True], ids=["ungated", "z_earlyout"])
def test_triangle_order_invariance(z_earlyout):
    rng = np.random.default_rng(3)
    scene = random_scene(rng, 16)
    cam = fixed_camera()
    cfg = RefConfig(width=64, height=48, mode=MODE_GOURAUD)
    perm = rng.permutation(scene.mesh.indices.shape[0])
    o_a = render_frame(scene, cam, convert.config_from(cfg))
    o_b = render_frame(_permuted(scene, perm), cam, convert.config_from(cfg))
    assert (o_a.color == o_b.color).all(), "oracle depends on triangle order"
    assert (o_a.color == ref_render_frame(scene, cam, cfg).color).all()

    gcfg = dataclasses.replace(cfg, z_earlyout=z_earlyout)
    d_a = _port_frames(scene, cam, gcfg)[0]
    d_b = _port_frames(_permuted(scene, perm), cam, gcfg)[0]
    assert (d_a.color == d_b.color).all(), "renderer depends on triangle order"
    assert (d_a.depth == d_b.depth).all()
    _near(d_a, _ref_frame(scene, cam, cfg))


def test_medium_bin_class_bit_identical():
    """config4 at 256x128 in 16x32 tiles, no shadow map, binned: the medium
    class on, off, overflowing (capacity 4) and wide (span 16) give the
    same frame, the reference's frame, with and without the z early-out."""
    p = ref_presets.small_preset(ref_presets.config4_phong(), 256, 128, tile_h=16, tile_w=32,
                                 bin_capacity=8192, shadow_map_size=0, raster_path="binned")
    cam, mm = p.animate(0.0, np)
    scene = p.scene.replace(model_matrices=mm)
    frames = {}
    for name, over in (("on", {}), ("off", {"medium_capacity": 0}),
                       ("overflowing", {"medium_capacity": 4}), ("wide", {"medium_span": 16})):
        for gate in (False, True):
            cfg = dataclasses.replace(p.config, z_earlyout=gate, **over)
            frames[name, gate] = _port_frames(scene, cam, cfg)[0]
    base = frames["off", False]
    assert int(base.stats["bin_overflow"]) == 0
    for key, f in frames.items():
        assert (f.color == base.color).all(), f"{key} color differs"
        assert (f.depth == base.depth).all(), f"{key} depth differs"
    _near(base, _ref_frame(scene, cam, dataclasses.replace(p.config, medium_capacity=0)))
