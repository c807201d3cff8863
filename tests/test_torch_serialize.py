"""Scene and camera-path files of the port (``xr_torch.core.serialize``)
against the reference's (``xr/core/serialize.py``): a file either package
writes loads in the other equal field by field (the texel quads as the
reference's uint32 in the file, the port's int32 bits in memory); a scene
on a device saves as its host arrays and a loaded scene renders the frame
of the original; camera paths round-trip both ways; a ragged texture
pyramid raises."""

import numpy as np
import pytest
import torch

from xr.core import serialize as ref_ser
from xr.scene import presets as ref_presets
from xr_torch import Renderer, convert
from xr_torch.core import serialize
from xr_torch.scene import presets
from xr_torch.scene import texture as tx

torch.set_num_threads(1)

GROUPS = (("mesh", serialize.MESH_FIELDS), ("materials", serialize.MATERIAL_FIELDS),
          ("lights", serialize.LIGHT_FIELDS))


def _same_scene(got, want):
    """Equal values field by field; int32 and uint32 quads by their bits."""
    for group, fields in GROUPS:
        for f in fields:
            a, b = np.asarray(getattr(getattr(got, group), f)), np.asarray(
                getattr(getattr(want, group), f))
            assert a.shape == b.shape and a.dtype == b.dtype and (a == b).all(), (group, f)
    assert (np.asarray(got.model_matrices) == np.asarray(want.model_matrices)).all()
    if want.textures is None:
        assert got.textures is None
        return
    gt, wt = got.textures, want.textures
    assert (gt.base_size, gt.num_levels) == (wt.base_size, wt.num_levels)
    assert (np.asarray(gt.data) == np.asarray(wt.data)).all()
    assert (np.asarray(gt.quads).view(np.uint32) == np.asarray(wt.quads).view(np.uint32)).all()


@pytest.mark.parametrize("name", ["config3", "config4b"])
def test_reference_file_loads_in_the_port(tmp_path, name):
    make = {"config3": lambda: ref_presets.config3_terrain(16, 16),
            "config4b": ref_presets.config4_blend}[name]
    ref_scene = make().scene
    path = str(tmp_path / "scene.npz")
    ref_ser.save_scene(path, ref_scene)
    got = serialize.load_scene(path)
    _same_scene(got, ref_ser.load_scene(path))
    _same_scene(got, ref_scene)
    if got.textures is not None:
        assert got.textures.quads.dtype == np.int32


@pytest.mark.parametrize("name", ["config3", "config4b"])
def test_port_file_loads_in_the_reference(tmp_path, name):
    make = {"config3": lambda: presets.config3_terrain(16, 16),
            "config4b": presets.config4_blend}[name]
    scene = make().scene
    path = str(tmp_path / "scene.npz")
    serialize.save_scene(path, scene)
    got = ref_ser.load_scene(path)
    _same_scene(got, scene)
    if got.textures is not None:
        assert np.asarray(got.textures.quads).dtype == np.uint32
    # the reference's own file of the same scene holds the same arrays
    ref_path = str(tmp_path / "ref.npz")
    ref_ser.save_scene(ref_path, got)
    with np.load(path) as a, np.load(ref_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and (a[k] == b[k]).all(), k


def test_device_scene_saves_and_renders_the_same_frame(tmp_path):
    p = presets.small_preset(presets.config3_terrain(16, 16), 64, 48, raster_path="binned")
    cam, _ = p.animate(0.3)
    scene = convert.scene_to_torch(p.scene, "cpu")
    path = str(tmp_path / "scene.npz")
    serialize.save_scene(path, scene)
    loaded = convert.scene_to_torch(serialize.load_scene(path), "cpu")
    frames = []
    for s in (scene, loaded):
        r = Renderer(s, p.config, "cpu")
        frames.append(r.readback(r.step(s, cam)))
    assert frames[0].color.tobytes() == frames[1].color.tobytes()
    assert frames[0].depth.tobytes() == frames[1].depth.tobytes()


def test_camera_paths_round_trip_both_ways(tmp_path):
    p, rp = presets.config5_flythrough(8, 8), ref_presets.config5_flythrough(8, 8)
    times = (0.0, 1.5, 3.0)
    cams, mats = serialize.bake_camera_path(p.animate, times)
    rcams, rmats = ref_ser.bake_camera_path(rp.animate, times)
    assert len(cams) == len(mats) == 3 and all((a == b).all() for a, b in zip(mats, rmats))
    port_path, ref_path = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    serialize.save_camera_path(port_path, cams)
    ref_ser.save_camera_path(ref_path, rcams)
    for path in (port_path, ref_path):
        for loaded in (serialize.load_camera_path(path), ref_ser.load_camera_path(path)):
            assert len(loaded) == 3
            for got, want in zip(loaded, rcams):
                for f in serialize.CAMERA_FIELDS:
                    a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f), np.float32)
                    assert a.dtype == np.float32 and (a == b).all(), f


def test_ragged_scene_raises(tmp_path):
    rng = np.random.default_rng(3)
    pyr = tx.build_ragged_pyramid([rng.uniform(0, 1, (s, s, 3)).astype(np.float32)
                                   for s in (16, 8)])
    scene = presets.config3_terrain(4, 4).scene.replace(textures=pyr)
    path = tmp_path / "scene.npz"
    with pytest.raises(ValueError, match="RaggedPyramid"):
        serialize.save_scene(str(path), scene)
    assert not path.exists()
