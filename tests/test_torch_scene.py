"""The port's host-side scene functions and configs make exactly the
reference's arrays and configs (terrain, cube, icosphere, merged and
transformed meshes, the config1-3 presets), and convert carries a reference
scene over unchanged."""

import dataclasses

import numpy as np
import pytest
import torch

from xr.core.types import as_numpy_scene
from xr.scene import presets as ref_presets
from xr.scene import procedural as ref_proc
from xr.scene import texture as ref_tx
from xr_torch import convert
from xr_torch.scene import presets, procedural, texture

# the suite runs several worker processes on shared cores: one torch
# thread each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

MESH_FIELDS = ("positions", "normals", "uvs", "indices", "material_id", "transform_id")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert (a.reshape(-1).view(np.uint8) == b.reshape(-1).view(np.uint8)).all()


@pytest.mark.parametrize("n", [48, 224])
def test_terrain_bit_identical(n):
    ref = ref_proc.with_vert_mat(ref_proc.terrain(n, n, size=40.0, height=4.0))
    port = procedural.with_vert_mat(procedural.terrain(n, n, size=40.0, height=4.0))
    for f in MESH_FIELDS + ("vert_mat",):
        _same(getattr(port, f), getattr(ref, f))
    assert port.num_triangles == 2 * n * n


def _same_mesh(port, ref):
    for f in MESH_FIELDS:
        _same(getattr(port, f), getattr(ref, f))
    if ref.vert_mat is None:
        assert port.vert_mat is None
    else:
        _same(port.vert_mat, ref.vert_mat)


@pytest.mark.parametrize("build", [
    lambda proc: proc.cube(1.2, mat=1),
    lambda proc: proc.icosphere(2, radius=0.55, mat=3),
    lambda proc: proc.merge_meshes([proc.cube(), proc.icosphere(1, mat=2)], transform_ids=[0, 1]),
    lambda proc: proc.transformed(proc.icosphere(2), np.array(
        [[0.0, 0.0, 2.0, 1.5], [0.0, 2.0, 0.0, -0.25], [-2.0, 0.0, 0.0, 3.0], [0, 0, 0, 1]],
        np.float32)),
], ids=["cube", "icosphere", "merge_meshes", "transformed"])
def test_meshes_bit_identical(build):
    _same_mesh(build(procedural), build(ref_proc))


@pytest.mark.parametrize("name", ["config1_cube", "config2_icospheres"])
def test_flat_and_gouraud_presets_bit_identical(name):
    ref, port = getattr(ref_presets, name)(), getattr(presets, name)()
    assert port.name == ref.name
    _same_mesh(port.scene.mesh, ref.scene.mesh)
    for f in ("base_color", "ka", "kd", "ks", "shininess", "tex_id", "alpha"):
        _same(getattr(port.scene.materials, f), getattr(ref.scene.materials, f))
    for f in ("dir_dirs", "dir_colors", "pt_pos", "pt_colors", "ambient"):
        _same(getattr(port.scene.lights, f), getattr(ref.scene.lights, f))
    _same(port.scene.model_matrices, ref.scene.model_matrices)
    assert port.scene.textures is None and ref.scene.textures is None
    for p, r in ((port, ref), (presets.small_preset(port, 192, 108, bin_capacity=8192),
                               ref_presets.small_preset(ref, 192, 108, bin_capacity=8192))):
        assert dataclasses.asdict(p.config) == dataclasses.asdict(r.config)
        assert convert.config_from(r.config) == p.config
    for t in (0.0, 0.7, 1.7):
        rc, rm = ref.animate(t, np)
        pc, pm = port.animate(t)
        for f in ("eye", "target", "up", "fov_y", "near", "far"):
            _same(getattr(pc, f), np.asarray(getattr(rc, f)))
        _same(pm, np.asarray(rm))


def test_preset_registry_names_reference_presets():
    for key, fn in presets.ALL_PRESETS.items():
        assert ref_presets.ALL_PRESETS[key].__name__ == fn.__name__


def test_pyramid_bit_identical():
    imgs = [ref_tx.checkerboard(256, 16), ref_tx.noise_texture(256)]
    for a, b in zip(imgs, [texture.checkerboard(256, 16), texture.noise_texture(256)]):
        _same(b, a)
    ref = ref_tx.build_pyramid(imgs)
    port = texture.build_pyramid(imgs)
    _same(port.data, ref.data)
    _same(port.quads, np.asarray(ref.quads).view(np.int32))
    assert (port.base_size, port.num_levels) == (ref.base_size, ref.num_levels)
    for k in range(ref.num_levels):
        assert port.level_size(k) == ref.level_size(k)
        assert port.level_offset(k) == ref.level_offset(k)


@pytest.mark.parametrize("small", [False, True])
def test_config3_render_config_field_equal(small):
    ref, port = ref_presets.config3_terrain(8, 8), presets.config3_terrain(8, 8)
    if small:
        ref = ref_presets.small_preset(ref, 192, 108, bin_capacity=8192)
        port = presets.small_preset(port, 192, 108, bin_capacity=8192)
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    assert convert.config_from(ref.config) == port.config


@pytest.mark.parametrize("t", [0.3, 1.7])
def test_animate_equal(t):
    rc, rm = ref_presets.config3_terrain(8, 8).animate(t, np)
    pc, pm = presets.config3_terrain(8, 8).animate(t)
    for f in ("eye", "target", "up", "fov_y", "near", "far"):
        _same(getattr(pc, f), np.asarray(getattr(rc, f)))
    _same(pm, np.asarray(rm))


def test_convert_round_trips_reference_scene():
    ref = as_numpy_scene(ref_presets.config3_terrain(16, 16).scene)
    port = convert.scene_to_torch(ref, torch.device("cpu"))
    for f in MESH_FIELDS + ("vert_mat",):
        _same(getattr(port.mesh, f).numpy(), getattr(ref.mesh, f))
    for f in ("base_color", "ka", "kd", "ks", "shininess", "tex_id", "alpha"):
        _same(getattr(port.materials, f).numpy(), getattr(ref.materials, f))
    for f in ("dir_dirs", "dir_colors", "pt_pos", "pt_colors", "ambient"):
        _same(getattr(port.lights, f).numpy(), getattr(ref.lights, f))
    _same(port.textures.data.numpy(), ref.textures.data)
    _same(port.textures.quads.numpy().view(np.uint32), ref.textures.quads)
    _same(port.model_matrices.numpy(), ref.model_matrices)
    # and the port's own preset converts to the same tensors
    own = convert.scene_to_torch(presets.config3_terrain(16, 16).scene, "cpu")
    assert torch.equal(own.textures.quads, port.textures.quads)
    assert torch.equal(own.mesh.positions, port.mesh.positions)
