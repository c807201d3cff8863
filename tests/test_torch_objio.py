"""The port's OBJ/MTL asset path against the reference's pure-Python one, on
the courtyard asset of the repository: every array of the loaded scene
equal, the marble material alone clamped; ``parse_mtl`` on the option cases
of tests/test_texture_addr.py; a ``save_obj``/``load_obj`` round trip; the
fill-in of missing normals; the parse kept per process.
"""

import os

import numpy as np
import pytest

from xr.scene import objio as ref_objio
from xr_torch.scene import objio, presets
from xr_torch.scene.procedural import icosphere

COURTYARD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "assets", "courtyard", "courtyard.obj")


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.int32 and b.dtype == np.uint32:
        a = a.view(np.uint32)
    assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all(), what


def _assert_same_scene(got, want):
    for f in ("positions", "normals", "uvs", "indices", "material_id", "transform_id", "vert_mat"):
        _same(getattr(got.mesh, f), getattr(want.mesh, f), f)
    for f in ("base_color", "ka", "kd", "ks", "shininess", "tex_id", "alpha", "tex_addr"):
        _same(getattr(got.materials, f), getattr(want.materials, f), f)
    for f in ("dir_dirs", "dir_colors", "pt_pos", "pt_colors", "ambient"):
        _same(getattr(got.lights, f), getattr(want.lights, f), f)
    _same(got.model_matrices, want.model_matrices, "model_matrices")
    assert got.textures.num_levels == want.textures.num_levels
    for f in ("data", "quads", "level_offset", "level_size", "base_size_per_tex"):
        _same(getattr(got.textures, f), getattr(want.textures, f), f)


@pytest.mark.parametrize("max_tex_rows", [None, 300_000], ids=["native", "capped"])
def test_courtyard_scene_equals_reference(max_tex_rows):
    got = objio.load_obj_scene(COURTYARD, max_tex_rows=max_tex_rows)
    want = ref_objio.load_obj_scene(COURTYARD, native=False, max_tex_rows=max_tex_rows)
    _assert_same_scene(got, want)
    assert got.mesh.num_triangles == 96_456
    top = 512 if max_tex_rows is None else 256
    assert list(got.textures.base_size_per_tex) == [top, 256, 128]


def test_courtyard_marble_alone_is_clamped():
    names = objio.load_obj(COURTYARD)[1]
    mtl = objio.parse_mtl(os.path.join(os.path.dirname(COURTYARD), "courtyard.mtl"))
    assert [bool(mtl[n].get("clamp")) for n in names] == [n == "marble" for n in names]
    scene = objio.load_obj_scene(COURTYARD)
    assert list(scene.materials.tex_addr) == [int(n == "marble") for n in names]
    assert sum(scene.materials.tex_addr) == 1


def test_parse_is_kept_per_file_state(tmp_path):
    p = str(tmp_path / "s.obj")
    objio.save_obj(p, icosphere(0))
    a, b = objio.parse_obj(p), objio.parse_obj(p)
    assert a["positions"] is b["positions"] and not a["positions"].flags.writeable
    mesh2 = icosphere(1)
    objio.save_obj(p, mesh2)  # another size: the kept parse must not be served
    assert objio.parse_obj(p)["indices"].shape[0] == mesh2.num_triangles


def test_mtl_options_as_the_reference(tmp_path):
    p = tmp_path / "m.mtl"
    p.write_text(
        "newmtl a\nKd 1 0 0\nKs 0.5 0.25 0\nNs 40\nd 0.5\nmap_Kd -clamp on tex.png\n"
        "newmtl b\nTr 0.25\nmap_Kd -blendu off -clamp off other.png\n"
        "newmtl c\nmap_Kd -o 0.1 0.2 0.3 plain.png\n"
        "newmtl e\nmap_Kd -mm 0.1 0.9 tex.png\n"
        "newmtl f\nmap_Kd -bm 2.0 bump.png\n"
        "newmtl g\nmap_Kd -imaginary 1 2 3 weird.png\n"
        "newmtl h\nd 0.75\nTr 0.9\nmap_Kd two words.png\n"
    )
    m = objio.parse_mtl(str(p))
    assert m == ref_objio.parse_mtl(str(p))
    assert m["a"]["clamp"] is True and m["a"]["map_Kd"] == "tex.png"
    assert m["b"]["clamp"] is False and m["b"]["map_Kd"] == "other.png" and m["b"]["d"] == 0.75
    assert "clamp" not in m["c"] and m["c"]["map_Kd"] == "plain.png"
    assert m["e"]["map_Kd"] == "tex.png" and m["f"]["map_Kd"] == "bump.png"
    assert m["g"]["map_Kd"] == "weird.png"  # unknown option: the last token
    assert m["h"]["d"] == 0.75 and m["h"]["map_Kd"] == "two words.png"


def test_save_load_round_trip(tmp_path):
    mesh = icosphere(1, radius=0.7)
    p = str(tmp_path / "ico.obj")
    objio.save_obj(p, mesh)
    got, names = objio.load_obj(p)
    ref, ref_names = ref_objio.load_obj(p, native=False)
    assert names == ref_names == ["default"]
    for f in ("positions", "normals", "uvs", "indices", "material_id", "transform_id"):
        _same(getattr(got, f), getattr(ref, f), f)
    # a vertex per (v, vt, vn) triple, in order of first use: the same soup
    assert got.num_triangles == mesh.num_triangles
    np.testing.assert_allclose(got.positions[got.indices], mesh.positions[mesh.indices], atol=1e-6)
    np.testing.assert_allclose(got.normals[got.indices], mesh.normals[mesh.indices], atol=1e-6)


def test_missing_normals_are_filled_in(tmp_path):
    """No vn lines at all: area-weighted smooth normals; some corners
    without a vn: only those are filled, authored ones are kept."""
    p = tmp_path / "q.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 0 -1\nv 0 0 -1\nf 1 2 3\nf 1 3 4\n")
    got, _ = objio.load_obj(str(p))
    ref, _ = ref_objio.load_obj(str(p), native=False)
    _same(got.normals, ref.normals, "normals")
    np.testing.assert_allclose(got.normals, np.tile([0.0, 1.0, 0.0], (4, 1)), atol=1e-6)
    p2 = tmp_path / "h.obj"
    p2.write_text("v 0 0 0\nv 1 0 0\nv 1 0 -1\nv 0 0 -1\nvn 1 0 0\n"
                  "usemtl m\nf 1//1 2//1 3\nf -4 -2 -1\n")
    got, names = objio.load_obj(str(p2))
    ref, _ = ref_objio.load_obj(str(p2), native=False)
    assert names == ["m"]
    for f in ("positions", "normals", "indices", "material_id"):
        _same(getattr(got, f), getattr(ref, f), f)
    assert (got.normals[:2] == [1.0, 0.0, 0.0]).all() and got.normals[2, 1] > 0.99


def test_scene_without_mtl_gets_the_default_material(tmp_path):
    p = str(tmp_path / "bare.obj")
    objio.save_obj(p, icosphere(0))
    got = objio.load_obj_scene(p)
    want = ref_objio.load_obj_scene(p, native=False)
    assert got.textures is None and want.textures is None
    for f in ("base_color", "ks", "shininess", "tex_id", "alpha"):
        _same(getattr(got.materials, f), getattr(want.materials, f), f)
    assert got.materials.tex_addr is None


def test_uniform_maps_take_the_uniform_pyramid(tmp_path):
    """Maps of one size (one of them not square: resampled to its own
    power-of-two square) build a TexturePyramid, as in the reference."""
    from xr_torch.core.image import write_png

    rng = np.random.default_rng(4)
    write_png(str(tmp_path / "a.png"), rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
    write_png(str(tmp_path / "b.png"), rng.integers(0, 256, (12, 16, 3), dtype=np.uint8))
    (tmp_path / "s.mtl").write_text("newmtl a\nmap_Kd a.png\nnewmtl b\nmap_Kd b.png\n")
    (tmp_path / "s.obj").write_text(
        "mtllib s.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\n"
        "usemtl a\nf 1/1 2/2 3/3\nusemtl b\nf 1/1 3/3 2/2\n")
    got = objio.load_obj_scene(str(tmp_path / "s.obj"))
    want = ref_objio.load_obj_scene(str(tmp_path / "s.obj"), native=False)
    assert not hasattr(got.textures, "base_size_per_tex") and got.textures.base_size == 16
    _same(got.textures.data, want.textures.data, "data")
    _same(got.textures.quads, want.textures.quads, "quads")
    _same(got.materials.tex_id, want.materials.tex_id, "tex_id")


def test_config6_needs_its_asset(tmp_path):
    with pytest.raises(FileNotFoundError):
        presets.config6_asset(assets_dir=str(tmp_path))
