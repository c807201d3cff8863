"""The port's native host components (``xr_torch.native``: the C++ OBJ
parser, PNG encoder and mip builder, built with g++ into build/) against
the port's pure-Python paths, as tests/test_native.py holds the
reference's; ``load_obj_scene`` on the courtyard with and without the
native parser; and ``xr_torch.tools.gen_assets``, which must reproduce
assets/courtyard/."""

import dataclasses
import os

import numpy as np
import pytest

from xr_torch.core import image
from xr_torch.core.types import MODE_FLAT, Camera, RenderConfig
from xr_torch.cpu_ref import render_frame
from xr_torch.native import api
from xr_torch.scene import objio
from xr_torch.scene.texture import build_pyramid
from xr_torch.tools import gen_assets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COURTYARD = os.path.join(ROOT, "assets", "courtyard")

OBJ_SAMPLE = """
# quads, materials, negative indices, the v/vt/vn forms
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 1 0
usemtl red
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl blue
f -5/-4/-2 -4/-3/-2 -1/-2/-1
f 1//2 2//2 5//1
"""


@pytest.fixture
def obj_path(tmp_path):
    p = tmp_path / "sample.obj"
    p.write_text(OBJ_SAMPLE)
    return str(p)


def _same_parse(a, b):
    assert a["materials"] == b["materials"]
    for k in ("positions", "normals", "uvs", "indices", "face_mat"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_library_builds_under_build_not_in_the_package():
    assert api.available()
    assert os.path.realpath(api.LIB) == os.path.realpath(
        os.path.join(ROOT, "build", "xr_torch", "native", "libxr_native.so"))
    assert os.path.exists(api.LIB) and api.build() == str(api.LIB)
    pkg = os.path.dirname(os.path.abspath(api.__file__))
    assert not [f for _, _, fs in os.walk(pkg) for f in fs if f.endswith(".so")]


def test_python_obj_parser(obj_path):
    r = objio.parse_obj(obj_path, native=False)
    assert r["indices"].shape == (4, 3)  # the quad's two triangles, then 1 + 1
    assert r["materials"] == ["red", "blue"]
    assert r["face_mat"].tolist() == [0, 0, 1, 1]
    assert r["positions"].shape[0] <= 12  # (v, vt, vn) corners reused


def test_native_obj_matches_python(obj_path):
    _same_parse(api.parse_obj(obj_path), objio._python_parse(obj_path))


def test_native_obj_malformed_face_terminates(tmp_path):
    """A non-numeric face token must not hang the native parser (strtol
    does not advance on it): the token is dropped."""
    p = tmp_path / "bad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 x 3\n")
    assert api.parse_obj(str(p))["indices"].shape == (1, 3)


def test_native_png_roundtrip_and_python_bytes(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (33, 47, 3), dtype=np.uint8)
    a, b = str(tmp_path / "n.png"), str(tmp_path / "p.png")
    assert api.write_png(a, img)
    assert (image.read_png(a) == img).all()
    image._write_png_python(b, img)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    gray = img[:, :, 0]
    assert api.write_png(a, gray) and (image.read_png(a) == gray[:, :, None]).all()


def test_native_mips_match_python():
    img = np.random.default_rng(2).random((64, 64, 3)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(build_pyramid([img]).data[0]), api.build_mips(img))


def test_courtyard_scene_native_equals_python():
    path = os.path.join(COURTYARD, "courtyard.obj")
    _same_parse(api.parse_obj(path), objio._python_parse(path))
    objio._PARSED.clear()
    a = objio.load_obj_scene(path, native=True)
    objio._PARSED.clear()
    b = objio.load_obj_scene(path, native=False)
    for part in ("mesh", "materials", "lights"):
        for f in dataclasses.fields(getattr(a, part)):
            x, y = getattr(getattr(a, part), f.name), getattr(getattr(b, part), f.name)
            assert (x is None and y is None) or np.array_equal(x, y), (part, f.name)
    assert np.array_equal(a.textures.data, b.textures.data)
    assert a.mesh.num_triangles == 96_456


def test_parse_cache_keeps_whichever_parser_ran(obj_path):
    objio._PARSED.clear()
    a = objio.parse_obj(obj_path)  # native
    b = objio.parse_obj(obj_path, native=False)  # served from the kept parse
    assert a["positions"] is b["positions"] and not a["positions"].flags.writeable


def test_mtl_dissolve_to_blend(tmp_path):
    """MTL `d` (and `Tr`) become Material.alpha, and a loaded
    half-transparent pane tints what lies behind it under blend."""
    (tmp_path / "scene.mtl").write_text(
        "newmtl solid\nKd 0.1 0.9 0.1\nnewmtl pane\nKd 0.9 0.1 0.1\nd 0.5\n"
        "newmtl legacy\nKd 0 0 1\nTr 0.7\n")
    m = objio.parse_mtl(str(tmp_path / "scene.mtl"))
    assert m["pane"]["d"] == 0.5 and abs(m["legacy"]["d"] - 0.3) < 1e-9
    (tmp_path / "scene.obj").write_text(
        "mtllib scene.mtl\n"
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\n"  # the back quad at z = 0
        "v -1 -1 1\nv 1 -1 1\nv 1 1 1\nv -1 1 1\n"  # the pane at z = 1
        "vn 0 0 1\n"
        "usemtl solid\nf 1//1 2//1 3//1\nf 1//1 3//1 4//1\n"
        "usemtl pane\nf 5//1 6//1 7//1\nf 5//1 7//1 8//1\n")
    scene = objio.load_obj_scene(str(tmp_path / "scene.obj"))
    np.testing.assert_allclose(np.asarray(scene.materials.alpha)[:2], [1.0, 0.5])
    cam = Camera(eye=np.asarray((0, 0, 4.0), np.float32), target=np.zeros(3, np.float32),
                 up=np.asarray((0, 1.0, 0), np.float32),
                 fov_y=np.asarray(np.deg2rad(60.0), np.float32),
                 near=np.asarray(0.3, np.float32), far=np.asarray(10.0, np.float32))
    cfg = RenderConfig(width=48, height=48, mode=MODE_FLAT, blend=True)
    cb = render_frame(scene, cam, cfg).color[24, 24].astype(int)
    co = render_frame(scene, cam, dataclasses.replace(cfg, blend=False)).color[24, 24].astype(int)
    assert (cb != co).any() and cb[1] > co[1] + 20, "green backing not visible through the pane"


def test_gen_assets_reproduces_the_courtyard(tmp_path):
    out = tmp_path / "courtyard"
    gen_assets.main(str(out))
    for name in ("courtyard.obj", "courtyard.mtl"):
        with open(out / name, "rb") as a, open(os.path.join(COURTYARD, name), "rb") as b:
            assert a.read() == b.read(), name
    for name in ("pavement.png", "brick.png", "marble.png"):
        assert np.array_equal(image.read_png(str(out / name)),
                              image.read_png(os.path.join(COURTYARD, name))), name
    for bad in (os.path.join(ROOT, "assets"), COURTYARD):
        with pytest.raises(SystemExit, match="refusing"):
            gen_assets.main(bad)
