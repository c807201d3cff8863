"""OBJ/MTL asset loading of the port (port of ``xr/scene/objio.py``; host
numpy throughout): OBJ -> SoA mesh arrays, MTL -> material rows, ``map_Kd``
PNGs -> a uniform or ragged texture pyramid.

The OBJ parse is native (``xr_torch.native``) where the library builds and
pure Python otherwise, with equal arrays. Parsing a large OBJ in Python
takes seconds, so the raw parse is kept per process, keyed on the file's
path, modification time and size, whichever parser produced it; the kept
arrays are read-only.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from xr_torch.core.image import read_png
from xr_torch.core.types import Lights, Material, Mesh, Scene
from xr_torch.scene.procedural import with_vert_mat
from xr_torch.scene.texture import build_pyramid, build_ragged_pyramid

_PARSED: dict = {}


def _python_parse(path: str):
    vs: List[Tuple[float, float, float]] = []
    vts: List[Tuple[float, float]] = []
    vns: List[Tuple[float, float, float]] = []
    out_pos, out_uv, out_nrm = [], [], []
    out_idx, out_mat = [], []
    dedup = {}
    mat_ids = {}
    mat_order: List[str] = []
    cur_mat = 0

    def fix(idx: int, count: int) -> int:
        if idx > 0:
            return idx - 1
        if idx < 0:
            return count + idx
        return -1

    def vertex(key):
        if key in dedup:
            return dedup[key]
        vid = len(out_pos)
        dedup[key] = vid
        v, t, n = key
        out_pos.append(vs[v] if 0 <= v < len(vs) else (0.0, 0.0, 0.0))
        out_uv.append(vts[t] if 0 <= t < len(vts) else (0.0, 0.0))
        out_nrm.append(vns[n] if 0 <= n < len(vns) else (0.0, 0.0, 1.0))
        return vid

    with open(path, "r", errors="replace") as f:
        for line in f:
            s = line.strip()
            if s.startswith("v "):
                p = s.split()
                vs.append((float(p[1]), float(p[2]), float(p[3])))
            elif s.startswith("vt "):
                p = s.split()
                vts.append((float(p[1]), float(p[2])))
            elif s.startswith("vn "):
                p = s.split()
                vns.append((float(p[1]), float(p[2]), float(p[3])))
            elif s.startswith("f "):
                corners = []
                for tok in s.split()[1:]:
                    if tok.startswith("#"):
                        break
                    parts = tok.split("/")
                    vi = fix(int(parts[0]), len(vs))
                    ti = fix(int(parts[1]), len(vts)) if len(parts) > 1 and parts[1] else -1
                    ni = fix(int(parts[2]), len(vns)) if len(parts) > 2 and parts[2] else -1
                    corners.append(vertex((vi, ti, ni)))
                for i in range(2, len(corners)):
                    out_idx.append((corners[0], corners[i - 1], corners[i]))
                    out_mat.append(cur_mat)
            elif s.startswith("usemtl"):
                name = s[6:].strip()
                if name not in mat_ids:
                    cur_mat = len(mat_order)
                    mat_ids[name] = cur_mat
                    mat_order.append(name)
                else:
                    cur_mat = mat_ids[name]

    if not mat_order:
        mat_order = ["default"]
    return {
        "positions": np.asarray(out_pos, np.float32).reshape(-1, 3),
        "normals": np.asarray(out_nrm, np.float32).reshape(-1, 3),
        "uvs": np.asarray(out_uv, np.float32).reshape(-1, 2),
        "indices": np.asarray(out_idx, np.int32).reshape(-1, 3),
        "face_mat": np.asarray(out_mat, np.int32),
        "materials": mat_order,
    }


def parse_obj(path: str, native: bool = True):
    """Parse an OBJ file into raw arrays, once per process and file state:
    natively when the library is available (native=False: the Python
    parser), unless a parse of this file state is kept already."""
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    r = _PARSED.get(key)
    if r is None:
        if native:
            from xr_torch.native import api

            r = api.parse_obj(path)
        if r is None:
            r = _python_parse(path)
        for a in r.values():
            if isinstance(a, np.ndarray):
                a.setflags(write=False)
        _PARSED[key] = r
    return dict(r, materials=list(r["materials"]))


def load_obj(path: str, native: bool = True) -> Tuple[Mesh, List[str]]:
    """Load an OBJ file as a Mesh (native: as for parse_obj). Authored
    normals are kept; a vertex whose normal is missing (zero, or the
    parser's default (0, 0, 1)) gets the area-weighted smooth normal.
    Returns (mesh, material_names)."""
    r = parse_obj(path, native)
    pos, nrm = r["positions"], r["normals"]
    idx = r["indices"]
    default_n = np.abs(nrm - np.array([0.0, 0.0, 1.0], np.float32)).sum(axis=1) == 0
    zero_n = np.abs(nrm).sum(axis=1) == 0
    if nrm.shape[0] == 0 or (default_n | zero_n).all():
        nrm = compute_vertex_normals(pos, idx)
    elif zero_n.any() or default_n.any():
        computed = compute_vertex_normals(pos, idx)
        missing = zero_n | default_n
        nrm = np.where(missing[:, None], computed, nrm)
    mesh = Mesh(
        positions=pos,
        normals=nrm,
        uvs=r["uvs"],
        indices=idx,
        material_id=r["face_mat"],
        transform_id=np.zeros(pos.shape[0], np.int32),
    )
    return mesh, r["materials"]


def compute_vertex_normals(pos: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals."""
    n = np.zeros_like(pos)
    p0, p1, p2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    for k in range(3):
        np.add.at(n, idx[:, k], fn)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(ln, 1e-20)).astype(np.float32)


# map_Kd options by the number of arguments that follow them
_MAP_OPTION_ARGS = {
    "-o": 3, "-s": 3, "-t": 3, "-mm": 2,
    "-blendu": 1, "-blendv": 1, "-cc": 1, "-texres": 1, "-bm": 1,
    "-boost": 1, "-imfchan": 1,
}


def parse_mtl(path: str):
    """Parse a Wavefront .mtl file -> {name: {Kd, Ks, Ns, d, map_Kd, clamp}}."""
    mats = {}
    cur = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            s = line.strip()
            if s.startswith("newmtl"):
                cur = s[6:].strip()
                mats[cur] = {}
            elif cur is None:
                continue
            elif s.startswith("Kd "):
                mats[cur]["Kd"] = tuple(float(x) for x in s.split()[1:4])
            elif s.startswith("Ks "):
                mats[cur]["Ks"] = tuple(float(x) for x in s.split()[1:4])
            elif s.startswith("Ns "):
                mats[cur]["Ns"] = float(s.split()[1])
            elif s.startswith("d "):
                # dissolve = opacity; alpha < 1 joins the blended pass
                mats[cur]["d"] = float(s.split()[1])
            elif s.startswith("Tr ") and "d" not in mats[cur]:
                # inverted-dissolve convention; `d` wins if both are present
                mats[cur]["d"] = 1.0 - float(s.split()[1])
            elif s.startswith("map_Kd"):
                # map_Kd [-options ...] file; `-clamp on` is the texture
                # address mode (Material.tex_addr), other options are skipped
                toks = s[6:].strip().split()
                i, unknown = 0, False
                while i < len(toks) and toks[i].startswith("-"):
                    if toks[i] == "-clamp" and i + 1 < len(toks):
                        mats[cur]["clamp"] = toks[i + 1].lower() == "on"
                        i += 2
                    elif toks[i] in _MAP_OPTION_ARGS:
                        i += 1 + _MAP_OPTION_ARGS[toks[i]]
                    else:
                        # unknown option, unknown arity: the scan may be out
                        # of step, so the LAST token is taken as the file
                        unknown = True
                        i += 2
                if unknown:
                    if toks and not toks[-1].startswith("-"):
                        mats[cur]["map_Kd"] = toks[-1]
                elif i < len(toks):
                    mats[cur]["map_Kd"] = " ".join(toks[i:])
    return mats


def _to_pot_square(im: np.ndarray) -> np.ndarray:
    """Nearest-neighbour resample to the image's own nearest power-of-two
    square (the image itself when it already is one)."""
    size = 1 << (max(im.shape[0], im.shape[1]) - 1).bit_length()
    if im.shape[:2] == (size, size):
        return im
    yi = (np.arange(size) * im.shape[0] // size).clip(0, im.shape[0] - 1)
    xi = (np.arange(size) * im.shape[1] // size).clip(0, im.shape[1] - 1)
    return im[yi][:, xi]


def load_obj_scene(path: str, lights=None, native: bool = True,
                   max_tex_rows: int | None = None) -> Scene:
    """Load an OBJ (+ its .mtl, + map_Kd textures) as a host-side Scene.

    MTL mapping: base_color = Kd, ks = mean(Ks), shininess = Ns, alpha = d,
    map_Kd -> texture (each map resampled to its own power-of-two square),
    `-clamp on` -> tex_addr 1. Maps of one size build a uniform pyramid;
    mixed sizes, or a `max_tex_rows` texture-area cap (see
    build_ragged_pyramid), build a RaggedPyramid. A missing .mtl gives the
    default material. native: as for parse_obj."""
    mesh, names = load_obj(path, native)
    mesh = with_vert_mat(mesh)

    mtl = {}
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "r", errors="replace") as f:
        for line in f:
            s = line.strip()
            if s.startswith("mtllib"):
                mp = os.path.join(base_dir, s[6:].strip())
                if os.path.exists(mp):
                    mtl.update(parse_mtl(mp))

    rows, images = [], []
    for name in names:
        m = mtl.get(name, {})
        row = {
            "base_color": m.get("Kd", (0.8, 0.8, 0.8)),
            "ks": float(np.mean(m.get("Ks", (0.0, 0.0, 0.0)))),
            "shininess": m.get("Ns", 32.0),
            "tex_id": -1,
            "alpha": float(m.get("d", 1.0)),
        }
        tex = m.get("map_Kd")
        if tex:
            tp = os.path.join(base_dir, tex)
            if os.path.exists(tp):
                row["tex_id"] = len(images)
                images.append(read_png(tp).astype(np.float32) / 255.0)
        if m.get("clamp"):
            row["tex_addr"] = 1
        rows.append(row)

    pyramid = None
    if images:
        squared = [_to_pot_square(im) for im in images]
        if max_tex_rows is None and len({im.shape[0] for im in squared}) == 1:
            pyramid = build_pyramid(squared)
        else:
            pyramid = build_ragged_pyramid(squared, max_tex_rows)

    if lights is None:
        lights = Lights.make(
            dir_dirs=[(-0.4, -0.8, -0.45)],
            dir_colors=[(1.0, 1.0, 1.0)],
            ambient=(0.15, 0.15, 0.15),
        )
    return Scene(
        mesh=mesh,
        materials=Material.table(rows),
        textures=pyramid,
        lights=lights,
        model_matrices=np.eye(4, dtype=np.float32)[None],
    )


def save_obj(path: str, mesh: Mesh) -> None:
    """Minimal OBJ writer (round trips, tests)."""
    with open(path, "w") as f:
        for p in np.asarray(mesh.positions):
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for t in np.asarray(mesh.uvs):
            f.write(f"vt {t[0]} {t[1]}\n")
        for nr in np.asarray(mesh.normals):
            f.write(f"vn {nr[0]} {nr[1]} {nr[2]}\n")
        for tri in np.asarray(mesh.indices):
            a, b, c = (int(i) + 1 for i in tri)
            f.write(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n")
