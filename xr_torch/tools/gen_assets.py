"""Generate the config6 asset pack, the courtyard: a multi-material OBJ, its
MTL and three PNG maps (port of ``tools/gen_assets.py``; the same seeds,
so the same files as ``assets/courtyard/``).

About 96k triangles: a tiled, gently displaced ground, perimeter walls, a
ring of columns with capitals, crates and spheres, a central monument; four
materials, three ``map_Kd`` textures of different sizes (512, 256 and 128
texels) and one clamped map, written as standard Wavefront OBJ/MTL and PNG
so that the whole asset path (parser, MTL, textures, render) runs from
disk.

Usage: python -m xr_torch.tools.gen_assets [outdir]
(default build/assets/courtyard at the repository root; it refuses to
write under the repository's assets/).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from xr_torch.core.image import write_png
from xr_torch.scene import procedural as proc
from xr_torch.scene import texture as tx
from xr_torch.scene.presets import rotation_y, translation

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(ROOT, "build", "assets", "courtyard")
MATERIALS = ["pavement", "brick", "marble", "crate"]
MTL = (
    "newmtl pavement\nKd 1.0 1.0 1.0\nKs 0.05 0.05 0.05\nNs 16\nmap_Kd pavement.png\n\n"
    "newmtl brick\nKd 1.0 0.95 0.9\nKs 0.0 0.0 0.0\nNs 8\nmap_Kd brick.png\n\n"
    # marble clamps (map_Kd -clamp on): the scene mixes address modes
    "newmtl marble\nKd 0.95 0.95 1.0\nKs 0.35 0.35 0.35\nNs 64\nmap_Kd -clamp on marble.png\n\n"
    "newmtl crate\nKd 0.85 0.6 0.3\nKs 0.15 0.15 0.15\nNs 24\n"
)


def _box_at(cx, cy, cz, sx, sy, sz, mat, ry=0.0):
    s = np.diag([sx, sy, sz, 1.0]).astype(np.float32)
    return proc.transformed(proc.cube(1.0, mat=mat),
                            translation((cx, cy, cz)) @ rotation_y(ry) @ s)


def build_meshes():
    """The courtyard's parts in world space, each with its material."""
    rng = np.random.default_rng(20260816)
    out = []

    # ground: a subdivided, gently displaced plane (most triangles, material 0)
    g = proc.grid_plane(160, 160, size=30.0, mat=0)
    pos = g.positions.copy()
    pos[:, 1] += (0.08 * np.sin(pos[:, 0] * 1.7) * np.cos(pos[:, 2] * 1.3)).astype(np.float32)
    out.append(g.replace(positions=pos))

    # perimeter walls, material 1
    for sgn in (-1.0, 1.0):
        out.append(_box_at(sgn * 14.5, 1.6, 0.0, 0.5, 3.2, 29.0, 1))
        out.append(_box_at(0.0, 1.6, sgn * 14.5, 29.0, 3.2, 0.5, 1))

    # a ring of columns (stretched icospheres) with capitals, material 2
    for k in range(14):
        ang = k * (2 * np.pi / 14)
        cx, cz = 9.0 * np.cos(ang), 9.0 * np.sin(ang)
        s = np.diag([1.0, 4.5, 1.0, 1.0]).astype(np.float32)
        out.append(proc.transformed(proc.icosphere(3, 0.55, mat=2), translation((cx, 2.2, cz)) @ s))
        out.append(_box_at(cx, 4.8, cz, 1.5, 0.25, 1.5, 2))

    # crates and spheres scattered in the yard, material 3
    for i in range(40):
        x, z = rng.uniform(-12, 12, 2)
        if x * x + z * z < 4.0:
            continue
        if i % 2 == 0:
            out.append(_box_at(x, 0.55, z, 1.1, 1.1, 1.1, 3, ry=float(rng.uniform(0, 3.14))))
        else:
            out.append(proc.transformed(proc.icosphere(3, 0.65, mat=3), translation((x, 0.7, z))))

    # the central monument, a stretched icosphere, material 2
    s = np.diag([1.0, 2.2, 1.0, 1.0]).astype(np.float32)
    out.append(proc.transformed(proc.icosphere(4, 1.6, mat=2), translation((0, 3.0, 0)) @ s))
    return out


def write_obj(path, mesh, mtl_name, mat_names):
    """Write a Mesh as OBJ, faces grouped by material (usemtl)."""
    with open(path, "w") as f:
        f.write(f"# xr config6 courtyard (generated)\nmtllib {mtl_name}\n")
        for p in mesh.positions:
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for t in mesh.uvs:
            f.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
        for n in mesh.normals:
            f.write(f"vn {n[0]:.4f} {n[1]:.4f} {n[2]:.4f}\n")
        cur = -1
        for fi in np.argsort(mesh.material_id, kind="stable"):
            m = int(mesh.material_id[fi])
            if m != cur:
                f.write(f"usemtl {mat_names[m]}\n")
                cur = m
            a, b, c = (int(v) + 1 for v in mesh.indices[fi])
            f.write(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n")


def _refuse_repo_assets(outdir: str) -> None:
    assets = os.path.realpath(os.path.join(ROOT, "assets"))
    out = os.path.realpath(outdir)
    if out == assets or out.startswith(assets + os.sep):
        raise SystemExit(f"gen_assets: refusing to write under {assets}; name another directory")


def main(outdir: str = DEFAULT_OUT) -> None:
    _refuse_repo_assets(outdir)
    os.makedirs(outdir, exist_ok=True)
    merged = proc.merge_meshes(build_meshes())
    print(f"tris: {merged.num_triangles}, verts: {merged.num_vertices}")

    # three sizes: 512 pavement, 256 brick, 128 marble
    pav = tx.checkerboard(512, 24, (0.82, 0.8, 0.76), (0.35, 0.33, 0.3))
    pav = np.clip(pav + 0.08 * (tx.noise_texture(512, seed=7) - 0.5), 0, 1)
    brick_base = tx.checkerboard(256, 16, (0.62, 0.28, 0.2), (0.55, 0.5, 0.45))
    brick = np.clip(brick_base * (0.7 + 0.6 * tx.noise_texture(256, seed=9)), 0, 1)
    marble = np.clip(0.75 + 0.5 * (tx.noise_texture(128, seed=3) - 0.5), 0, 1) * np.asarray(
        [0.9, 0.9, 0.95], np.float32)
    for name, img in zip(("pavement.png", "brick.png", "marble.png"), (pav, brick, marble)):
        write_png(os.path.join(outdir, name),
                  np.floor(np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8))

    with open(os.path.join(outdir, "courtyard.mtl"), "w") as f:
        f.write(MTL)
    write_obj(os.path.join(outdir, "courtyard.obj"), merged, "courtyard.mtl", MATERIALS)
    print("wrote", outdir)


if __name__ == "__main__":
    main(*sys.argv[1:])
