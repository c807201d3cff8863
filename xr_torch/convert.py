"""Carry state into the port: scene structs, cameras, configs and setup
triangle buffers with numpy (or any array-like) leaves become the port's
structs with torch tensors on one explicit device.

The functions duck-type on attribute names, so they take the port's own
host-side structs and the reference's objects alike (for the reference,
after ``as_numpy_scene`` or with numpy leaves); this module never imports
the reference package.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from xr_torch.core.types import (
    Camera,
    Lights,
    Material,
    Mesh,
    RaggedPyramid,
    RenderConfig,
    Scene,
    TexturePyramid,
)


def tensor(x, device, dtype=None) -> torch.Tensor:
    """One leaf onto `device`. uint32 arrays keep their bits as int32."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy(order="C")
    t = torch.from_numpy(a).to(device)
    return t if dtype is None else t.to(dtype)


def _frozen(x):
    return tuple(map(_frozen, x)) if isinstance(x, (list, tuple)) else x


@functools.lru_cache(maxsize=None)
def _constant(values, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, device, dtype=torch.float32) -> torch.Tensor:
    """A tensor of fixed host values (numbers or nested lists of them) on
    `device`, made once per (values, dtype, device) and shared by every
    caller afterwards: never write into it. A frame takes its constants
    from here, so no frame copies them from the host again, and a captured
    frame reads them where they lie."""
    return _constant(_frozen(values), dtype, torch.device(device))


class StagingRing:
    """Static f32 tensors on a device that the host refills each frame:
    the named values are written into one of two pinned host buffers and
    copied to one device buffer without blocking (the tensors are views of
    it). A buffer is written again only after its last copy is done (an
    event each), so the host never overwrites a copy in flight while a
    frame is presented and the next one queued. On the CPU the values are
    written into the tensors directly."""

    def __init__(self, shapes: dict, device):
        self.device = torch.device(device)
        sizes = [int(np.prod(s)) for s in shapes.values()]
        ends = np.cumsum(sizes)
        self._slots = {k: (int(e - n), tuple(s)) for k, s, n, e in
                       zip(shapes, shapes.values(), sizes, ends)}
        n = int(ends[-1]) if sizes else 0
        self._buf = torch.zeros((n,), dtype=torch.float32, device=self.device)
        self.tensors = {k: self._buf[o : o + int(np.prod(s))].view(s)
                        for k, (o, s) in self._slots.items()}
        cuda = self.device.type == "cuda"
        self._host = [torch.zeros((n,), dtype=torch.float32, pin_memory=True)
                      for _ in range(2)] if cuda else [self._buf]
        self._done = [None] * len(self._host)
        self._next = 0

    def load(self, values: dict) -> None:
        """Write each named value (an array-like or a tensor of its slot's
        size) into the tensors, in f32."""
        i = self._next
        self._next = (i + 1) % len(self._host)
        if self._done[i] is not None:
            self._done[i].synchronize()
        host = self._host[i].numpy()
        for k, (o, s) in self._slots.items():
            v = to_numpy(values[k], np.float32).reshape(-1)
            if v.size != int(np.prod(s)):
                raise ValueError(f"{k}: {v.size} values, expected shape {s}")
            host[o : o + v.size] = v
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                self._buf.copy_(self._host[i], non_blocking=True)
                self._done[i] = torch.cuda.Event()
                self._done[i].record()


def to_numpy(x, dtype=None) -> np.ndarray:
    """One leaf (an array-like or a tensor on any device) as a host numpy
    array, of `dtype` when one is given."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _opt(x, device, dtype):
    return None if x is None else tensor(x, device, dtype)


F32, I32 = torch.float32, torch.int32


def mesh_to_torch(m, device) -> Mesh:
    return Mesh(
        positions=tensor(m.positions, device, F32),
        normals=tensor(m.normals, device, F32),
        uvs=tensor(m.uvs, device, F32),
        indices=tensor(m.indices, device, I32),
        material_id=tensor(m.material_id, device, I32),
        transform_id=tensor(m.transform_id, device, I32),
        vert_mat=_opt(getattr(m, "vert_mat", None), device, I32),
    )


def textures_to_torch(tex, device):
    """A TexturePyramid or a RaggedPyramid (told apart by
    ``base_size_per_tex``) with tensor leaves on device, or None."""
    if tex is None:
        return None
    if hasattr(tex, "base_size_per_tex"):
        return RaggedPyramid(
            data=tensor(tex.data, device, F32),
            quads=tensor(tex.quads, device, I32),
            level_offset=tensor(tex.level_offset, device, I32),
            level_size=tensor(tex.level_size, device, I32),
            base_size_per_tex=tensor(tex.base_size_per_tex, device, I32),
            num_levels=int(tex.num_levels),
        )
    return TexturePyramid(
        data=tensor(tex.data, device, F32),
        quads=tensor(tex.quads, device, I32),
        base_size=int(tex.base_size),
        num_levels=int(tex.num_levels),
    )


def scene_to_torch(scene, device) -> Scene:
    """A Scene (the port's or the reference's) with tensor leaves on device."""
    mat = scene.materials
    lt = scene.lights
    return Scene(
        mesh=mesh_to_torch(scene.mesh, device),
        materials=Material(
            base_color=tensor(mat.base_color, device, F32),
            ka=tensor(mat.ka, device, F32),
            kd=tensor(mat.kd, device, F32),
            ks=tensor(mat.ks, device, F32),
            shininess=tensor(mat.shininess, device, F32),
            tex_id=tensor(mat.tex_id, device, I32),
            alpha=_opt(getattr(mat, "alpha", None), device, F32),
            tex_addr=_opt(getattr(mat, "tex_addr", None), device, I32),
        ),
        textures=textures_to_torch(scene.textures, device),
        lights=Lights(
            dir_dirs=tensor(lt.dir_dirs, device, F32),
            dir_colors=tensor(lt.dir_colors, device, F32),
            pt_pos=tensor(lt.pt_pos, device, F32),
            pt_colors=tensor(lt.pt_colors, device, F32),
            ambient=tensor(lt.ambient, device, F32),
        ),
        model_matrices=tensor(scene.model_matrices, device, F32),
    )


def camera_to_torch(cam, device) -> Camera:
    return Camera(**{
        f: tensor(getattr(cam, f), device, F32)
        for f in ("eye", "target", "up", "fov_y", "near", "far")
    })


def config_from(cfg) -> RenderConfig:
    """The port's RenderConfig with every field of a reference config."""
    d = dataclasses.asdict(cfg)
    d["bg_color"] = tuple(d["bg_color"])
    return RenderConfig(**d)


def tribuf_to_torch(tri, device):
    """A setup-triangle buffer (reference TriBuf or the port's) on device."""
    from xr_torch.pipeline.geometry import TriBuf

    return TriBuf(
        xs=tensor(tri.xs, device, I32),
        ys=tensor(tri.ys, device, I32),
        z=tensor(tri.z, device, F32),
        inv_w=tensor(tri.inv_w, device, F32),
        attr_w=tensor(tri.attr_w, device, F32),
        face_rgb=tensor(tri.face_rgb, device, F32),
        mat_id=tensor(tri.mat_id, device, I32),
        src_id=tensor(tri.src_id, device, I32),
        valid=tensor(tri.valid, device, torch.bool),
        count=tensor(tri.count, device, I32),
        overflow=tensor(tri.overflow, device, I32),
        num_src=int(tri.num_src),
    )
