"""Screen bands (port of ``xr/dist/shard.py``): one frame rendered as n
horizontal bands, each band on a device of a "mesh", gathered into the full
frame on the first.

Semantics are the reference's, bit for bit. The frame's height is padded to
``Hp = n * Hb`` with ``Hb`` a multiple of ``tile_h``; band b renders rows
``[b * Hb, (b + 1) * Hb)`` under ``config`` with ``height=Hb`` and
``y_offset = b * Hb``. Geometry sees the full frame, so its screen reject
culls nothing that belongs to another band; the shadow pass is the full
depth-only pass from the light; under blending the transparent records are
masked out of both visibility passes and each band composites the whole
transparent list, in source order, over its own rows. The gathered frame is
cropped to ``H`` rows. It equals the single-device frame byte for byte.

The reference runs one controller over a ``shard_map`` mesh; here one
process drives every band, and the mesh is a list of n torch devices in
which a device may appear more than once (the reference's
``make_band_mesh`` asserts one device a band): on one card the n bands run
in turn on it. Work that does not depend on the band (camera matrices, the
shadow pass, geometry), which the reference replicates on every band, runs
once per distinct device, with identical results. The scene is copied to
each distinct device and the bands are gathered on the first with ``.to``
and ``torch.cat``: one code path for one card and for several.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from xr_torch import convert
from xr_torch.app import renderer
from xr_torch.core import shade_math as sm
from xr_torch.core.types import MODE_DEPTH_ONLY, Frame, RenderConfig, Scene
from xr_torch.pipeline.geometry import clip_capacity
from xr_torch.pipeline.shadow import light_matrices_for_scene
from xr_torch.raster import dispatch
from xr_torch.shading import blend

I32 = torch.int32


def make_band_mesh(num_bands: int, devices=None) -> list:
    """The device of each of num_bands bands, taken from devices in turn
    (a device serves several bands when there are fewer devices than
    bands). devices=None: every visible CUDA device; raises if there is
    none (pass e.g. ``["cpu"]`` to band on the CPU)."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("ShardedRenderer: no CUDA device; pass devices= explicitly")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    if not devices or num_bands < 1:
        raise ValueError(f"need at least one device and one band, got {devices}, {num_bands}")
    return [devices[b % len(devices)] for b in range(num_bands)]


def _pad_to(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def band_config(config: RenderConfig, num_bands: int):
    """(Hp, Hb, the config of one band): the height padded to num_bands *
    tile_h and split in num_bands bands of Hb rows."""
    Hp = _pad_to(config.height, num_bands * config.tile_h)
    Hb = Hp // num_bands
    return Hp, Hb, dataclasses.replace(config, height=Hb, num_shards=1)


class DeviceWork(NamedTuple):
    """What every band on one device reads: the scene there, the camera
    with tensor leaves, the setup records (tri) and those visibility sees
    (vis_tri), the shadow map for shading and its pass's bin_overflow, and
    under blending the live transparent slots and their chunks' screen
    boxes (read to the host once here for all the device's bands)."""

    scene: Scene
    cam: object
    tri: object
    vis_tri: object
    shadow: dict
    shadow_bin_overflow: torch.Tensor
    blend_live: Optional[blend.LiveSlots]


def device_pass(scene: Scene, camera, config: RenderConfig, light_view, light_proj,
                capacity: int) -> DeviceWork:
    """The per-frame work that does not depend on the band, on the scene's
    device: camera matrices, the shadow pass and geometry of the full
    frame."""
    cam, view, proj = renderer.camera_matrices(scene, camera, config)
    shadow = {}
    s_bin_of = torch.zeros((), dtype=I32, device=scene.mesh.positions.device)
    if renderer.has_shadow_pass(config):
        shadow, s_bin_of = renderer.shadow_pass(scene, config, light_view, light_proj, capacity)
    tri, vis_tri = renderer.visible_triangles(scene, view, proj, config, capacity)
    live = blend.live_records(tri, scene, config) if config.blend else None
    return DeviceWork(scene, cam, tri, vis_tri, shadow, s_bin_of, live)


def band_pass(work: DeviceWork, band_cfg: RenderConfig, y_offset: int, capacity: int,
              shade_hook=None):
    """One band: visibility, shading, the blend composite and the u8
    resolve of rows [y_offset, y_offset + band_cfg.height). Returns (color
    u8 (Hb, W, 3), depth (Hb, W), bin_overflow, blend_overflow or None)."""
    tid, zbuf, bin_of = dispatch.visibility(work.vis_tri, band_cfg, capacity, y_offset=y_offset)
    depth = torch.where(torch.isinf(zbuf), 1.0, zbuf)
    blend_of = None
    if band_cfg.mode == MODE_DEPTH_ONLY:
        color = torch.zeros((band_cfg.height, band_cfg.width, 3), dtype=torch.uint8,
                            device=depth.device)
    else:
        eye = work.cam.eye
        rgb = renderer.shade(work.tri, tid, work.scene, band_cfg, eye, work.shadow, shade_hook,
                             depth, y_offset)
        if band_cfg.blend:
            rgb, blend_of = renderer.blend_pass(rgb, depth, work.tri, work.scene, band_cfg, eye,
                                                work.shadow, y_offset, work.blend_live)
        color = sm.resolve_u8(rgb)
    return color, depth, bin_of, blend_of


def render_step_sharded(scene: Scene, camera, config: RenderConfig, mesh: list,
                        light_view=None, light_proj=None, capacity: Optional[int] = None,
                        shade_hook=None, out=None) -> Frame:
    """One frame in len(mesh) bands, band b on mesh[b], gathered on
    mesh[0] (``xr/dist/shard.py:54-211``). scene: tensors on any device,
    copied to each distinct device of the mesh; light_view, light_proj,
    shade_hook as for xr_torch.app.renderer.render_step; out: optional
    preallocated (color_u8 (H,W,3), depth_f32 (H,W)) pair on mesh[0].

    Stats as the reference's: tris_in, tris_setup, clip_overflow and
    blend_overflow of one band (the geometry is the same on every band);
    bin_overflow summed over the bands plus the shadow pass's once;
    covered_pixels summed over the bands' Hb rows, padding included;
    fragments_shaded Hp * W plus the shadow map's texels. No nf_* counters,
    whatever config.debug_checks says, as in the reference."""
    n = len(mesh)
    cap = capacity or clip_capacity(scene.mesh.num_triangles, config)
    H, W = config.height, config.width
    Hp, Hb, band_cfg = band_config(config, n)
    work = {d: device_pass(convert.scene_to_torch(scene, d), camera, config, light_view,
                           light_proj, cap)
            for d in dict.fromkeys(mesh)}
    bands = [band_pass(work[d], band_cfg, b * Hb, cap, shade_hook) for b, d in enumerate(mesh)]

    dev = mesh[0]
    w0 = work[dev]
    color = torch.cat([c.to(dev) for c, _, _, _ in bands])[:H]
    depth = torch.cat([z.to(dev) for _, z, _, _ in bands])[:H]
    shaded = Hp * W
    if renderer.has_shadow_pass(config):
        shaded += config.shadow_map_size * config.shadow_map_size
    stats = {
        "tris_in": torch.tensor(scene.mesh.num_triangles, dtype=I32, device=dev),
        "tris_setup": w0.tri.count,
        "clip_overflow": w0.tri.overflow,
        "bin_overflow": torch.stack([of.to(dev) for _, _, of, _ in bands]).sum(dtype=I32)
        + w0.shadow_bin_overflow,
        "fragments_shaded": torch.tensor(shaded, dtype=I32, device=dev),
        "covered_pixels": torch.stack([(z < 1.0).sum(dtype=I32).to(dev)
                                       for _, z, _, _ in bands]).sum(dtype=I32),
    }
    if config.blend:
        stats["blend_overflow"] = bands[0][3]
    if out is not None:
        color = out[0].copy_(color)
        depth = out[1].copy_(depth)
    return Frame(color=color, depth=depth, stats=stats)


class ShardedRenderer(renderer.FramebufferPool):
    """Banded counterpart of xr_torch.Renderer (``xr/dist/shard.py:214-264``):
    ``step``/``readback``/``present``/``flush`` as there, each frame in
    config.num_shards bands over devices (see make_band_mesh: None means
    every visible CUDA device and raises without one; a list such as
    ``["cuda:0"]`` or ``["cpu"]`` may hold fewer devices than bands). The
    shadow pass's light matrices are fit to the scene given here, once;
    frames land on the first device, in pooled buffers unless
    recycle_framebuffers=False; shade_hook: the custom pixel stage of every
    band."""

    def __init__(self, scene: Scene, config: RenderConfig, devices=None, shade_hook=None,
                 recycle_framebuffers: bool = True):
        self.config = config
        self.mesh = make_band_mesh(config.num_shards, devices)
        self.capacity = clip_capacity(scene.mesh.num_triangles, config)
        self._hook = shade_hook
        self._recycle = recycle_framebuffers
        self._inflight = None
        self._copy = None
        self._pool = []
        self._light = (light_matrices_for_scene(scene) if renderer.has_shadow_pass(config)
                       else None)

    def step(self, scene: Scene, camera) -> Frame:
        """Render one frame. scene: tensors on the first device of the mesh
        (copied to the others); camera: array-likes or tensors."""
        lv, lp = self._light or (None, None)
        return render_step_sharded(scene, camera, self.config, self.mesh, lv, lp, self.capacity,
                                   self._hook, out=self._out(self.mesh[0]))
