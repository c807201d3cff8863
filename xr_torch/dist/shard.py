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
in turn on it. The frame is a list of ``graph.Stage``s on each distinct
device (``sharded_stages``): the work that does not depend on the band
(the shadow pass, geometry), which the reference replicates on every band,
once, with identical results; then the work of the device's bands, each
band's depth and u8 color written into its rows of one padded frame.
``gather_bands`` copies the rows of the bands on other devices into the
first device's frame (the reference's ``all_gather``) and makes the stats;
on a mesh of one device it is the last stage. ``render_step_sharded`` runs
the stages eagerly; ``ShardedRenderer`` on cards captures each device's
once and replays them, as the reference's jits ``render_step_sharded``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from xr_torch import convert
from xr_torch.app import renderer
from xr_torch.app.graph import FrameProgram, Stage, run_stages, signature, tree_map
from xr_torch.core import shade_math as sm
from xr_torch.core.types import MODE_DEPTH_ONLY, Frame, RenderConfig, Scene
from xr_torch.pipeline.geometry import clip_capacity
from xr_torch.pipeline.shadow import light_matrices_for_scene
from xr_torch.prof import span
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


def sharded_stages(config: RenderConfig, mesh: list, capacity: int, shade_hook=None) -> dict:
    """The banded frame as stages (graph.Stage) on each distinct device of
    the mesh, from renderer.frame_inputs' values there: the shadow pass and
    the full frame's geometry once, then the work of the device's bands
    under the unbanded frame's spans, ordered by kind so that each kind is
    one segment: every band's bin_prep, every band's vis, the depths (band
    b's into rows [b * Hb, (b + 1) * Hb) of depth_pad), every band's shade;
    under blend one stage that makes the live transparent slots once and
    composites every band; every band's resolve into its rows of
    color_pad. Band b's
    values are prefixed b{b}_. On a mesh of one device the last stage is
    the gather (gather_bands), and the values then hold the frame: color,
    depth and stats. Returns {device: stages}, mesh[0]'s first."""
    Hp, Hb, band_cfg = band_config(config, len(mesh))
    devices = list(dict.fromkeys(mesh))
    out = {}
    for dev in devices:
        bands = [(f"b{b}_", slice(b * Hb, (b + 1) * Hb)) for b, d in enumerate(mesh) if d == dev]
        stages = []
        if renderer.has_shadow_pass(config):
            stages += renderer._shadow_stages(config, capacity, ("shadow_pass",))
        stages.append(renderer._geometry_stage(config, capacity, "", ()))
        vis = [renderer._vis_stages(band_cfg, capacity, p, (), y_offset=rows.start, tris="vis",
                                    rows=rows) for p, rows in bands]
        *steps, depths = zip(*vis)  # (bin_prep, vis or one unspanned step), the depths
        for kind in steps:
            stages += kind
        stages.append(Stage((), functools.partial(_frame_buffers, config=config, Hp=Hp)))
        stages += depths
        if config.mode != MODE_DEPTH_ONLY:
            stages += [Stage(("shade",), functools.partial(renderer._shade, config=band_cfg,
                                                           shade_hook=shade_hook, prefix=p,
                                                           y_offset=rows.start))
                       for p, rows in bands]
            if config.blend:
                stages.append(Stage(("blend",), functools.partial(
                    _blend_bands, config=config, band_cfg=band_cfg, bands=bands)))
            stages += [Stage(("resolve",), functools.partial(_resolve, prefix=p, rows=rows))
                       for p, rows in bands]
        out[dev] = stages
    if len(devices) == 1:
        out[devices[0]].append(Stage((), lambda v: gather_bands({devices[0]: v}, config, mesh)))
    return out


def _frame_buffers(v, config: RenderConfig, Hp: int) -> dict:
    """The padded frame the bands write their rows into: color_pad (Hp, W,
    3) u8 (black, depth only) and depth_pad (Hp, W) f32."""
    dev, W = v["view"].device, config.width
    color = (torch.zeros if config.mode == MODE_DEPTH_ONLY else torch.empty)(
        (Hp, W, 3), dtype=torch.uint8, device=dev)
    return {"color_pad": color, "depth_pad": torch.empty((Hp, W), dtype=torch.float32, device=dev)}


def _blend_bands(v, config: RenderConfig, band_cfg: RenderConfig, bands: list) -> dict:
    """The transparent records composited over each band of the device:
    the live slots made once on the device (blend.live_slots), then each
    band's composite at its y_offset (on a card one kernel launch a band;
    on the CPU the plain version, which reads the slots to the host once)."""
    live = blend.live_slots(v["tri"], v["scene"], config)
    out = {}
    for p, rows in bands:
        rgb, overflow = renderer.blend_pass(v[p + "rgb"], v[p + "depth"], v["tri"], v["scene"],
                                            band_cfg, v["cam"].eye, v.get("shadow", {}),
                                            rows.start, live)
        out.update({p + "rgb": rgb, p + "blend_overflow": overflow})
    return out


def _resolve(v, prefix: str, rows: slice) -> dict:
    sm.resolve_u8(v[prefix + "rgb"], out=v["color_pad"][rows])
    return {}


def gather_bands(values: dict, config: RenderConfig, mesh: list) -> dict:
    """The frame from each distinct device's values after its stages
    (values: {device: values}): the rows of every band on another device
    copied into mesh[0]'s padded frame, which is cropped to H rows; and the
    stats as the reference's: tris_in, tris_setup, clip_overflow and
    blend_overflow of one band (the geometry is the same on every band);
    bin_overflow summed over the bands plus the shadow pass's once;
    covered_pixels over the padded height; fragments_shaded Hp * W plus the
    shadow map's texels. No nf_* counters, whatever config.debug_checks
    says, as in the reference. Returns the values color, depth and stats."""
    Hp, Hb, _ = band_config(config, len(mesh))
    dev = mesh[0]
    v0 = values[dev]
    color, depth = v0["color_pad"], v0["depth_pad"]
    for b, d in enumerate(mesh):
        if d != dev:
            rows = slice(b * Hb, (b + 1) * Hb)
            color[rows].copy_(values[d]["color_pad"][rows])
            depth[rows].copy_(values[d]["depth_pad"][rows])
    bin_of = torch.stack([values[d][f"b{b}_bin_overflow"].to(dev)
                          for b, d in enumerate(mesh)]).sum(dtype=I32)
    shaded = Hp * config.width
    if renderer.has_shadow_pass(config):
        bin_of = bin_of + v0["light_bin_overflow"]
        shaded += config.shadow_map_size * config.shadow_map_size
    stats = {
        "tris_in": convert.constant(v0["scene"].mesh.num_triangles, dev, I32),
        "tris_setup": v0["tri"].count,
        "clip_overflow": v0["tri"].overflow,
        "bin_overflow": bin_of,
        "fragments_shaded": convert.constant(shaded, dev, I32),
        "covered_pixels": (depth < 1.0).sum(dtype=I32),
    }
    if "b0_blend_overflow" in v0:
        stats["blend_overflow"] = v0["b0_blend_overflow"]
    return {"color": color[:config.height], "depth": depth[:config.height], "stats": stats}


def _on(scene: Scene, device) -> Scene:
    """The scene's tensors on device (those already there as they are)."""
    return tree_map(lambda t: t.to(device), scene)


def render_step_sharded(scene: Scene, camera, config: RenderConfig, mesh: list,
                        light_view=None, light_proj=None, capacity: Optional[int] = None,
                        shade_hook=None, out=None) -> Frame:
    """One frame in len(mesh) bands, band b on mesh[b], gathered on
    mesh[0] (``xr/dist/shard.py:54-211``), run eagerly: sharded_stages on
    each distinct device, then gather_bands. scene: tensors on any device,
    copied to each distinct device of the mesh; light_view, light_proj,
    shade_hook as for xr_torch.app.renderer.render_step; out: optional
    preallocated (color_u8 (H,W,3), depth_f32 (H,W)) pair on mesh[0]. The
    stats are gather_bands'."""
    cap = capacity or clip_capacity(scene.mesh.num_triangles, config)
    values = {}
    for dev, stages in sharded_stages(config, mesh, cap, shade_hook).items():
        with span("camera"):
            inputs = renderer.frame_inputs(_on(scene, dev), camera, config, light_view,
                                           light_proj)
        values[dev] = run_stages(stages, inputs)
    v = values[mesh[0]] if len(values) == 1 else gather_bands(values, config, mesh)
    color, depth = v["color"], v["depth"]
    if out is not None:
        color = out[0].copy_(color)
        depth = out[1].copy_(depth)
    return Frame(color=color, depth=depth, stats=v["stats"])


class CapturedBands:
    """ShardedRenderer's frame on cards: each distinct device's stages
    (sharded_stages) captured by a graph.FrameProgram on a
    renderer.FrameInputs there (the scene copied from the caller's tensors
    where a leaf changed, the camera and light through the device's pinned
    ring). On one device the gather and the stats are captured too and
    packed into one vector; on several they run after every device's
    replay (gather_bands: the cross-device copies, outside any graph)."""

    def __init__(self, scene: Scene, host: dict, config: RenderConfig, mesh: list,
                 capacity: int, shade_hook):
        stages = sharded_stages(config, mesh, capacity, shade_hook)
        self.first = mesh[0]
        self._gather = None
        if len(stages) == 1:
            stages[self.first].append(Stage((), renderer.pack_stats))
        else:
            self._gather = functools.partial(gather_bands, config=config, mesh=mesh)
        self.inputs = {d: renderer.FrameInputs(scene, host, d) for d in stages}
        self.programs = {d: FrameProgram(st, self.inputs[d].values, d)
                         for d, st in stages.items()}

    def load(self, scene: Scene, host: dict) -> None:
        for inputs in self.inputs.values():
            inputs.load(scene, host)

    def frame(self, out=None) -> Frame:
        """Replay every device's program and gather (renderer.frame_from)."""
        values = {d: p.replay() for d, p in self.programs.items()}
        if self._gather is None:
            return renderer.frame_from(values[self.first], out)
        with torch.cuda.device(self.first):
            v = self._gather(values)
            v.update(renderer.pack_stats(v))
            return renderer.frame_from(v, out)


class ShardedRenderer(renderer.FramebufferPool):
    """Banded counterpart of xr_torch.Renderer (``xr/dist/shard.py:214-264``):
    ``step``/``readback``/``present``/``flush`` as there, each frame in
    config.num_shards bands over devices (see make_band_mesh: None means
    every visible CUDA device and raises without one; a list such as
    ``["cuda:0"]`` or ``["cpu"]`` may hold fewer devices than bands). The
    shadow pass's light matrices are fit to the scene given here, once;
    frames land on the first device, in pooled buffers unless
    recycle_framebuffers=False; shade_hook: the custom pixel stage of every
    band.

    On cards the first ``step`` captures the banded frame and every later
    one replays it (CapturedBands; the reference jits render_step_sharded):
    a scene in the same tensors replays as it is, one of the same shapes in
    other tensors is copied into the captured inputs, another shape
    captures anew, as ``jit`` retraces; a capture or replay that fails
    raises, naming the stage. Every stage is captured, the blend's
    too. A frame equals ``render_step_sharded``'s
    bit for bit, which runs the same stages eagerly and is what ``step``
    runs on the CPU."""

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
        self._captured = None
        self._key = None

    def step(self, scene: Scene, camera) -> Frame:
        """Render one frame. scene: tensors on the first device of the mesh
        (copied to the others); camera: array-likes or tensors."""
        lv, lp = self._light or (None, None)
        first = self.mesh[0]
        if first.type != "cuda":
            return render_step_sharded(scene, camera, self.config, self.mesh, lv, lp,
                                       self.capacity, self._hook, out=self._out(first))
        host = renderer.host_inputs(camera, self.config, lv, lp)
        key = (signature(scene), tuple(tuple(np.shape(v)) for v in host.values()))
        if key != self._key:
            self._captured = self._key = None  # the old graphs go before the new
            self._captured = CapturedBands(scene, host, self.config, self.mesh, self.capacity,
                                           self._hook)
            self._key = key
        with span("camera"):
            self._captured.load(scene, host)
        return self._captured.frame(self._out(first))
