"""Application layer of the port (port of ``xr/app/renderer.py``): the frame
step, strict readback and the ``Renderer`` that users drive.

``render_step`` runs the whole frame on the scene's device — camera
matrices, the shadow map's depth-only pass from the light (Phong with
``shadow_map_size``), geometry, binning, the visibility kernel, deferred
shading, the blend pass (``blend``) and the u8 resolve — with shapes fixed
by the config, eagerly: the reference's function before ``jax.jit``. Its
stages after the camera are ``frame_stages``; ``Renderer`` on a card
captures them once as CUDA graphs (``CapturedFrame``, ``app/graph.py``)
and replays them each frame, as the reference's Renderer jits it; no
stage reads the card's values on the host (the blend stage's live slots
stay on the card, composited by a kernel).
``readback_frame`` is the Present() replacement: a device-to-host copy that
raises on any overflow counter and, under ``debug_checks``, names the first
pipeline stage whose non-finite counter (``nf_*``) is not zero.
``PresentMixin.present`` starts that copy when the frame is queued (CUDA:
pinned host buffers, non-blocking, behind an event), so the host's use of
frame N-1 overlaps frame N.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from xr_torch import convert
from xr_torch.app.graph import FrameProgram, Stage, StaticLeaves, run_stages, signature
from xr_torch.core import math3d as m3
from xr_torch.core import shade_math as sm
from xr_torch.core.types import (MODE_DEPTH_ONLY, MODE_PHONG, Camera, Frame, RenderConfig,
                                  Scene)
from xr_torch.pipeline.geometry import clip_capacity, geometry
from xr_torch.pipeline.shadow import camera_matrices_np, light_matrices_for_scene
from xr_torch.prof import span
from xr_torch.raster import dispatch
from xr_torch.shading import blend
from xr_torch.shading.deferred import shade_deferred


def _nf_count(*arrays, mask=None) -> torch.Tensor:
    """Non-finite elements across the float tensors of arrays, () i32; mask
    (leading dims) keeps only its rows."""
    total = None
    for a in arrays:
        if a is None or not a.is_floating_point():
            continue
        bad = ~torch.isfinite(a)
        if mask is not None:
            bad = bad & mask.reshape(mask.shape + (1,) * (bad.ndim - mask.ndim))
        n = bad.sum(dtype=torch.int32)
        total = n if total is None else total + n
    return total


def sanitize_stats(scene: Scene, tri, depth, rgb) -> dict:
    """The nf_* counters of debug_checks (``xr/app/renderer.py:58-78``), in
    pipeline order: the scene's inputs, the live setup records, the
    resolved depth and, unless the frame is depth only, the shaded color."""
    m = scene.mesh
    out = {
        "nf_0_input": _nf_count(m.positions, m.normals, m.uvs, scene.model_matrices),
        "nf_1_geometry": _nf_count(tri.z, tri.inv_w, tri.attr_w, tri.face_rgb, mask=tri.valid),
        "nf_2_visibility": _nf_count(depth),
    }
    if rgb is not None:
        out["nf_3_shading"] = _nf_count(rgb)
    return out


def camera_matrices(scene: Scene, camera, config: RenderConfig):
    """The frame's (camera with tensor leaves, view, proj) on the scene's
    device. view and proj are built on the host with numpy in the
    reference's op order (``pipeline.shadow.camera_matrices_np``) and
    copied to the device, so the card, the CPU and the reference render
    from the same bits: ``torch.tan`` on CUDA, on the CPU and numpy's
    ``tan`` differ by an ulp at some angles, which moves snapped vertices
    (F12). A camera with tensor leaves on a card is read to the host."""
    dev = scene.mesh.positions.device
    view, proj = camera_matrices_np(camera, config.width / config.height)
    return (convert.camera_to_torch(camera, dev), convert.tensor(view, dev),
            convert.tensor(proj, dev))


def visible_triangles(scene, view, proj, config: RenderConfig, capacity: int):
    """Geometry, and the triangles visibility sees: under blending the
    transparent records win no pixels and cast no shadows
    (``xr/app/renderer.py:81-92``). Returns (tri, vis_tri)."""
    tri = geometry(scene, view, proj, config, capacity=capacity)
    return tri, tri.replace(valid=blend.opaque_valid(tri, scene)) if config.blend else tri


def depth_pass(scene, view, proj, config: RenderConfig, capacity: int):
    """Geometry and visibility (_pass_stages): (tri, tid, depth with 1.0
    background, bin_overflow)."""
    v = run_stages(_pass_stages(config, capacity, "", ()),
                   {"scene": scene, "view": view, "proj": proj})
    return v["tri"], v["tid"], v["depth"], v["bin_overflow"]


def shadow_config(config: RenderConfig) -> RenderConfig:
    """The shadow map's depth-only pass: shadow_map_size squared, seen from
    the light."""
    return dataclasses.replace(config, width=config.shadow_map_size,
                               height=config.shadow_map_size, mode=MODE_DEPTH_ONLY,
                               shadow_map_size=0)


def has_shadow_pass(config: RenderConfig) -> bool:
    return config.mode == MODE_PHONG and config.shadow_map_size > 0


def _light_matrices(light_view, light_proj):
    if light_view is None or light_proj is None:
        raise ValueError("a Phong frame with a shadow map needs light_view and light_proj")
    return {"light_view": light_view, "light_proj": light_proj}


def shadow_pass(scene: Scene, config: RenderConfig, light_view, light_proj, capacity: int):
    """The shadow map: the depth-only pass from the light at
    shadow_map_size^2, with ``light_viewproj = proj @ view`` in fixed order
    (``xr/app/renderer.py:140-154``). Returns ({"shadow_depth",
    "light_viewproj"} for shading, bin_overflow)."""
    dev = scene.mesh.positions.device
    v = {k: convert.tensor(m, dev, torch.float32)
         for k, m in _light_matrices(light_view, light_proj).items()}
    v = run_stages(_shadow_stages(config, capacity, ()), {"scene": scene, **v})
    return v["shadow"], v["light_bin_overflow"]


def shade(tri, tid, scene: Scene, config: RenderConfig, eye, shadow: dict, shade_hook=None,
          depth=None, y_offset: int = 0):
    """Deferred shading of the visible records: linear rgb (H, W, 3), the
    rows [y_offset, y_offset + H) of the frame."""
    return shade_deferred(tri, tid, scene, config, eye=eye, shade_hook=shade_hook, depth=depth,
                          y_offset=y_offset, **shadow)


def blend_pass(rgb, depth, tri, scene: Scene, config: RenderConfig, eye, shadow: dict,
               y_offset: int = 0, live=None):
    """The transparent records composited over the shaded frame (or band
    of rows from y_offset): (rgb, blend_overflow). live: the live
    transparent slots if already made (blend.live_slots)."""
    return blend.composite_transparent(rgb, depth, tri, scene, config, eye, y_offset=y_offset,
                                       live=live, **shadow)


def frame_inputs(scene: Scene, camera, config: RenderConfig, light_view=None,
                 light_proj=None) -> dict:
    """The frame's inputs on the scene's device: scene, cam (the camera
    with tensor leaves), view and proj, and with a shadow pass light_view
    and light_proj (f32)."""
    cam, view, proj = camera_matrices(scene, camera, config)
    values = {"scene": scene, "cam": cam, "view": view, "proj": proj}
    if has_shadow_pass(config):
        dev = scene.mesh.positions.device
        values.update({k: convert.tensor(m, dev, torch.float32)
                       for k, m in _light_matrices(light_view, light_proj).items()})
    return values


def frame_stages(config: RenderConfig, capacity: int, shade_hook=None) -> list:
    """render_step's stages after the camera, in order (graph.Stage: the
    spans it runs under and a function of the frame's values so far,
    frame_inputs' first, that returns new ones): the shadow pass's
    geometry, visibility steps and maps (under shadow_pass); the camera
    pass's geometry and visibility steps and its depth; shade, blend and
    resolve; then the stats. No stage reads the card's values on the host,
    so a card captures every one. The frame is the values color, depth and
    stats."""
    stages = []
    shaded = config.width * config.height
    if has_shadow_pass(config):
        stages += _shadow_stages(config, capacity, ("shadow_pass",))
        shaded += config.shadow_map_size * config.shadow_map_size
    stages += _pass_stages(config, capacity, "", ())
    if config.mode != MODE_DEPTH_ONLY:
        stages.append(Stage(("shade",), functools.partial(_shade, config=config,
                                                           shade_hook=shade_hook)))
        if config.blend:
            stages.append(Stage(("blend",), functools.partial(_blend, config=config)))
        stages.append(Stage(("resolve",), lambda v: {"color": sm.resolve_u8(v["rgb"])}))
    stages.append(Stage((), functools.partial(_stats, config=config, shaded=shaded)))
    return stages


def _pass_stages(config: RenderConfig, capacity: int, prefix: str, outer: tuple) -> list:
    """depth_pass as stages, from the values prefix + view and proj:
    geometry, then visibility (_vis_stages); gives prefix + tri, tid, depth
    (1.0 background) and bin_overflow."""
    return ([_geometry_stage(config, capacity, prefix, outer)]
            + _vis_stages(config, capacity, prefix, outer))


def _geometry_stage(config: RenderConfig, capacity: int, prefix: str, outer: tuple) -> Stage:
    """Geometry of the frame (visible_triangles) from prefix + view and
    proj: prefix + tri, and prefix + vis, the triangles visibility sees."""

    def geometry_(v):
        tri, vis_tri = visible_triangles(v["scene"], v[prefix + "view"], v[prefix + "proj"],
                                         config, capacity)
        return {prefix + "tri": tri, prefix + "vis": vis_tri}

    return Stage(outer + ("geometry",), geometry_)


def _vis_stages(config: RenderConfig, capacity: int, prefix: str, outer: tuple,
                y_offset: int = 0, tris: Optional[str] = None, rows=None) -> list:
    """Visibility's steps (raster.dispatch.visibility_steps, rows
    [y_offset, y_offset + config.height) of the frame) on the triangles
    v[tris] (default prefix + vis), then prefix + tid, bin_overflow and
    depth with 1.0 background; rows: a slice of v["depth_pad"] the depth is
    written into (a screen band's rows of the padded frame)."""
    key = prefix + "vis"

    def step(fn, src):
        return lambda v: {key: fn(v[src])}

    def depth_(v):
        tid, zbuf, bin_of = v[key]
        if rows is None:
            depth = torch.where(torch.isinf(zbuf), 1.0, zbuf)
        else:
            depth = torch.where(torch.isinf(zbuf), convert.constant(1.0, zbuf.device), zbuf,
                                out=v["depth_pad"][rows])
        return {key: None, prefix + "tid": tid, prefix + "bin_overflow": bin_of,
                prefix + "depth": depth}

    steps = dispatch.visibility_steps(config, capacity, y_offset)
    return ([Stage(outer + ((name,) if name else ()), step(fn, (tris or key) if i == 0 else key))
             for i, (name, fn) in enumerate(steps)]
            + [Stage(outer, depth_)])


def _shadow_stages(config: RenderConfig, capacity: int, outer: tuple) -> list:
    """The shadow pass as stages, from the values light_view and
    light_proj: the depth-only pass, then the maps shading reads."""
    return (_pass_stages(shadow_config(config), capacity, "light_", outer)
            + [Stage(outer, _shadow_maps)])


def _shadow_maps(v) -> dict:
    """What shading reads of the shadow pass: its depth and
    ``light_viewproj = proj @ view`` in fixed order (``xr/app/renderer.py:140-154``)."""
    shadow = {"shadow_depth": v["light_depth"],
              "light_viewproj": m3.matmul(v["light_proj"], v["light_view"])}
    return {"shadow": shadow, "light_tri": None, "light_tid": None}


def _shade(v, config, shade_hook, prefix: str = "", y_offset: int = 0) -> dict:
    """prefix + rgb: shading of prefix + tid and depth, the rows from
    y_offset."""
    return {prefix + "rgb": shade(v["tri"], v[prefix + "tid"], v["scene"], config, v["cam"].eye,
                                  v.get("shadow", {}), shade_hook, v[prefix + "depth"], y_offset)}


def _blend(v, config) -> dict:
    rgb, overflow = blend_pass(v["rgb"], v["depth"], v["tri"], v["scene"], config, v["cam"].eye,
                               v.get("shadow", {}))
    return {"rgb": rgb, "blend_overflow": overflow}


def _stats(v, config, shaded: int) -> dict:
    """The frame's stats (and, depth only, its black color); tris_in and
    fragments_shaded are constants of the device (convert.constant)."""
    scene, tri, depth = v["scene"], v["tri"], v["depth"]
    dev = depth.device
    bin_of = v["bin_overflow"]
    if "light_bin_overflow" in v:
        bin_of = bin_of + v["light_bin_overflow"]
    stats = {
        "tris_in": convert.constant(scene.mesh.num_triangles, dev, torch.int32),
        "tris_setup": tri.count,
        "clip_overflow": tri.overflow,
        "bin_overflow": bin_of,
        "fragments_shaded": convert.constant(shaded, dev, torch.int32),
        "covered_pixels": (depth < 1.0).sum(dtype=torch.int32),
    }
    if "blend_overflow" in v:
        stats["blend_overflow"] = v["blend_overflow"]
    out = {"stats": stats}
    if config.mode == MODE_DEPTH_ONLY:
        out["color"] = torch.zeros((config.height, config.width, 3), dtype=torch.uint8,
                                   device=dev)
    if config.debug_checks:
        stats.update(sanitize_stats(scene, tri, depth, v.get("rgb")))
    return out


def render_step(scene: Scene, camera, config: RenderConfig, light_view=None,
                light_proj=None, capacity: Optional[int] = None, out=None,
                shade_hook=None) -> Frame:
    """One frame on the scene's device (``xr/app/renderer.py:95-211``), run
    eagerly: the counterpart of the reference's function before
    ``jax.jit``, which ``Renderer`` captures on a card. Like the
    reference's, it ignores config.num_shards (screen bands are
    xr_torch.dist.shard's). Stage by stage: the camera (frame_inputs), then
    frame_stages (the shadow pass, geometry, visibility's bin_prep and vis,
    shade, blend, resolve), each under a ``prof.span`` of its name. camera:
    a Camera whose leaves are array-likes or tensors. light_view,
    light_proj: the shadow pass's (4, 4) matrices (see
    xr_torch.pipeline.shadow), required for Phong with shadow_map_size > 0.
    out: optional preallocated (color_u8 (H,W,3), depth_f32 (H,W)) pair the
    frame is written into. shade_hook: the custom pixel stage,
    ``hook(color, scene, mat_id, torch[, frag=Frag])`` on the (N, 3) linear
    color before the background (xr_torch.shading.deferred). Under
    config.debug_checks the stats gain the nf_* counters."""
    cap = capacity or clip_capacity(scene.mesh.num_triangles, config)
    with span("camera"):
        values = frame_inputs(scene, camera, config, light_view, light_proj)
    values = run_stages(frame_stages(config, cap, shade_hook), values)
    color, depth = values["color"], values["depth"]
    if out is not None:
        color = out[0].copy_(color)
        depth = out[1].copy_(depth)
    return Frame(color=color, depth=depth, stats=values["stats"])


def _host(t: torch.Tensor):
    """A numpy copy that owns its memory: on the CPU, ``.numpy()`` would
    alias the tensor, and Renderer hands its output buffers to later
    frames."""
    return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()


class HostCopy(NamedTuple):
    """A frame's device-to-host copy in flight."""

    frame: Frame  # pinned host tensors, complete once `done` is
    done: torch.cuda.Event


def start_host_copy(frame: Frame) -> Optional[HostCopy]:
    """Queue a CUDA frame's copy into pinned host memory behind the work
    that renders it; None for a frame on the CPU, which needs no copy."""
    dev = frame.color.device
    if dev.type != "cuda":
        return None

    def pin(t):
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)

    with torch.cuda.device(dev):
        host = Frame(color=pin(frame.color), depth=pin(frame.depth),
                     stats={k: pin(v) for k, v in frame.stats.items()})
        done = torch.cuda.Event()
        done.record()
    return HostCopy(host, done)


def readback_frame(frame: Frame, strict: bool = True,
                   copy: Optional[HostCopy] = None) -> Frame:
    """Device-to-host copy. strict: raise if a fixed-capacity stage
    overflowed and dropped triangles, or (debug_checks) naming the first
    stage whose nf_* counter is not zero. copy: the frame's copy started
    earlier (start_host_copy); it is waited for in place of a new,
    synchronous one."""
    if copy is not None:
        copy.done.synchronize()
        frame = copy.frame
    out = Frame(
        color=_host(frame.color),
        depth=_host(frame.depth),
        stats={k: _host(v) for k, v in frame.stats.items()},
    )
    if strict:
        for k in ("clip_overflow", "bin_overflow", "blend_overflow"):
            n = int(out.stats.get(k, 0))
            if n:
                raise RuntimeError(
                    f"{k}={n}: triangles dropped — raise clip_expand/"
                    "bin_capacity in RenderConfig"
                )
        # the nf_* keys sort in pipeline order: the first that is not zero
        # names the stage that produced the non-finite values
        for k in sorted(out.stats):
            if k.startswith("nf_") and int(out.stats[k]):
                raise RuntimeError(
                    f"debug_checks: {int(out.stats[k])} non-finite values "
                    f"first appear in the {k.split('_', 2)[2]} stage ({k})"
                )
    return out


class PresentMixin:
    """One frame in flight: ``present(frame)`` queues frame N, starts its
    host copy and returns frame N-1's completed host copy (None on the
    first call); ``flush()`` drains."""

    _inflight: Optional[Frame] = None
    _copy: Optional[HostCopy] = None

    def _retire(self, frame: Frame) -> None:
        """Called once a frame's host copy is complete."""

    def present(self, frame: Frame, strict: bool = True) -> Optional[Frame]:
        return self._swap(frame, start_host_copy(frame), strict)

    def flush(self, strict: bool = True) -> Optional[Frame]:
        return self._swap(None, None, strict)

    def _swap(self, frame, copy, strict):
        """Put (frame, copy) in flight; the host copy of the frame that was."""
        prev, prev_copy = self._inflight, self._copy
        self._inflight, self._copy = frame, copy
        if prev is None:
            return None
        return self._readback(prev, strict, prev_copy)

    def readback(self, frame: Frame, strict: bool = True) -> Frame:
        """Device-to-host transfer of one frame: synchronous, unless the
        frame is the one in flight, whose copy `present` started."""
        return self._readback(frame, strict,
                              self._copy if frame is self._inflight else None)

    def _readback(self, frame: Frame, strict: bool, copy: Optional[HostCopy]) -> Frame:
        try:
            return readback_frame(frame, strict, copy)
        finally:
            self._retire(frame)


class FramebufferPool(PresentMixin):
    """Output buffers of ``self.config``'s size, reused across frames
    (recycle_framebuffers): a frame's color/depth go back to the pool once
    its host copy is taken, and a later step overwrites them."""

    config: RenderConfig
    _recycle: bool = True
    _pool: list

    def _retire(self, frame: Frame) -> None:
        if self._recycle:
            self._pool.append((frame.color, frame.depth))

    def _out(self, dev):
        """A (color, depth) pair to write the next frame into, or None
        without recycling."""
        if not self._recycle:
            return None
        if self._pool:
            return self._pool.pop()
        cfg = self.config
        return (
            torch.empty((cfg.height, cfg.width, 3), dtype=torch.uint8, device=dev),
            torch.empty((cfg.height, cfg.width), dtype=torch.float32, device=dev),
        )


CAMERA_LEAVES = ("eye", "target", "up", "fov_y", "near", "far")


def host_inputs(camera, config: RenderConfig, light_view=None, light_proj=None) -> dict:
    """What FrameInputs stages for a frame, on the host: view and proj
    (built in numpy, F12), the camera's leaves and, with a shadow pass, the
    light matrices."""
    view, proj = camera_matrices_np(camera, config.width / config.height)
    host = {"view": view, "proj": proj, **{f: getattr(camera, f) for f in CAMERA_LEAVES}}
    if has_shadow_pass(config):
        host.update(_light_matrices(light_view, light_proj))
    return host


def pack_stats(v) -> dict:
    """The frame's stats in one vector (stats_vec), which frame_from copies
    out once."""
    return {"stats_vec": torch.stack(list(v["stats"].values()))}


def frame_from(v: dict, out=None) -> Frame:
    """The Frame of a replayed frame's values (color, depth, stats and
    stats_vec): its color and depth copied into `out` (or new tensors), its
    stats into a vector of their own, so the Frame outlives the next
    replay."""
    own = v["stats_vec"].clone()
    stats = {k: own[i] for i, k in enumerate(v["stats"])}
    if out is None:
        return Frame(color=v["color"].clone(), depth=v["depth"].clone(), stats=stats)
    return Frame(color=out[0].copy_(v["color"]), depth=out[1].copy_(v["depth"]), stats=stats)


class FrameInputs:
    """The static inputs a frame is captured on, which ``load`` refills
    before each replay: the scene's leaves in tensors of their own
    (graph.StaticLeaves), and view and proj (built on the host, F12), the
    camera's six leaves and the light matrices in one device buffer, which
    a ring of pinned buffers fills without blocking (convert.StagingRing).
    ``values``: frame_stages' inputs. host: a first frame's host_inputs."""

    def __init__(self, scene: Scene, host: dict, device):
        self.scene = StaticLeaves(scene, device)
        self.staging = convert.StagingRing({k: tuple(np.shape(v)) for k, v in host.items()},
                                           device)
        self.load(scene, host)
        t = self.staging.tensors
        self.values = {"scene": self.scene.tree, "view": t["view"], "proj": t["proj"],
                       "cam": Camera(**{f: t[f] for f in CAMERA_LEAVES})}
        self.values.update({k: t[k] for k in ("light_view", "light_proj") if k in t})

    def load(self, scene: Scene, host: dict) -> None:
        self.scene.load(scene)
        self.staging.load(host)


class CapturedFrame:
    """Renderer's frame on a card: a frame's stages (frame_stages) captured
    by a FrameProgram on FrameInputs. The last graph also packs the stats
    into one vector (pack_stats)."""

    def __init__(self, scene: Scene, host: dict, stages: list, device):
        self.inputs = FrameInputs(scene, host, device)
        self.program = FrameProgram(stages + [Stage((), pack_stats)], self.inputs.values, device)

    def frame(self, out=None) -> Frame:
        """Replay the frame (see frame_from)."""
        return frame_from(self.program.replay(), out)


class Renderer(FramebufferPool):
    """Renders frames of one scene and config on an explicit device.

    On a CUDA device the first ``step`` captures the frame and every later
    one replays it (``CapturedFrame``; ``xr/app/renderer.py:326-332`` jits
    render_step): one CUDA graph per stage span, with no copy from the host
    but the camera's and no read of the card's values on the host (the
    blend stage too: its kernel reads the live transparent slots on the
    card). A scene in the same tensors replays as it is (edits in place
    are seen); one of the same shapes in other tensors is copied into the
    captured inputs first; another shape or config captures anew, as
    ``jit`` retraces. A capture or replay that fails raises, naming the
    stage. A frame equals ``render_step``'s bit for bit, which runs the
    same stages eagerly and is what ``step`` runs on the CPU. A new
    Renderer is the way to change the config or shade_hook (the
    reference's PSO rebuild).

    The shadow pass's light matrices are fit to the scene given here, once,
    on the host (``xr/app/renderer.py:324-325``); ``step`` takes an
    override. ``step(scene, camera)`` queues a frame; ``readback``/``present``/
    ``flush`` bring it to the host. Output buffers are preallocated and
    reused (recycle_framebuffers): a frame's color/depth tensors go back to
    the pool once its host copy is taken, and a later step overwrites them
    — keep the host Frame; with recycle_framebuffers=False every frame gets
    fresh buffers. shade_hook: the custom pixel stage of every frame (see
    render_step). autosize_cameras: a Camera, or a list of Cameras or
    (Camera, model_matrices) pairs, over which every capacity is measured
    at construction (xr_torch.app.autosize, on this device) times
    autosize_margin; ``self.config`` is the sized config.
    """

    def __init__(self, scene: Scene, config: RenderConfig, device, shade_hook=None,
                 recycle_framebuffers: bool = True, autosize_cameras=None,
                 autosize_margin: float = 1.5):
        self.device = torch.device(device)
        if autosize_cameras is not None:
            from xr_torch.app.autosize import autosize_config

            if not isinstance(autosize_cameras, list):
                autosize_cameras = [autosize_cameras]
            config = autosize_config(scene, autosize_cameras, config, autosize_margin,
                                     device=self.device)
        self.config = config
        self.capacity = clip_capacity(scene.mesh.num_triangles, config)
        self._hook = shade_hook
        self._recycle = recycle_framebuffers
        self._inflight = None
        self._copy = None
        self._pool = []
        self._light = light_matrices_for_scene(scene) if has_shadow_pass(config) else None
        self._captured = None
        self._key = None

    def step(self, scene: Scene, camera, light_matrices=None) -> Frame:
        """Render one frame. scene: tensors on this renderer's device (see
        xr_torch.convert.scene_to_torch); camera: array-likes or tensors;
        light_matrices: optional (view, proj) replacing the fitted ones."""
        dev = scene.mesh.positions.device
        if dev.type != self.device.type or (
            self.device.index is not None and dev.index != self.device.index
        ):
            raise ValueError(
                f"scene is on {dev}, renderer on {self.device}"
            )
        lv, lp = light_matrices or self._light or (None, None)
        if dev.type != "cuda":
            return render_step(scene, camera, self.config, light_view=lv, light_proj=lp,
                               capacity=self.capacity, out=self._out(dev),
                               shade_hook=self._hook)
        host = host_inputs(camera, self.config, lv, lp)
        key = (signature(scene), tuple(tuple(np.shape(v)) for v in host.values()))
        if key != self._key:
            self._captured = self._key = None  # the old graphs go before the new
            self._captured = CapturedFrame(
                scene, host, frame_stages(self.config, self.capacity, self._hook), dev)
            self._key = key
        with span("camera"):
            self._captured.inputs.load(scene, host)
        return self._captured.frame(self._out(dev))
