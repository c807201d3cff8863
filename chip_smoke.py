"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no final line):
  1. device: a CUDA card is required; prints nvidia-smi's name and power limit
     and reads the SM clock the integer bound is taken at
  2. build: compiles the CUDA kernels from xr_torch/csrc/ (nvcc, one process
     per source, started together)
  3. kernel vs plain: each visibility kernel against its plain PyTorch
     version on identical inputs, bit-exact tid and z and equal dropped:
     the stream kernel (vis_stream) on config3 at golden size in four cases,
     on config2 at golden size (128x128 tiles) and on the full 1920x1080
     config3 and config2 frames; the list kernel (vis_lists) on config3 at
     golden size in four cases, on config2 at golden size with
     bin_capacity 8192 and 2048 (2079 dropped) and on the full config2
     frame; both kernels on config4's two full passes (the shadow pass,
     1024x1024 from the light, depth only, and the 1920x1080 camera pass,
     64x128 tiles) and on config4b's camera pass (the transparent panes
     masked out); times both kernels and their plain versions on the full
     frames, beside the bound of each launch (the bytes and the integer
     operations no exact design avoids, _vis_work), and holds the output of
     the launch after the 50 timed ones against the plain version and
     against the first launch's
  4. gathers: the lane gather (lane_gather, P1) at the probe's four shapes
     and the 16-channel and one-channel quad gathers (quad_gather P2,
     quad_gather1 P3) at the full 2,073,600-pixel shape, bit-exact against
     their plain versions; P1 and P2 also on uniformly random indices, on
     indices outside the table row, P2 on 13 table rows, a second launch
     against the first and the launch after the timed ones against the
     plain version; each timed with a cold L2, the launches queued behind a
     spin on the device, beside its plain version, the one PyTorch call
     that computes it (P1, P3; two calls for P2) and its bound
  5. golden: config1 (brute force), config2 (128x128 tiles, stream kernel),
     config3, config4 and config4b (two passes) at golden size through
     Renderer on the card against tests/goldens/ (<= 1 LSB; config4/4b at
     most max(2, 0.1 %) pixels past it, the shadow-edge rule of
     tests/test_goldens.py), coverage within 1e-6
  6. main path, each run with the launch counts set to 0 just before it
     and read just after, one warm-up frame first:
     - config3 at 1920x1080 (100,352 triangles), 30 frames through
       Renderer.step + readback; the stream kernel in every frame
     - config2 at 1920x1080 (11,520 triangles), 30 frames with
       backend="pallas_smem" (the list kernel in every frame), then the
       same cameras with backend="auto" (the stream kernel): identical
       color, depth and stats
     - config1 at 512x512, 10 frames through brute force
     - config4 at 1920x1080 with a 1024x1024 shadow map, 30 frames with
       backend="auto" (the stream kernel twice a frame), then the same
       cameras with "pallas_smem" (the list kernel twice a frame):
       identical color, depth and stats
     - config4b (config4 with two blended panes) at 1920x1080, 30 frames on
       config4's cameras: no blend overflow, config4's depth, other colors
     - the gather microbenchmarks: xr_torch.tools.probe_lanegather and
       xr_torch.tools.microbench_gather, as run from the command line
     prints ms/frame of each and the device time of each stage, timed on
     the stage functions render_step calls
The line before the last is a JSON object with the kernels' numbers; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
STREAM_CASES = {
    "as_is": {},
    "large_bucket": {"medium_capacity": 0, "tile_h": 8},
    "painter": {"depth_test": False},
    "stream_overflow": {"stream_expand": 0.001},
}
LIST_CASES = {
    "as_is": {},
    "large_bucket": {"medium_capacity": 0, "tile_h": 8},
    "painter": {"depth_test": False},
    "lists_overflow": {"bin_capacity": 64},
}
SOURCES = {
    "vis_stream": ("xr_torch/csrc/vis_stream.cu", "xr/raster/pallas_stream.py:80"),
    "vis_lists": ("xr_torch/csrc/vis_lists.cu", "xr/raster/pallas_smem.py:346"),
    "lane_gather": ("xr_torch/csrc/gather.cu", "tools/probe_lanegather.py:26"),
    "quad_gather": ("xr_torch/csrc/gather.cu", "tools/microbench_gather.py:108"),
    "quad_gather1": ("xr_torch/csrc/gather.cu", "tools/microbench_gather.py:133"),
}
KERNELS = tuple(SOURCES)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
INT32_LANES = 132 * 64  # SMs x INT32 lanes per SM
EDGE_OPS = 6  # per pixel of a record's bbox: three edge functions of two multiply-adds
DECODE_OPS = 8  # per (tile, record) pair: unpacking the bbox and the tie offsets


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events around reps calls that
    the host enqueues one by one: for calls that outlast their launch. A
    kernel shorter than the host's launch of its wrapper is timed by
    xr_torch.tools.timing.device_ms, queued behind a spin on the device."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _manifest(name: str) -> dict:
    with open(os.path.join(ROOT, "tests", "goldens", "manifest.json")) as f:
        return json.load(f)[name]


def _preset(name: str, full: bool = False):
    """config1/config2 as published; config3's terrain is 48x48 quads at
    golden size and 224x224 (100,352 triangles) in full."""
    from xr_torch.scene import presets

    if name == "config3":
        n = 224 if full else 48
        return presets.config3_terrain(n, n)
    return presets.ALL_PRESETS[name]()


def _tie_preset(p):
    """The preset with its mesh merged with a copy of itself: every covered
    pixel ties on z between a triangle and its copy."""
    from xr_torch.scene import procedural as proc

    mesh = proc.with_vert_mat(proc.merge_meshes([p.scene.mesh, p.scene.mesh]))
    return p._replace(scene=p.scene.replace(mesh=mesh))


def _kernel_fns(kernel: str):
    """(prepare, wrapper, plain version) of a visibility kernel."""
    from xr_torch.raster import smem, stream

    return {
        "vis_stream": (stream.prepare, stream.vis_stream, stream.vis_stream_plain),
        "vis_lists": (smem.prepare_lists, smem.vis_lists, smem.vis_lists_plain),
    }[kernel]


def _smi(query: str, *fmt: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader" + "".join(fmt)],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device():
    """Returns (nvidia-smi's name and power limit line, max SM clock in Hz)."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; a CUDA card is required")
    smi = _smi("name,power.limit")
    clock_hz = float(_smi("clocks.max.sm", ",nounits")) * 1e6
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"max SM clock {clock_hz / 1e6:.0f} MHz")
    return smi, clock_hz


def _bound(nbytes: float, ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_build() -> None:
    from xr_torch import kernels

    t0 = time.perf_counter()
    path = kernels.build(verbose=True)
    kernels.library()
    log(f"build: {path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {kernels.build_seconds if kernels.build_seconds is not None else 0.0:.2f} s)")


def _setup(dev, preset, width, height, t, **over):
    from xr_torch import convert
    from xr_torch.scene import presets

    p = presets.small_preset(preset, width, height, **over)
    cam, mm = p.animate(t)
    scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), dev)
    return p, cam, scene


def _vis_work(kernel, inp, cfg):
    """(pairs, bbox pixels, bytes) of one visibility launch, whatever
    implements it. Pairs: every (tile, record) the launch folds, the tile's
    segment inside the budget (stream) or its list (lists) and the large
    bucket for every tile that runs. Bbox pixels: for each pair the pixels
    of the record's bbox that lie inside that tile and the frame; no exact
    design evaluates the three edge functions on fewer. Bytes: the record
    rows that some tile references, the ids and the per-tile words, each
    read once, and the (tid, z) frame written once; a design's scratch is
    not counted."""
    H, W, th, sub = cfg.height, cfg.width, cfg.tile_h, cfg.subpixel
    dev = inp.rec.device
    ntx, nty = -(-W // 128), -(-H // th)
    ntiles = ntx * nty
    if kernel == "vis_stream":
        ran = inp.tile_ran != 0
        counts = torch.where(ran, inp.run_counts, 0).long()
        ids_of = lambda t, j: inp.sid.long()[inp.starts.long()[t] + j]  # noqa: E731
        words = 3 * ntiles
    else:
        ran = torch.ones(ntiles, dtype=torch.bool, device=dev)
        counts = inp.counts.long()
        ids_of = lambda t, j: inp.lists.long()[t, j]  # noqa: E731
        words = ntiles
    tile = torch.repeat_interleave(torch.arange(ntiles, device=dev), counts)
    j = torch.arange(tile.numel(), device=dev) - (torch.cumsum(counts, 0) - counts)[tile]
    ids = ids_of(tile, j)
    L = int(inp.large_count)
    rt = ran.nonzero().flatten()
    tile = torch.cat([tile, rt.repeat_interleave(L)])
    ids = torch.cat([ids, inp.large_ids[:L].long().repeat(rt.numel())])
    bxp, byp = inp.rec[ids, 17].long(), inp.rec[ids, 16].long()
    bx0, bx1 = (bxp & 0xFFFF) - 32768, ((bxp >> 16) & 0xFFFF) - 32768
    by0, by1 = (byp & 0xFFFF) - 32768, ((byp >> 16) & 0xFFFF) - 32768
    half = sub // 2
    # pixel ranges of the bbox (centers at c * sub + half), cut to the tile and the frame
    col0, row0 = (tile % ntx) * 128, (tile // ntx) * th
    x0 = torch.maximum(-(-(bx0 - half) // sub), col0)
    x1 = torch.minimum((bx1 - half) // sub, torch.clamp_max(col0 + 127, W - 1))
    y0 = torch.maximum(-(-(by0 - half) // sub), row0)
    y1 = torch.minimum((by1 - half) // sub, torch.clamp_max(row0 + th - 1, H - 1))
    pixels = int((torch.clamp_min(x1 - x0 + 1, 0) * torch.clamp_min(y1 - y0 + 1, 0)).sum())
    nbytes = (int(torch.unique(ids).numel()) * inp.rec.shape[1] * 4
              + (ids.numel() + words) * 4 + H * W * 8)
    return ids.numel(), pixels, nbytes


def _view_proj(dev, cam, cfg):
    from xr_torch import convert
    from xr_torch.core import math3d as m3

    return m3.camera_matrices(convert.camera_to_torch(cam, dev), cfg.width / cfg.height, dev)


def _same_vis(label, what, got, want) -> None:
    """Raise unless the (tid, z) pairs hold the same bits."""
    torch.cuda.synchronize()
    for field, a, b in (("tid", got[0], want[0]),
                        ("z bits", got[1].view(torch.int32), want[1].view(torch.int32))):
        if not torch.equal(a, b):
            raise AssertionError(
                f"{label}: {field} differ from {what} at {int((a != b).sum())} pixels")


def _compare_kernel(dev, kernel, cfg, scene, view_proj, name, time_it=False, clock_hz=None):
    """The kernel and its plain version on the records the frame's
    visibility sees (renderer.visible_triangles: under blend, the opaque
    ones)."""
    from xr_torch.app.renderer import visible_triangles
    from xr_torch.pipeline.geometry import clip_capacity
    from xr_torch.tools import timing

    prepare, launch, plain = _kernel_fns(kernel)
    _, tri = visible_triangles(scene, *view_proj, cfg, clip_capacity(scene.mesh.num_triangles, cfg))
    inp = prepare(tri, cfg)
    tk, zk = launch(inp, cfg)
    torch.cuda.synchronize()
    tp, zp = plain(inp, cfg)
    torch.cuda.synchronize()
    label = f"{kernel} [{name}] {cfg.width}x{cfg.height} tiles {cfg.tile_h}x{cfg.tile_w}"
    _same_vis(label, "the plain version", (tk, zk), (tp, zp))
    # the merge order varies from launch to launch; the output must not
    _same_vis(label, "the first launch", launch(inp, cfg), (tk, zk))
    fin = torch.isfinite(zp)
    err = float((zk[fin] - zp[fin]).abs().max()) if bool(fin.any()) else 0.0
    bg = int((tk == 2**31 - 1).sum())
    line = (f"kernel vs plain {label}: tid and z bit-exact, "
            f"large_count={int(inp.large_count)} dropped={int(inp.dropped)} "
            f"bg_pixels={bg} records={int(tri.count)}")
    chunks = inp.item_start[1:] - inp.item_start[:-1]
    out = {"max_abs_err": err, "large_count": int(inp.large_count),
           "dropped": int(inp.dropped), "bg": bg, "max_chunks": int(chunks.max()),
           "one_chunk_tiles": int((chunks == 1).sum())}
    line += f" chunks={int(chunks.sum())} (most in a tile {out['max_chunks']})"
    if time_it:
        # 50 launches queued behind ~20 ms of spinning: device time
        out["ms"] = timing.device_ms(lambda: launch(inp, cfg), reps=50, warmup=2)[0]
        # after 50 launches in a row the scratch must still be the kernel's own
        _same_vis(label, "the plain version, after the timed launches", launch(inp, cfg),
                  (tp, zp))
        out["plain_ms"] = cuda_ms(lambda: plain(inp, cfg), reps=5, warmup=1)
        pairs, pixels, nbytes = _vis_work(kernel, inp, cfg)
        out.update(_bound(nbytes, pixels * EDGE_OPS + pairs * DECODE_OPS,
                          INT32_LANES * clock_hz))
        out.update(pairs=pairs, bbox_pixels=pixels, bytes=nbytes)
        line += (f"; kernel {out['ms']!r} ms, plain {out['plain_ms']!r} ms, bound "
                 f"{out['bound_ms']!r} ms by {out['bound_by']} ({pairs} (tile, record) "
                 f"pairs, {pixels} bbox pixels, {nbytes} bytes)")
    log(line)
    return out


def phase_kernel_vs_plain(dev, clock_hz) -> dict:
    from xr_torch import convert
    from xr_torch.app.renderer import shadow_config
    from xr_torch.pipeline.shadow import light_matrices_for_scene

    errs = {"vis_stream": [], "vis_lists": []}

    def run(kernel, p, cfg_over, scene, cam, name, time_it=False, cfg=None, view_proj=None):
        cfg = cfg or dataclasses.replace(p.config, **cfg_over)
        r = _compare_kernel(dev, kernel, cfg, scene, view_proj or _view_proj(dev, cam, cfg),
                            name, time_it, clock_hz)
        errs[kernel].append(r["max_abs_err"])
        return r

    m = _manifest("config3")
    p, cam, scene = _setup(dev, _preset("config3"), m["width"], m["height"], m["t"],
                           **m["overrides"])
    for kernel, cases in (("vis_stream", STREAM_CASES), ("vis_lists", LIST_CASES)):
        for name, over in cases.items():
            r = run(kernel, p, over, scene, cam, name)
            if name == "large_bucket" and r["large_count"] <= 0:
                raise AssertionError(f"{kernel} large_bucket: the large bucket is empty")
            if name == "stream_overflow" and not (r["dropped"] > 0 and r["bg"] > 0):
                raise AssertionError("stream_overflow: expected dropped records and BG tiles")
            if name == "lists_overflow" and r["dropped"] <= 0:
                raise AssertionError("lists_overflow: expected dropped list entries")

    # a tile's walk cut into three or more chunks, merged through the packed
    # key, with the depth test and in painter's order: config3 as it is (the
    # split case; some tiles keep one chunk and store directly), and with
    # the terrain doubled, so that every covered pixel ties on z between a
    # triangle and its copy, also across chunks
    tie = _tie_preset(_preset("config3"))
    for label, (pp, pcam, pscene) in (
            ("split", (p, cam, scene)),
            ("z_tie", _setup(dev, tie, m["width"], m["height"], m["t"], **m["overrides"]))):
        for kernel in ("vis_stream", "vis_lists"):
            for depth_test in (True, False):
                r = run(kernel, pp, {"depth_test": depth_test}, pscene, pcam,
                        f"{label} {'depth' if depth_test else 'painter'}")
                if r["max_chunks"] < 3 or r["dropped"]:
                    raise AssertionError(f"{kernel} {label}: {r}")
                if label == "split" and not r["one_chunk_tiles"]:
                    raise AssertionError(f"{kernel} split: no tile stores directly: {r}")

    # config2 at golden size: 128x128 tiles (4 slabs a tile); the list
    # kernel is called directly, since dispatch streams at bin_capacity 8192
    m = _manifest("config2")
    p, cam, scene = _setup(dev, _preset("config2"), m["width"], m["height"], m["t"],
                           **m["overrides"])
    run("vis_stream", p, {}, scene, cam, "config2")
    for cap, want in ((8192, 0), (2048, 2079)):
        r = run("vis_lists", p, {"bin_capacity": cap}, scene, cam, f"config2 cap {cap}")
        if r["dropped"] != want:
            raise AssertionError(f"config2 cap {cap}: dropped {r['dropped']}, expected {want}")

    out = {}
    full = (("vis_stream", "config3"), ("vis_stream", "config2"), ("vis_lists", "config2"))
    for kernel, name in full:
        p, cam, scene = _setup(dev, _preset(name, full=True), 1920, 1080, 0.3)
        r = run(kernel, p, {}, scene, cam, f"full {name}", time_it=True)
        if r["dropped"]:
            raise AssertionError(f"full {name} frame dropped {r['dropped']} records")
        out[(kernel, name)] = r

    # config4's two passes, each as the frame gives it to both kernels
    # (64x128 tiles, two slabs a tile; bin_capacity 4096 keeps the list
    # kernel inside the SMEM budget): the shadow pass at 1024x1024 from the
    # light, depth only, and the 1920x1080 camera pass; then config4b's
    # camera pass, where the transparent panes are masked out of visibility
    for name in ("config4", "config4b"):
        p, cam, scene = _setup(dev, _preset(name), 1920, 1080, 0.3)
        passes = [(f"{name} camera pass", p.config, None)]
        if name == "config4":
            light = tuple(convert.tensor(m, dev) for m in light_matrices_for_scene(scene))
            passes.insert(0, ("config4 shadow pass", shadow_config(p.config), light))
        for label, cfg, view_proj in passes:
            for kernel in ("vis_stream", "vis_lists"):
                r = run(kernel, p, {}, scene, cam, label, time_it=name == "config4", cfg=cfg,
                        view_proj=view_proj)
                if r["dropped"] or r["bg"] == cfg.width * cfg.height:
                    raise AssertionError(f"{label}: {r}")

    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "pairs", "bbox_pixels", "bytes")
    return {
        "vis_stream": {"max_abs_err": max(errs["vis_stream"]), "library_ms": None,
                       **{k: out[("vis_stream", "config3")][k] for k in fields}},
        "vis_lists": {"max_abs_err": max(errs["vis_lists"]), "library_ms": None,
                      **{k: out[("vis_lists", "config2")][k] for k in fields}},
    }


def _bit_exact(label, got, want) -> float:
    """Raise unless got and want hold the same bits; returns their largest
    absolute difference (0.0)."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label}: {got.shape} {got.dtype} vs {want.shape} {want.dtype}")
    bits = (lambda t: t.view(torch.int32)) if got.dtype == torch.float32 else (lambda t: t)
    if not torch.equal(bits(got), bits(want)):
        raise AssertionError(f"{label}: differs from the plain version at "
                             f"{int((bits(got) != bits(want)).sum())} elements")
    return float((got.double() - want.double()).abs().max())


def phase_gathers(dev, clock_hz) -> dict:
    """P1 at the probe's four shapes, P2 and P3 at the full shape: each
    kernel bit-exact against its plain version (P1 and P2 also on uniformly
    random indices, on indices outside the row, P2 on S = 13, a second
    launch against the first and the launch after the timed ones against
    the plain version: a launch's scratch leaves nothing to the next), then
    timed with a cold L2 beside the plain version and the PyTorch call(s)
    that compute the same function. Returns each kernel's numbers (P1's at
    its largest shape)."""
    from xr_torch.tools import gather, timing
    from xr_torch.tools import microbench_gather as mb
    from xr_torch.tools import probe_lanegather as plg

    flush = timing.flush_buffer(dev)
    int_rate = INT32_LANES * clock_hz
    rng = np.random.default_rng(2)
    out = {}

    def cold_ms(fn):
        """(ms, repetitions) with a cold L2: `flush` (larger than the 50 MB
        L2) is rewritten before each call, events bracket the call alone,
        every repetition queued behind a spin on the device."""
        return timing.device_ms(fn, flush=flush)

    def on(a):
        return torch.from_numpy(a).to(dev)

    def report(name, label, fn, plain, library, idx, tab, nbytes, ops, err, library_calls=1):
        want = plain(idx, tab)
        ms, reps = cold_ms(lambda: fn(idx, tab))
        _bit_exact(f"{name} {label}, the launch after the timed ones", fn(idx, tab), want)
        r = {"max_abs_err": err, "ms": ms, "plain_ms": cold_ms(lambda: plain(idx, tab))[0],
             **_bound(nbytes, ops, int_rate)}
        lib_ms = cold_ms(library)[0]
        r["library_ms"] = lib_ms if library_calls == 1 else None
        log(f"gather {name} {label}: bit-exact; kernel {r['ms']!r} ms, plain "
            f"{r['plain_ms']!r} ms, library ({library_calls} call{'s' * (library_calls > 1)}) "
            f"{lib_ms!r} ms, bound {r['bound_ms']!r} ms by {r['bound_by']} ({nbytes} bytes); "
            f"cold L2, {reps} launches queued behind a device spin")
        if library_calls > 1:
            r["library_two_calls_ms"] = lib_ms
        out[name] = r

    def hold(name, label, fn, plain, idx, tab) -> float:
        """The kernel against its plain version, and a second launch
        against the first."""
        first = fn(idx, tab)
        err = _bit_exact(f"{name} {label}", first, plain(idx, tab))
        _bit_exact(f"{name} {label}, second launch", fn(idx, tab), first)
        return err

    for width, subl, dtype in plg.SHAPES:
        tab_h, idx_h, _ = plg.make_inputs(width, subl, dtype)
        tab, idx = on(tab_h), on(idx_h)
        S, W = tab.shape
        label = f"({S}, {W}) {np.dtype(dtype).name}"
        err = hold("lane_gather", label, gather.lane_gather, gather.lane_gather_plain, idx, tab)
        # one index in eight outside the row, on either side
        outside = on(rng.integers(-W // 16, W + W // 16, (1, W)).astype(np.int32))
        err = max(err, hold("lane_gather", label + " indices outside the row",
                            gather.lane_gather, gather.lane_gather_plain, outside, tab))
        idx64 = idx.long().expand(S, W)  # torch.take_along_dim takes int64 indices only
        if not torch.equal(torch.take_along_dim(tab, idx64, 1), gather.lane_gather(idx, tab)):
            raise AssertionError(f"lane_gather {label}: torch.take_along_dim disagrees")
        report("lane_gather", label, gather.lane_gather, gather.lane_gather_plain,
               lambda: torch.take_along_dim(tab, idx64, 1), idx, tab,
               idx.numel() * 4 + 2 * tab.numel() * 4, 0, err)

    idx_np, tex_np, quads = mb.make_inputs()
    flat_h, tab_h = mb.lane_layout(idx_np, tex_np, quads)
    flat, tab = on(flat_h), on(tab_h)
    N, (S, PP) = flat.numel(), tab.shape
    label = f"{N} px, table ({S}, {PP})"
    err = hold("quad_gather", label, gather.quad_gather, gather.quad_gather_plain, flat, tab)
    # uniformly random indices; one in eight outside the row, also on 13
    # table rows, which the row gather reads word by word
    random = on(rng.integers(0, PP, flat_h.shape).astype(np.int32))
    outside = on(rng.integers(-PP // 16, PP + PP // 16, (997, 131)).astype(np.int32))
    for what, i, t in (("random indices", random, tab), ("indices outside the row", outside, tab),
                       ("S = 13", outside, tab[:13].contiguous())):
        err = max(err, hold("quad_gather", f"{label} {what}", gather.quad_gather,
                            gather.quad_gather_plain, i, t))
    if not torch.equal(tab[:, flat].sum(0, dtype=torch.int32), gather.quad_gather(flat, tab)):
        raise AssertionError("quad_gather: tab[:, idx].sum(0) disagrees")
    report("quad_gather", label, gather.quad_gather, gather.quad_gather_plain,
           lambda: tab[:, flat].sum(0, dtype=torch.int32), flat, tab,
           2 * N * 4 + tab.numel() * 4, N * S, err, library_calls=2)
    ms, reps = cold_ms(lambda: gather.quad_gather(random, tab))
    log(f"gather quad_gather {label} random indices: kernel {ms!r} ms; cold L2, {reps} launches "
        f"queued behind a device spin")
    err = _bit_exact(f"quad_gather1 {label}", gather.quad_gather1(flat, tab),
                     gather.quad_gather1_plain(flat, tab))
    if not torch.equal(tab[0][flat], gather.quad_gather1(flat, tab)):
        raise AssertionError("quad_gather1: tab[0][idx] disagrees")
    report("quad_gather1", label, gather.quad_gather1, gather.quad_gather1_plain,
           lambda: tab[0][flat], flat, tab, 2 * N * 4 + PP * 4, 0, err)
    return out


def phase_golden(dev) -> None:
    from xr_torch import Renderer, kernels
    from xr_torch.core.image import read_png

    for name in ("config1", "config2", "config3", "config4", "config4b"):
        m = _manifest(name)
        p, cam, scene = _setup(dev, _preset(name), m["width"], m["height"], m["t"],
                               **m["overrides"])
        r = Renderer(scene, p.config, dev)
        kernels.reset_launches()
        frame = r.readback(r.step(scene, cam))
        launched = dict(kernels.launches)
        golden = read_png(os.path.join(ROOT, "tests", "goldens", f"{name}.png"))
        diff = np.abs(frame.color.astype(int) - golden.astype(int))
        bad = int((diff.max(axis=-1) > 1).sum())
        cov = float((frame.depth < 1.0).mean())
        # shadow edges: tests/test_goldens.py allows max(2, 0.1 %) pixels
        npix = m["width"] * m["height"]
        allowed = max(2, int(npix * 0.001)) if name.startswith("config4") else 0
        log(f"golden {name} {m['width']}x{m['height']}: {bad} px > 1 LSB (allowed {allowed}, "
            f"max {diff.max()}), coverage {cov!r} vs {m['coverage']!r}; launches {launched}")
        if bad > allowed or abs(cov - m["coverage"]) >= 1e-6:
            raise AssertionError(f"golden mismatch: {name}")
        # config1 renders by brute force (no kernel); the others stream,
        # config4/4b twice (the shadow map, then the frame)
        want = {"config1": 0, "config4": 2, "config4b": 2}.get(name, 1)
        if launched["vis_stream"] != want or launched["vis_lists"]:
            raise AssertionError(f"{name}: unexpected kernel launches {launched}")


def _stage_times(dev, p, cam, scene, kernel="vis_stream", reps=10) -> dict:
    """Device time of each stage of one frame, by CUDA events, each stage
    the function render_step calls: camera_matrices, shadow_pass (a Phong
    frame with a shadow map: geometry, binning and the kernel at
    shadow_map_size^2 from the light), then the frame's depth_pass split
    into visible_triangles (geometry), the kernel's prepare (binning) and
    its launch, then shade, blend_pass (under blend), resolve and
    readback."""
    from xr_torch.app import renderer
    from xr_torch.core import shade_math as sm
    from xr_torch.pipeline.geometry import clip_capacity
    from xr_torch.pipeline.shadow import light_matrices_for_scene

    prepare, launch, _ = _kernel_fns(kernel)
    cfg = p.config
    cap = clip_capacity(scene.mesh.num_triangles, cfg)
    out = {"camera": cuda_ms(lambda: renderer.camera_matrices(scene, cam, cfg), reps)}
    c, view, proj = renderer.camera_matrices(scene, cam, cfg)
    light, shadow = (None, None), {}
    if renderer.has_shadow_pass(cfg):
        light = light_matrices_for_scene(scene)
        out["shadow_pass"] = cuda_ms(lambda: renderer.shadow_pass(scene, cfg, *light, cap), reps)
        shadow, _ = renderer.shadow_pass(scene, cfg, *light, cap)
    tri, vis_tri = renderer.visible_triangles(scene, view, proj, cfg, cap)
    out["geometry"] = cuda_ms(lambda: renderer.visible_triangles(scene, view, proj, cfg, cap), reps)
    inp = prepare(vis_tri, cfg)
    out["bin+prep"] = cuda_ms(lambda: prepare(vis_tri, cfg), reps)
    out["vis_kernel"] = cuda_ms(lambda: launch(inp, cfg), reps)
    _, tid, depth, _ = renderer.depth_pass(scene, view, proj, cfg, cap)
    out["shade"] = cuda_ms(lambda: renderer.shade(tri, tid, scene, cfg, c.eye, shadow), reps)
    rgb = renderer.shade(tri, tid, scene, cfg, c.eye, shadow)
    if cfg.blend:
        out["blend"] = cuda_ms(
            lambda: renderer.blend_pass(rgb, depth, tri, scene, cfg, c.eye, shadow), reps)
    out["resolve"] = cuda_ms(lambda: sm.resolve_u8(rgb), reps)
    frame = renderer.render_step(scene, cam, cfg, *light)
    out["readback"] = cuda_ms(lambda: renderer.readback_frame(frame), reps)
    return out


def _run_frames(dev, scene, cfg, cams):
    """One warm-up frame, then one frame per camera through Renderer.step +
    readback, with the launch counts set to 0 just before the timed frames
    and read just after. Returns (ms per frame, host frames, launches)."""
    from xr_torch import Renderer, kernels

    r = Renderer(scene, cfg, dev)
    r.readback(r.step(scene, cams[0]))  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    times, frames = [], []
    for cam in cams:
        t0 = time.perf_counter()
        frames.append(r.readback(r.step(scene, cam)))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.launches)
    for f in frames:
        if f.color.shape != (cfg.height, cfg.width, 3) or f.color.dtype != np.uint8:
            raise AssertionError("bad frame shape")
        if not np.isfinite(f.depth).all() or int(f.stats["clip_overflow"]) or int(f.stats["bin_overflow"]):
            raise AssertionError(f"bad frame: {f.stats}")
        if f.color.max() == 0:
            raise AssertionError("black frame")
    return times, frames, launches


def _log_run(label, cfg, ntris, times, launches) -> float:
    ms = float(np.mean(times))
    log(f"main path {label} {cfg.width}x{cfg.height}, {ntris} tris, {len(times)} frames "
        f"(step + readback, host clock): mean {ms:.3f} ms, median {np.median(times):.3f} ms, "
        f"min {min(times):.3f} ms, max {max(times):.3f} ms -> {1e3 / ms:.2f} fps, "
        f"{cfg.width * cfg.height / ms / 1e3:.2f} Mpix/s; launches {launches}")
    return ms


def _log_stages(label, stages) -> None:
    log(f"stage device time {label} (ms, CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; sum {sum(stages.values()):.3f}")


def _coverage_between(frames, lo, hi) -> None:
    for f in frames:
        cov = float((f.depth < 1.0).mean())
        if not lo < cov < hi:
            raise AssertionError(f"implausible frame, coverage {cov}")


def phase_main_path(dev) -> dict:
    """Returns the launches of each kernel, summed over the runs."""
    total = dict.fromkeys(KERNELS, 0)

    def count(launches):
        for k, v in launches.items():
            total[k] += v

    # config3: the textured headline frame through the stream kernel
    p, _, scene = _setup(dev, _preset("config3", full=True), 1920, 1080, 0.0)
    if scene.mesh.num_triangles != 100_352:
        raise AssertionError("config3 must have 100,352 triangles")
    cams = [p.animate(0.05 * (i + 1))[0] for i in range(30)]
    times, frames, launches = _run_frames(dev, scene, p.config, cams)
    if launches["vis_stream"] < 30:
        raise AssertionError(f"config3: stream kernel launched {launches} in 30 frames")
    _coverage_between(frames, 0.3, 1.0)
    count(launches)
    _log_run("config3", p.config, scene.mesh.num_triangles, times, launches)
    log("frame stats (t=0.05): " + ", ".join(f"{k}={int(v)}" for k, v in frames[0].stats.items()))
    _log_stages("config3 t=0.3", _stage_times(dev, p, cams[5], scene))
    del frames

    # config2: Gouraud icospheres, list kernel (pallas_smem) against the
    # stream kernel (auto) on the same cameras
    p, _, scene = _setup(dev, _preset("config2"), 1920, 1080, 0.0)
    if scene.mesh.num_triangles != 11_520:
        raise AssertionError("config2 must have 11,520 triangles")
    cams = [p.animate(0.05 * (i + 1))[0] for i in range(30)]
    runs = {}
    for backend, kernel in (("pallas_smem", "vis_lists"), ("auto", "vis_stream")):
        cfg = dataclasses.replace(p.config, backend=backend)
        times, frames, launches = _run_frames(dev, scene, cfg, cams)
        other = "vis_stream" if kernel == "vis_lists" else "vis_lists"
        if launches[kernel] < 30 or launches[other]:
            raise AssertionError(f"config2 {backend}: launches {launches} in 30 frames")
        _coverage_between(frames, 0.1, 0.9)
        count(launches)
        _log_run(f"config2 backend={backend}", cfg, scene.mesh.num_triangles, times, launches)
        _log_stages(f"config2 backend={backend} t=0.3",
                    _stage_times(dev, p._replace(config=cfg), cams[5], scene, kernel))
        runs[backend] = frames
    _same_frames("config2", runs["pallas_smem"], runs["auto"])
    del runs

    # config1: the flat cube through brute force (no kernel)
    p, _, scene = _setup(dev, _preset("config1"), 512, 512, 0.0)
    cams = [p.animate(0.1 * (i + 1))[0] for i in range(10)]
    times, frames, launches = _run_frames(dev, scene, p.config, cams)
    if any(launches.values()):
        raise AssertionError(f"config1: brute force launched {launches}")
    _coverage_between(frames, 0.02, 0.9)
    _log_run("config1 (brute force)", p.config, scene.mesh.num_triangles, times, launches)
    del frames

    # config4: Phong with a 1024x1024 shadow map, two visibility launches a
    # frame, through the stream kernel (auto) and the list kernel
    # (pallas_smem) on the same cameras
    p, _, scene = _setup(dev, _preset("config4"), 1920, 1080, 0.0)
    cams = [p.animate(0.05 * (i + 1))[0] for i in range(30)]
    runs = {}
    for backend, kernel in (("auto", "vis_stream"), ("pallas_smem", "vis_lists")):
        cfg = dataclasses.replace(p.config, backend=backend)
        times, frames, launches = _run_frames(dev, scene, cfg, cams)
        other = "vis_stream" if kernel == "vis_lists" else "vis_lists"
        if launches[kernel] < 2 * len(cams) or launches[other]:
            raise AssertionError(f"config4 {backend}: launches {launches} in {len(cams)} frames")
        _coverage_between(frames, 0.2, 0.95)
        count(launches)
        _log_run(f"config4 backend={backend}", cfg, scene.mesh.num_triangles, times, launches)
        _log_stages(f"config4 backend={backend} t=0.3",
                    _stage_times(dev, p._replace(config=cfg), cams[5], scene, kernel))
        runs[backend] = frames
    _same_frames("config4", runs["auto"], runs["pallas_smem"])
    log("frame stats (t=0.05): " + ", ".join(f"{k}={int(v)}" for k, v in runs["auto"][0].stats.items()))

    # config4b: config4 with two blended panes on config4's cameras; the
    # panes write no depth and tint what is behind them
    p, _, scene = _setup(dev, _preset("config4b"), 1920, 1080, 0.0)
    times, frames, launches = _run_frames(dev, scene, p.config, cams)
    if launches["vis_stream"] < 2 * len(cams) or launches["vis_lists"]:
        raise AssertionError(f"config4b: launches {launches} in {len(cams)} frames")
    for i, (f, g) in enumerate(zip(frames, runs["auto"])):
        if int(f.stats["blend_overflow"]) or not np.array_equal(f.depth, g.depth):
            raise AssertionError(f"config4b frame {i}: {f.stats}, or its depth is not config4's")
        if (f.color != g.color).any(axis=-1).mean() < 0.01:
            raise AssertionError(f"config4b frame {i}: the panes tint under 1 % of the pixels")
    count(launches)
    _log_run("config4b (blend)", p.config, scene.mesh.num_triangles, times, launches)
    _log_stages("config4b t=0.3", _stage_times(dev, p, cams[5], scene))
    del runs, frames
    return total


def _same_frames(label, a_frames, b_frames) -> None:
    for i, (a, b) in enumerate(zip(a_frames, b_frames)):
        if not (np.array_equal(a.color, b.color) and np.array_equal(a.depth, b.depth)):
            raise AssertionError(f"{label} frame {i}: the backends' frames differ")
        if any(int(a.stats[k]) != int(b.stats[k]) for k in a.stats):
            raise AssertionError(f"{label} frame {i}: stats differ {a.stats} vs {b.stats}")
    log(f"{label}: the {len(a_frames)} frames of the two backends are equal (color, depth, stats)")


def phase_gather_tools(dev) -> dict:
    """The gather microbenchmarks as run from the command line, with the
    launch counts set to 0 just before and read just after."""
    from xr_torch import kernels
    from xr_torch.tools import microbench_gather, probe_lanegather

    kernels.reset_launches()
    probe_lanegather.main(dev)
    microbench_gather.main(dev)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    log(f"main path gather tools: launches {launches}")
    for name in ("lane_gather", "quad_gather", "quad_gather1"):
        if not launches[name]:
            raise AssertionError(f"the gather tools launched no {name}")
    return launches


def main() -> int:
    smi, clock_hz = phase_device()
    dev = torch.device("cuda", 0)
    import xr_torch  # noqa: F401  (TF32 off)

    phase_build()
    kv = phase_kernel_vs_plain(dev, clock_hz)
    kv.update(phase_gathers(dev, clock_hz))
    phase_golden(dev)
    launches = phase_main_path(dev)
    for k, v in phase_gather_tools(dev).items():
        launches[k] += v
    for name in KERNELS:
        if not launches[name] or kv[name]["max_abs_err"] != 0.0:
            raise AssertionError(f"{name}: launches {launches[name]}, error {kv[name]}")
    log(smi)
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": SOURCES[name][0],
        "replaces": SOURCES[name][1],
        "launches": launches[name],
        **kv[name],
    } for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
