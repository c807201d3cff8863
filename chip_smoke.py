"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no final line):
  1. device: a CUDA card is required; prints nvidia-smi's name and power limit
  2. build: compiles the CUDA kernels from xr_torch/csrc/ (nvcc, one process
     per source, started together)
  3. kernel vs plain: each visibility kernel against its plain PyTorch
     version on identical inputs, bit-exact tid and z and equal dropped:
     the stream kernel (vis_stream) on config3 at golden size in four cases,
     on config2 at golden size (128x128 tiles) and on the full 1920x1080
     config3 and config2 frames; the list kernel (vis_lists) on config3 at
     golden size in four cases, on config2 at golden size with
     bin_capacity 8192 and 2048 (2079 dropped) and on the full config2
     frame; times both kernels and their plain versions on the full frames
  4. golden: config1 (brute force), config2 (128x128 tiles, stream kernel)
     and config3 at golden size through Renderer on the card against
     tests/goldens/ (<= 1 LSB, coverage within 1e-6)
  5. main path, each run with the launch counts set to 0 just before it
     and read just after, one warm-up frame first:
     - config3 at 1920x1080 (100,352 triangles), 30 frames through
       Renderer.step + readback; the stream kernel in every frame
     - config2 at 1920x1080 (11,520 triangles), 30 frames with
       backend="pallas_smem" (the list kernel in every frame), then the
       same cameras with backend="auto" (the stream kernel): identical
       color, depth and stats
     - config1 at 512x512, 10 frames through brute force
     prints ms/frame of each and the device time of each stage
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
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events around reps calls."""
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


def _kernel_fns(kernel: str):
    """(prepare, wrapper, plain version) of a visibility kernel."""
    from xr_torch.raster import smem, stream

    return {
        "vis_stream": (stream.prepare, stream.vis_stream, stream.vis_stream_plain),
        "vis_lists": (smem.prepare_lists, smem.vis_lists, smem.vis_lists_plain),
    }[kernel]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; a CUDA card is required")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


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


def _compare_kernel(dev, kernel, cfg, scene, cam, name, time_it=False):
    from xr_torch import convert
    from xr_torch.core import math3d as m3
    from xr_torch.pipeline.geometry import geometry

    prepare, launch, plain = _kernel_fns(kernel)
    view, proj = m3.camera_matrices(convert.camera_to_torch(cam, dev), cfg.width / cfg.height, dev)
    tri = geometry(scene, view, proj, cfg)
    inp = prepare(tri, cfg)
    tk, zk = launch(inp, cfg)
    torch.cuda.synchronize()
    tp, zp = plain(inp, cfg)
    torch.cuda.synchronize()
    label = f"{kernel} [{name}] {cfg.width}x{cfg.height} tiles {cfg.tile_h}x{cfg.tile_w}"
    if not torch.equal(tk, tp):
        n = int((tk != tp).sum())
        raise AssertionError(f"{label}: tid differs from the plain version at {n} pixels")
    if not torch.equal(zk.view(torch.int32), zp.view(torch.int32)):
        n = int((zk.view(torch.int32) != zp.view(torch.int32)).sum())
        raise AssertionError(f"{label}: z bits differ from the plain version at {n} pixels")
    fin = torch.isfinite(zp)
    err = float((zk[fin] - zp[fin]).abs().max()) if bool(fin.any()) else 0.0
    bg = int((tk == 2**31 - 1).sum())
    line = (f"kernel vs plain {label}: tid and z bit-exact, "
            f"large_count={int(inp.large_count)} dropped={int(inp.dropped)} "
            f"bg_pixels={bg} records={int(tri.count)}")
    out = {"max_abs_err": err, "large_count": int(inp.large_count),
           "dropped": int(inp.dropped), "bg": bg}
    if time_it:
        out["ms"] = cuda_ms(lambda: launch(inp, cfg), reps=50)
        out["plain_ms"] = cuda_ms(lambda: plain(inp, cfg), reps=5, warmup=1)
        line += f"; kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms"
    log(line)
    return out


def phase_kernel_vs_plain(dev) -> dict:
    errs = {"vis_stream": [], "vis_lists": []}

    def run(kernel, p, cfg_over, scene, cam, name, time_it=False):
        r = _compare_kernel(dev, kernel, dataclasses.replace(p.config, **cfg_over), scene, cam,
                            name, time_it)
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
    return {
        "vis_stream": {"max_abs_err": max(errs["vis_stream"]),
                       "ms": out[("vis_stream", "config3")]["ms"],
                       "plain_ms": out[("vis_stream", "config3")]["plain_ms"]},
        "vis_lists": {"max_abs_err": max(errs["vis_lists"]),
                      "ms": out[("vis_lists", "config2")]["ms"],
                      "plain_ms": out[("vis_lists", "config2")]["plain_ms"]},
    }


def phase_golden(dev) -> None:
    from xr_torch import Renderer, kernels
    from xr_torch.core.image import read_png

    for name in ("config1", "config2", "config3"):
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
        log(f"golden {name} {m['width']}x{m['height']}: {bad} px > 1 LSB (max {diff.max()}), "
            f"coverage {cov!r} vs {m['coverage']!r}; launches {launched}")
        if bad or abs(cov - m["coverage"]) >= 1e-6:
            raise AssertionError(f"golden mismatch: {name}")
        # config1 renders by brute force (no kernel); config2 and 3 stream
        if (launched["vis_stream"] > 0) != (name != "config1"):
            raise AssertionError(f"{name}: unexpected kernel launches {launched}")


def _stage_times(dev, p, cam, scene, kernel="vis_stream", reps=10) -> dict:
    """Device time of each stage of one frame, by CUDA events."""
    from xr_torch import convert
    from xr_torch.app.renderer import readback_frame, render_step
    from xr_torch.core import math3d as m3
    from xr_torch.core import shade_math as sm
    from xr_torch.pipeline.geometry import geometry
    from xr_torch.shading.deferred import shade_deferred

    prepare, launch, _ = _kernel_fns(kernel)
    cfg = p.config
    view, proj = m3.camera_matrices(convert.camera_to_torch(cam, dev), cfg.width / cfg.height, dev)
    tri = geometry(scene, view, proj, cfg)
    inp = prepare(tri, cfg)
    tid, _ = launch(inp, cfg)
    frame = render_step(scene, cam, cfg)
    return {
        "camera": cuda_ms(lambda: m3.camera_matrices(convert.camera_to_torch(cam, dev), cfg.width / cfg.height, dev), reps),
        "geometry": cuda_ms(lambda: geometry(scene, view, proj, cfg), reps),
        "bin+prep": cuda_ms(lambda: prepare(tri, cfg), reps),
        "vis_kernel": cuda_ms(lambda: launch(inp, cfg), reps),
        "shade+resolve": cuda_ms(lambda: sm.resolve_u8(shade_deferred(tri, tid, scene, cfg)), reps),
        "readback": cuda_ms(lambda: readback_frame(frame), reps),
    }


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
    total = {"vis_stream": 0, "vis_lists": 0}

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
    for i, (a, b) in enumerate(zip(runs["pallas_smem"], runs["auto"])):
        if not (np.array_equal(a.color, b.color) and np.array_equal(a.depth, b.depth)):
            raise AssertionError(f"config2 frame {i}: pallas_smem and auto differ")
        if any(int(a.stats[k]) != int(b.stats[k]) for k in a.stats):
            raise AssertionError(f"config2 frame {i}: stats differ {a.stats} vs {b.stats}")
    log(f"config2: the {len(cams)} pallas_smem frames equal the auto frames (color, depth, stats)")
    del runs

    # config1: the flat cube through brute force (no kernel)
    p, _, scene = _setup(dev, _preset("config1"), 512, 512, 0.0)
    cams = [p.animate(0.1 * (i + 1))[0] for i in range(10)]
    times, frames, launches = _run_frames(dev, scene, p.config, cams)
    if any(launches.values()):
        raise AssertionError(f"config1: brute force launched {launches}")
    _coverage_between(frames, 0.02, 0.9)
    _log_run("config1 (brute force)", p.config, scene.mesh.num_triangles, times, launches)
    return total


def main() -> int:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    import xr_torch  # noqa: F401  (TF32 off)

    phase_build()
    kv = phase_kernel_vs_plain(dev)
    phase_golden(dev)
    launches = phase_main_path(dev)
    log(smi)
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": SOURCES[name][0],
        "replaces": SOURCES[name][1],
        "launches": launches[name],
        "max_abs_err": kv[name]["max_abs_err"],
        "ms": kv[name]["ms"],
        "plain_ms": kv[name]["plain_ms"],
    } for name in ("vis_stream", "vis_lists")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
