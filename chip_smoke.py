"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no final line):
  1. device: a CUDA card is required; prints nvidia-smi's name and power limit
     and reads the SM clock the integer bound is taken at
  2. build: compiles the CUDA kernels from xr_torch/csrc/ (nvcc, one process
     per source, started together) and prints ptxas's registers and spill
     stores of each fold kernel (the ungated B1 and B2, the gated B1 with
     and without z_chunk_gate) and of the two blend kernels (the slot table
     and the composite), none of which may spill
     native: the host codec (xr_torch/native, g++ into build/) must build;
     the courtyard's OBJ parsed natively and by Python gives equal arrays,
     a 1920x1080 PNG written natively and by Python decodes to the same
     bytes; each one's seconds
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
     masked out); the stream kernel on config6's two full passes (the
     loaded courtyard, 96,456 triangles: the 1024x1024 shadow pass and the
     1920x1080 camera pass) and on config5's full 1920x1080 frame
     (1,003,008 triangles in) at t = 3.0 as the preset sets it (z_earlyout
     on: the gated kernel, vis_stream_zgate), under z_band_gate and under
     z_chunk_gate, and with the flag off, which must all give the same bits
     (the plain fold over 431,358 record slots is compared once and timed
     by that one call if it takes over 5 s); the stream kernel on config7's
     full frame (177,920 triangles, every capacity measured by its dry pass
     on the card, z_earlyout on) at t = 13 and 26; the gated stream kernel
     on the stacked planes of xr_torch/tools/layers.py at 1920x1080 (16
     planes of config3's triangle count, each covering the frame): ids
     front to back (layers16, also under z_chunk_gate), back to front
     (layers16_rev) and back to front under bin_zorder; the stream kernel on
     config5's full frame in the coordinates of each band of its preset's
     four (y_offset 0, 288, 576 and 864 of 1080 rows padded to 1152: the
     records of the top of the frame lie far above the bottom band's first
     row); every gated launch against the reference's serial gate in plain
     PyTorch (records.fold_plain_gated, whose skip counts it prints) and
     against the ungated kernel on the same inputs, then GATE_STRESS more
     launches in a row each held against the ungated kernel's bits on the
     device (the merge order and the bounds the chunks share vary from
     launch to launch; a launch that differs fails the phase), and timed in
     turns with the ungated kernel (3 rounds); and both
     kernels on config4's camera pass in band 1 of 2 (y_offset 576), each
     timed; both kernels on config3 at golden size and in full under
     bin_zorder, bin_pairs=2 and bin_pairs=2 with a quad budget of 2 (which
     must send quads to the large bucket), with the depth test and in
     painter's order, and the stream kernel under bin_zorder + z_earlyout
     (gated), each also bit-exact against the option-free output;
     times both kernels and their plain versions on the full frames,
     beside the bound of each launch (the bytes and the integer operations
     no exact design avoids, _vis_work), and holds the output of the launch
     after the 50 timed ones against the plain version and against the
     first launch's
     gate probe: xr_torch.tools.sweep_visibility rebuilds the kernels with
     the gate's counters (-DXR_GATE_COUNTS) in a process of its own and
     prints the card's skip share of one launch on config5 (t = 3.0, also
     under z_chunk_gate and bin_zorder, and in each of its four bands),
     config7 (t = 13 and 26), config3 under bin_zorder + z_earlyout and the
     stacked-plane cases, beside the plain serial gate's; config5's must be
     above 0, layers16's above one half, and under z_chunk_gate the staging
     must drop records of layers16
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
     config3, config4 and config4b (two passes), config5 (a 64x64 terrain,
     num_shards 1, the golden's own override), config6 and config6cap (two
     passes) and config7 (n0=64, its config sized on the card, which must equal the one sized on the
     CPU) at golden size through Renderer on the card against tests/goldens/
     (<= 1 LSB; config4/4b/6/6cap at most max(2, 0.1 %) pixels past it, the
     shadow-edge rule of tests/test_goldens.py), coverage within 1e-6; the
     checked frame is each Renderer's second step (the first captures)
  6. main path, each run with the launch counts set to 0 just before it
     and read just after, one warm-up frame first (Renderer's capture); a
     replayed graph calls no launch wrapper and counts the visibility
     kernels the driver's graph holds (xr_torch.kernels.graph_launches):
     - config3 at 1920x1080 (100,352 triangles), 30 frames through
       Renderer.step + readback; the stream kernel in every frame; then the
       same cameras under bin_zorder + z_earlyout (the gated kernel) and
       under bin_pairs=2,
       byte-equal to those frames; then the app layer: 10 frames with
       debug_checks (every nf_* 0, beside 10 without), a NaN vertex through
       the stream kernel (no fault, strict readback names the input stage),
       a shade_hook reading frag.depth, and 10 frames with
       recycle_framebuffers=False equal to the recycled ones
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
       config4's cameras: no blend overflow, config4's depth, other colors,
       the blend kernels (blend_slots, blend_composite) once a frame; the
       blend stage's device time beside that of the composite that ran all
       its chunks (127.686 ms, another call; PERF.md), and the live chunks
       of each frame (ceil(count / blend_chunk)); then at five of the
       benchmark cell's t the slot-table kernel against its plain version
       (blend.live_slots_plain: meta vector, ids, chunk boxes and rows, bit
       for bit), and the blend kernel, in place on a copy, against its
       plain version (blend.blend_composite_plain, the cropped torch
       composite: each live chunk on its live slots over its screen box)
       and the whole-frame composite on all slots
       (blend.composite_whole_frame), unbanded and in each of 4 bands: the
       same f32 bytes, and every pixel no fragment lands on with its input
       bits, else the phase fails; each frame's live slots and box share,
       the composites' device ms and memory and the slot tables' device
       ms, in turns, beside the card's name and power limit
     - config6 (the courtyard loaded from its OBJ, MTL and PNG files, Phong
       with a 1024x1024 shadow map, a ragged texture pyramid, one clamped
       map) at 1920x1080, 30 frames, the stream kernel twice a frame; then
       config6cap (the texture-area cap) on the same cameras: config6's
       depth and stats, other colors at some pixels
     - config4 (both backends) in two screen bands and config4b in four
       (xr_torch.dist.shard.ShardedRenderer, every band on this card), 5 of
       those cameras each: byte-equal to the unbanded frames, the kernel
       once for the shadow map and once a band
     - config5 (1,003,008 triangles: a 708x708 terrain and 40 boxes) at
       1920x1080 through Renderer, unbanded, 10 frames at t = 1.0 ... 10.0
       of its frozen camera path, the gated stream kernel (z_earlyout:
       vis_stream_zgate) once a frame, every overflow counter 0; then in
       its preset's four bands through ShardedRenderer on this card on the
       same cameras: the gated kernel four times a frame, every counter 0, tris_setup, color and depth
       those of the unbanded frames; prints the peak device memory of
       each, each stage's device ms a frame of the graphed banded and
       unbanded frames (a torch.profiler trace of 5 frames each, read by
       span as the benchmark reads a cell) and the ms/frame of the two,
       unbanded and banded (graphed) in turns; then the unbanded frames with
       z_earlyout on (the gated kernel) and off (the ungated one) in turns,
       byte-equal, 3 rounds of 5 frames
     - config7 (177,920 triangles, the LOD terrain) at 1920x1080, 30 frames
       at t = 1.3 ... 39 of its camera path, the gated kernel once a frame,
       every overflow counter 0; prints tris_setup beside the record
       capacity its dry pass measured and the peak device memory; then
       z_earlyout on and off in turns, as config5's
     - one config3 frame and one banded config5 frame through present() +
       flush() (the host copy started when the frame is queued, into pinned
       memory) against step() + readback(): the same bytes
     - graphs: Renderer.step replays the frame it captured at its first
       step (one CUDA graph a stage span, config4b's blend included: no
       segment may run eagerly):
       the six benchmark cells' presets as published at 1920x1080 (the
       present cell through present() + flush()), GRAPH_FRAMES t of each
       cell's seed-0 path, against render_step's eager frames of the same
       cameras: color, depth and stats byte-equal and the same kernel
       launches a frame, else the phase fails; the
       capture's seconds, the graphs a frame and the peak device memory;
       then eager and graphed in turns, 3 rounds: host ms in the step call
       and ms a frame; then config3 with backend="jnp" at its own
       bin_capacity (3 t) the same way: its plain lists' fold loops as far
       as the data goes in an eager frame, to the capacity in a captured one;
       then ShardedRenderer.step, which replays the banded frame it
       captured at its first step (each kind of band work one graph),
       against render_step_sharded's eager frames the same way, and
       holding the unbanded Renderer's bytes: config5 in its preset's four
       bands, config4b in four, config4 in two with backend "auto" and
       "pallas_smem", and config4 in two with "jnp" (3 t: the fold to the
       capacity once a band); also the eager frames' peak memory
     - the gather microbenchmarks: xr_torch.tools.probe_lanegather and
       xr_torch.tools.microbench_gather, as run from the command line
     prints ms/frame of each and the device time of each stage, timed on
     the stage functions render_step calls
     oracle: one frame of each of config1 (512x512), config2 (pallas_smem:
     the list kernel), config3, config4, config4b, config6, config7 and
     config5 (unbanded, and in its preset's four bands) at 1920x1080,
     rendered on the card through Renderer.step + readback (B1, or B2 for
     config2) and by the port's CPU oracle (xr_torch.cpu_ref, no binning,
     records or kernel), at the t of the path's first frame above; held to
     the device-vs-oracle rule (tests/test_tpu_device_frames.py:51-86):
     coverage and stats equal, color within 1 LSB outside the oracle's
     shadow-flip risk set (at most npix / 1000 pixels, npix / 500 on
     config6 as the reference's config6 device test allows, none past 180
     LSB), depth within 1e-6 but at 0.1 % of the pixels and within 1e-5
     there; prints the oracle's seconds and the CPU's name
  7. entry points, each as a user runs it, in a process of its own:
     ``python -m xr_torch.examples.run config5 --frames 5`` (the preset's
     four bands on the card, graphed; exit 0, every counter 0 in its done
     event; prints its ms a frame)
     and ``python -m xr_torch.tools.profile_frame config3 --frames 8``
     (its device ms/frame from the torch.profiler trace, its host ms/frame
     of the same frames and their ratio, the device's busy share);
     ``python -m xr_torch.examples.run config1 --oracle --frames 2`` (exit
     0, a done event on the CPU) and ``python -m
     xr_torch.tools.regen_goldens build/goldens`` (every golden within
     1 LSB of tests/goldens, the shadow-edge rule for config4/4b/6/6cap)
  8. benchmark: ``python -m bench_torch --frames 8`` in a process of its own:
     the port's benchmark, its six cells at 8 timed frames each, every cell
     held to the benchmark's numpy reference (bench_torch/reference.py;
     the present cell's presented frame too, and its bytes to
     readback()'s); fails unless every cell is correct; prints the cells' lines, and the kernel
     launches of their timed frames count with the main path's
The line before the last is a JSON object with the kernels' numbers; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import platform
import re
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
BIN_OPTIONS = {
    "bin_zorder": {"bin_zorder": True},
    "bin_pairs=2": {"bin_pairs": 2},
    "bin_pairs=2 quad 2": {"bin_pairs": 2, "bin_quad_capacity": 2},
}
SOURCES = {
    "vis_stream": ("xr_torch/csrc/vis_stream.cu", "xr/raster/pallas_stream.py:80"),
    # no Pallas kernel: the reference's blend composite, an XLA stage, and
    # its source order and record gathers
    "blend_composite": ("xr_torch/csrc/blend.cu", "xr/shading/blend.py:95"),
    "blend_slots": ("xr_torch/csrc/blend.cu", "xr/shading/blend.py:76"),
    # B1 under z_earlyout: the gates of the record loop (B3) on the card
    "vis_stream_zgate": ("xr_torch/csrc/vis_stream.cu", "xr/raster/pallas_smem.py:138"),
    "vis_lists": ("xr_torch/csrc/vis_lists.cu", "xr/raster/pallas_smem.py:346"),
    "lane_gather": ("xr_torch/csrc/gather.cu", "tools/probe_lanegather.py:26"),
    "quad_gather": ("xr_torch/csrc/gather.cu", "tools/microbench_gather.py:108"),
    "quad_gather1": ("xr_torch/csrc/gather.cu", "tools/microbench_gather.py:133"),
}
KERNELS = tuple(SOURCES)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores (NVIDIA's data sheet)
# f32 operations of one shaded transparent fragment of config4b in
# csrc/blend.cu (Phong, two directional and two point lights, the shadow
# test, no texture): barycentrics and depth 9, 1/w and 8 attributes 55, the
# normal 10, base 3, the shadow test 43, the view vector 13, ambient 6, the
# lights 259, the composite 10
PHONG_FRAGMENT_OPS = 408
INT32_LANES = 132 * 64  # SMs x INT32 lanes per SM
EDGE_OPS = 6  # per pixel of a record's bbox: three edge functions of two multiply-adds
DECODE_OPS = 8  # per (tile, record) pair: unpacking the bbox and the tie offsets
GATE_STRESS = 1000  # launches of the gated kernel a path, each held against the ungated one
BENCH_FRAMES = 8  # timed frames a cell in the benchmark phase
GRAPH_FRAMES = 8  # t a cell in the phase of graphed against eager frames


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


SHADOW_EDGE = ("config4", "config4b", "config6", "config6cap")  # tests/test_goldens.py:51-56


@functools.lru_cache(maxsize=None)
def _preset(name: str, full: bool = False):
    """The presets as published, host side (built once a run); config3's
    terrain is 48x48 quads at golden size and 224x224 (100,352 triangles)
    in full, config5's 64x64 and 708x708 (1,003,008 triangles with its
    boxes) with its preset's num_shards=4 (Renderer ignores it; the golden
    overrides it to 1); config7's LOD terrain is n0=64 at golden size and n0=160 (177,920
    triangles) in full."""
    from xr_torch.scene import presets

    if name == "config3":
        n = 224 if full else 48
        return presets.config3_terrain(n, n)
    if name == "config5":
        n = 708 if full else 64
        return presets.config5_flythrough(n, n)
    if name == "config7":  # capacities measured by its dry pass on the card
        return presets.config7_terrain_lod(160 if full else 64, device="cuda")
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


def _b1(cfg) -> str:
    """The name B1's launches count under: the gated variant under the z
    gate (z_earlyout with the depth test)."""
    from xr_torch.raster import stream

    return "vis_stream_zgate" if stream.gated(cfg) else "vis_stream"


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
    """Build the kernels with ptxas's report; every fold kernel must keep
    its registers without a spill."""
    import contextlib
    import io

    from xr_torch import kernels
    from xr_torch.tools.sweep_visibility import fold_kernels

    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        path = kernels.build(verbose=True)
    kernels.library()
    log(f"build: {path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {kernels.build_seconds if kernels.build_seconds is not None else 0.0:.2f} s)")
    if kernels.build_seconds is not None:  # this process compiled: ptxas reported
        folds = fold_kernels(out.getvalue())
        log(f"build: ptxas, fold kernels (walk, gate): {folds}")
        if len(folds) != 4 or any(v["spill_bytes"] for v in folds.values()):
            raise AssertionError(f"build: a fold kernel spills or is missing: {folds}")
        for key in ("blend_slots", "blend_composite"):
            usage = kernels.ptxas_usage(out.getvalue(), key)
            if usage is None or usage["spill_bytes"]:
                raise AssertionError(f"build: the {key} kernel spills or is missing: {usage}")
            log(f"build: ptxas, {kernels.KERNEL_NAMES[key][0]}: {usage['registers']} "
                f"registers, {usage['spill_bytes']} bytes of spill stores")


def phase_native() -> None:
    """The native host codec (xr_torch.native): its g++ build must succeed
    here (a library user falls back to Python; this run does not), the
    courtyard's OBJ parses natively to the Python parser's arrays, and a
    1920x1080 PNG written natively decodes to the bytes the Python encoder
    writes."""
    from xr_torch.core import image
    from xr_torch.native import api
    from xr_torch.scene import objio

    t0 = time.perf_counter()
    if not api.available():
        raise AssertionError(f"native: g++ could not build {api.SRC} (zlib needed)")
    log(f"native: {api.LIB.name} built and loaded in {time.perf_counter() - t0:.2f} s")
    path = os.path.join(ROOT, "assets", "courtyard", "courtyard.obj")
    t0 = time.perf_counter()
    nat = api.parse_obj(path)
    t_nat = time.perf_counter() - t0
    py = objio._python_parse(path)
    t_py = time.perf_counter() - t0 - t_nat
    keys = ("positions", "normals", "uvs", "indices", "face_mat")
    if nat["materials"] != py["materials"] or not all(
            nat[k].dtype == py[k].dtype and np.array_equal(nat[k], py[k]) for k in keys):
        raise AssertionError("native: the courtyard's native parse differs from Python's")
    log(f"native: courtyard.obj ({nat['indices'].shape[0]} triangles) parsed natively in "
        f"{t_nat:.3f} s, by Python in {t_py:.3f} s: equal arrays")
    img = np.random.default_rng(0).integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    out = os.path.join(ROOT, "build", "chip_smoke_native")
    os.makedirs(out, exist_ok=True)
    a, b = os.path.join(out, "native.png"), os.path.join(out, "python.png")
    t0 = time.perf_counter()
    if not api.write_png(a, img):
        raise AssertionError("native: write_png failed")
    t_nat = time.perf_counter() - t0
    image._write_png_python(b, img)
    t_py = time.perf_counter() - t0 - t_nat
    da, db = image.read_png(a), image.read_png(b)
    if not (np.array_equal(da, db) and np.array_equal(da, img)):
        raise AssertionError("native: the native PNG does not decode to the Python PNG's bytes")
    log(f"native: a 1920x1080 PNG written natively in {t_nat:.3f} s, by Python in "
        f"{t_py:.3f} s: both decode to the same bytes")


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


def _gate_stress(label, launch, inp, cfg, want) -> None:
    """GATE_STRESS launches of the gated kernel in a row, each held against
    the ungated kernel's bits (want) on the device, with one read at the
    end; raises if any launch differs."""
    wt, wz = want[0], want[1].view(torch.int32)
    bad = torch.zeros((), dtype=torch.int32, device=wt.device)
    for _ in range(GATE_STRESS):
        t, z = launch(inp, cfg)
        bad += ((t != wt).any() | (z.view(torch.int32) != wz).any()).to(torch.int32)
    n = int(bad)
    if n:
        raise AssertionError(f"{label}: {n} of {GATE_STRESS} launches in a row differ from the "
                             "ungated kernel")
    log(f"gate stress {label}: {GATE_STRESS} launches in a row, each the ungated kernel's bits")


def _compare_kernel(dev, kernel, cfg, scene, view_proj, name, time_it=False, clock_hz=None,
                    geom_cfg=None, y_offset=0):
    """The kernel and its plain version on the records the frame's
    visibility sees (renderer.visible_triangles: under blend, the opaque
    ones). A screen band: geometry of the full frame (geom_cfg), the
    kernel on the band's config cfg at y_offset."""
    from xr_torch.app.renderer import visible_triangles
    from xr_torch.pipeline.geometry import clip_capacity
    from xr_torch.tools import timing

    from xr_torch.raster import stream

    prepare, launch, plain = _kernel_fns(kernel)
    geom_cfg = geom_cfg or cfg
    _, tri = visible_triangles(scene, *view_proj, geom_cfg,
                               clip_capacity(scene.mesh.num_triangles, geom_cfg))
    inp = prepare(tri, cfg, y_offset)
    gated = kernel == "vis_stream" and stream.gated(cfg)
    tk, zk = launch(inp, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if gated:  # the reference's serial gate, and what it skipped
        tp, zp, skips = stream.vis_stream_plain_gated(inp, cfg)
    else:
        tp, zp = plain(inp, cfg)
    torch.cuda.synchronize()
    plain_once_ms = (time.perf_counter() - t0) * 1e3
    label = (f"{_b1(cfg) if kernel == 'vis_stream' else kernel} [{name}] "
             f"{cfg.width}x{cfg.height} tiles {cfg.tile_h}x{cfg.tile_w}")
    _same_vis(label, "the plain version", (tk, zk), (tp, zp))
    # the merge order varies from launch to launch; the output must not
    _same_vis(label, "the first launch", launch(inp, cfg), (tk, zk))
    if gated:  # the gate skips only what cannot win: the ungated kernel's bits
        ungated = dataclasses.replace(cfg, z_earlyout=False, z_band_gate=False,
                                      z_chunk_gate=False)
        _same_vis(label, "the ungated kernel", launch(inp, ungated), (tk, zk))
        _gate_stress(label, launch, inp, cfg, (tk, zk))
    fin = torch.isfinite(zp)
    err = float((zk[fin] - zp[fin]).abs().max()) if bool(fin.any()) else 0.0
    bg = int((tk == 2**31 - 1).sum())
    line = (f"kernel vs plain {label}: tid and z bit-exact, "
            f"large_count={int(inp.large_count)} dropped={int(inp.dropped)} "
            f"bg_pixels={bg} records={int(tri.count)}")
    chunks = inp.item_start[1:] - inp.item_start[:-1]
    out = {"max_abs_err": err, "large_count": int(inp.large_count),
           "dropped": int(inp.dropped), "bg": bg, "max_chunks": int(chunks.max()),
           "one_chunk_tiles": int((chunks == 1).sum()), "vis": (tk, zk)}
    line += f" chunks={int(chunks.sum())} (most in a tile {out['max_chunks']})"
    if gated:
        share = (skips["record"] + skips["chunk"]) / max(skips["walked"], 1)
        out["plain_skips"] = dict(skips, skip_share=share)
        line += (f"; the same bits as the ungated kernel; the reference's serial gate "
                 f"(plain) skips {skips['record']} records by z_min, {skips['chunk']} in "
                 f"chunks, {skips['band']} (record, band) pairs, of {skips['walked']} "
                 f"walked: skip share {share!r}")
    if y_offset:
        by0 = (inp.rec[:, 16] & 0xFFFF) - 32768
        line += (f"; band at y_offset {y_offset}, records from local y "
                 f"{int(by0[tri.valid].min())} subpixels")
    if time_it and gated:
        # gated and ungated in turns, 3 rounds of 50 launches each queued
        # behind ~20 ms of spinning: device time
        turns = {"ms": [], "ungated_ms": []}
        for k in ("ms", "ungated_ms") * 3:
            c = cfg if k == "ms" else ungated
            turns[k].append(timing.device_ms(lambda: launch(inp, c), reps=50, warmup=2)[0])
        out.update({k: float(np.mean(v)) for k, v in turns.items()})
        line += f"; in turns gated {turns['ms']!r} ms, ungated {turns['ungated_ms']!r} ms"
    elif time_it:
        # 50 launches queued behind ~20 ms of spinning: device time
        out["ms"] = timing.device_ms(lambda: launch(inp, cfg), reps=50, warmup=2)[0]
    if time_it:
        # after 50 launches in a row the scratch must still be the kernel's own
        _same_vis(label, "the plain version, after the timed launches", launch(inp, cfg),
                  (tp, zp))
        # a plain fold of seconds is not run six more times: its one call counts
        once = plain_once_ms > 5e3
        out["plain_ms"] = plain_once_ms if once else cuda_ms(lambda: plain(inp, cfg), reps=5,
                                                            warmup=1)
        pairs, pixels, nbytes = _vis_work(kernel, inp, cfg)
        out.update(_bound(nbytes, pixels * EDGE_OPS + pairs * DECODE_OPS,
                          INT32_LANES * clock_hz))
        out.update(pairs=pairs, bbox_pixels=pixels, bytes=nbytes)
        line += (f"; kernel {out['ms']!r} ms, plain {out['plain_ms']!r} ms"
                 f"{' (the one compared call, host clock)' if once else ''}, bound "
                 f"{out['bound_ms']!r} ms by {out['bound_by']} ({pairs} (tile, record) "
                 f"pairs, {pixels} bbox pixels, {nbytes} bytes)")
    log(line)
    return out


def phase_kernel_vs_plain(dev, clock_hz) -> dict:
    from xr_torch import convert
    from xr_torch.app.renderer import shadow_config
    from xr_torch.dist import shard
    from xr_torch.pipeline.shadow import light_matrices_for_scene
    from xr_torch.tools import layers

    errs = {"vis_stream": [], "vis_stream_zgate": [], "vis_lists": []}

    def run(kernel, p, cfg_over, scene, cam, name, time_it=False, cfg=None, view_proj=None,
            geom_cfg=None, y_offset=0):
        cfg = cfg or dataclasses.replace(p.config, **cfg_over)
        view_proj = view_proj or _view_proj(dev, cam, geom_cfg or cfg)
        r = _compare_kernel(dev, kernel, cfg, scene, view_proj, name, time_it, clock_hz,
                            geom_cfg, y_offset)
        errs[_b1(cfg) if kernel == "vis_stream" else kernel].append(r["max_abs_err"])
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
    # config4's camera pass in band 1 of 2: rows 576-1151 of 1152
    p, cam, scene = _setup(dev, _preset("config4"), 1920, 1080, 0.3)
    _, hb, band = shard.band_config(p.config, 2)
    for kernel in ("vis_stream", "vis_lists"):
        r = run(kernel, p, {}, scene, cam, "config4 camera pass band 1 of 2", time_it=True,
                cfg=band, geom_cfg=p.config, y_offset=hb)
        if r["dropped"] or r["bg"] == band.width * band.height:
            raise AssertionError(f"config4 band 1 of 2: {r}")

    # config6: the loaded courtyard's two passes (32x128 tiles, large bucket
    # 4096) through the stream kernel
    p, cam, scene = _setup(dev, _preset("config6"), 1920, 1080, 0.3)
    light = tuple(convert.tensor(m, dev) for m in light_matrices_for_scene(scene))
    for label, cfg, view_proj in (("config6 shadow pass", shadow_config(p.config), light),
                                  ("config6 camera pass", p.config, None)):
        r = run("vis_stream", p, {}, scene, cam, label, time_it=True, cfg=cfg, view_proj=view_proj)
        if r["dropped"] or r["bg"] == cfg.width * cfg.height:
            raise AssertionError(f"{label}: {r}")

    # config5: the deep scene's full frame, 431,358 record slots; as the
    # preset sets it (z_earlyout on: the gated kernel against the
    # reference's serial gate and the ungated kernel, timed in turns with
    # it), under each refinement of the gate, and with the flag off: the
    # same bits
    p, cam, scene = _setup(dev, _preset("config5", full=True), 1920, 1080, 3.0)
    if scene.mesh.num_triangles != 1_003_008 or not p.config.z_earlyout:
        raise AssertionError("config5 must have 1,003,008 triangles and set z_earlyout")
    r = run("vis_stream", p, {}, scene, cam, "full config5 z_earlyout", time_it=True)
    out[("vis_stream_zgate", "config5")] = r
    rs = [r, run("vis_stream", p, {"z_earlyout": False}, scene, cam, "full config5 no z_earlyout")]
    for gate in ("z_band_gate", "z_chunk_gate"):
        rs.append(run("vis_stream", p, {gate: True}, scene, cam, f"full config5 {gate}"))
        _same_vis(f"full config5 {gate}", "z_earlyout alone", rs[-1]["vis"], r["vis"])
    for x in rs:
        if x["dropped"] or x["bg"] != r["bg"]:
            raise AssertionError(f"full config5: {x}")
    # config5 in its preset's four bands: y_offset 0, 288, 576, 864
    n = p.config.num_shards
    _, hb, band = shard.band_config(p.config, n)
    for b in range(n):
        r = run("vis_stream", p, {}, scene, cam, f"full config5 band {b} of {n}", time_it=True,
                cfg=band, geom_cfg=p.config, y_offset=b * hb)
        if r["dropped"] or r["bg"] == band.width * band.height:
            raise AssertionError(f"config5 band {b}: {r}")
    del scene

    # config7: the LOD terrain's full frame (177,920 triangles) as its
    # preset sizes it, every capacity measured, z_earlyout on, at two of the
    # sample times of its dry pass
    for t in (13.0, 26.0):
        p, cam, scene = _setup(dev, _preset("config7", full=True), 1920, 1080, t)
        r = run("vis_stream", p, {}, scene, cam, f"full config7 t={t}", time_it=True)
        if r["dropped"] or not p.config.z_earlyout or r["bg"] == 1920 * 1080:
            raise AssertionError(f"full config7 t={t}: {r}")
    del scene

    # the stacked planes of xr_torch/tools/layers.py at 1920x1080 (16
    # planes, every one covering the frame: depth complexity 16): ids front
    # to back (also under z_chunk_gate, whose staging drops records there),
    # back to front, and back to front sorted again by bin_zorder
    for name, reverse, over in (("layers16", False, {}),
                                ("layers16 z_chunk_gate", False, {"z_chunk_gate": True}),
                                ("layers16_rev", True, {}),
                                ("layers16_rev bin_zorder", True, {"bin_zorder": True})):
        p = layers.layers16(reverse)
        cam, mm = p.animate(0.0)
        scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), dev)
        r = run("vis_stream", p, over, scene, cam, f"full {name}", time_it=True)
        if r["dropped"] or r["bg"] or not p.config.z_earlyout:
            raise AssertionError(f"full {name}: {r}")
    del scene

    # the bin options on config3 at golden size and in full: segments out
    # of id order (bin_zorder) and walks that hold an id twice (bin_pairs=2,
    # whose 2x2-spanning triangles past a quad budget of 2 also ride the
    # large bucket); each against its plain version and the option-free
    # output, with the depth test and in painter's order
    m = _manifest("config3")
    for label, (p, cam, scene) in (
            ("golden", _setup(dev, _preset("config3"), m["width"], m["height"], m["t"],
                              **m["overrides"])),
            ("full", _setup(dev, _preset("config3", full=True), 1920, 1080, 0.3))):
        for kernel in ("vis_stream", "vis_lists"):
            for depth_test in (True, False):
                mode = "depth" if depth_test else "painter"
                base = run(kernel, p, {"depth_test": depth_test}, scene, cam,
                           f"config3 {label} {mode}")
                options = dict(BIN_OPTIONS)
                if kernel == "vis_stream" and depth_test:  # the gated kernel on sorted segments
                    options["bin_zorder+z_earlyout"] = {"bin_zorder": True, "z_earlyout": True}
                for opt, over in options.items():
                    r = run(kernel, p, {"depth_test": depth_test, **over}, scene, cam,
                            f"config3 {label} {mode} {opt}",
                            time_it=label == "full" and opt == "bin_zorder+z_earlyout")
                    what = f"{kernel} config3 {label} {mode} {opt}"
                    _same_vis(what, "the option-free output", r["vis"], base["vis"])
                    if r["dropped"] or base["dropped"]:
                        raise AssertionError(f"{what}: dropped {r['dropped']}")
                    if opt.endswith("quad 2") and not r["large_count"] > base["large_count"]:
                        raise AssertionError(f"{what}: no quad rode the large bucket: {r}")
    del scene

    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "pairs", "bbox_pixels", "bytes")
    return {
        "vis_stream": {"max_abs_err": max(errs["vis_stream"]), "library_ms": None,
                       **{k: out[("vis_stream", "config3")][k] for k in fields}},
        # config5's full frame, gated; ungated_ms: the ungated kernel in turns
        "vis_stream_zgate": {"max_abs_err": max(errs["vis_stream_zgate"]), "library_ms": None,
                             **{k: out[("vis_stream_zgate", "config5")][k]
                                for k in fields + ("ungated_ms",)}},
        "vis_lists": {"max_abs_err": max(errs["vis_lists"]), "library_ms": None,
                      **{k: out[("vis_lists", "config2")][k] for k in fields}},
    }


def phase_gate_probe() -> None:
    """The card's skip share: xr_torch.tools.sweep_visibility rebuilds the
    kernels with the gate's counters (-DXR_GATE_COUNTS, into its own
    library) in a process of its own and counts, in one launch on each
    gated 1080p frame, the (record, warp) pairs that meet a footprint
    inside the frame and those the gate skipped; printed beside the share
    of records the reference's serial gate skips (plain). config5's must be
    above 0 and layers16's above one half, and under z_chunk_gate the
    staging must drop records of layers16 (on config5 it drops none: its
    warps start from +inf)."""
    spec = "512,128,2,gatecounts"
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "xr_torch.tools.sweep_visibility", spec],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise AssertionError(f"gate probe failed:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    row = json.loads(res.stdout.strip().splitlines()[-1])
    for label, cell in row.items():
        if not isinstance(cell, dict) or "card" not in cell:
            continue
        card, plain = cell["card"], cell["plain_serial_gate"]
        if not (cell["exact"] and cell["exact_vs_ungated"]):
            raise AssertionError(f"gate probe {label}: the probe build is not exact: {cell}")
        log(f"gate probe {label} (build {row['build']}): card skip share {card['skip_share']!r} "
            f"({card['skipped_in_walk']} (record, warp) pairs skipped in the walk, "
            f"{card['dropped_at_staging']} dropped at staging, of {card['pairs']} in the "
            f"frame; {card['bounded_starts']} of {card['warp_starts']} warps of shared tiles "
            f"started bounded); the reference's serial gate (plain) {plain['skip_share']!r} "
            f"of {plain['walked']} records; probe build {cell['ms']!r} ms, ungated "
            f"{cell['ungated_ms']!r} ms")
    share = row["vis_stream config5"]["card"]["skip_share"]
    if not share > 0:
        raise AssertionError(f"gate probe: the gate skips nothing on config5 ({share})")
    share = row["vis_stream layers16"]["card"]["skip_share"]
    if not share > 0.5:
        raise AssertionError(f"gate probe: the gate skips half or less of layers16 ({share})")
    dropped = row["vis_stream layers16 z_chunk_gate=True"]["card"]["dropped_at_staging"]
    if not dropped > 0:
        raise AssertionError("gate probe: z_chunk_gate's staging drops nothing of layers16")
    log(f"gate probe: {time.perf_counter() - t0:.1f} s with its build; fold kernels "
        f"{row['fold_kernels']}")


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
    from xr_torch import Renderer
    from xr_torch.core.image import read_png

    from xr_torch.scene import presets

    # config7's dry pass on the card measures what it measures on the CPU
    card, cpu = _preset("config7").config, presets.config7_terrain_lod(64, device="cpu").config
    if card != cpu:
        raise AssertionError(f"config7 sized on the card {card} differs from the CPU's {cpu}")
    log(f"config7 n0=64: the config sized on the card equals the CPU's "
        f"(clip_expand {card.clip_expand!r}, bin_capacity {card.bin_capacity}, "
        f"stream_entry_cap {card.stream_entry_cap})")
    for name in ("config1", "config2", "config3", "config4", "config4b", "config5", "config6",
                 "config6cap", "config7"):
        m = _manifest(name)
        p, cam, scene = _setup(dev, _preset(name), m["width"], m["height"], m["t"],
                               **m["overrides"])
        r = Renderer(scene, p.config, dev)
        r.step(scene, cam)  # the capture
        frame, launched = _counted(lambda: r.readback(r.step(scene, cam)))
        golden = read_png(os.path.join(ROOT, "tests", "goldens", f"{name}.png"))
        diff = np.abs(frame.color.astype(int) - golden.astype(int))
        bad = int((diff.max(axis=-1) > 1).sum())
        cov = float((frame.depth < 1.0).mean())
        # shadow edges: tests/test_goldens.py allows max(2, 0.1 %) pixels
        npix = m["width"] * m["height"]
        allowed = max(2, int(npix * 0.001)) if name in SHADOW_EDGE else 0
        log(f"golden {name} {m['width']}x{m['height']}: {bad} px > 1 LSB (allowed {allowed}, "
            f"max {diff.max()}), coverage {cov!r} vs {m['coverage']!r}; launches {launched}")
        if bad > allowed or abs(cov - m["coverage"]) >= 1e-6:
            raise AssertionError(f"golden mismatch: {name}")
        # config1 renders by brute force (no kernel); the others stream,
        # the shadow-mapped ones twice (the shadow map, then the frame);
        # config4b's blend kernels once each
        want = 0 if name == "config1" else 2 if name in SHADOW_EDGE else 1
        blends = int(p.config.blend)
        if (launched[_b1(p.config)] != want or launched["blend_composite"] != blends
                or launched["blend_slots"] != blends
                or sum(launched.values()) != want + 2 * blends):
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


def _counted(fn):
    """fn() with the launch counts set to 0 just before it and read just
    after (kernels.launches: a wrapper's launches, and each replayed graph's
    visibility kernels as the driver's graph holds them); returns (fn's
    value, the launches)."""
    from xr_torch import kernels

    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(kernels.launches)


def _run_frames(dev, scene, cfg, cams, banded=False, **renderer_kw):
    """One warm-up frame (Renderer's capture), then one frame per camera
    through Renderer.step + readback (banded: ShardedRenderer's, its
    config.num_shards bands all on dev), the launches counted over them
    (_counted). Returns (ms per frame, host frames, launches)."""
    from bench_torch.frames import failure
    from xr_torch import Renderer, ShardedRenderer

    r = (ShardedRenderer(scene, cfg, devices=[dev], **renderer_kw) if banded
         else Renderer(scene, cfg, dev, **renderer_kw))
    r.readback(r.step(scene, cams[0]))  # warm-up
    torch.cuda.synchronize()

    def run():
        times, frames = [], []
        for cam in cams:
            t0 = time.perf_counter()
            frames.append(r.readback(r.step(scene, cam)))
            times.append((time.perf_counter() - t0) * 1e3)
        return times, frames

    (times, frames), launches = _counted(run)
    for f in frames:
        reason = failure(f, cfg)
        if reason:
            raise AssertionError(f"bad frame: {reason}, {f.stats}")
    return times, frames, launches


def _log_run(label, cfg, ntris, times, launches) -> float:
    ms = float(np.mean(times))
    log(f"main path {label} {cfg.width}x{cfg.height}, {ntris} tris, {len(times)} frames "
        f"(step + readback, host clock): mean {ms:.3f} ms, median {np.median(times):.3f} ms, "
        f"min {min(times):.3f} ms, max {max(times):.3f} ms -> {1e3 / ms:.2f} fps, "
        f"{cfg.width * cfg.height / ms / 1e3:.2f} Mpix/s; launches {launches}")
    return ms


def _log_stages(label, stages, how: str = "CUDA events") -> None:
    log(f"stage device time {label} (ms, {how}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; sum {sum(stages.values()):.3f}")


def _coverage_between(frames, lo, hi) -> None:
    for f in frames:
        cov = float((f.depth < 1.0).mean())
        if not lo < cov < hi:
            raise AssertionError(f"implausible frame, coverage {cov}")


def phase_main_path(dev, smi: str):
    """Returns (the launches of each kernel, summed over the runs; the
    blend kernels' numbers, _blend_crop_check)."""
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

    # config3 under each bin option on the same cameras: the same bytes, and
    # the stage line of each (the bin+prep stage is the one they change)
    for label, over in (("bin_zorder+z_earlyout", {"bin_zorder": True, "z_earlyout": True}),
                        ("bin_pairs=2", {"bin_pairs": 2})):
        cfg = dataclasses.replace(p.config, **over)
        times, got, launches = _run_frames(dev, scene, cfg, cams)
        if launches[_b1(cfg)] < 30 or sum(launches.values()) != launches[_b1(cfg)]:
            raise AssertionError(f"config3 {label}: launches {launches} in 30 frames")
        count(launches)
        _same_frames(f"config3 {label} against config3", got, frames)
        _log_run(f"config3 {label}", cfg, scene.mesh.num_triangles, times, launches)
        _log_stages(f"config3 {label} t=0.3", _stage_times(dev, p._replace(config=cfg), cams[5],
                                                           scene))
    del got
    _bin_prep_turns(p, cams[5], scene, {"bin_zorder": {"bin_zorder": True},
                                         "bin_pairs=2": {"bin_pairs": 2}})
    for launches in _app_layer(dev, p, scene, cams, frames):
        count(launches)
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
    if (launches["vis_stream"] < 2 * len(cams) or launches["vis_lists"]
            or launches["blend_composite"] < len(cams) or launches["blend_slots"] < len(cams)):
        raise AssertionError(f"config4b: launches {launches} in {len(cams)} frames")
    for i, (f, g) in enumerate(zip(frames, runs["auto"])):
        if int(f.stats["blend_overflow"]) or not np.array_equal(f.depth, g.depth):
            raise AssertionError(f"config4b frame {i}: {f.stats}, or its depth is not config4's")
        if (f.color != g.color).any(axis=-1).mean() < 0.01:
            raise AssertionError(f"config4b frame {i}: the panes tint under 1 % of the pixels")
    count(launches)
    _log_run("config4b (blend)", p.config, scene.mesh.num_triangles, times, launches)
    stages = _stage_times(dev, p, cams[5], scene)
    _log_stages("config4b t=0.3", stages)
    log(f"config4b blend stage: {stages['blend']:.3f} ms device time at t=0.3 (the blend "
        "kernel; the composite that ran all its chunks: 127.686 ms, in another call); live "
        f"chunks per frame {_blend_chunks(p, scene, cams)} of "
        f"{-(-p.config.blend_capacity // p.config.blend_chunk)}")
    kv_blend = _blend_crop_check(dev, p, scene, smi)

    # screen bands on the shadow-mapped frames: config4 (both backends) in
    # two bands, config4b in four, every band on this card; the unbanded
    # frames of the same cameras above are the reference
    p4, _, scene4 = _setup(dev, _preset("config4"), 1920, 1080, 0.0)
    for label, pp, sc, n, backend, want in (
            ("config4 backend=auto", p4, scene4, 2, "auto", runs["auto"]),
            ("config4 backend=pallas_smem", p4, scene4, 2, "pallas_smem", runs["pallas_smem"]),
            ("config4b", p, scene, 4, p.config.backend, frames)):
        cfg = dataclasses.replace(pp.config, num_shards=n, backend=backend)
        times, got, launches = _run_frames(dev, sc, cfg, cams[:5], banded=True)
        kernel = "vis_lists" if backend == "pallas_smem" else "vis_stream"
        other = "vis_stream" if kernel == "vis_lists" else "vis_lists"
        blends = n * 5 if pp.config.blend else 0  # one a band; the slot table one a frame
        if (launches[kernel] != (1 + n) * 5 or launches[other]
                or launches["blend_composite"] != blends
                or launches["blend_slots"] != (5 if pp.config.blend else 0)):
            raise AssertionError(f"{label} in {n} bands: launches {launches} in 5 frames")
        count(launches)
        _same_bytes(f"{label} in {n} bands against unbanded", got, want[:5])
        _log_run(f"{label} in {n} bands", cfg, sc.mesh.num_triangles, times, launches)
    del runs, frames, got

    # config6: the courtyard from its files, Phong with a shadow map, a
    # ragged pyramid with one clamped map; then the texture-area cap on the
    # same cameras, which may only change colors
    runs = {}
    for name in ("config6", "config6cap"):
        p, _, scene = _setup(dev, _preset(name), 1920, 1080, 0.0)
        if scene.mesh.num_triangles != 96_456 or scene.materials.tex_addr is None:
            raise AssertionError(f"{name} must have 96,456 triangles and a clamped map")
        cams = [p.animate(0.05 * (i + 1))[0] for i in range(30)]
        times, frames, launches = _run_frames(dev, scene, p.config, cams)
        if launches["vis_stream"] != 2 * len(cams) or launches["vis_lists"]:
            raise AssertionError(f"{name}: launches {launches} in {len(cams)} frames")
        _coverage_between(frames, 0.3, 1.0)
        count(launches)
        rows = scene.textures.quads.shape[0]
        _log_run(f"{name} ({rows} quad rows)", p.config, scene.mesh.num_triangles, times, launches)
        _log_stages(f"{name} t=0.3", _stage_times(dev, p, cams[5], scene))
        runs[name] = frames
    log("frame stats (t=0.05): "
        + ", ".join(f"{k}={int(v)}" for k, v in runs["config6"][0].stats.items()))
    changed = []
    for i, (f, g) in enumerate(zip(runs["config6"], runs["config6cap"])):
        if not np.array_equal(f.depth, g.depth) or any(
                int(f.stats[k]) != int(g.stats[k]) for k in f.stats):
            raise AssertionError(f"config6cap frame {i}: depth or stats are not config6's")
        changed.append(float((f.color != g.color).any(axis=-1).mean()))
    if min(changed) <= 0.0:
        raise AssertionError("config6cap: a frame has config6's colors, the cap did nothing")
    log(f"config6cap: depth and stats are config6's in all {len(changed)} frames; the cap "
        f"changes {min(changed):.4%} to {max(changed):.4%} of the pixels")
    del runs, frames

    # config5: the deep scene along its frozen camera path, one device,
    # unbanded through Renderer (which ignores num_shards)
    p, _, scene = _setup(dev, _preset("config5", full=True), 1920, 1080, 0.0)
    cams = [p.animate(1.0 * (i + 1))[0] for i in range(10)]
    torch.cuda.reset_peak_memory_stats(dev)
    times, frames, launches = _run_frames(dev, scene, p.config, cams)
    peak = torch.cuda.max_memory_allocated(dev)
    if launches["vis_stream_zgate"] != len(cams) or sum(launches.values()) != len(cams):
        raise AssertionError(f"config5: launches {launches} in {len(cams)} frames")
    _coverage_between(frames, 0.3, 1.0)
    count(launches)
    _log_run("config5 (unbanded, t=1..10)", p.config, scene.mesh.num_triangles, times,
             launches)
    log("config5 tris_setup by frame: " + ", ".join(str(int(f.stats["tris_setup"])) for f in frames)
        + f"; record capacity {_capacity(scene, p.config)}; peak device memory "
        f"{peak / 2**20:.1f} MiB (torch.cuda.max_memory_allocated)")
    _log_stages("config5 t=3.0", _stage_times(dev, p, cams[2], scene))

    # config5 in its preset's four bands on this card: the same cameras, the
    # same bytes, the stream kernel once a band
    n = p.config.num_shards
    if n != 4:
        raise AssertionError(f"config5's preset must set num_shards=4, not {n}")
    torch.cuda.reset_peak_memory_stats(dev)
    times, got, launches = _run_frames(dev, scene, p.config, cams, banded=True)
    peak = torch.cuda.max_memory_allocated(dev)
    if launches["vis_stream_zgate"] != n * len(cams) or sum(launches.values()) != n * len(cams):
        raise AssertionError(f"config5 in {n} bands: launches {launches} in {len(cams)} frames")
    count(launches)
    _same_bytes(f"config5 in {n} bands against unbanded", got, frames)
    _log_run(f"config5 in {n} bands (ShardedRenderer, one card, t=1..10)", p.config,
             scene.mesh.num_triangles, times, launches)
    log(f"config5 in {n} bands: peak device memory {peak / 2**20:.1f} MiB "
        "(torch.cuda.max_memory_allocated)")
    for label, tr in _banded_stage_times(dev, p, cams[:5], scene).items():
        _log_stages(f"config5 {label}, graphed, t=1..5, a frame", tr["stage_ms"],
                    "torch.profiler")
        log(f"config5 {label}, graphed: device {tr['device_ms_per_frame']!r} ms a frame, "
            f"busy share {tr['busy_share']!r}, stage host ms a frame "
            + ", ".join(f"{k} {v:.3f}" for k, v in tr["stage_host_ms"].items()))
    _banded_turns(dev, p, scene, cams[:5])
    _gate_turns(dev, "config5", p, scene, cams[:5])
    del frames, got

    # config7: the LOD terrain along its camera path (t = 1.3 ... 39, the
    # span its dry pass sampled), every capacity measured, one device
    p, _, scene = _setup(dev, _preset("config7", full=True), 1920, 1080, 0.0)
    if scene.mesh.num_triangles != 177_920 or not p.config.z_earlyout:
        raise AssertionError("config7 must have 177,920 triangles and set z_earlyout")
    cams = [p.animate(1.3 * (i + 1))[0] for i in range(30)]
    torch.cuda.reset_peak_memory_stats(dev)
    times, frames, launches = _run_frames(dev, scene, p.config, cams)
    peak = torch.cuda.max_memory_allocated(dev)
    if launches["vis_stream_zgate"] != len(cams) or sum(launches.values()) != len(cams):
        raise AssertionError(f"config7: launches {launches} in {len(cams)} frames")
    _coverage_between(frames, 0.3, 1.0)
    count(launches)
    _log_run("config7 (t=1.3..39)", p.config, scene.mesh.num_triangles, times, launches)
    log("config7 tris_setup by frame: " + ", ".join(str(int(f.stats["tris_setup"])) for f in frames)
        + f"; record capacity {_capacity(scene, p.config)}; peak device memory "
        f"{peak / 2**20:.1f} MiB (torch.cuda.max_memory_allocated)")
    _log_stages("config7 t=13.0", _stage_times(dev, p, p.animate(13.0)[0], scene))
    _gate_turns(dev, "config7", p, scene, cams[9:14])
    del frames
    return total, kv_blend


def _blend_chunks(p, scene, cams) -> list:
    """The chunks the blend composite runs in each camera's frame: one per
    live chunk (ceil(count / blend_chunk)), read as the composite reads
    them (xr_torch.shading.blend.live_records)."""
    from xr_torch.app import renderer
    from xr_torch.shading import blend

    cfg, out = p.config, []
    cap = _capacity(scene, cfg)
    for cam in cams:
        _, view, proj = renderer.camera_matrices(scene, cam, cfg)
        tri, _ = renderer.visible_triangles(scene, view, proj, cfg, cap)
        out.append(len(blend.live_records(tri, scene, cfg).boxes))
    return out


BLEND_CROP_TIMES = (0.05, 3.0, 6.05, 9.0, 16.0)  # inside config4b_1080p's frames


def _blend_work(live, depth, cfg, y_offset=0) -> dict:
    """What the composite must touch over the frame's (band's) depth, the
    live slots over the union of their boxes (blend.fragment_mask): the
    transparent fragments it shades (covered, inside the depth range, in
    front of the opaque depth), the pixels a fragment lands on (their color
    read and written) and the pixels a live slot covers (their depth
    read)."""
    from xr_torch.core import fixedpoint as fp
    from xr_torch.shading import blend

    H, W = depth.shape
    boxes = live.boxes
    out = {"fragments": 0, "fragment_pixels": 0, "covered_pixels": 0}
    if not boxes:
        return out
    y0, y1 = max(min(b[0] for b in boxes), y_offset), min(max(b[1] for b in boxes), y_offset + H)
    x0, x1 = max(min(b[2] for b in boxes), 0), min(max(b[3] for b in boxes), W)
    if y0 >= y1 or x0 >= x1:
        return out
    rec = blend.unpack_slots(live.table[: live.count], cfg.attr_width)
    px = fp.pixel_center_fixed(torch.arange(x0, x1, device=depth.device), cfg.subpixel)
    py = fp.pixel_center_fixed(torch.arange(y0, y1, device=depth.device), cfg.subpixel)
    mask, _ = blend.fragment_mask(rec, px, py, depth[y0 - y_offset:y1 - y_offset, x0:x1])
    cov, _ = fp.coverage(rec.xs[:, None, None, :], rec.ys[:, None, None, :],
                         px[None, None, :], py[None, :, None])
    return {"fragments": int(mask.sum()), "fragment_pixels": int(mask.any(0).sum()),
            "covered_pixels": int(cov.any(0).sum())}


def _slots_err(got, want, cfg) -> float:
    """The largest absolute difference between two slot tables' live
    values: the meta vector, ids and chunk boxes, and each field of the
    live rows (f32 fields as floats, integer fields as integers)."""
    from xr_torch.shading import blend

    n = int(want.count)
    err = max(float((got.meta - want.meta).abs().max()),
              float((got.ids[:n] - want.ids[:n]).abs().max()) if n else 0.0,
              float((got.boxes - want.boxes).abs().max()))
    a = blend.unpack_slots(got.table[:n], cfg.attr_width)
    b = blend.unpack_slots(want.table[:n], cfg.attr_width)
    for name, _ in blend.FIELDS:
        if n:
            x, y = getattr(a, name), getattr(b, name)
            d = (x - y).abs() if x.is_floating_point() else (x.long() - y.long()).abs()
            err = max(err, float(d.max()))
    return err


def _slot_bytes(tri, slots, cfg, materials) -> tuple:
    """(bytes, f32 operations, the count in words) of the slot table's
    work: each record's valid flag and material read once, the alpha
    column, each transparent record's source id, each live record's
    fields and material row once; the live rows, ids, chunk boxes and meta
    written once. Operations: a compare a record, the six LOD terms' 36 a
    live row."""
    C, A = tri.xs.shape[0], cfg.attr_width
    n, total = int(slots.count), int(slots.total)
    width = slots.table.shape[1]
    nchunks = slots.boxes.shape[0]
    reads = C * 5 + materials * 4 + total * 4 + n * (4 * (15 + 3 * A + 1) + 4 * 11)
    writes = n * (4 * width + 8) + nchunks * 16 + 4 * 8
    ops = C + 36 * n
    return reads + writes, ops, (f"{C} records x 5 B, {materials} alphas, {total} source ids, "
                                 f"{n} live records x {4 * (15 + 3 * A + 1) + 4 * 11} B read; "
                                 f"{n} rows x {4 * width + 8} B, {nchunks} boxes, the meta "
                                 "written")


def _blend_crop_check(dev, p, scene, smi: str) -> dict:
    """The slot-table kernel (live_slots on the card) against its plain
    version (blend.live_slots_plain), bit for bit; the blend kernel
    (composite_transparent on the card, in place on a copy) against its
    plain version (blend.blend_composite_plain: the cropped torch
    composite, the live slots read to the host) and the whole-frame
    composite on all slots (blend.composite_whole_frame), the same f32
    bytes, and every pixel no fragment lands on with its input's bits; at
    BLEND_CROP_TIMES, unbanded and in 4 bands, else the run fails. Logs
    each frame's live slots and the box's share of the frame (of the band);
    at the first time the three composites' device ms in turns (kernel,
    crop, whole frame, whole frame, crop, kernel: the kernel's launch alone
    with a cold L2 behind a device spin, the torch composites by CUDA
    events around 10 calls) and the slot tables' (kernel, plain, plain,
    kernel: both cold behind a device spin), beside the card's name and
    power limit, and the composites' memory. Returns both kernels' numbers
    for the kernels line (their time, their plain versions', their bounds:
    for the composite the color of the pixels a fragment lands on read and
    written, the depth of the covered pixels, the table, or the shaded
    fragments' f32 operations over the FP32 peak; for the slot table
    _slot_bytes)."""
    from xr_torch import kernels
    from xr_torch.app import renderer
    from xr_torch.core import fixedpoint as fp
    from xr_torch.dist import shard
    from xr_torch.pipeline.shadow import light_matrices_for_scene
    from xr_torch.raster import dispatch
    from xr_torch.shading import blend
    from xr_torch.tools.timing import device_ms, flush_buffer

    cfg = p.config
    cap = _capacity(scene, cfg)
    light = light_matrices_for_scene(scene)
    shadow, _ = renderer.shadow_pass(scene, cfg, *light, cap)
    n = 4
    _, hb, band = shard.band_config(cfg, n)
    err = slot_err = 0.0

    def same(label, kernel, plain, whole, before, live, depth, yo=0):
        nonlocal err
        for what, want in (("its plain version", plain), ("the whole-frame composite", whole)):
            err = max(err, float((kernel - want).abs().max()))
            if not torch.equal(kernel.view(torch.int32), want.view(torch.int32)):
                bad = int((kernel != want).any(-1).sum())
                raise AssertionError(f"config4b {label}: the blend kernel differs from {what} "
                                     f"at {bad} pixels")
        # the pixels no fragment lands on keep their bits
        rec = blend.unpack_slots(live.table[: live.count], cfg.attr_width)
        H, W = depth.shape
        px = fp.pixel_center_fixed(torch.arange(W, device=dev), cfg.subpixel)
        py = fp.pixel_center_fixed(torch.arange(yo, yo + H, device=dev), cfg.subpixel)
        kept = ~blend.fragment_mask(rec, px, py, depth)[0].any(0)
        if not torch.equal(kernel.view(torch.int32)[kept], before.view(torch.int32)[kept]):
            raise AssertionError(f"config4b {label}: the blend kernel wrote a pixel no "
                                 "fragment lands on")

    def share(live, rows, width):
        area = 0
        for y0, y1, x0, x1 in live.boxes:
            x0, x1 = blend._columns(x0, x1, width)
            area += max(min(y1, rows.stop) - max(y0, rows.start), 0) * max(x1 - x0, 0)
        return area / ((rows.stop - rows.start) * width)

    out = None
    for t in BLEND_CROP_TIMES:
        cam = p.animate(t)[0]
        c, view, proj = renderer.camera_matrices(scene, cam, cfg)
        tri, tid, depth, _ = renderer.depth_pass(scene, view, proj, cfg, cap)
        rgb = renderer.shade(tri, tid, scene, cfg, c.eye, shadow)
        kernels.reset_launches()
        slots = blend.live_slots(tri, scene, cfg)
        torch.cuda.synchronize()
        if kernels.launches["blend_slots"] != 1 or sum(kernels.launches.values()) != 1:
            raise AssertionError(f"config4b t={t}: the slot table launched {kernels.launches}")
        plain_slots = blend.live_slots_plain(tri, scene, cfg)
        slot_err = max(slot_err, _slots_err(slots, plain_slots, cfg))
        k = int(plain_slots.count)
        if not (torch.equal(slots.meta, plain_slots.meta)
                and torch.equal(slots.ids[:k], plain_slots.ids[:k])
                and torch.equal(slots.boxes, plain_slots.boxes)
                and torch.equal(slots.table[:k].view(torch.int32),
                                plain_slots.table[:k].view(torch.int32))):
            raise AssertionError(f"config4b t={t}: the slot-table kernel differs from its plain "
                                 f"version: meta {slots.meta.tolist()} against "
                                 f"{plain_slots.meta.tolist()}")
        live = blend.live_records(tri, scene, cfg, slots)
        args = (depth, tri, scene, cfg, c.eye)
        kernels.reset_launches()
        color = rgb.clone()
        got, overflow = blend.composite_transparent(color, *args, live=slots, **shadow)
        torch.cuda.synchronize()
        if (kernels.launches["blend_composite"] != 1 or sum(kernels.launches.values()) != 1
                or int(overflow) or got is not color):
            raise AssertionError(f"config4b t={t}: launches {kernels.launches}, overflow "
                                 f"{int(overflow)}, in place {got is color}")
        same(f"t={t}", got, blend.blend_composite_plain(rgb.clone(), *args, live=slots, **shadow),
             blend.composite_whole_frame(rgb, *args, **shadow)[0], rgb, live, depth)
        shares = []
        vis_tri = tri.replace(valid=blend.opaque_valid(tri, scene))
        for b in range(n):
            yo = b * hb
            btid, bz, _ = dispatch.visibility(vis_tri, band, cap, y_offset=yo)
            bdepth = torch.where(torch.isinf(bz), 1.0, bz)
            brgb = renderer.shade(tri, btid, scene, band, c.eye, shadow, None, bdepth, yo)
            bargs = (bdepth, tri, scene, band, c.eye)
            same(f"t={t} band {b} of {n}",
                 blend.composite_transparent(brgb.clone(), *bargs, y_offset=yo, live=slots,
                                             **shadow)[0],
                 blend.blend_composite_plain(brgb.clone(), *bargs, y_offset=yo, live=slots,
                                             **shadow),
                 blend.composite_whole_frame(brgb, *bargs, y_offset=yo, **shadow)[0], brgb, live,
                 bdepth, yo)
            shares.append(share(live, range(yo, yo + hb), cfg.width))
        log(f"config4b blend t={t}: {live.count} live slots, boxes {live.boxes}, union "
            f"{slots.union.tolist()}, {share(live, range(cfg.height), cfg.width):.4f} of the "
            f"frame; bands of {hb} rows: " + ", ".join(f"{s:.4f}" for s in shares)
            + "; the slot-table kernel's rows are its plain version's, the composite's f32 "
            "bytes its plain version's and the whole-frame composite's, unbanded and in every "
            "band, and no pixel outside the fragments written")
        if t == BLEND_CROP_TIMES[0]:
            launch = blend.kernel_call(rgb.clone(), depth, slots, scene, cfg, c.eye, **shadow)
            slot_launch = blend.slots_call(tri, scene, cfg)
            flush = flush_buffer(dev)
            fns = {"kernel": launch,
                   "crop": lambda: blend.blend_composite_plain(rgb.clone(), *args, **shadow),
                   "whole frame": lambda: blend.composite_whole_frame(rgb, *args, **shadow)}
            ms = {k: [] for k in fns}
            for k in ("kernel", "crop", "whole frame", "whole frame", "crop", "kernel"):
                # the kernel alone, cold L2, queued behind a device spin; the
                # torch composites read the host, so events around 10 calls
                ms[k].append(device_ms(launch, 20, flush=flush)[0] if k == "kernel"
                             else cuda_ms(fns[k], 10))
            slot_ms = {"kernel": [], "plain": []}
            slot_fns = {"kernel": slot_launch,
                        "plain": lambda: blend.live_slots_plain(tri, scene, cfg)}
            for k in ("kernel", "plain", "plain", "kernel"):
                slot_ms[k].append(device_ms(slot_fns[k], 20, flush=flush)[0])
            del flush
            peaks = {}
            for k in ("kernel", "crop"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
                fns[k]()
                peaks[k] = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
            work = _blend_work(live, depth, cfg)
            box_px = sum(max(min(y1, cfg.height) - max(y0, 0), 0)
                         * max(min(x1, cfg.width) - max(x0, 0), 0)
                         for y0, y1, x0, x1 in live.boxes)
            nbytes = (24 * work["fragment_pixels"] + 4 * work["covered_pixels"]
                      + live.count * slots.table.shape[1] * 4 + 4 * 8)
            ops = work["fragments"] * PHONG_FRAGMENT_OPS
            composite = {"max_abs_err": 0.0, "ms": float(np.mean(ms["kernel"])),
                         "plain_ms": float(np.mean(ms["crop"])),
                         **_bound(nbytes, ops, FP32_OPS_PER_S), "library_ms": None}
            s_bytes, s_ops, s_count = _slot_bytes(tri, slots, cfg,
                                                   scene.materials.alpha.shape[0])
            table = {"max_abs_err": 0.0, "ms": float(np.mean(slot_ms["kernel"])),
                     "plain_ms": float(np.mean(slot_ms["plain"])),
                     **_bound(s_bytes, s_ops, FP32_OPS_PER_S), "library_ms": None}
            log(f"config4b blend composite t={t} on {smi} (in turns kernel, crop, whole "
                "frame, whole frame, crop, kernel; the kernel's launch alone with a cold L2, "
                "20 launches behind a device spin; the torch composites by CUDA events around "
                "10 calls): kernel "
                f"{ms['kernel'][0]:.4f} / {ms['kernel'][1]:.4f} ms, cropped torch composite "
                f"{ms['crop'][0]:.4f} / {ms['crop'][1]:.4f} ms, whole frame "
                f"{ms['whole frame'][0]:.4f} / {ms['whole frame'][1]:.4f} ms; memory above its "
                f"inputs: kernel {peaks['kernel']:.1f} MiB, crop {peaks['crop']:.1f} MiB; bound "
                f"{composite['bound_ms']:.5f} ms by {composite['bound_by']} ({nbytes} bytes: "
                f"the color of {work['fragment_pixels']} pixels under a fragment read and "
                f"written, the depth of {work['covered_pixels']} covered pixels, {live.count} "
                f"table rows and the meta; {work['fragments']} fragments x "
                f"{PHONG_FRAGMENT_OPS} f32 operations = {ops}); the boxes hold {box_px} pixels")
            log(f"config4b slot table t={t} on {smi} (in turns kernel, plain, plain, kernel; "
                "each with a cold L2, 20 calls behind a device spin): kernel "
                f"{slot_ms['kernel'][0]:.4f} / {slot_ms['kernel'][1]:.4f} ms, plain "
                f"(live_slots_plain) {slot_ms['plain'][0]:.4f} / {slot_ms['plain'][1]:.4f} ms; "
                f"bound {table['bound_ms']:.6f} ms by {table['bound_by']} ({s_bytes} bytes: "
                f"{s_count}; {s_ops} f32 operations)")
            out = {"blend_composite": composite, "blend_slots": table}
    out["blend_composite"]["max_abs_err"] = err
    out["blend_slots"]["max_abs_err"] = slot_err
    return out


def _same_bytes(label, banded, unbanded) -> None:
    """Raise unless the banded frames hold the unbanded frames' color and
    depth bytes and tris_setup, with every overflow counter 0 (the banded
    covered_pixels and fragments_shaded count the padded height)."""
    for i, (a, b) in enumerate(zip(banded, unbanded)):
        if a.color.tobytes() != b.color.tobytes() or a.depth.tobytes() != b.depth.tobytes():
            raise AssertionError(f"{label} frame {i}: the frames differ")
        if int(a.stats["tris_setup"]) != int(b.stats["tris_setup"]) or any(
                int(a.stats.get(k, 0)) for k in ("clip_overflow", "bin_overflow",
                                                 "blend_overflow")):
            raise AssertionError(f"{label} frame {i}: stats {a.stats} vs {b.stats}")
    log(f"{label}: the {len(banded)} frames hold the same color and depth bytes and "
        "tris_setup; every counter 0")


def _banded_stage_times(dev, p, cams, scene) -> dict:
    """Each stage's device ms a frame of the preset's graphed frames in its
    bands (ShardedRenderer, all on dev) and unbanded (Renderer), read from
    a torch.profiler trace of those frames the way the benchmark reads a
    cell (bench_torch.layers: the device operations launched under each
    stage's span, a replayed graph's under the span it replays in; the
    readback's copy under readback). Returns {label: parse_trace's dict}."""
    from types import SimpleNamespace

    from bench_torch import layers
    from xr_torch import Renderer, ShardedRenderer

    out = {}
    for label, r in (("unbanded", Renderer(scene, p.config, dev)),
                     (f"{p.config.num_shards} bands",
                      ShardedRenderer(scene, p.config, devices=[dev]))):
        r.readback(r.step(scene, cams[0]))  # the capture
        outdir = os.path.join(ROOT, "build", "trace_" + label.replace(" ", "_"))
        setup = SimpleNamespace(renderer=r, scene=scene)
        out[label] = layers.parse_trace(layers.trace_window(setup, cams, False, outdir),
                                        len(cams))
        del r, setup
    return out


def _banded_turns(dev, p, scene, cams, rounds=3) -> None:
    """config5's ms/frame unbanded (Renderer) and in its bands
    (ShardedRenderer, one card), both graphed, in turns, so the host
    clock's drift falls on both alike."""
    ms = {"unbanded": [], f"{p.config.num_shards} bands": []}
    for _ in range(rounds):
        for label, banded in zip(ms, (False, True)):
            times, _, _ = _run_frames(dev, scene, p.config, cams, banded=banded)
            ms[label].append(float(np.mean(times)))
    log(f"config5 1920x1080 in turns, {rounds} rounds of {len(cams)} frames (step + readback, "
        "host clock, mean ms/frame of each round): "
        + "; ".join(f"{k} {v}" for k, v in ms.items()))


def _gate_turns(dev, name, p, scene, cams, rounds=3) -> None:
    """The preset's unbanded ms/frame with z_earlyout on (the gated kernel)
    and off (the ungated one), in turns, so the host clock's drift falls on
    both alike; the frames must hold the same bytes."""
    cfgs = {"z_earlyout": p.config, "no z_earlyout": dataclasses.replace(p.config,
                                                                         z_earlyout=False)}
    ms, first = {k: [] for k in cfgs}, {}
    for _ in range(rounds):
        for k, cfg in cfgs.items():
            times, frames, launches = _run_frames(dev, scene, cfg, cams)
            if launches[_b1(cfg)] != len(cams) or sum(launches.values()) != len(cams):
                raise AssertionError(f"{name} {k}: launches {launches} in {len(cams)} frames")
            first.setdefault(k, frames)
            ms[k].append(float(np.mean(times)))
    _same_frames(f"{name} z_earlyout against no z_earlyout", first["z_earlyout"],
                 first["no z_earlyout"])
    log(f"{name} 1920x1080 z_earlyout on and off in turns, {rounds} rounds of {len(cams)} frames "
        "(step + readback, host clock, mean ms/frame of each round): "
        + "; ".join(f"{k} {v}" for k, v in ms.items()))


def _bin_prep_turns(p, cam, scene, options, rounds=5) -> None:
    """The bin+prep stage (stream.prepare) of one frame with and without
    each option, timed in turns (CUDA events around 10 host-enqueued
    calls, as the stage line), so the host clock's drift falls on all
    alike; prints the median and the range of each."""
    from xr_torch.app import renderer
    from xr_torch.raster import stream

    _, view, proj = renderer.camera_matrices(scene, cam, p.config)
    _, tri = renderer.visible_triangles(scene, view, proj, p.config, _capacity(scene, p.config))
    cfgs = {"none": p.config, **{k: dataclasses.replace(p.config, **v) for k, v in options.items()}}
    ms = {k: [] for k in cfgs}
    for _ in range(rounds):
        for k, cfg in cfgs.items():
            ms[k].append(cuda_ms(lambda: stream.prepare(tri, cfg), reps=10))
    log("bin+prep in turns, config3 1920x1080 t=0.3 (ms, CUDA events, median [min, max] of "
        f"{rounds} rounds of 10 calls): "
        + ", ".join(f"{k} {float(np.median(v)):.3f} [{min(v):.3f}, {max(v):.3f}]"
                    for k, v in ms.items()))


def _app_layer(dev, p, scene, cams, frames) -> list:
    """config3 at 1920x1080 through the app layer's options, against the
    plain frames of the same cameras: debug_checks (every nf_* 0, its cost
    in ms per frame), a NaN vertex through the stream kernel (no fault;
    strict readback names the input stage), a shade_hook reading
    frag.depth, and recycle_framebuffers=False (the same bytes). Returns
    the launches of each run, each counted (_counted)."""
    from xr_torch import Renderer

    n, runs = 10, []
    dbg = dataclasses.replace(p.config, debug_checks=True)
    ms = {"with": [], "without": []}
    for _ in range(3):  # in turns: the host clock drifts between runs
        times, got, launches = _run_frames(dev, scene, dbg, cams[:n])
        runs.append(launches)
        ms["with"].append(float(np.mean(times)))
        for f in got:
            nf = {k: int(v) for k, v in f.stats.items() if k.startswith("nf_")}
            if len(nf) != 4 or any(nf.values()):
                raise AssertionError(f"debug_checks on a clean frame: {nf}")
        _same_frames("config3 debug_checks against config3", got, frames[:n])
        times, _, launches = _run_frames(dev, scene, p.config, cams[:n])
        runs.append(launches)
        ms["without"].append(float(np.mean(times)))
    log(f"debug_checks: config3 1920x1080, 3 rounds of {n} frames in turns, mean ms/frame "
        f"with it {ms['with']}, without {ms['without']} (step + readback, host clock); "
        "every nf_* 0")

    def one_frame(r, sc):
        f, launched = _counted(lambda: r.step(sc, cams[0]))
        runs.append(launched)
        if runs[-1]["vis_stream"] != 1:
            raise AssertionError(f"one frame launched {runs[-1]}")
        return f

    pos = scene.mesh.positions.clone()
    pos[7, 1] = float("nan")
    r = Renderer(scene, dbg, dev)
    r.step(scene, cams[0])  # the capture
    f = one_frame(r, scene.replace(mesh=scene.mesh.replace(positions=pos)))
    try:
        r.readback(f)
    except RuntimeError as e:
        if "input stage" not in str(e):
            raise
        log(f"NaN vertex through the stream kernel: no fault; strict readback raised: {e}")
    else:
        raise AssertionError("a NaN vertex read back without a raise")
    if not np.array_equal(r.readback(one_frame(r, scene)).color, frames[0].color):
        raise AssertionError("the frame after the NaN frame is not config3's")

    seen = {}

    def fog(color, scene_, mat_id, xp, frag=None):
        seen["depth"] = frag.depth
        f = torch.clamp(frag.depth * 1.5, 0.0, 1.0)[..., None]
        return color * (1.0 - f) + f

    r = Renderer(scene, p.config, dev, shade_hook=fog)
    r.step(scene, cams[0])  # the capture
    hooked = r.readback(one_frame(r, scene))
    fg = hooked.depth < 1.0
    if (seen["depth"].device != scene.mesh.positions.device
            or not np.array_equal(hooked.depth, frames[0].depth)
            or not hooked.color[fg].astype(int).sum() > frames[0].color[fg].astype(int).sum()
            or not np.array_equal(hooked.color[~fg], frames[0].color[~fg])):
        raise AssertionError("shade_hook: the fogged frame is not config3's brightened by depth")
    log("shade_hook reading frag.depth (fog by depth): covered pixels brighter, background and "
        "depth unchanged")

    _, got, launches = _run_frames(dev, scene, p.config, cams[:n], recycle_framebuffers=False)
    runs.append(launches)
    _same_frames("config3 recycle_framebuffers=False against recycled", got, frames[:n])
    return runs


def _capacity(scene, cfg) -> int:
    from xr_torch.pipeline.geometry import clip_capacity

    return clip_capacity(scene.mesh.num_triangles, cfg)


def phase_present(dev) -> None:
    """One config3 frame, and one config5 frame in its preset's four bands,
    through present() and flush() against step() and readback(): the host
    frames hold the same bytes."""
    from bench_torch.oracle import same_bytes
    from xr_torch import Renderer, ShardedRenderer

    for name, label, t, t2 in (("config3", "config3", 0.3, 0.9),
                               ("config5", "config5 in 4 bands", 3.0, 6.0)):
        p, cam, scene = _setup(dev, _preset(name, full=True), 1920, 1080, t)
        r = (ShardedRenderer(scene, p.config, devices=[dev]) if name == "config5"
             else Renderer(scene, p.config, dev))
        want = r.readback(r.step(scene, cam))
        if r.present(r.step(scene, cam)) is not None:
            raise AssertionError("present: the first call must return None")
        got = r.present(r.step(scene, p.animate(t2)[0]))
        last = r.flush()
        if (not same_bytes(got, want) or np.array_equal(last.color, want.color)
                or r.flush() is not None):
            raise AssertionError(f"present/flush {label}: the host frame is not readback's")
        log(f"present: {label} 1920x1080 through present() + flush() holds the bytes of "
            "step() + readback() (color, depth, stats)")
        del scene


def _same_frames(label, a_frames, b_frames) -> None:
    """Raise unless the two runs' frames hold the same color and depth
    bytes and the same stats (those of b_frames)."""
    for i, (a, b) in enumerate(zip(a_frames, b_frames)):
        if not (np.array_equal(a.color, b.color) and np.array_equal(a.depth, b.depth)):
            raise AssertionError(f"{label} frame {i}: the frames differ")
        if any(int(a.stats[k]) != int(b.stats[k]) for k in b.stats):
            raise AssertionError(f"{label} frame {i}: stats differ {a.stats} vs {b.stats}")
    log(f"{label}: the {len(a_frames)} frames of the two runs are equal (color, depth, stats)")


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


# the oracle phase's frames: (label, preset, full size, width, height, the t
# of the path's first frame in phase 6, backend, bands, the kernel and its
# launches a frame); config5's two frames share one oracle frame
ORACLE_PATHS = (
    ("config1", "config1", False, 512, 512, 0.1, None, 1, None, 0),
    ("config2 pallas_smem", "config2", False, 1920, 1080, 0.05, "pallas_smem", 1, "vis_lists", 1),
    ("config3", "config3", True, 1920, 1080, 0.05, None, 1, "vis_stream", 1),
    ("config4", "config4", False, 1920, 1080, 0.05, None, 1, "vis_stream", 2),
    ("config4b", "config4b", False, 1920, 1080, 0.05, None, 1, "vis_stream", 2),
    ("config6", "config6", False, 1920, 1080, 0.05, None, 1, "vis_stream", 2),
    ("config7", "config7", True, 1920, 1080, 1.3, None, 1, "vis_stream_zgate", 1),
    ("config5", "config5", True, 1920, 1080, 1.0, None, 1, "vis_stream_zgate", 1),
    ("config5 in 4 bands", "config5", True, 1920, 1080, 1.0, None, 4, "vis_stream_zgate", 4),
)


def _cpu_name() -> str:
    """The host's CPU, where the oracle runs: lscpu's model name, vendor and
    architecture."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=60).stdout
    except OSError:
        out = ""
    info = dict(ln.split(":", 1) for ln in out.splitlines() if ":" in ln)
    name = (info.get("Model name") or "no model name").strip()
    vendor = (info.get("Vendor ID") or "no vendor").strip()
    return f"{name} ({vendor}, {platform.machine()})"


def _against_oracle(label, card, ref, risk, banded, allowed) -> list:
    """The device-vs-oracle rule (bench_torch.oracle.against_oracle); logs
    the numbers, returns the rules broken."""
    from bench_torch.oracle import against_oracle

    broken, line = against_oracle(card, ref, risk, banded, allowed)
    log(f"oracle {label}: {line}")
    return broken


def phase_oracle(dev) -> dict:
    """Full-width card frames held against the port's CPU oracle
    (xr_torch.cpu_ref), which shares no binning, records or kernel with the
    card's path: one frame of each path of ORACLE_PATHS through
    Renderer.step + readback (ShardedRenderer's for bands, all on this
    card), the same frame by the oracle on the CPU with its shadow-flip
    risk set, under _against_oracle's rule. Each card frame is the second
    step (the first captures), its launches counted (_counted). A frame that breaks the rule
    has its arrays written to build/oracle_mismatch/ and fails the phase
    once every frame is checked. Returns the launches."""
    from xr_torch import Renderer, ShardedRenderer, convert
    from xr_torch.cpu_ref.margins import frame_and_risk

    total = dict.fromkeys(KERNELS, 0)
    cpu = _cpu_name()
    log(f"oracle: the CPU oracle runs on {cpu} ({os.cpu_count()} logical CPUs, "
        f"{torch.get_num_threads()} torch threads)")
    failed, oracle_frames = [], {}
    for label, name, full, w, h, t, backend, bands, kernel, per_frame in ORACLE_PATHS:
        over = {"num_shards": bands} | ({"backend": backend} if backend else {})
        p, _, scene = _setup(dev, _preset(name, full), w, h, 0.0, **over)
        cam = p.animate(t)[0]
        r = (ShardedRenderer(scene, p.config, devices=[dev]) if bands > 1
             else Renderer(scene, p.config, dev))
        r.step(scene, cam)  # the capture
        card, launches = _counted(lambda: r.readback(r.step(scene, cam)))
        want = {k: (per_frame if k == kernel else 0) for k in KERNELS}
        want["blend_composite"] = bands if p.config.blend else 0
        want["blend_slots"] = int(p.config.blend)
        if launches != want:
            raise AssertionError(f"oracle {label}: launches {launches}, expected {want}")
        for k, v in launches.items():
            total[k] += v
        key = (name, full, w, h, t)
        if key not in oracle_frames:
            host = p.scene.replace(model_matrices=convert.to_numpy(scene.model_matrices))
            t0 = time.perf_counter()
            oracle_frames[key] = (*frame_and_risk(host, cam, p.config),
                                  time.perf_counter() - t0)
            log(f"oracle {label} {w}x{h} t={t}: the CPU oracle took "
                f"{oracle_frames[key][2]:.2f} s ({cpu}); card launches {launches}")
        ref, risk, _ = oracle_frames[key]
        # the courtyard's long shallow shadow edges: the reference's config6
        # device test allows npix / 500 (tests/test_tpu_device_frames.py:185-189)
        allowed = w * h // (500 if name == "config6" else 1000)
        broken = _against_oracle(f"{label} {w}x{h}", card, ref, risk, bands > 1, allowed)
        if broken:
            failed.append(f"{label}: {', '.join(broken)}")
            out = os.path.join(ROOT, "build", "oracle_mismatch")
            os.makedirs(out, exist_ok=True)
            np.savez_compressed(os.path.join(out, label.replace(" ", "_") + ".npz"),
                                card_color=card.color, card_depth=card.depth,
                                oracle_color=ref.color, oracle_depth=ref.depth, risk=risk)
        del r, scene, card
    if failed:
        raise AssertionError("card frames break the device-vs-oracle rule: " + "; ".join(failed))
    log(f"oracle: all {len(ORACLE_PATHS)} card frames hold the device-vs-oracle rule; "
        f"launches {total}")
    return total


def _entry_point(*args, timeout=600) -> str:
    """Run ``python -m args`` from the repository root; its stdout. Raises
    on a nonzero exit."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [ROOT, env.get("PYTHONPATH")]))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout)
    if res.returncode != 0:
        raise AssertionError(f"python -m {' '.join(args)} exited {res.returncode}:\n"
                             f"{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    log(f"entry point: python -m {' '.join(args)}: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s (process start and kernel load included)")
    return res.stdout


def phase_entry_points() -> None:
    """The runner on config5 (its preset's four bands on this card) and the
    profiler on config3, each as a user runs it."""
    out = _entry_point("xr_torch.examples.run", "config5", "--frames", "5")
    events = {e["event"]: e for e in map(json.loads, filter(None, out.splitlines()))}
    done = events["done"]
    log(f"run config5: first_frame {events['first_frame']}; done {done}")
    log(f"run config5 in {done['num_shards']} bands (ShardedRenderer, graphed), "
        f"{done['frames']} frames: {done['ms_per_frame']!r} ms a frame")
    if done["num_shards"] != 4 or done["frames"] != 5 or any(
            done["stats"][k] for k in ("clip_overflow", "bin_overflow")):
        raise AssertionError(f"run config5: {done}")

    prof_dir = os.path.join(ROOT, "build", "profile_frame_config3")
    out = _entry_point("xr_torch.tools.profile_frame", "config3", "--frames", "8", "--out",
                       prof_dir)
    log(out.strip())
    dev_ms = float(re.search(r"device total: \S+ ms over 8 frames => (\S+) ms/frame",
                             out).group(1))
    host_ms = float(re.search(r"host: (\S+) ms/frame", out).group(1))
    if not dev_ms > 0.0:
        raise AssertionError("profile_frame config3: no device time in the trace")
    log(f"profile_frame config3 1920x1080, 8 frames: device {dev_ms!r} ms/frame, host "
        f"{host_ms!r} ms/frame, device busy share {dev_ms / host_ms!r}")

    out = _entry_point("xr_torch.examples.run", "config1", "--oracle", "--frames", "2")
    done = [e for e in map(json.loads, filter(None, out.splitlines())) if e["event"] == "done"]
    if not done or done[0]["device"] != "cpu" or done[0]["frames"] != 2:
        raise AssertionError(f"run config1 --oracle: no done event on the CPU in {out!r}")
    log(f"run config1 --oracle: done {done[0]}")

    from xr_torch.core.image import read_png

    gold = os.path.join(ROOT, "build", "goldens")
    _entry_point("xr_torch.tools.regen_goldens", gold)
    with open(os.path.join(ROOT, "tests", "goldens", "manifest.json")) as f:
        names = list(json.load(f))
    for name in names:
        got = read_png(os.path.join(gold, f"{name}.png")).astype(int)
        want = read_png(os.path.join(ROOT, "tests", "goldens", f"{name}.png")).astype(int)
        bad = int((np.abs(got - want).max(axis=-1) > 1).sum())
        allowed = max(2, got.shape[0] * got.shape[1] // 1000) if name in SHADOW_EDGE else 0
        if got.shape != want.shape or bad > allowed:
            raise AssertionError(f"regen_goldens {name}: {bad} px past 1 LSB (allowed {allowed})")
    log(f"regen_goldens: {len(names)} goldens rendered by the CPU oracle into {gold}, each "
        "within 1 LSB of tests/goldens (shadow edges: max(2, 0.1 %) px past it)")


def _eager_step(r, scene, cam):
    """The frame renderer r captures, run eagerly into r's output buffers,
    as step ran it before frames were captured: render_step (Renderer) or
    render_step_sharded (ShardedRenderer)."""
    from xr_torch.app.renderer import render_step
    from xr_torch.dist.shard import ShardedRenderer, render_step_sharded

    lv, lp = r._light or (None, None)
    if isinstance(r, ShardedRenderer):
        return render_step_sharded(scene, cam, r.config, r.mesh, lv, lp, r.capacity, r._hook,
                                   out=r._out(r.mesh[0]))
    return render_step(scene, cam, r.config, lv, lp, capacity=r.capacity,
                       out=r._out(scene.mesh.positions.device), shade_hook=r._hook)


def _segments(r) -> list:
    """The segments of the frame renderer r captured (every device's)."""
    c = r._captured
    return [s for prog in ([c.program] if hasattr(c, "program") else c.programs.values())
            for s in prog.segments]


def _graph_turns(r, scene, cams, present: bool, rounds: int = 3) -> dict:
    """Eager and graphed frames in turns (eager first in even rounds): host
    ms in the step call and ms a frame (step + readback; through present,
    the interval between returns, flush closing the last), each round's
    median over the cameras; and ms a frame of the steps queued back to
    back with no readback (CUDA events around all of them: the device's
    pace where the host keeps ahead of it). Returns {"eager"|"graphed":
    {"step": [...], "frame": [...], "queued": [...]}}."""
    out = {k: {"step": [], "frame": [], "queued": []} for k in ("eager", "graphed")}
    for k in range(rounds):
        for mode in (("eager", "graphed") if k % 2 == 0 else ("graphed", "eager")):
            step = (lambda c: _eager_step(r, scene, c)) if mode == "eager" else (
                lambda c: r.step(scene, c))
            r.readback(step(cams[0]))
            torch.cuda.synchronize()
            steps, frames = [], []
            mark = time.perf_counter()
            for cam in cams:
                t0 = time.perf_counter()
                f = step(cam)
                steps.append((time.perf_counter() - t0) * 1e3)
                if present:
                    r.present(f)
                else:
                    r.readback(f)
                now = time.perf_counter()
                frames.append((now - (mark if present else t0)) * 1e3)
                mark = now
            if present:
                r.flush()
                frames = frames[1:] + [(time.perf_counter() - mark) * 1e3]
            out[mode]["step"].append(float(np.median(steps)))
            out[mode]["frame"].append(float(np.median(frames)))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            queued = [step(cam) for cam in cams]
            end.record()
            torch.cuda.synchronize()
            out[mode]["queued"].append(start.elapsed_time(end) / len(cams))
            for f in queued:
                r._retire(f)
    return out


def _graphs_case(dev, name, preset, ts, present=False, bands=0, **over) -> dict:
    """One case of phase_graphs: the preset as published at 1920x1080 (with
    `over`) at the t of `ts`; bands: that many screen bands through
    ShardedRenderer on this card, whose frames must also hold the unbanded
    Renderer's bytes. Returns the launches of the graphed frames."""
    from bench_torch.frames import failure
    from bench_torch.oracle import same_bytes
    from xr_torch import Renderer, ShardedRenderer
    from xr_torch.app.renderer import readback_frame

    p, _, scene = _setup(dev, _preset(preset, full=True), 1920, 1080, 0.0, **over)
    if bands:
        cfg = dataclasses.replace(p.config, num_shards=bands)
        r = ShardedRenderer(scene, cfg, devices=[dev])
    else:
        cfg = p.config
        r = Renderer(scene, cfg, dev)
    cams = [p.animate(t)[0] for t in ts]
    eager, n_eager = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    for cam in cams:
        f, n = _counted(lambda: readback_frame(_eager_step(r, scene, cam)))
        eager.append(f)
        n_eager.append(n)
    peak_eager = torch.cuda.max_memory_allocated(dev) - base
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t_cap = time.perf_counter()
    r.readback(r.step(scene, cams[0]))
    t_cap = time.perf_counter() - t_cap
    peak = torch.cuda.max_memory_allocated(dev) - base
    segs = _segments(r)
    if any(s.graph is None for s in segs):
        raise AssertionError(f"{name}: segments run eagerly: "
                             f"{[s.name for s in segs if s.graph is None]}")
    total = dict.fromkeys(KERNELS, 0)

    def graphed(cam):
        if present:  # the frame's pinned copy, started when it is queued
            if r.present(r.step(scene, cam)) is not None:
                raise AssertionError(f"{name}: present returned a frame after flush")
            return r.flush()
        return r.readback(r.step(scene, cam))

    frames = []
    for i, cam in enumerate(cams):
        got, n_got = _counted(lambda: graphed(cam))
        frames.append(got)
        for k, v in n_got.items():
            total[k] += v
        reason = failure(got, cfg)
        if reason or not same_bytes(got, eager[i]) or list(got.stats) != list(eager[i].stats):
            raise AssertionError(f"{name} t={ts[i]:.2f}: the graphed frame is not "
                                 f"the eager frame's ({reason})")
        if n_got != n_eager[i]:
            raise AssertionError(f"{name} t={ts[i]:.2f}: graphed launches {n_got}, eager "
                                 f"{n_eager[i]}")
    if bands:
        u = Renderer(scene, p.config, dev)
        _same_bytes(f"graphs {name} against the unbanded Renderer", frames,
                    [u.readback(u.step(scene, cam)) for cam in cams])
        del u
    turns = _graph_turns(r, scene, cams, present)
    eager_fn = "render_step_sharded" if bands else "render_step"
    log(f"graphs {name}: {len(ts)} frames (t {ts[0]:.2f}..{ts[-1]:.2f}) byte-equal to "
        f"{eager_fn}'s, launches a frame (eager and graphed alike) {n_eager[0]}; "
        f"{sum(s.graph is not None for s in segs)} graphs a frame, eager "
        f"{[s.name for s in segs if s.graph is None]}; capture + first frame {t_cap:.3f} s; "
        f"device memory at its peak above what was allocated before: the capture "
        f"{peak / 2**20:.1f} MiB, the eager frames {peak_eager / 2**20:.1f} MiB")
    for mode in ("eager", "graphed"):
        log(f"graphs {name} {mode} (3 rounds in turns, medians of {len(ts)} frames): host ms "
            f"in step {turns[mode]['step']}, ms a frame {turns[mode]['frame']}, ms a frame "
            f"queued back to back (CUDA events) {turns[mode]['queued']}")
    return total


def phase_graphs(dev) -> dict:
    """Renderer.step replays the frame it captured at its first step: the
    six benchmark cells' presets as published at 1920x1080 (the present
    cell's through present() + flush()), each over GRAPH_FRAMES t of its
    cell's seed-0 path, graphed against render_step's eager frames on the
    same cameras: color, depth and stats byte-equal and the same kernel
    launches a frame (_counted), else the phase fails. Then the two in turns, 3 rounds: host
    ms in the step call and ms a frame. Prints the capture's seconds, the
    graphs a frame (and the segments that run eagerly), peak device memory
    of each. Then config3 with backend="jnp" at its own bin_capacity, 3 t:
    its plain lists' fold loops as far as the data goes in an eager frame
    and to the capacity in a captured one, which cannot read the data;
    byte-equal and timed in turns the same way. Then ShardedRenderer.step
    on this card the same way, against render_step_sharded's eager frames
    and the unbanded Renderer's bytes: config5 in its preset's four bands
    and config4b in four (their cells' t), config4 in two with both
    kernels' backends (config4b's t), and config4 in two with
    backend="jnp" (3 t: its fold to the capacity, once a band). Returns the
    launches of the graphed frames."""
    from bench_torch.cells import CELLS, frame_t, t0

    total = dict.fromkeys(KERNELS, 0)

    def cell_ts(preset, n=GRAPH_FRAMES):
        cell = next(c for c in CELLS if c.preset == preset)
        return [frame_t(t0(cell, 0), i) for i in range(n)]

    for cell in CELLS:
        t_first = t0(cell, 0)
        ts = [frame_t(t_first, i) for i in range(GRAPH_FRAMES)]
        for k, v in _graphs_case(dev, cell.name, cell.preset, ts, cell.present).items():
            total[k] += v
    _graphs_case(dev, "config3 backend=jnp", "config3", cell_ts("config3", 3), backend="jnp")
    for name, preset, bands, ts, over in (
            ("config5 in 4 bands", "config5", 4, cell_ts("config5"), {}),
            ("config4b in 4 bands", "config4b", 4, cell_ts("config4b"), {}),
            ("config4 in 2 bands", "config4", 2, cell_ts("config4b"), {}),
            ("config4 in 2 bands backend=pallas_smem", "config4", 2, cell_ts("config4b"),
             {"backend": "pallas_smem"}),
            ("config4 in 2 bands backend=jnp", "config4", 2, cell_ts("config4b", 3),
             {"backend": "jnp"})):
        for k, v in _graphs_case(dev, name, preset, ts, bands=bands, **over).items():
            total[k] += v
    return total


def phase_benchmark() -> dict:
    """The port's benchmark as its command runs it (python -m bench_torch),
    at BENCH_FRAMES timed frames a cell, every cell checked against the
    benchmark's reference (the present cell also against readback()); fails
    unless every cell is correct.
    Prints the cells' lines; returns the kernel launches of the cells'
    timed frames."""
    from bench_torch.cells import CELLS

    out = _entry_point("bench_torch", "--frames", str(BENCH_FRAMES), timeout=900)
    lines = out.strip().splitlines()
    for line in lines[:-1]:
        if line.startswith(("cell ", "bench_torch:", "build:")):
            log(f"benchmark: {line}")
    res = json.loads(lines[-1])
    bad = [k for k, w in res["workloads"].items() if not w["correct"]]
    if not res["ok"] or bad or len(res["workloads"]) != len(CELLS):
        raise AssertionError(f"benchmark: cells not correct {bad}: {lines[-1][:2000]}")
    total = dict.fromkeys(KERNELS, 0)
    for w in res["workloads"].values():
        for k, v in w["launches"].items():
            total[k] += v
    log(f"benchmark: all {len(res['workloads'])} cells correct at {BENCH_FRAMES} frames a cell; "
        f"launches {total}")
    return total


def main() -> int:
    smi, clock_hz = phase_device()
    dev = torch.device("cuda", 0)
    import xr_torch  # noqa: F401  (TF32 off)

    phase_build()
    phase_native()
    kv = phase_kernel_vs_plain(dev, clock_hz)
    phase_gate_probe()
    kv.update(phase_gathers(dev, clock_hz))
    phase_golden(dev)
    launches, kv_blend = phase_main_path(dev, smi)
    kv.update(kv_blend)
    for k, v in phase_oracle(dev).items():
        launches[k] += v
    phase_present(dev)
    for k, v in phase_graphs(dev).items():
        launches[k] += v
    for k, v in phase_gather_tools(dev).items():
        launches[k] += v
    phase_entry_points()
    for k, v in phase_benchmark().items():
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
