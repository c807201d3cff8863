"""Sweep of the visibility kernels' constants and probes, on the card.

    python -m xr_torch.tools.sweep_visibility

Rebuilds the kernels (csrc/fold_records.cuh) once per variant, each in a
process of its own, and times at 1920x1080, by CUDA events over 50 launches
queued behind 20 ms of spinning on the device: the stream kernel on config3,
the list kernel on config2 and the stream kernel on config4's shadow pass
and camera pass (t = 0.3); and the z gate: the stream kernel on config5
(t = 3.0) without it, with it (the preset's ``z_earlyout``), under
``z_chunk_gate`` and under ``bin_zorder``, on config5 in each of its
preset's four bands, on config7 (t = 13.0 and 26.0), on config3 under
``bin_zorder`` and ``z_earlyout``, and on the depth-complexity cases of
``xr_torch/tools/layers.py``: ``layers16`` (16 planes, ids front to back),
``layers16`` under ``z_chunk_gate``, ``layers16_rev`` (back to front)
and ``layers16_rev`` under ``bin_zorder``; each gated case in turns with
the ungated kernel on the same inputs (3 rounds).

A variant is threads per CTA, records per work item, CTAs an SM must hold
(which caps the registers), and options. Exact: ``runs`` deals a tile's
records to its chunks as runs of consecutive records (both kernels);
``nogate`` compiles the gated kernel's tests and bounds out (what the rest
of its structure costs); ``gatecounts`` builds the gate's probe
(``-DXR_GATE_COUNTS``, slower), which counts the (record, warp) pairs that
meet a footprint inside the frame and those the gate skipped (dropped at
staging, skipped in the walk), so that each gated case reports the card's
skip share of one launch beside the share of records the reference's
serial gate skips in the plain version (``records.fold_plain_gated``).
Not exact: ``nofold``, ``nomerge`` and ``nostage`` compile the pixel work,
the merge or the staging out, which shows where the time goes. Each line
names its build's flags, says whether the output matched the plain version
(and, gated, the ungated kernel) and what ptxas reported for each fold
kernel. A line of one variant:

    python -m xr_torch.tools.sweep_visibility 512,128,2,gatecounts
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import re
import subprocess
import sys

import torch

VARIANTS = (
    "256,128,1,runs", "256,128,1", "512,128,2", "512,128,1", "1024,128,1", "512,64,2",
    "512,256,2", "512,128,2,gatecounts", "512,128,2,nogate", "512,128,2,nofold",
    "512,128,2,nomerge", "512,128,2,nofold,nomerge",
    "512,128,2,nofold,nomerge,nostage", "512,128,2",
)
# (kernel, preset, shadow pass, t, config overrides; "band": b of the
# preset's num_shards)
CASES = (("vis_stream", "config3", False, 0.3, {}), ("vis_lists", "config2", False, 0.3, {}),
         ("vis_stream", "config4", True, 0.3, {}), ("vis_stream", "config4", False, 0.3, {}),
         ("vis_stream", "config5", False, 3.0, {"z_earlyout": False}),
         ("vis_stream", "config5", False, 3.0, {}),
         ("vis_stream", "config5", False, 3.0, {"z_chunk_gate": True}),
         ("vis_stream", "config5", False, 3.0, {"bin_zorder": True}),
         *(("vis_stream", "config5", False, 3.0, {"band": b}) for b in range(4)),
         ("vis_stream", "config7", False, 13.0, {}),
         ("vis_stream", "config7", False, 26.0, {}),
         ("vis_stream", "config3", False, 0.3, {"bin_zorder": True, "z_earlyout": True}),
         ("vis_stream", "layers16", False, 0.0, {}),
         ("vis_stream", "layers16", False, 0.0, {"z_chunk_gate": True}),
         ("vis_stream", "layers16_rev", False, 0.0, {}),
         ("vis_stream", "layers16_rev", False, 0.0, {"bin_zorder": True}))
OPTIONS = {"runs": "-DXR_RUNS", "nogate": "-DXR_ZG_NOGATE", "gatecounts": "-DXR_GATE_COUNTS",
           "nofold": "-DXR_NO_FOLD", "nomerge": "-DXR_NO_MERGE", "nostage": "-DXR_NO_STAGE"}
BROKEN = ("nofold", "nomerge", "nostage")


@functools.lru_cache(maxsize=None)
def _preset(name):
    from xr_torch.scene import presets
    from xr_torch.tools import layers

    if name.startswith("layers16"):
        return layers.layers16(reverse=name.endswith("_rev"))
    if name == "config3":
        return presets.config3_terrain()
    if name == "config5":
        return presets.config5_flythrough()
    if name == "config7":
        return presets.config7_terrain_lod(device="cuda")
    return presets.ALL_PRESETS[name]()


def _inputs(dev, kernel, name, shadow, t=0.3, over=None):
    """(prepared inputs, config, launch, plain version) of one case."""
    from xr_torch import convert
    from xr_torch.app.renderer import shadow_config, visible_triangles
    from xr_torch.core import math3d as m3
    from xr_torch.dist import shard
    from xr_torch.pipeline.geometry import clip_capacity
    from xr_torch.pipeline.shadow import light_matrices_for_scene
    from xr_torch.raster import smem, stream

    p = _preset(name)
    cam, mm = p.animate(t)
    scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), dev)
    over = dict(over or {})
    band = over.pop("band", None)
    cfg = dataclasses.replace(p.config, **over)
    if shadow:
        cfg = shadow_config(cfg)
        view_proj = tuple(convert.tensor(m, dev) for m in light_matrices_for_scene(scene))
    else:
        view_proj = m3.camera_matrices(convert.camera_to_torch(cam, dev),
                                       cfg.width / cfg.height, dev)
    _, tri = visible_triangles(scene, *view_proj, cfg,
                               clip_capacity(scene.mesh.num_triangles, cfg))
    prepare, launch, plain = {
        "vis_stream": (stream.prepare, stream.vis_stream, stream.vis_stream_plain),
        "vis_lists": (smem.prepare_lists, smem.vis_lists, smem.vis_lists_plain),
    }[kernel]
    y_offset = 0
    if band is not None:  # the full frame's geometry, the band's visibility
        _, hb, cfg = shard.band_config(cfg, cfg.num_shards)
        y_offset = band * hb
    inp = prepare(tri, cfg, y_offset)
    if int(tri.overflow) or int(inp.dropped):
        raise RuntimeError(f"{name}: {int(tri.overflow)} triangles past the clip budget, "
                           f"{int(inp.dropped)} records dropped")
    return inp, cfg, launch, plain


def _same(a, b) -> bool:
    return torch.equal(a[0], b[0]) and torch.equal(a[1].view(torch.int32),
                                                   b[1].view(torch.int32))


def fold_kernels(log: str) -> dict:
    """ptxas's registers and spill stores of each fold kernel (by its
    mangled name: the walk, then the gate, 0 for fold_kernel), from a
    verbose build."""
    out = {}
    for m in re.finditer(r"Function properties for (_ZN2xr\d+(?:zgate_)?fold_kernelI\w+)\n"
                         r".*?(\d+) bytes spill stores.*?\n.*?Used (\d+) registers", log):
        name = m.group(1)
        walk = "stream" if "StreamWalk" in name else "lists"
        gate = re.search(r"ELi(\d+)E", name)
        out[f"{walk} gate {gate.group(1) if gate else 0}"] = {
            "registers": int(m.group(3)), "spill_bytes": int(m.group(2))}
    return out


def gate_counts(lib) -> dict:
    """The probe build's counters since the last read (then cleared)."""
    import ctypes

    buf = (ctypes.c_ulonglong * 5)()
    lib.xr_gate_counts.argtypes = [ctypes.c_void_p]
    lib.xr_gate_counts.restype = ctypes.c_int
    torch.cuda.synchronize()
    if lib.xr_gate_counts(ctypes.addressof(buf)):
        raise RuntimeError("xr_gate_counts failed")
    hits, dropped, skipped, starts, bounded = buf
    return {"pairs": hits, "dropped_at_staging": dropped, "skipped_in_walk": skipped,
            "warp_starts": starts, "bounded_starts": bounded,
            "skip_share": (dropped + skipped) / hits if hits else 0.0}


def run_variant(spec: str) -> dict:
    """Build one variant in this process and time the cases."""
    from xr_torch import kernels
    from xr_torch.raster import records, stream
    from xr_torch.tools import timing

    threads, item, min_ctas, *opts = spec.split(",")
    kernels.NVCC_FLAGS += [f"-DXR_THREADS={threads}", f"-DXR_ITEM={item}",
                           f"-DXR_MIN_CTAS={min_ctas}"]
    kernels.NVCC_FLAGS += [OPTIONS[o] for o in opts]
    records.ITEM_RECORDS = int(item)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        kernels.build(verbose=True)
    dev = torch.device("cuda", 0)
    # a variant built before (the same flags) prints nothing
    row = {"variant": spec, "build": " ".join(f for f in kernels.NVCC_FLAGS if f.startswith("-D")),
           "fold_kernels": fold_kernels(log.getvalue())}
    probe = "gatecounts" in opts
    for kernel, name, shadow, t, over in CASES:
        inp, cfg, launch, plain = _inputs(dev, kernel, name, shadow, t, over)
        gated = kernel == "vis_stream" and stream.gated(cfg)
        if probe and gated:
            gate_counts(kernels.library())  # clears the counters
        got = launch(inp, cfg)
        label = f"{kernel} {name}{' shadow pass' if shadow else ''}" + "".join(
            f" {k}={v}" for k, v in over.items()) + (f" t={t}" if name == "config7" else "")
        cell = {}
        if probe and gated:
            cell["card"] = gate_counts(kernels.library())
        if gated:
            t_, z_, skips = stream.vis_stream_plain_gated(inp, cfg)
            want = (t_, z_)
            cell["plain_serial_gate"] = dict(
                skips, skip_share=(skips["record"] + skips["chunk"]) / max(skips["walked"], 1))
            ungated = dataclasses.replace(cfg, z_earlyout=False, z_chunk_gate=False,
                                          z_band_gate=False)
            cell["exact_vs_ungated"] = _same(got, launch(inp, ungated))
        else:
            want = plain(inp, cfg)
        cell["exact"] = _same(got, want)
        # 50 launches (L2 warm) that the host enqueues while the device spins;
        # gated, also the ungated kernel on the same inputs, in turns
        fns = [lambda: launch(inp, cfg)]
        if gated:
            fns.append(lambda: launch(inp, ungated))
        times = [[] for _ in fns]
        for k in ((0, 1) * 3 if gated else (0,)):
            times[k].append(timing.device_ms(fns[k], reps=50, warmup=3)[0])
        cell["ms"] = sum(times[0]) / len(times[0])
        if gated:
            cell["ungated_ms"] = sum(times[1]) / len(times[1])
            cell["turns"] = times
        row[label] = cell
    return row


def main(specs=VARIANTS) -> list:
    """One process per variant; prints a JSON line each. Raises if a variant
    that should be exact is not."""
    if not torch.cuda.is_available():
        raise SystemExit("sweep_visibility: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    rows = []
    for spec in specs:
        out = subprocess.run([sys.executable, "-m", "xr_torch.tools.sweep_visibility", spec],
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"variant {spec} failed:\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
        rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
        broken = any(p in spec for p in BROKEN)
        cells = [v for v in rows[-1].values() if isinstance(v, dict) and "exact" in v]
        if not broken and not all(v["exact"] and v.get("exact_vs_ungated", True) for v in cells):
            raise RuntimeError(f"variant {spec} differs from the plain version")
    return rows


if __name__ == "__main__":
    if len(sys.argv) > 1:
        print(json.dumps(run_variant(sys.argv[1])), flush=True)
    else:
        main()
