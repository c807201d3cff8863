"""Per-kernel device profile of one preset's frame (port of
``tools/profile_frame.py``).

``capture`` renders a warm-up frame, then ``--frames`` frames under
torch.profiler (``xr_torch.prof.torch_trace``: a Chrome trace in
``--out``), and records the host-clock ms/frame of those traced frames.
``parse`` sums the device time of the trace's kernels, copies and sets by
name, prints the top K and the sum by stage bucket, "device total ... =>
... ms/frame", the host ms/frame beside it and their ratio: the share of
the frame the device is busy.

Usage:
  python -m xr_torch.tools.profile_frame config3 [--frames 8] [--top 40]
      [--override key=value ...] [--device cuda] [--out DIR] [--parse-only]
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys
import tempfile
import time

CAPTURE_FILE = "capture.json"
# device-side event categories of torch.profiler's Chrome trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# first match wins; names are matched lowercased
STAGE_BUCKETS = [
    # fold_kernel, zgate_fold_kernel and clear_kernel of csrc/
    ("vis_stream", ("<xr::streamwalk",)),
    ("vis_lists", ("<xr::listwalk",)),
    ("copy/memcpy", ("memcpy", "memset", "copy")),
    ("sort", ("sort",)),
    ("gather/index", ("gather", "index", "scatter")),
    ("gemm", ("gemm", "cutlass", "xmma")),
    ("elementwise", ("elementwise",)),
]


def _parse_override(kv: str):
    k, v = kv.split("=", 1)
    for conv in (int, float):
        try:
            return k, conv(v)
        except ValueError:
            pass
    if v in ("True", "False"):
        return k, v == "True"
    return k, v


def capture(preset_name: str, frames: int, outdir: str, overrides=(), device: str = "cuda"):
    """Trace `frames` frames of the preset at t = 0.05, 0.10, ... after a
    warm-up frame at t = 0 through render_step, as the reference does."""
    import torch

    from xr_torch import convert, prof
    from xr_torch.app.renderer import has_shadow_pass, render_step
    from xr_torch.examples.run import make_preset, resolve_device
    from xr_torch.pipeline.geometry import clip_capacity
    from xr_torch.pipeline.shadow import light_matrices_for_scene

    dev = resolve_device(device)
    p = make_preset(preset_name, dev)
    if overrides:
        p = p._replace(config=dataclasses.replace(p.config, **dict(overrides)))
    scene = convert.scene_to_torch(p.scene, dev)
    cap = clip_capacity(scene.mesh.num_triangles, p.config)
    lv, lp = light_matrices_for_scene(p.scene) if has_shadow_pass(p.config) else (None, None)

    def frame_at(t):
        cam, mm = p.animate(t)
        return render_step(scene.replace(model_matrices=convert.tensor(mm, dev, torch.float32)),
                           cam, p.config, lv, lp, capacity=cap)

    def sync(frame):
        frame.color.cpu()

    sync(frame_at(0.0))
    with prof.torch_trace(outdir):
        t0 = time.perf_counter()
        for i in range(frames):
            last = frame_at(0.05 * (i + 1))
        sync(last)
        host_ms = (time.perf_counter() - t0) * 1e3 / frames
    meta = {"preset": preset_name, "frames": frames, "device": str(dev),
            "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "host_ms_per_frame": host_ms}
    with open(os.path.join(outdir, CAPTURE_FILE), "w") as f:
        json.dump(meta, f)
    return meta


def parse(outdir: str, frames: int, top: int) -> dict:
    """Print and return the device time of the trace in outdir by name and
    by stage bucket, its total per frame, and the host ms/frame of the
    capture beside it."""
    from xr_torch.prof import TRACE_FILE

    path = os.path.join(outdir, TRACE_FILE)
    if not os.path.exists(path):
        print("no trace found under", outdir)
        sys.exit(1)
    with open(path) as f:
        tr = json.load(f)
    events = tr["traceEvents"] if isinstance(tr, dict) else tr
    per_op = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            per_op[e["name"]] += e.get("dur", 0) / 1e3  # us -> ms
    total = sum(per_op.values())
    meta = {}
    if os.path.exists(os.path.join(outdir, CAPTURE_FILE)):
        with open(os.path.join(outdir, CAPTURE_FILE)) as f:
            meta = json.load(f)
    host = meta.get("host_ms_per_frame")
    dev_ms = total / frames
    share = dev_ms / host if host and total else None

    print(f"\ntrace: {path} ({meta.get('device_name', 'device unknown')})")
    print(f"device total: {total:.3f} ms over {frames} frames => {dev_ms:.3f} ms/frame")
    if host is not None:
        busy = (f"device busy share {share:.4f}" if share is not None
                else "device busy share not measured (no device events in the trace)")
        print(f"host: {host:.3f} ms/frame (host clock, the traced frames); {busy}")
    print(f"\n{'ms/frame':>9}  {'%':>5}  op")
    for name, ms in per_op.most_common(top):
        print(f"{ms / frames:9.3f}  {100 * ms / total:5.1f}  {name[:110]}")
    buckets = collections.Counter()
    for name, ms in per_op.items():
        lo = name.lower()
        bucket = next((b for b, keys in STAGE_BUCKETS if any(k in lo for k in keys)), "other")
        buckets[bucket] += ms
    print("\nbuckets (ms/frame):")
    for bname, ms in buckets.most_common():
        print(f"  {bname:20s} {ms / frames:8.3f}")
    return {"device_ms_per_frame": dev_ms, "host_ms_per_frame": host, "busy_share": share,
            "per_op_ms": dict(per_op), "buckets_ms": dict(buckets)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("preset")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "xr_torch_prof"))
    ap.add_argument("--parse-only", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--override", action="append", default=[],
                    help="RenderConfig override key=value (repeatable), e.g. "
                    "--override bin_pairs=2")
    args = ap.parse_args(argv)
    if not args.parse_only:
        capture(args.preset, args.frames, args.out,
                overrides=[_parse_override(o) for o in args.override], device=args.device)
    return parse(args.out, args.frames, args.top)


if __name__ == "__main__":
    main()
