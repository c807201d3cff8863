"""Frame-loop runner of the port (port of ``examples/run.py``): pump ->
update -> render -> present as a headless script, on an explicit device.
Present is a device-to-host copy and a PNG dump. Prints one JSON event a
line: ``scene_saved``, ``autosized``, ``first_frame``, ``profile``,
``done``.

Usage:
  python -m xr_torch.examples.run config1 --frames 30 --out frames/
  python -m xr_torch.examples.run config3 --frames 60 --profile
  python -m xr_torch.examples.run config5            # its preset's 4 bands
  python -m xr_torch.examples.run config2 --shards 2 --device cpu
  python -m xr_torch.examples.run config1 --oracle --frames 2

``num_shards > 1`` (the preset's or ``--shards``) renders through
``ShardedRenderer``: on ``--device cuda`` its bands spread over every
visible card, a card serving several bands when there are fewer cards; on
any other device all bands run there in turn. ``--oracle`` renders each
frame with the CPU oracle (``xr_torch.cpu_ref.render_frame``) instead,
on the CPU whatever ``--device`` says, with the same events.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import tempfile
import time


def make_preset(name: str, device):
    """The preset as published; config7's capacities are measured by its
    dry pass on device."""
    from xr_torch.scene.presets import ALL_PRESETS

    return ALL_PRESETS[name](device=device) if name == "config7" else ALL_PRESETS[name]()


def resolve_device(name: str):
    """The torch device named; raises for a CUDA device when there is none
    (the runner never falls back to the CPU)."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device (use --device cpu to render on the CPU)")
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("preset")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--out", default="")
    ap.add_argument("--dump-every", type=int, default=0, help="PNG every N frames")
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--shards", type=int, default=0)
    ap.add_argument("--profile", action="store_true", help="torch.profiler trace")
    ap.add_argument("--dt", type=float, default=1.0 / 30.0)
    ap.add_argument("--start-frame", type=int, default=0,
                    help="resume the animation at frame k (t = k * dt)")
    ap.add_argument("--save-scene", default="",
                    help="serialize the scene to this .npz and continue")
    ap.add_argument("--scene", default="",
                    help="render a previously saved .npz scene instead of the preset's")
    ap.add_argument("--autosize", action="store_true",
                    help="size capacity knobs from a measured dry pass over this run's "
                    "camera path (xr_torch/app/autosize.py)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--oracle", action="store_true",
                    help="render with the CPU oracle (xr_torch/cpu_ref), on the CPU")
    args = ap.parse_args(argv)

    import torch

    from xr_torch import Renderer, ShardedRenderer, convert
    from xr_torch.core import serialize
    from xr_torch.core.image import write_png

    dev = torch.device("cpu") if args.oracle else resolve_device(args.device)
    p = make_preset(args.preset, dev)
    if args.scene:
        p = p._replace(scene=serialize.load_scene(args.scene))
    if args.save_scene:
        serialize.save_scene(args.save_scene, p.scene)
        print(json.dumps({"event": "scene_saved", "path": args.save_scene}), flush=True)
    cfg = p.config
    if args.width and args.height:
        cfg = dataclasses.replace(cfg, width=args.width, height=args.height)
    if args.shards:
        cfg = dataclasses.replace(cfg, num_shards=args.shards)
    if args.autosize:
        from xr_torch.app.autosize import autosize_config

        ts = [args.start_frame * args.dt + k * args.dt * args.frames / 4.0 for k in range(5)]
        cfg = autosize_config(p.scene, [p.animate(t)[0] for t in ts], cfg, device=dev)
        print(json.dumps({
            "event": "autosized",
            "bin_capacity": cfg.bin_capacity,
            "clip_budget": cfg.clip_budget,
            "clip_expand": round(cfg.clip_expand, 4),
            "stream_entry_cap": cfg.stream_entry_cap,
            "large_capacity": cfg.large_capacity,
        }), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    if args.oracle:
        r = OracleRunner(cfg)

        def step(t):
            cam, mm = p.animate(t)
            return r.step(p.scene.replace(model_matrices=mm), cam)
    else:
        scene = convert.scene_to_torch(p.scene, dev)
        if cfg.num_shards > 1:
            # --device cuda: every visible card; otherwise all bands on dev
            r = ShardedRenderer(scene, cfg, devices=None if str(dev) == "cuda" else [dev])
        else:
            r = Renderer(scene, cfg, dev)

        def step(t):
            cam, mm = p.animate(t)
            return r.step(scene.replace(model_matrices=convert.tensor(mm, dev, torch.float32)),
                          cam)

    def stats(f):
        return {k: int(v) for k, v in f.stats.items()}

    t_first = time.perf_counter()
    f = r.readback(step(args.dt * args.start_frame), strict=False)
    print(json.dumps({"event": "first_frame",
                      "compile_s": round(time.perf_counter() - t_first, 2),
                      "stats": stats(f)}), flush=True)

    def dump(i, f):
        write_png(os.path.join(args.out, f"{args.preset}_{i:04d}.png"), f.color)

    prof_dir = args.out or os.path.join(tempfile.gettempdir(), "xr_torch_profile")
    # one frame in flight: present(frame i) starts its host copy and returns
    # frame i-1's, whose PNG is written while the device renders frame i+1
    t0 = time.perf_counter()
    with _maybe_trace(args.profile, prof_dir):
        last, pending_i = None, None
        for i in range(args.frames):
            frame = step(args.dt * (args.start_frame + i))
            if args.dump_every and i % args.dump_every == 0:
                done = r.present(frame)
                if done is not None:
                    dump(pending_i, done)
                pending_i = i
            last = frame
        if pending_i is not None:
            dump(pending_i, r.flush())
        fr = r.readback(last, strict=False)
    dt = (time.perf_counter() - t0) / max(args.frames, 1)
    if args.profile:
        print(json.dumps({"event": "profile", "dir": prof_dir}), flush=True)
    if args.out:
        write_png(os.path.join(args.out, f"{args.preset}_final.png"), fr.color)
    print(json.dumps({
        "event": "done",
        "preset": args.preset,
        "frames": args.frames,
        "device": str(dev),
        "num_shards": cfg.num_shards,
        "ms_per_frame": round(dt * 1e3, 2),
        "fps": round(1.0 / dt, 2),
        # from the device-side counter (shadow-pass texels included)
        "mpixels_shaded_per_s": round(int(fr.stats["fragments_shaded"]) / dt / 1e6, 1),
        "stats": stats(fr),
    }), flush=True)


class OracleRunner:
    """The CPU oracle behind the renderer methods the frame loop calls. Its
    frames are host frames already: readback hands the frame back, and
    present keeps one frame in flight as Renderer's does."""

    def __init__(self, config):
        self.config = config
        self._inflight = None

    def step(self, scene, camera):
        from xr_torch.cpu_ref import render_frame

        return render_frame(scene, camera, self.config)

    def readback(self, frame, strict: bool = True):
        return frame

    def present(self, frame, strict: bool = True):
        prev, self._inflight = self._inflight, frame
        return prev

    def flush(self, strict: bool = True):
        return self.present(None)


def _maybe_trace(on: bool, log_dir: str):
    from xr_torch import prof

    return prof.torch_trace(log_dir) if on else contextlib.nullcontext()


if __name__ == "__main__":
    main()
