"""Shader hot-reload of the port (port of ``examples/watch.py``): watches a
Python "shader" file defining ``shade(...)``, re-imports it on change,
renders a preview frame through a new Renderer whose ``shade_hook`` is
that function, and writes a PNG. A shader that fails to load or to render
keeps the previous preview.

Usage:
  python -m xr_torch.examples.watch --preset config3 --shader my_shader.py \\
      --out preview.png [--device cuda] [--once]

The shader file must define:
  def shade(color, scene, mat_id, xp):  # -> (N, 3) f32 linear color
with color (N, 3) the pipeline's shaded output, mat_id (N,) per-pixel
material indices (None in flat and Gouraud modes) and xp = torch. A starter
file is written where --shader does not exist.
"""

import argparse
import importlib.util
import os
import tempfile
import time
import traceback

STARTER = '''def shade(color, scene, mat_id, xp):
    """Edit me and save: the frame re-renders.

    color: (N, 3) f32 linear pipeline output (a torch tensor); scene: the
    Scene; mat_id: (N,) per-pixel material index or None; xp: torch.
    """
    # Try e.g.:
    #   return color.flip(-1)                         # swap channels
    #   return color ** 2.2                           # crush gamma
    #   return color.mean(-1, keepdim=True).expand_as(color)  # grayscale
    return color
'''


def load_shader(path):
    spec = importlib.util.spec_from_file_location("user_shader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.shade


def main(argv=None):
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="config2")
    ap.add_argument("--shader", default=os.path.join(tmp, "xr_torch_shader.py"))
    ap.add_argument("--out", default=os.path.join(tmp, "xr_torch_preview.png"))
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--t", type=float, default=0.4, help="animation time")
    ap.add_argument("--poll", type=float, default=0.5)
    ap.add_argument("--once", action="store_true", help="render once and exit")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from xr_torch import Renderer, convert
    from xr_torch.core.image import write_png
    from xr_torch.examples.run import make_preset, resolve_device
    from xr_torch.scene.presets import small_preset

    dev = resolve_device(args.device)
    if not os.path.exists(args.shader):
        with open(args.shader, "w") as f:
            f.write(STARTER)
        print(f"wrote starter shader to {args.shader}")

    p = small_preset(make_preset(args.preset, dev), args.width, args.height, bin_capacity=8192)
    cam, mm = p.animate(args.t)
    scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), dev)

    def render_with(user_shade):
        r = Renderer(scene, p.config, dev, shade_hook=user_shade)
        return r.readback(r.step(scene, cam)).color

    mtime = 0.0
    while True:
        m = os.path.getmtime(args.shader)
        if m != mtime:
            mtime = m
            try:
                t0 = time.time()
                write_png(args.out, render_with(load_shader(args.shader)))
                print(f"[{time.strftime('%H:%M:%S')}] reloaded {args.shader} "
                      f"({args.preset}) -> {args.out} ({time.time() - t0:.1f}s)", flush=True)
            except Exception:  # a broken shader keeps the previous preview
                print("shader error; keeping the previous pipeline:")
                traceback.print_exc(limit=3)
        if args.once:
            break
        time.sleep(args.poll)


if __name__ == "__main__":
    main()
