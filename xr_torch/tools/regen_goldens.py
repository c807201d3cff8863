"""Render the golden frames with the port's CPU oracle (port of
``tools/regen_goldens.py``): the goldens are generated by the oracle, so
they can be derived again, never blessed by hand.

Each golden's size, time and config overrides come from
``tests/goldens/manifest.json``. The PNGs and a manifest of the same keys
(coverage measured anew) go to the output directory; the checked-in
``tests/goldens`` is never written, and naming it is refused.

Usage: python -m xr_torch.tools.regen_goldens [outdir [name ...]]
(default build/goldens at the repository root, every golden)
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")
DEFAULT_OUT = os.path.join(ROOT, "build", "goldens")


def factories() -> dict:
    """The preset of each golden, as the reference's tool builds it
    (config7's capacities measured by its dry pass on the CPU)."""
    from xr_torch.scene import presets

    return {
        "config1": presets.config1_cube,
        "config2": presets.config2_icospheres,
        "config3": lambda: presets.config3_terrain(nx=48, nz=48),
        "config4": presets.config4_phong,
        "config4b": presets.config4_blend,  # two transparent panes over config4
        "config5": lambda: presets.config5_flythrough(nx=64, nz=64),
        "config6": presets.config6_asset,  # the courtyard from its files
        "config6cap": presets.config6_capped,  # its texture-area cap
        "config7": lambda: presets.config7_terrain_lod(n0=64, device="cpu"),
    }


def main(outdir: str = DEFAULT_OUT, *names: str) -> dict:
    """Render the named goldens (all when none is named) into outdir;
    returns the manifest written there."""
    from xr_torch.core.image import write_png
    from xr_torch.cpu_ref import render_frame
    from xr_torch.scene import presets

    golden = os.path.realpath(GOLDEN_DIR)
    out = os.path.realpath(outdir)
    if out == golden or out.startswith(golden + os.sep):
        raise SystemExit(f"regen_goldens: refusing to write under {golden}; name another directory")
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as f:
        cases = json.load(f)
    unknown = set(names) - set(cases)
    if unknown:
        raise SystemExit(f"regen_goldens: no golden named {sorted(unknown)}")
    os.makedirs(outdir, exist_ok=True)
    make = factories()
    manifest = {}
    for name, case in cases.items():
        if names and name not in names:
            continue
        w, h, t, over = case["width"], case["height"], case["t"], case["overrides"]
        p = presets.small_preset(make[name](), w, h, **over)
        cam, mm = p.animate(t)
        frame = render_frame(p.scene.replace(model_matrices=mm), cam, p.config)
        if int(frame.stats["clip_overflow"]):
            raise RuntimeError(f"{name}: clip_overflow {int(frame.stats['clip_overflow'])}")
        path = os.path.join(outdir, f"{name}.png")
        write_png(path, frame.color)
        manifest[name] = {"width": w, "height": h, "t": t, "overrides": over,
                          "coverage": float((frame.depth < 1.0).mean())}
        print(f"{name}: coverage={manifest[name]['coverage']:.3f} -> {path}", flush=True)
    with open(os.path.join(outdir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


if __name__ == "__main__":
    main(*sys.argv[1:])
