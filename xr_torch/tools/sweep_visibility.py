"""Sweep of the visibility kernels' constants and probes, on the card.

    python -m xr_torch.tools.sweep_visibility

Rebuilds the kernels (csrc/fold_records.cuh) once per variant, each in a
process of its own, and times the stream kernel on config3, the list kernel
on config2 and the stream kernel on config4's shadow pass and camera pass,
all at 1920x1080 (t = 0.3), by CUDA events over 50 launches queued behind
20 ms of spinning on the device. A variant is threads per CTA, records per
work item, CTAs an SM must hold (which caps the registers), and probes:
``runs`` deals a tile's records to its chunks as runs of consecutive records
(exact), ``nofold``, ``nomerge`` and ``nostage`` compile the pixel work, the
merge or the staging out, which breaks the output and shows where the time
goes. Each line also says whether the output matched the plain version and
what ptxas reported for the fold kernel. A line of one variant:

    python -m xr_torch.tools.sweep_visibility 512,128,2,nofold
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys

import torch

VARIANTS = (
    "256,128,1,runs", "256,128,1", "512,128,2", "512,128,1", "1024,128,1", "512,64,2",
    "512,256,2", "512,128,2,nofold", "512,128,2,nomerge", "512,128,2,nofold,nomerge",
    "512,128,2,nofold,nomerge,nostage", "512,128,2",
)
CASES = (("vis_stream", "config3", False), ("vis_lists", "config2", False),
         ("vis_stream", "config4", True), ("vis_stream", "config4", False))


def _inputs(dev, kernel, name, shadow):
    """(prepared inputs, config, launch, plain version) of one case."""
    from xr_torch import convert
    from xr_torch.app.renderer import shadow_config, visible_triangles
    from xr_torch.core import math3d as m3
    from xr_torch.pipeline.geometry import clip_capacity
    from xr_torch.pipeline.shadow import light_matrices_for_scene
    from xr_torch.raster import smem, stream
    from xr_torch.scene import presets

    p = presets.config3_terrain() if name == "config3" else presets.ALL_PRESETS[name]()
    cam, mm = p.animate(0.3)
    scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), dev)
    cfg = p.config
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
    return prepare(tri, cfg), cfg, launch, plain


def run_variant(spec: str) -> dict:
    """Build one variant in this process and time the four cases."""
    from xr_torch import kernels
    from xr_torch.raster import records
    from xr_torch.tools import timing

    threads, item, min_ctas, *probes = spec.split(",")
    kernels.NVCC_FLAGS += [f"-DXR_THREADS={threads}", f"-DXR_ITEM={item}",
                           f"-DXR_MIN_CTAS={min_ctas}"]
    kernels.NVCC_FLAGS += [{"runs": "-DXR_RUNS", "nofold": "-DXR_NO_FOLD",
                            "nomerge": "-DXR_NO_MERGE", "nostage": "-DXR_NO_STAGE"}[p]
                           for p in probes]
    records.ITEM_RECORDS = int(item)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        kernels.build(verbose=True)
    fold = re.search(r"fold_kernel.*?\n.*?(\d+) bytes spill stores.*?\n.*?Used (\d+) registers",
                     log.getvalue())
    dev = torch.device("cuda", 0)
    # a variant built before (the same flags) prints nothing
    row = {"variant": spec, "registers": int(fold.group(2)) if fold else None,
           "spill_bytes": int(fold.group(1)) if fold else None}
    for kernel, name, shadow in CASES:
        inp, cfg, launch, plain = _inputs(dev, kernel, name, shadow)
        got, want = launch(inp, cfg), plain(inp, cfg)
        exact = torch.equal(got[0], want[0]) and torch.equal(got[1].view(torch.int32),
                                                             want[1].view(torch.int32))
        label = f"{kernel} {name}{' shadow pass' if shadow else ''}"
        # 50 launches (L2 warm) that the host enqueues while the device spins
        ms = timing.device_ms(lambda: launch(inp, cfg), reps=50, warmup=3)[0]
        row[label] = {"ms": ms, "exact": exact}
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
        broken = any(p in spec for p in ("nofold", "nomerge", "nostage"))
        if not broken and not all(v["exact"] for v in rows[-1].values() if isinstance(v, dict)):
            raise RuntimeError(f"variant {spec} differs from the plain version")
    return rows


if __name__ == "__main__":
    if len(sys.argv) > 1:
        print(json.dumps(run_variant(sys.argv[1])), flush=True)
    else:
        main()
