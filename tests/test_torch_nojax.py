"""The port stands alone: with jax, flax and xr made unimportable, every
xr_torch module (the gather tools, the OBJ loader, the screen bands, scene
files, the profiler and the entry points included) imports and small
config1, config2, config3, config4, config4b, config5, config6 and config7
(its capacities measured by the port's own dry pass) frames render on the
CPU without launching a kernel, config5 also in its preset's four bands;
the CPU oracle renders, with its shadow mask, the scalar rasterizer runs
and the native codec parses. Each module of the oracle, the native codec
and the two asset tools, imported alone in a fresh interpreter, brings in
none of jax, flax or xr; so does each module of the z gate (the records,
the stream prep and wrapper, the sweep tool) and of the math helpers."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["xr"] = None
import numpy as np
import torch
torch.set_num_threads(1)
import xr_torch
for m in pkgutil.walk_packages(xr_torch.__path__, "xr_torch."):
    importlib.import_module(m.name)
from xr_torch import Renderer, ShardedRenderer, convert, kernels, prof
from xr_torch.core import serialize
from xr_torch.dist import shard
from xr_torch.examples import run, watch
from xr_torch.tools import profile_frame
from xr_torch.scene.presets import (config1_cube, config2_icospheres, config3_terrain,
                                    config4_blend, config4_phong, config5_flythrough,
                                    config6_asset, config7_terrain_lod, small_preset)
for preset, cov in ((config3_terrain(48, 48), 0.5), (config1_cube(), 0.1),
                    (config2_icospheres(), 0.1), (config4_phong(), 0.3), (config4_blend(), 0.3),
                    (config5_flythrough(32, 32), 0.5), (config6_asset(), 0.5),
                    (config7_terrain_lod(16, device="cpu"), 0.3)):
    p = small_preset(preset, 64, 48, shadow_map_size=min(preset.config.shadow_map_size, 64))
    cam, mm = p.animate(0.3)
    scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), "cpu")
    r = Renderer(scene, p.config, "cpu")
    f = r.readback(r.step(scene, cam))
    assert f.color.shape == (48, 64, 3) and f.color.dtype == np.uint8
    assert np.isfinite(f.depth).all() and (f.depth < 1.0).mean() > cov, p.name
    assert f.color.max() > 0
    if p.config.num_shards > 1:
        s = ShardedRenderer(scene, p.config, devices=["cpu"])
        g = s.readback(s.step(scene, cam))
        assert len(s.mesh) == 4 and g.color.tobytes() == f.color.tobytes()
# the CPU oracle, its shadow mask, the scalar rasterizer and the native codec
from xr_torch.cpu_ref import brute, render_frame
from xr_torch.cpu_ref.margins import frame_and_risk
from xr_torch.native import api
p = small_preset(config4_blend(), 64, 48, shadow_map_size=64)
cam, mm = p.animate(0.3)
f, risk = frame_and_risk(p.scene.replace(model_matrices=mm), cam, p.config)
assert f.color.shape == (48, 64, 3) and risk.shape == (48, 64) and (f.depth < 1.0).mean() > 0.3
p = small_preset(config1_cube(), 32, 32)
cam, mm = p.animate(0.7)
b_color, b_depth = brute.render(p.scene.replace(model_matrices=mm), cam, p.config)
o = render_frame(p.scene.replace(model_matrices=mm), cam, p.config)
assert np.abs(b_depth - o.depth).max() <= 1e-5 and np.abs(b_color.astype(int) - o.color).max() <= 2
assert api.parse_obj("assets/courtyard/courtyard.obj")["indices"].shape == (96456, 3)
assert not any(kernels.launches.values())
assert not any(k == "jax" or k.startswith(("jax.", "flax", "xr.")) for k, v in sys.modules.items() if v is not None)
print("OK")
"""


def test_port_imports_and_renders_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("OK")


ALONE = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(k for k, v in sys.modules.items()
             if v is not None and (k in ("jax", "flax", "xr") or k.startswith(("jax.", "flax.", "xr."))))
assert not bad, bad
print("OK")
"""


@pytest.mark.parametrize("module", [
    "xr_torch.cpu_ref.oracle", "xr_torch.cpu_ref.margins", "xr_torch.cpu_ref.brute",
    "xr_torch.native.api", "xr_torch.tools.regen_goldens", "xr_torch.tools.gen_assets",
    "xr_torch.raster.records", "xr_torch.raster.stream", "xr_torch.tools.sweep_visibility",
    "xr_torch.core.math3d", "xr_torch.core.types",
])
def test_module_alone_imports_no_jax(module):
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", ALONE, module], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == "OK"
