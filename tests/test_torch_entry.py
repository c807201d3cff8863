"""The port's entry points and host modules on the CPU: FrameTimer against
the reference's (``xr/prof.py``) on the same timings; ``python -m
xr_torch.examples.run`` as a user runs it, whose ``done`` stats equal the
reference Renderer's (and, with ``--shards 2``, the reference
ShardedRenderer's) on the same frame, with a scene saved and loaded back;
``--oracle``, every frame through the port's CPU oracle, against the
reference oracle's frame; the runner's refusal of a missing card (without
``--oracle``); ``watch --once`` writing its PNG;
and ``tools.profile_frame``: a capture on the CPU and its parse, and the
parse of a trace with device events."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from xr import prof as ref_prof
from xr.app.renderer import Renderer as RefRenderer
from xr.cpu_ref import render_frame as ref_render_frame
from xr.dist.shard import ShardedRenderer as RefShardedRenderer
from xr.scene import presets as ref_presets
from xr_torch import prof
from xr_torch.core.image import read_png
from xr_torch.examples import run, watch
from xr_torch.tools import profile_frame

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_frame_timer_report_equals_reference():
    timers = (prof.FrameTimer(), ref_prof.FrameTimer())
    for t in timers:
        t.totals = {"frame": 0.0731, "present": 0.0123}
        t.counts = {"frame": 3, "present": 2}
    for px in (None, 1920 * 1080):
        assert timers[0].report(pixels_per_frame=px) == timers[1].report(pixels_per_frame=px)
    with timers[0].section("x"):
        pass
    assert timers[0].counts["x"] == 1 and timers[0].mean_ms("x") >= 0.0
    assert timers[0].mean_ms("missing") == 0.0


def _run(*args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "xr_torch.examples.run", *args], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    events = [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]
    return {e["event"]: e for e in events}


@pytest.mark.parametrize("shards", [0, 2])
def test_run_done_stats_equal_reference(tmp_path, shards):
    scene_path = str(tmp_path / "scene.npz")
    args = ["config1", "--width", "160", "--height", "160", "--frames", "2", "--device", "cpu"]
    ev = _run(*args, "--shards", str(shards), "--save-scene", scene_path)
    assert set(ev) == {"scene_saved", "first_frame", "done"}
    assert ev["done"]["device"] == "cpu" and ev["done"]["frames"] == 2
    # the last frame is at t = dt: the reference's frame there
    p = ref_presets.small_preset(ref_presets.config1_cube(), 160, 160,
                                 num_shards=max(shards, 1))
    cam, mm = p.animate(1.0 / 30.0, np)
    scene = p.scene.replace(model_matrices=mm)
    r = RefShardedRenderer(scene, p.config) if shards else RefRenderer(scene, p.config)
    want = {k: int(v) for k, v in r.readback(r.step(scene, cam)).stats.items()}
    assert ev["done"]["stats"] == want
    # the saved scene renders the same frame
    again = _run(*args, "--shards", str(shards), "--scene", scene_path)
    assert again["done"]["stats"] == want


def test_run_dumps_frames_and_a_trace(tmp_path):
    out = str(tmp_path / "out")
    ev = _run("config2", "--width", "64", "--height", "48", "--frames", "3", "--device", "cpu",
              "--dump-every", "1", "--out", out, "--profile", "--autosize")
    assert {"autosized", "profile", "done"} <= set(ev) and ev["profile"]["dir"] == out
    assert all(ev["done"]["stats"][k] == 0 for k in ("clip_overflow", "bin_overflow"))
    names = sorted(os.listdir(out))
    assert names == ["config2_0000.png", "config2_0001.png", "config2_0002.png",
                     "config2_final.png", prof.TRACE_FILE]
    last, final = (read_png(os.path.join(out, n)) for n in names[2:4])
    assert last.shape == (48, 64, 3) and (last == final).all()


def test_run_oracle_renders_on_the_cpu(tmp_path):
    """--oracle: every frame through the CPU oracle, with no --device; the
    last frame (t = dt) has the reference oracle's stats, its dump the
    reference oracle's pixels within 1 LSB."""
    out = str(tmp_path / "out")
    ev = _run("config1", "--oracle", "--frames", "2", "--width", "64", "--height", "64",
              "--dump-every", "1", "--out", out)
    assert set(ev) == {"first_frame", "done"}
    assert ev["done"]["device"] == "cpu" and ev["done"]["frames"] == 2
    p = ref_presets.small_preset(ref_presets.config1_cube(), 64, 64)
    cam, mm = p.animate(1.0 / 30.0, np)
    ref = ref_render_frame(p.scene.replace(model_matrices=mm), cam, p.config)
    assert ev["done"]["stats"] == {k: int(v) for k, v in ref.stats.items()}
    got = read_png(os.path.join(out, "config1_0001.png")).astype(int)
    assert np.abs(got - ref.color.astype(int)).max() <= 1
    assert sorted(os.listdir(out)) == ["config1_0000.png", "config1_0001.png",
                                       "config1_final.png"]


def test_run_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        run.resolve_device("cuda")
    with pytest.raises(SystemExit, match="no CUDA device"):
        run.main(["config1", "--frames", "1", "--width", "32", "--height", "32"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        watch.main(["--once", "--device", "cuda:0"])
    assert run.resolve_device("cpu") == torch.device("cpu")


def test_watch_once_writes_the_preview(tmp_path):
    shader, out = str(tmp_path / "shader.py"), str(tmp_path / "preview.png")
    common = ["--once", "--device", "cpu", "--preset", "config3", "--width", "64", "--height",
              "48", "--shader", shader, "--out", out]
    watch.main(common)  # writes the starter shader, which returns color
    assert open(shader).read() == watch.STARTER
    plain = read_png(out)
    assert plain.shape == (48, 64, 3) and plain.max() > 0
    with open(shader, "w") as f:
        f.write("def shade(color, scene, mat_id, xp):\n"
                "    return xp.flip(color, dims=[-1])\n")
    watch.main(common)
    flipped = read_png(out)
    assert (flipped == plain[..., ::-1]).all()


def test_profile_frame_capture_and_parse_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "prof")
    got = profile_frame.main(["config1", "--frames", "2", "--device", "cpu", "--out", out,
                              "--override", "width=64", "--override", "height=64"])
    text = capsys.readouterr().out
    assert "device total: 0.000 ms over 2 frames" in text and "not measured" in text
    assert got["device_ms_per_frame"] == 0.0 and got["busy_share"] is None
    assert got["host_ms_per_frame"] > 0.0
    with open(os.path.join(out, profile_frame.CAPTURE_FILE)) as f:
        assert json.load(f)["device"] == "cpu"


def test_profile_frame_parse_sums_device_events(tmp_path, capsys):
    def ev(cat, name, dur):
        return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 7, "ts": 0.0, "dur": dur}

    events = [ev("kernel", "void xr::fold_kernel<xr::StreamWalk>(int const*, xr::StreamWalk)",
                 300.0),
              ev("kernel", "void xr::clear_kernel<xr::StreamWalk>(int const*)", 100.0),
              ev("kernel", "void cub::DeviceRadixSortOnesweepKernel<int>()", 200.0),
              ev("kernel", "void at::native::index_elementwise_kernel<128, 4>()", 150.0),
              ev("kernel", "void at::native::vectorized_elementwise_kernel<4>()", 50.0),
              ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 100.0),
              ev("gpu_memset", "Memset (Device)", 20.0),
              ev("kernel", "void at::native::reduce_kernel<512, 1>()", 80.0),
              ev("cpu_op", "aten::add", 5000.0)]
    with open(tmp_path / prof.TRACE_FILE, "w") as f:
        json.dump({"traceEvents": events}, f)
    with open(tmp_path / profile_frame.CAPTURE_FILE, "w") as f:
        json.dump({"host_ms_per_frame": 2.0, "device_name": "a card"}, f)
    got = profile_frame.parse(str(tmp_path), frames=2, top=3)
    assert got["device_ms_per_frame"] == pytest.approx(0.5)
    assert got["busy_share"] == pytest.approx(0.25)
    assert got["buckets_ms"] == pytest.approx({"vis_stream": 0.4, "sort": 0.2,
                                               "gather/index": 0.15, "elementwise": 0.05,
                                               "copy/memcpy": 0.12, "other": 0.08})
    text = capsys.readouterr().out
    assert "device total: 1.000 ms over 2 frames => 0.500 ms/frame" in text
    assert "device busy share 0.2500" in text
