"""Timing and tracing of the port (port of ``xr/prof.py``): host-clock pass
timings for the example runner, and a torch.profiler trace in place of the
reference's XLA trace, and the spans the frame's stages run under.
Nothing runs unless called."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional


class FrameTimer:
    """Wall-clock pass timings + fps/Mpix counters for the example runner.

    Usage:
        timer = FrameTimer()
        with timer.section("frame"):
            frame = renderer.readback(renderer.step(scene, camera))
        print(timer.report(pixels_per_frame=W*H))
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def mean_ms(self, name: str) -> float:
        if self.counts.get(name, 0) == 0:
            return 0.0
        return self.totals[name] / self.counts[name] * 1e3

    def report(self, pixels_per_frame: Optional[int] = None) -> str:
        out = {k: round(self.mean_ms(k), 3) for k in self.totals}
        if pixels_per_frame and self.counts.get("frame"):
            dt = self.totals["frame"] / self.counts["frame"]
            out["fps"] = round(1.0 / dt, 2)
            out["mpixels_shaded_per_s"] = round(pixels_per_frame / dt / 1e6, 1)
        return json.dumps(out)


TRACE_FILE = "trace.json"
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` span named `name` while a
    profiler records, else a no-op context: a span costs microseconds a
    call, the test a fraction of one. The frame's stages (camera,
    shadow_pass, geometry, bin_prep, vis, shade, blend, resolve) run under
    spans of those names, which a trace reads their device time from."""
    import torch

    return torch.profiler.record_function(name) if torch._C._autograd._profiler_enabled() \
        else _NO_SPAN


@contextlib.contextmanager
def spans(names):
    """The spans `names`, outermost first, nested (none for an empty
    list)."""
    with contextlib.ExitStack() as stack:
        for n in names:
            stack.enter_context(span(n))
        yield


@contextlib.contextmanager
def torch_trace(log_dir: str):
    """Trace the block with torch.profiler (CPU, and CUDA where a card is
    present) and write it as a Chrome trace, ``log_dir/trace.json``
    (chrome://tracing, Perfetto); yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
