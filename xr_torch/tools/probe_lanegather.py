"""Lane-gather probe on the card (port of ``tools/probe_lanegather.py``).

    python -m xr_torch.tools.probe_lanegather

For each of the reference's four shapes — (S, W) = (8, 8192) u32,
(16, 8192) u32, (16, 75648) u32 and (32, 75648) f32, W rounded up to a
multiple of 128 — builds the reference's table and index (numpy, seed 0),
runs the lane gather ``out[s, j] = tab[s, idx[0, j]]`` through its CUDA
kernel (csrc/gather.cu), checks it against numpy's take_along_axis, and
prints its time as the reference prints its own: the mean of 20 launches
back to back, so the L2 is warm (``chip_smoke.py`` times the same kernel
with a cold one). The launches are queued behind a spin on the device
(``timing.device_ms``), so the time is the device's and not the pace at
which the host launches. A kernel that fails to build, launch or match ends
the run with an error; there is no CPU fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from xr_torch.tools import gather, timing

SHAPES = ((8192, 8, np.uint32), (8192, 16, np.uint32), (75616, 16, np.uint32),
          (75616, 32, np.float32))


def make_inputs(width: int, subl: int, dtype):
    """The reference's inputs (``tools/probe_lanegather.py:17-24``): tab
    (S, W) of integers below 2^20 as u32 (int32 bits here) or as f32 values,
    idx (1, W) i32 in [0, width). Returns numpy (tab, idx, tab_np u32)."""
    W = (width + 127) // 128 * 128
    rng = np.random.default_rng(0)
    tab_np = rng.integers(0, 1 << 20, size=(subl, W)).astype(np.uint32)
    idx_np = rng.integers(0, width, size=(1, W)).astype(np.int32)
    tab = tab_np.view(np.int32) if dtype == np.uint32 else tab_np.astype(np.float32)
    return tab, idx_np, tab_np


def bench(width: int, subl: int, dtype, device, iters: int = 20) -> dict:
    """One probe line. Returns {"W", "S", "dtype", "ok", "ms", "ns_elem"}."""
    tab_h, idx_h, tab_np = make_inputs(width, subl, dtype)
    S, W = tab_h.shape
    tab = torch.from_numpy(tab_h).to(device)
    idx = torch.from_numpy(idx_h).to(device)
    out = gather.lane_gather(idx, tab).cpu().numpy()
    ref = np.take_along_axis(tab_np, np.broadcast_to(idx_h, (S, W)), axis=1)
    ref = ref.view(np.int32) if dtype == np.uint32 else ref.astype(np.float32)
    ok = bool(np.array_equal(out, ref))
    ms, reps = timing.device_ms(lambda: gather.lane_gather(idx, tab), reps=iters)
    name = np.dtype(dtype).name
    print(f"W={W} S={S} {name}: ok={ok} {ms:.4f} ms ({ms * 1e6 / (S * W):.4f} ns/elem; "
          f"warm L2, {reps} launches queued behind a device spin)", flush=True)
    return {"W": W, "S": S, "dtype": name, "ok": ok, "ms": ms, "ns_elem": ms * 1e6 / (S * W)}


def main(device=None) -> list:
    """Run the four probes on `device` (the first CUDA card by default);
    raises if there is no card or a result differs from numpy."""
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("probe_lanegather: needs a CUDA card")
        device = torch.device("cuda", 0)
    rows = [bench(w, s, dt, device) for w, s, dt in SHAPES]
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"lane gather differs from numpy: {bad}")
    return rows


if __name__ == "__main__":
    main()
