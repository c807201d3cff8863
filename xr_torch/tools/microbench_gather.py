"""Texture-row fetch microbenchmark on the card (port of
``tools/microbench_gather.py``).

    python -m xr_torch.tools.microbench_gather

The reference's inputs (numpy, seed 0): 1920x1080 = 2,073,600 pixel
indices with config3-like coherence into a quad table of 2 textures x
87,381 entries x 13 u32 texels. It times, by CUDA events around 20 calls
back to back (a warm L2, the reference's protocol; ``chip_smoke.py`` times
the kernels with a cold one) that are queued behind a spin on the device
(``timing.device_ms``: the device's time, not the host's pace), the
reference's XLA fetch variants written as the same torch indexing expressions (2-D vs
flat index, row widths 13/16/4, two row fetches, sort + gather + unsort) —
the yardstick of what row width and index form cost on this card — and
then the two lane-gather kernels of the reference (csrc/gather.cu) on the
transposed (16, 174,848) table: the 16-channel summed gather (P2) and the
one-channel gather (P3), each checked bit for bit against its plain
version. A kernel that fails to build, launch or match ends the run with an
error; there is no CPU fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from xr_torch.tools import gather, timing

NPIX = 1920 * 1080  # 2,073,600
P = 87381  # 256^2 + 128^2 + ... + 1 (quad-pyramid entries per texture)
NTEX = 2
PP = (NTEX * P + 127) // 128 * 128  # 174,848: the lane-padded table width
NB = NPIX // 1024  # 2025 blocks of (8, 128)
I32 = torch.int32


def make_inputs():
    """The reference's numpy inputs (``tools/microbench_gather.py:41-54``):
    idx (NPIX,) i32, tex (NPIX,) i32, quads (NTEX, P, 13) u32."""
    rng = np.random.default_rng(0)
    base = (np.arange(NPIX, dtype=np.int64) * 37) % (P // 2)
    jitter = rng.integers(0, 64, NPIX)
    idx = ((base + jitter) % P).astype(np.int32)
    tex = (rng.random(NPIX) < 0.5).astype(np.int32)
    quads = rng.integers(0, 2**32, (NTEX, P, 13), dtype=np.uint32)
    return idx, tex, quads


def lane_layout(idx, tex, quads):
    """The kernels' operands (``tools/microbench_gather.py:101-106``): flat
    indices tex * P + idx as (NB, 8, 128) i32 and the transposed table
    (16, PP) (13 texel rows, zero padded), u32 as int32 bits."""
    tab = np.zeros((16, PP), np.uint32)
    tab[:13, : NTEX * P] = quads.reshape(NTEX * P, 13).T
    flat = (tex * P + idx)[: NB * 1024].reshape(NB, 8, 128).astype(np.int32)
    return flat, tab.view(np.int32)


def timed(fn, *args, iters=20, name=""):
    """Mean device time of fn(*args) with a warm L2; prints the reference's
    line. Returns seconds."""
    ms, reps = timing.device_ms(lambda: fn(*args), reps=iters)
    dt = ms / 1e3
    print(f"{name:28s} {dt*1e3:8.4f} ms   {dt*1e9/NPIX:6.3f} ns/px   "
          f"(warm L2, {reps} calls queued behind a device spin)", flush=True)
    return dt


# the reference's XLA variants (``tools/microbench_gather.py:56-95``) as
# torch indexing; each row is summed with u32 wraparound (int32 sums)


def g_2d(q, t, i):
    return q[t, i].sum(-1, dtype=I32)  # (N, 13) — the sample_trilinear shape


def g_flat(q, t, i):
    return q[t * P + i].sum(-1, dtype=I32)


def g_two4(q, t, i):
    r0 = q[t * P + i]
    r1 = q[t * P + ((i * 5) % P)]
    return r0.sum(-1, dtype=I32) + r1.sum(-1, dtype=I32)


def g_sorted13(q, t, i):
    # sort indices, gather, unsort — does locality matter?
    order = torch.argsort(i)
    r = q[t[order] * P + i[order]].sum(-1, dtype=I32)
    inv = torch.argsort(order)
    return r[inv]


def main(device=None) -> dict:
    """Run every variant and both kernels on `device` (the first CUDA card
    by default). Returns {name: seconds}; raises if there is no card or a
    kernel differs from its plain version."""
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("microbench_gather: needs a CUDA card")
        device = torch.device("cuda", 0)
    idx_np, tex_np, quads_np = make_inputs()
    quads2d = torch.from_numpy(quads_np.view(np.int32)).to(device)
    quads_flat = quads2d.reshape(NTEX * P, 13)
    quads16 = torch.nn.functional.pad(quads_flat, (0, 3))
    quads4 = quads_flat[:, :4].contiguous()
    idx = torch.from_numpy(idx_np).to(device)
    tex = torch.from_numpy(tex_np).to(device)

    out = {}
    for name, fn, q in (
        ("torch 2d-index (N,13)", g_2d, quads2d),
        ("torch flat-index (N,13)", g_flat, quads_flat),
        ("torch flat-index (N,16)", g_flat, quads16),
        ("torch flat-index (N,4)", g_flat, quads4),
        ("torch 2x flat-index (N,4)", g_two4, quads4),
        ("torch sort+gather+unsort 13", g_sorted13, quads_flat),
    ):
        out[name] = timed(fn, q, tex, idx, name=name)

    flat_h, tab_h = lane_layout(idx_np, tex_np, quads_np)
    flat = torch.from_numpy(flat_h).to(device)
    tab = torch.from_numpy(tab_h).to(device)
    for name, fn, plain in (
        ("cuda lane-gather 16ch", gather.quad_gather, gather.quad_gather_plain),
        ("cuda lane-gather 1ch", gather.quad_gather1, gather.quad_gather1_plain),
    ):
        got = fn(flat, tab)
        if not torch.equal(got, plain(flat, tab)):
            raise RuntimeError(f"{name}: the kernel differs from its plain version")
        out[name] = timed(fn, flat, tab, name=name)
    return out


if __name__ == "__main__":
    main()
