"""Sweep of the gather kernels' designs, constants and probes, on the card.

    python -m xr_torch.tools.sweep_gather

Rebuilds csrc/gather.cu once per variant (``-D`` macros, see the source's
header: the design of the lane gather P1 and of the 16-channel quad gather
P2, threads a CTA, table rows a thread, lanes an index, the columns of a
transpose tile, the table size from which P1 transposes, the dependent
launch of a launch's second kernel, the prefetch pass, the design of the
one-channel gather P3 with its threads, unroll, slice size, interleaving
and the ratio of indices to table words from which it takes its slices; the
empty variant is the source as it stands) and, in one process, holds every
variant bit for bit against the plain versions (the tools' indices,
uniformly random ones, indices outside the row, S = 13 for P2, P3 also on a
second table of odd width and on one that does not start on 16 bytes, in
turn with the first, a second launch against the first and the launch
after the timed ones) and times it with a
cold L2 (a 128 MB write before each launch, events around the launch alone)
and with a warm one, every launch queued behind a spin on the device
(``timing.device_ms``). P1 is timed at the probe's four shapes, P2 and the
one-channel gather P3 at the full 2,073,600-index shape, both also on random
indices. Design 0 is the one-thread-an-element kernel that reads the table
in place; the list starts and ends with it, so that a drift of the card
shows. ``P2_NO_TRANSPOSE`` and ``P2_NO_GATHER`` compile one of P2's two
kernels out: they break the output and show how a launch's time splits
(without the transpose the rows are read from device memory when the L2 is
cold: the cost of the gather alone for a caller that keeps its table
row-major). A line also carries what ptxas reported (registers, spill
bytes) for each gather kernel. Variants of one's own, macros without the
``XR_`` prefix:

    python -m xr_torch.tools.sweep_gather P2_LANES=2,PDL=0 P1_ROWS_MIN=0 ""
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys

import numpy as np
import torch

VARIANTS = (
    "P1_DESIGN=0,P2_DESIGN=0,P3_DESIGN=0",
    "P3_DESIGN=0", "P3_DESIGN=1", "P3_DESIGN=2", "P3_DESIGN=2,P3_THREADS=512",
    "P3_DESIGN=2,P3_UNROLL=2", "P3_DESIGN=2,P3_UNROLL=8", "P3_DESIGN=2,P3_UNROLL=16",
    "P3_DESIGN=2,P3_SLICE_KB=100", "P3_DESIGN=2,P3_MIN_RATIO=0",
    "P3_DESIGN=2,P3_INTERLEAVE=1,P3_UNROLL=8", "P3_DESIGN=0",
    "", "PDL=0", "T_ANY,PDL=0,P2_THREADS=256", "T_ANY,PDL=0,P2_THREADS=256,P1_ROWS_MIN=0",
    "T_COLS=128",
    "P2_LANES=2", "P2_LANES=1", "P2_LANES=8", "P2_THREADS=256", "P2_THREADS=512",
    "P2_NO_TRANSPOSE,PDL=0", "P2_NO_GATHER,PDL=0",
    "P1_ROWS_MIN=0", "P1_ROWS_MIN=0,PDL=0", "P1_ROWS_MIN=0,G_COLS=64", "P1_ROWS_MIN=0,G_COLS=256",
    "P1_DESIGN=1,P1_ROWS=4", "P1_DESIGN=1,P1_ROWS=8", "P1_DESIGN=1,P1_ROWS=16",
    "P1_DESIGN=1,P1_ROWS=32", "P1_DESIGN=1,P1_ROWS=8,P1_THREADS=128",
    "P1_DESIGN=1,P1_ROWS=8,P1_PREFETCH=1", "P1_DESIGN=1,P1_ROWS=8,P1_PREFETCH=2",
    "", "P1_DESIGN=0,P2_DESIGN=0,P3_DESIGN=0",
)
PROBES = ("P2_NO_TRANSPOSE", "P2_NO_GATHER")


def _flags(spec: str) -> list:
    return [f"-DXR_{m}" for m in spec.split(",") if m]


def _build(spec: str) -> dict:
    """Build and load the variant's library in this process. Returns what
    ptxas said of each gather kernel: {name: [registers, spill bytes]}."""
    from xr_torch import kernels

    kernels.NVCC_FLAGS = [f for f in kernels.NVCC_FLAGS if not f.startswith("-DXR_")]
    kernels.NVCC_FLAGS += _flags(spec)
    kernels._lib = None
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        kernels.build(verbose=True)
    kernels.library()
    found = re.findall(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores.*?"
                       r"Used (\d+) registers", log.getvalue(), re.S)
    out = {}
    for mangled, spill, regs in found:
        name = re.search(r"\d+((?:lane_gather|quad_gather|transpose|prefetch)\w*?_kernel)"
                         r"(?:ILi(\d+)E)?", mangled)
        if name:  # a template's instance as name<argument>
            key = name.group(1) + (f"<{name.group(2)}>" if name.group(2) else "")
            out[key] = [int(regs), int(spill)]
    return out


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    torch.cuda.synchronize()
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _inputs(dev) -> dict:
    """The tools' operands on the card, and random ones beside them."""
    from xr_torch.tools import microbench_gather as mb
    from xr_torch.tools import probe_lanegather as plg

    rng = np.random.default_rng(1)
    idx_np, tex_np, quads = mb.make_inputs()
    flat_h, tab_h = mb.lane_layout(idx_np, tex_np, quads)
    pp = tab_h.shape[1]
    on = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    inp = {
        "flat": on(flat_h), "tab": on(tab_h),
        "random": on(rng.integers(0, pp, flat_h.shape).astype(np.int32)),
        # one in eight outside the row, on either side
        "outside": on(rng.integers(-pp // 16, pp + pp // 16, (997, 131)).astype(np.int32)),
        "outside_full": on(rng.integers(-pp // 16, pp + pp // 16, flat_h.shape).astype(np.int32)),
        "lanes": [],
    }
    # P3's other tables: an odd width (a slice that ends on single words),
    # and the same words one word off a 16-byte boundary
    odd = rng.integers(-2**31, 2**31, (2, 100_003)).astype(np.int32)
    shifted = on(np.concatenate([[0], odd.reshape(-1)]).astype(np.int32))[1:].view(2, 100_003)
    inp["p3_tables"] = [inp["tab"], on(odd), shifted]
    inp["p3_idx"] = on(rng.integers(-9_000, 109_000, flat_h.shape).astype(np.int32))
    for width, subl, dtype in plg.SHAPES:
        tab, idx, _ = plg.make_inputs(width, subl, dtype)
        W = tab.shape[1]
        outside = rng.integers(-W // 16, W + W // 16, (1, W)).astype(np.int32)
        inp["lanes"].append((f"({subl}, {W}) {np.dtype(dtype).name}", on(tab), on(idx),
                             on(outside)))
    # the microbenchmark's (N, 16) row gather in torch: the same bytes as P2
    q16 = np.zeros((mb.NTEX * mb.P, 16), np.int32)
    q16[:, :13] = quads.reshape(-1, 13).view(np.int32)
    inp["torch_rows"] = (on(q16), on(tex_np), on(idx_np))
    return inp


def _times(fn, flush, reps=50) -> dict:
    from xr_torch.tools import timing

    cold, n = timing.device_ms(fn, reps=reps, flush=flush)
    warm, _ = timing.device_ms(fn, reps=reps)
    return {"cold_ms": cold, "warm_ms": warm, "reps": n}


def check_p3(inp: dict) -> bool:
    """The one-channel gather against its plain version: the tool's
    indices, random ones, ones outside the row (few, and as many as the
    tool's), and three tables in turn, twice."""
    from xr_torch.tools import gather

    ok = True
    for i in (inp["flat"], inp["random"], inp["outside"], inp["outside_full"]):
        ok &= _same(gather.quad_gather1(i, inp["tab"]), gather.quad_gather1_plain(i, inp["tab"]))
    for _ in range(2):
        for tab in inp["p3_tables"]:
            i = inp["flat"] if tab is inp["tab"] else inp["p3_idx"]
            ok &= _same(gather.quad_gather1(i, tab), gather.quad_gather1_plain(i, tab))
    return ok


def run_variant(spec: str, inp: dict, flush: torch.Tensor) -> dict:
    """Build one variant, check it and time what it changes."""
    from xr_torch.tools import gather

    row = {"variant": spec, "ptxas": _build(spec)}
    probe = any(p in spec for p in PROBES)
    exact = True
    macros = [m for m in spec.split(",") if m]
    # a variant that names macros of one kernel only is timed on that kernel
    only_p1 = bool(macros) and all(m.startswith("P1_") or m.startswith("G_") for m in macros)
    only_p2 = bool(macros) and all(m.startswith("P2_") for m in macros)
    only_p3 = bool(macros) and all(m.startswith("P3_") for m in macros)
    if not (only_p1 or only_p2):
        flat, tab = inp["flat"], inp["tab"]
        exact = check_p3(inp)
        row["quad_gather1"] = _times(lambda: gather.quad_gather1(flat, tab), flush)
        row["quad_gather1 random idx"] = _times(
            lambda: gather.quad_gather1(inp["random"], tab), flush)
        exact = exact and _same(gather.quad_gather1(flat, tab),
                                gather.quad_gather1_plain(flat, tab))
    if not (only_p1 or only_p3):
        flat, tab = inp["flat"], inp["tab"]
        want = gather.quad_gather_plain(flat, tab)
        first = gather.quad_gather(flat, tab)
        checks = [
            _same(first, want),
            _same(gather.quad_gather(flat, tab), first),
            _same(gather.quad_gather(inp["random"], tab),
                  gather.quad_gather_plain(inp["random"], tab)),
            _same(gather.quad_gather(inp["outside"], tab),
                  gather.quad_gather_plain(inp["outside"], tab)),
            _same(gather.quad_gather(inp["outside"], tab[:13].contiguous()),
                  gather.quad_gather_plain(inp["outside"], tab[:13].contiguous())),
        ]
        row["quad_gather"] = _times(lambda: gather.quad_gather(flat, tab), flush)
        checks.append(_same(gather.quad_gather(flat, tab), want))
        row["quad_gather random idx"] = _times(
            lambda: gather.quad_gather(inp["random"], tab), flush)
        exact = exact and all(checks)
    if not (only_p2 or only_p3):
        for label, tab, idx, outside in inp["lanes"]:
            want = gather.lane_gather_plain(idx, tab)
            first = gather.lane_gather(idx, tab)
            checks = [
                _same(first, want),
                _same(gather.lane_gather(idx, tab), first),
                _same(gather.lane_gather(outside, tab), gather.lane_gather_plain(outside, tab)),
            ]
            row[f"lane_gather {label}"] = _times(lambda: gather.lane_gather(idx, tab), flush)
            checks.append(_same(gather.lane_gather(idx, tab), want))
            exact = exact and all(checks)
    row["exact"] = exact
    if not exact and not probe:
        raise RuntimeError(f"variant {spec} differs from the plain version: {row}")
    return row


def main(specs=VARIANTS) -> list:
    """Every variant in this process; prints a JSON line each. Raises
    without a card or if a variant that is no probe is not bit-exact."""
    if not torch.cuda.is_available():
        raise SystemExit("sweep_gather: needs a CUDA card")
    from xr_torch.tools import microbench_gather as mb
    from xr_torch.tools import timing

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    inp, flush = _inputs(dev), timing.flush_buffer(dev)
    print(json.dumps({"torch flat-index (N,16)":
                      _times(lambda: mb.g_flat(*inp["torch_rows"]), flush, reps=20)}), flush=True)
    rows = []
    for spec in specs:
        rows.append(run_variant(spec, inp, flush))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main(tuple(sys.argv[1:]) or VARIANTS)
