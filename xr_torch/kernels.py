"""Hand-written CUDA kernels of the port: build, load, launch, count.

Kernels (one launch wrapper each):
  vis_stream    csrc/vis_stream.cu  streaming tile visibility
  vis_lists     csrc/vis_lists.cu   per-tile list visibility
  lane_gather   csrc/gather.cu      out[s, j] = tab[s, idx[j]]
  quad_gather   csrc/gather.cu      out[n] = sum_s tab[s, idx[n]] (u32, wrapping)
  quad_gather1  csrc/gather.cu      out[n] = tab[0, idx[n]]
The two visibility kernels share their record fold (csrc/fold_records.cuh):
a launch is a small clear kernel followed by the fold kernel over the work
items the prep lists, counted as one launch. The gathers carry the
texture-fetch microbenchmarks (xr_torch/tools/); a gather launch may be two
kernels too (quad_gather first writes the table row-major into scratch that
the wrapper allocates, then gathers whole rows), counted as one launch.

The sources under ``xr_torch/csrc/`` are compiled at first use with nvcc,
one process per source started together, and linked into one shared
library with a plain C interface (keyed by a hash of the sources, headers
and flags, under ``build/xr_torch/`` at the repository root, which
``.gitignore`` lists) and loaded with ctypes. A failed build or a nonzero
launch status raises: there is no fallback on a CUDA tensor.

``launches`` counts kernel launches per kernel name, so a run can show that
a frame went through the kernel. Only the launch wrappers touch it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = [CSRC / "vis_stream.cu", CSRC / "vis_lists.cu", CSRC / "gather.cu"]
HEADERS = [CSRC / "fold_records.cuh"]
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "xr_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]

TILE_W = 128  # tile width the visibility kernels take (csrc/fold_records.cuh)

launches = {"vis_stream": 0, "vis_lists": 0, "lane_gather": 0, "quad_gather": 0,
            "quad_gather1": 0}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the nvcc call in this process, if any


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _run(cmds, verbose: bool) -> None:
    """Run the commands in parallel; raise with the output of a failure."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)) for c in cmds]
    outs = [(c, p.communicate()[0], p.returncode) for c, p in procs]
    for c, out, rc in outs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(c)}\n{out}")
        if verbose:
            print(out)


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if it is not built yet; returns its path."""
    global build_seconds
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libxr_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in SOURCES]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    _run([[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(o), str(src)]
          for src, o in zip(SOURCES, objs)], verbose)
    _run([[nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]], verbose)
    build_seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink()
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.xr_vis_stream.argtypes = [p] * 13 + [i] * 9 + [p]
            lib.xr_vis_stream.restype = i
            lib.xr_vis_lists.argtypes = [p] * 11 + [i] * 10 + [p]
            lib.xr_vis_lists.restype = i
            lib.xr_lane_gather.argtypes = [p, p, p, p, i, i, p]
            lib.xr_quad_gather.argtypes = [p, p, p, p, i64, i, i, p]
            lib.xr_quad_gather1.argtypes = [p, p, p, i64, i, p]
            lib.xr_lane_gather_scratch.argtypes = lib.xr_quad_gather_scratch.argtypes = [i, i]
            for fn in (lib.xr_lane_gather, lib.xr_quad_gather, lib.xr_quad_gather1,
                       lib.xr_lane_gather_scratch, lib.xr_quad_gather_scratch):
                fn.restype = i
            lib.xr_cuda_error_string.argtypes = [i]
            lib.xr_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(name, t, dtype, shape=None, device=None):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def _check_tile(tile_w: int) -> None:
    if tile_w != TILE_W:
        raise ValueError(f"tile_w {tile_w}: the visibility kernels take tile_w {TILE_W}")


def _launch(name, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {library().xr_cuda_error_string(err).decode()}"
        )
    launches[name] += 1


def _check_items(item_tile, item_start, ntiles, dev):
    _check("item_tile", item_tile, torch.int32, None, dev)
    _check("item_start", item_start, torch.int32, (ntiles + 1,), dev)
    if item_tile.ndim != 1 or item_tile.shape[0] < ntiles:
        raise ValueError("item_tile must hold at least one chunk per tile")


def _outputs(height, width, tile_h, ntx, dev):
    """The (tid, z) frame and the kernels' scratch (64-bit keys of every
    tile pixel, one arrival counter per 32-row slab), none initialised."""
    nty = -(-height // tile_h)
    tid = torch.empty((height, width), dtype=torch.int32, device=dev)
    z = torch.empty((height, width), dtype=torch.float32, device=dev)
    keys = torch.empty((nty * tile_h, ntx * TILE_W), dtype=torch.int64, device=dev)
    arrivals = torch.empty((nty * ntx * -(-tile_h // 32),), dtype=torch.int32, device=dev)
    return tid, z, keys, arrivals


def vis_stream(rec, sid, starts, run_counts, tile_ran, large_ids, large_count,
               item_tile, item_start,
               *, height, width, tile_h, tile_w, ntx, subpixel, depth_test):
    """Launch the streaming visibility kernel (see csrc/vis_stream.cu) on the
    current stream. Returns (tid (H,W) int32, z (H,W) f32, +inf background).

    rec (C,18) i32; sid (S,) i32; starts, run_counts, tile_ran (ntiles,) i32;
    large_ids (L,) i32; large_count (1,) i32; item_tile (bound,) i32 and
    item_start (ntiles + 1,) i32 as raster.records.item_table makes them —
    all on one CUDA device. Tiles are tile_w = 128 wide and of any height."""
    _check_tile(tile_w)
    lib = library()
    dev = rec.device
    ntiles = starts.shape[0]
    _check("rec", rec, torch.int32, (rec.shape[0], 18), dev)
    _check("sid", sid, torch.int32, None, dev)
    for n, t in (("starts", starts), ("run_counts", run_counts), ("tile_ran", tile_ran)):
        _check(n, t, torch.int32, (ntiles,), dev)
    _check("large_ids", large_ids, torch.int32, None, dev)
    _check("large_count", large_count, torch.int32, (1,), dev)
    _check_items(item_tile, item_start, ntiles, dev)
    if ntiles != ntx * (-(-height // tile_h)):
        raise ValueError("starts must have one entry per tile")
    tid, z, keys, arrivals = _outputs(height, width, tile_h, ntx, dev)
    _launch(
        "vis_stream", lib.xr_vis_stream,
        rec.data_ptr(), sid.data_ptr(), starts.data_ptr(), run_counts.data_ptr(),
        tile_ran.data_ptr(), large_ids.data_ptr(), large_count.data_ptr(),
        item_tile.data_ptr(), item_start.data_ptr(), keys.data_ptr(), arrivals.data_ptr(),
        tid.data_ptr(), z.data_ptr(),
        ntiles, item_tile.shape[0], height, width, tile_h, tile_w, ntx, subpixel,
        int(bool(depth_test)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return tid, z


def vis_lists(rec, lists, counts, large_ids, large_count, item_tile, item_start,
              *, height, width, tile_h, tile_w, ntx, subpixel, depth_test):
    """Launch the per-tile list visibility kernel (see csrc/vis_lists.cu) on
    the current stream. Returns (tid (H,W) int32, z (H,W) f32, +inf
    background).

    rec (C,18) i32; lists (ntiles, cap) i32; counts (ntiles,) i32 (<= cap);
    large_ids (L,) i32; large_count (1,) i32; item_tile (bound,) i32 and
    item_start (ntiles + 1,) i32 as raster.records.item_table makes them —
    all on one CUDA device. Tiles are tile_w = 128 wide and of any height."""
    _check_tile(tile_w)
    lib = library()
    dev = rec.device
    ntiles, cap = lists.shape
    _check("rec", rec, torch.int32, (rec.shape[0], 18), dev)
    _check("lists", lists, torch.int32, None, dev)
    _check("counts", counts, torch.int32, (ntiles,), dev)
    _check("large_ids", large_ids, torch.int32, None, dev)
    _check("large_count", large_count, torch.int32, (1,), dev)
    _check_items(item_tile, item_start, ntiles, dev)
    if ntiles != ntx * (-(-height // tile_h)):
        raise ValueError("lists must have one row per tile")
    tid, z, keys, arrivals = _outputs(height, width, tile_h, ntx, dev)
    _launch(
        "vis_lists", lib.xr_vis_lists,
        rec.data_ptr(), lists.data_ptr(), counts.data_ptr(), large_ids.data_ptr(),
        large_count.data_ptr(), item_tile.data_ptr(), item_start.data_ptr(),
        keys.data_ptr(), arrivals.data_ptr(), tid.data_ptr(), z.data_ptr(),
        ntiles, cap, item_tile.shape[0], height, width, tile_h, tile_w, ntx, subpixel,
        int(bool(depth_test)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return tid, z


def _gather_table(tab, dtypes=(torch.int32,)):
    _check("tab", tab, tab.dtype)
    if tab.dtype not in dtypes:
        raise ValueError(f"tab: dtype {tab.dtype}, expected one of {dtypes}")
    if tab.ndim != 2 or min(tab.shape) <= 0:
        raise ValueError(f"tab: shape {tuple(tab.shape)}, expected a non-empty (S, W)")


def _scratch(needed, tab):
    """The table's size of uninitialised scratch where the launch writes
    the table row-major first, else nothing. Nothing is kept between
    launches."""
    return torch.empty_like(tab) if needed(*tab.shape) else None


def lane_gather(idx, tab):
    """Launch the lane gather (csrc/gather.cu) on the current stream:
    out[s, j] = tab[s, idx[0, j]] — 0 where idx[0, j] is outside [0, W).
    A table of 8, 16 or 32 rows that is large enough to pay for a second
    kernel is first written row-major into scratch allocated here, and a
    column's S values are gathered as one line (two kernels, counted as one
    launch); any other table is read in place, one thread an element.

    idx (1, W) i32; tab (S, W) i32 (u32 bits) or f32, on one CUDA device.
    Returns (S, W) of tab's dtype."""
    _gather_table(tab, (torch.int32, torch.float32))
    S, W = tab.shape
    _check("idx", idx, torch.int32, (1, W), tab.device)
    lib = library()
    out = torch.empty_like(tab)
    scratch = _scratch(lib.xr_lane_gather_scratch, tab)
    _launch("lane_gather", lib.xr_lane_gather, tab.data_ptr(), idx.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(), S, W,
            torch.cuda.current_stream(tab.device).cuda_stream)
    return out


def quad_gather(idx, tab):
    """Launch the quad gather (csrc/gather.cu) on the current stream:
    out[...] = sum over s of tab[s, idx[...]] in u32, wrapping — 0 where the
    index is outside [0, PP). Two kernels, counted as one launch: the table
    is written row-major, (PP, S), into scratch allocated here, and the
    gather reads each index's S words as one row. Every launch transposes.

    idx (...) i32, any shape; tab (S, PP) i32 (u32 bits), on one CUDA
    device. Returns idx's shape, i32 (u32 bits)."""
    _gather_table(tab)
    S, PP = tab.shape
    _check("idx", idx, torch.int32, None, tab.device)
    lib = library()
    out = torch.empty_like(idx)
    scratch = _scratch(lib.xr_quad_gather_scratch, tab)
    _launch("quad_gather", lib.xr_quad_gather, tab.data_ptr(), idx.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            idx.numel(), S, PP, torch.cuda.current_stream(tab.device).cuda_stream)
    return out


def quad_gather1(idx, tab):
    """Launch the one-channel quad gather (csrc/gather.cu) on the current
    stream: out[...] = tab[0, idx[...]] — 0 where the index is outside
    [0, PP).

    idx (...) i32, any shape; tab (S, PP) i32 (u32 bits), on one CUDA
    device. Returns idx's shape, i32 (u32 bits)."""
    _gather_table(tab)
    _, PP = tab.shape
    _check("idx", idx, torch.int32, None, tab.device)
    out = torch.empty_like(idx)
    _launch("quad_gather1", library().xr_quad_gather1, tab.data_ptr(), idx.data_ptr(),
            out.data_ptr(), idx.numel(), PP,
            torch.cuda.current_stream(tab.device).cuda_stream)
    return out
