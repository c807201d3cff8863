"""Hand-written CUDA kernels of the port: build, load, launch, count.

Kernels (one launch wrapper each):
  vis_stream    csrc/vis_stream.cu  streaming tile visibility; launches under
                                    the z gate count as vis_stream_zgate
  vis_lists     csrc/vis_lists.cu   per-tile list visibility
  lane_gather   csrc/gather.cu      out[s, j] = tab[s, idx[j]]
  quad_gather   csrc/gather.cu      out[n] = sum_s tab[s, idx[n]] (u32, wrapping)
  quad_gather1  csrc/gather.cu      out[n] = tab[0, idx[n]]
  blend_slots   csrc/blend.cu       the live transparent slot table, built on
                                    the device in one block (shading/blend.py)
  blend_composite csrc/blend.cu     the live slots composited in place over a
                                    frame or band, on the tiles they meet
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
a frame went through the kernel. A launch wrapper counts a launch that runs;
one called while a CUDA graph is captured records the kernel into the graph
and counts nothing. A replayed graph launches the kernel nodes it holds
without calling a wrapper: ``graph_launches`` reads the visibility and
blend kernels among them from the graph the driver built (its kernel
nodes, by name), and each replay counts those (``count_replay``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = [CSRC / "vis_stream.cu", CSRC / "vis_lists.cu", CSRC / "gather.cu",
           CSRC / "blend.cu"]
HEADERS = [CSRC / "fold_records.cuh"]
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "xr_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]

TILE_W = 128  # tile width the visibility kernels take (csrc/fold_records.cuh)

launches = {"vis_stream": 0, "vis_stream_zgate": 0, "vis_lists": 0, "lane_gather": 0,
            "quad_gather": 0, "quad_gather1": 0, "blend_composite": 0, "blend_slots": 0}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the nvcc call in this process, if any


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# the fold kernel of each visibility launch (the clear kernel before it is
# not counted) and the blend kernels, by the words of its name, gated first:
# the gated kernel's name holds the ungated one's
KERNEL_NAMES = {"vis_stream_zgate": ("zgate_fold_kernel", "StreamWalk"),
                "vis_stream": ("fold_kernel", "StreamWalk"),
                "vis_lists": ("fold_kernel", "ListWalk"),
                "blend_composite": ("blend_composite_kernel",),
                "blend_slots": ("slot_table_kernel",)}


def launch_name(kernel: str):
    """The launches key of a device kernel's name (mangled or not), or
    None for any other kernel."""
    return next((k for k, words in KERNEL_NAMES.items() if all(w in kernel for w in words)),
                None)


def count_replay(counts: dict) -> None:
    """Count one replay of a CUDA graph holding `counts` (graph_launches)."""
    for k, n in counts.items():
        launches[k] += n


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)."""

    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_bytes", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


_cu = None


def _driver():
    """The CUDA driver library, for what a graph under capture holds."""
    global _cu
    if _cu is None:
        cu = ctypes.CDLL("libcuda.so.1")
        ptr, size = ctypes.POINTER, ctypes.c_size_t
        cu.cuStreamGetCaptureInfo_v2.argtypes = [
            ctypes.c_void_p, ptr(ctypes.c_int), ptr(ctypes.c_uint64), ptr(ctypes.c_void_p),
            ptr(ctypes.c_void_p), ptr(size)]
        cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ptr(size)]
        cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ptr(ctypes.c_int)]
        # the v2 call where the driver has it; the v1 struct is the v2's head
        cu.node_params = getattr(cu, "cuGraphKernelNodeGetParams_v2", None) or \
            cu.cuGraphKernelNodeGetParams
        cu.node_params.argtypes = [ctypes.c_void_p, ptr(_KernelNodeParams)]
        cu.cuKernelGetName.argtypes = cu.cuFuncGetName.argtypes = [
            ptr(ctypes.c_char_p), ctypes.c_void_p]
        cu.cuGetErrorString.argtypes = [ctypes.c_int, ptr(ctypes.c_char_p)]
        _cu = cu
    return _cu


def _cu_check(what: str, err: int) -> None:
    if err != 0:
        msg = ctypes.c_char_p()
        _driver().cuGetErrorString(err, ctypes.byref(msg))
        raise RuntimeError(f"{what} failed: {(msg.value or b'error %d' % err).decode()}")


def graph_launches(stream) -> dict:
    """The counted kernels in the CUDA graph that `stream` is capturing,
    by launches key (the kernel nodes recorded so far): what each replay of
    the graph launches."""
    cu, by = _driver(), ctypes.byref
    status, graph = ctypes.c_int(), ctypes.c_void_p()
    _cu_check("cuStreamGetCaptureInfo", cu.cuStreamGetCaptureInfo_v2(
        stream.cuda_stream, by(status), by(ctypes.c_uint64()), by(graph),
        by(ctypes.c_void_p()), by(ctypes.c_size_t())))
    if status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError("graph_launches: the stream is not capturing")
    n = ctypes.c_size_t()
    _cu_check("cuGraphGetNodes", cu.cuGraphGetNodes(graph, None, by(n)))
    nodes = (ctypes.c_void_p * n.value)()
    _cu_check("cuGraphGetNodes", cu.cuGraphGetNodes(graph, nodes, by(n)))
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    for node in nodes[: n.value]:
        kind = ctypes.c_int()
        _cu_check("cuGraphNodeGetType", cu.cuGraphNodeGetType(node, by(kind)))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params, name = _KernelNodeParams(), ctypes.c_char_p()
        _cu_check("cuGraphKernelNodeGetParams", cu.node_params(node, by(params)))
        if params.kern:
            _cu_check("cuKernelGetName", cu.cuKernelGetName(by(name), params.kern))
        else:
            _cu_check("cuFuncGetName", cu.cuFuncGetName(by(name), params.func))
        key = launch_name(name.value.decode())
        if key is not None:
            counts[key] += 1
    return counts


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


def ptxas_usage(log: str, key: str):
    """ptxas's registers and bytes of spill stores ({"registers",
    "spill_bytes"}) of the first kernel of a verbose build's log whose
    mangled name holds the words of KERNEL_NAMES[key]; None if the log
    reports none."""
    for m in re.finditer(r"Function properties for (\S+)\n.*?(\d+) bytes spill stores.*?\n"
                         r".*?Used (\d+) registers", log):
        if all(w in m.group(1) for w in KERNEL_NAMES[key]):
            return {"registers": int(m.group(3)), "spill_bytes": int(m.group(2))}
    return None


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.xr_vis_stream.argtypes = [p] * 15 + [i] * 10 + [p]
            lib.xr_vis_stream.restype = i
            lib.xr_zgate_words.argtypes = [i, i]
            lib.xr_zgate_words.restype = ctypes.c_longlong
            lib.xr_vis_lists.argtypes = [p] * 11 + [i] * 10 + [p]
            lib.xr_vis_lists.restype = i
            lib.xr_lane_gather.argtypes = [p, p, p, p, i, i, p]
            lib.xr_quad_gather.argtypes = [p, p, p, p, i64, i, i, p]
            lib.xr_quad_gather1.argtypes = [p, p, p, i64, i, p]
            lib.xr_quad_gather1_slices.argtypes = [i, ctypes.POINTER(i)]
            lib.xr_quad_gather1_slices.restype = i
            lib.xr_lane_gather_scratch.argtypes = lib.xr_quad_gather_scratch.argtypes = [i, i]
            for fn in (lib.xr_lane_gather, lib.xr_quad_gather, lib.xr_quad_gather1,
                       lib.xr_lane_gather_scratch, lib.xr_quad_gather_scratch):
                fn.restype = i
            lib.xr_blend_composite.argtypes = [p] * 9 + [i] * 14 + [ctypes.c_float, p]
            lib.xr_blend_composite.restype = i
            lib.xr_blend_slots.argtypes = [p] * 22 + [i] * 9 + [ctypes.c_float, p]
            lib.xr_blend_slots.restype = i
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
    if not torch.cuda.is_current_stream_capturing():
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
               *, height, width, tile_h, tile_w, ntx, subpixel, depth_test,
               item_order=None, chunk_gate=False):
    """Launch the streaming visibility kernel (see csrc/vis_stream.cu) on the
    current stream. Returns (tid (H,W) int32, z (H,W) f32, +inf background).

    rec (C,18) i32; sid (S,) i32; starts, run_counts, tile_ran (ntiles,) i32;
    large_ids (L,) i32; large_count (1,) i32; item_tile (bound,) i32 and
    item_start (ntiles + 1,) i32 as raster.records.item_table makes them —
    all on one CUDA device. Tiles are tile_w = 128 wide and of any height.
    With item_order ((bound,) i32, raster.records.chunk_major_order) the z
    gate runs (the depth test only; counted as vis_stream_zgate) on a
    scratch of bound words allocated here, and with chunk_gate also its
    drop at staging."""
    _check_tile(tile_w)
    if item_order is not None and not depth_test:
        raise ValueError("the z gate needs the depth test")
    if chunk_gate and item_order is None:
        raise ValueError("chunk_gate refines the z gate: pass item_order")
    gate = 0 if item_order is None else 3 if chunk_gate else 1
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
    if item_order is not None:
        _check("item_order", item_order, torch.int32, item_tile.shape, dev)
    tid, z, keys, arrivals = _outputs(height, width, tile_h, ntx, dev)
    # the gate's bound word per (tile, 32-row slab, warp)
    bounds = (torch.empty((lib.xr_zgate_words(ntiles, tile_h),), dtype=torch.int32, device=dev)
              if gate else None)
    _launch(
        "vis_stream_zgate" if gate else "vis_stream", lib.xr_vis_stream,
        rec.data_ptr(), sid.data_ptr(), starts.data_ptr(), run_counts.data_ptr(),
        tile_ran.data_ptr(), large_ids.data_ptr(), large_count.data_ptr(),
        item_tile.data_ptr(), item_start.data_ptr(),
        None if item_order is None else item_order.data_ptr(), keys.data_ptr(),
        arrivals.data_ptr(), None if bounds is None else bounds.data_ptr(), tid.data_ptr(),
        z.data_ptr(),
        ntiles, item_tile.shape[0], height, width, tile_h, tile_w, ntx, subpixel,
        int(bool(depth_test)), gate,
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


def quad_gather1_slices(width: int):
    """(K, slice words) of the cut of a row of `width` words that the
    one-channel gather's slice design makes (csrc/gather.cu, XR_P3_DESIGN 2)."""
    sw = ctypes.c_int(0)
    return library().xr_quad_gather1_slices(width, ctypes.byref(sw)), sw.value


def quad_gather1(idx, tab):
    """Launch the one-channel quad gather (csrc/gather.cu) on the current
    stream: out[...] = tab[0, idx[...]] — 0 where the index is outside
    [0, PP). The row is read in place, one thread an element; the source
    keeps two other designs for the sweep tool (tools.gather.
    quad_gather1_slices_plain states the one that works from slices).

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


META = 8  # the slot table's meta vector: count, total, overflow, 0, union y0 y1 x0 x1
SLOT_COLUMNS = 37  # the slot table's columns before the attributes (shading/blend.py FIELDS)


def _ptr(t):
    return None if t is None else t.data_ptr()


def blend_slots(tri, mats, tex_size, *, tex_base, uv_slot, subpixel, cap, chunk, height,
                width):
    """Launch the slot-table kernel (csrc/blend.cu) on the current stream:
    the first `cap` transparent records (valid, material alpha < 1) in
    source order, as the composite reads them. Returns (meta (8,) i32: the
    live count min(total, cap), the transparent total, the overflow
    max(total - cap, 0), 0, and the union (y0, y1, x0, x1) of the live
    chunks' boxes cut to the height x width frame; ids (nchunks * chunk,)
    i64, the record ids in source order; boxes (nchunks, 4) i32, each
    chunk's box over its live slots; table (cap, 37 + 3 * A) f32, one row
    a slot in shading/blend.py's FIELDS layout). ids and table are written
    up to the live count only.

    tri: setup records, xs and ys (C, 3) i32, z, inv_w and face_rgb (C, 3)
    f32, attr_w (C, 3, A) f32, mat_id and src_id (C,) i32, valid (C,)
    bool; mats: materials, alpha, ka, kd, ks, shininess (M,) f32,
    base_color (M, 3) f32, tex_id (M,) i32, tex_addr (M,) i32 or None;
    tex_size (ntex,) i32, a ragged pyramid's base size per texture, or
    None (then tex_base, a float, is every slot's); uv_slot: the attribute
    of u where the mode samples a texture, else -1 -- all on one CUDA
    device. nchunks = ceil(cap / chunk)."""
    dev = tri.xs.device
    C = tri.xs.shape[0]
    A = tri.attr_w.shape[-1]
    for n in ("xs", "ys"):
        _check(n, getattr(tri, n), torch.int32, (C, 3), dev)
    for n in ("z", "inv_w", "face_rgb"):
        _check(n, getattr(tri, n), torch.float32, (C, 3), dev)
    _check("attr_w", tri.attr_w, torch.float32, (C, 3, A), dev)
    for n in ("mat_id", "src_id"):
        _check(n, getattr(tri, n), torch.int32, (C,), dev)
    _check("valid", tri.valid, torch.bool, (C,), dev)
    M = mats.alpha.shape[0]
    for n in ("alpha", "ka", "kd", "ks", "shininess"):
        _check(n, getattr(mats, n), torch.float32, (M,), dev)
    _check("base_color", mats.base_color, torch.float32, (M, 3), dev)
    _check("tex_id", mats.tex_id, torch.int32, (M,), dev)
    if mats.tex_addr is not None:
        _check("tex_addr", mats.tex_addr, torch.int32, (M,), dev)
    if tex_size is not None:
        _check("tex_size", tex_size, torch.int32, None, dev)
    if cap < 1 or chunk < 1:
        raise ValueError(f"blend_slots: capacity {cap} and chunk {chunk} must be positive")
    nchunks = -(-cap // chunk)
    meta = torch.empty((META,), dtype=torch.int32, device=dev)
    ids = torch.empty((nchunks * chunk,), dtype=torch.int64, device=dev)
    boxes = torch.empty((nchunks, 4), dtype=torch.int32, device=dev)
    table = torch.empty((cap, SLOT_COLUMNS + 3 * A), dtype=torch.float32, device=dev)
    _launch("blend_slots", library().xr_blend_slots,
            tri.xs.data_ptr(), tri.ys.data_ptr(), tri.z.data_ptr(), tri.inv_w.data_ptr(),
            tri.face_rgb.data_ptr(), tri.attr_w.data_ptr(), tri.mat_id.data_ptr(),
            tri.src_id.data_ptr(), tri.valid.data_ptr(), mats.alpha.data_ptr(),
            mats.base_color.data_ptr(), mats.ka.data_ptr(), mats.kd.data_ptr(),
            mats.ks.data_ptr(), mats.shininess.data_ptr(), mats.tex_id.data_ptr(),
            _ptr(mats.tex_addr), _ptr(tex_size), ids.data_ptr(), boxes.data_ptr(),
            table.data_ptr(), meta.data_ptr(), C, M, A, uv_slot, subpixel, cap, chunk, height,
            width, float(tex_base), torch.cuda.current_stream(dev).cuda_stream)
    return meta, ids, boxes, table


def blend_composite(color, depth, table, meta, consts, shadow, quads, level_size, level_base,
                    *, mode, attr_width, y_offset, subpixel, n_dir, n_point, bias, levels):
    """Launch the blend composite (csrc/blend.cu) on the current stream:
    the live slots of the slot table composited over color in source
    order, in place, on the tiles of the live boxes' union only. Returns
    color: consumed, its pixels under a fragment written, every other one
    as it was.

    color (H, W, 3) f32 and depth (H, W) f32: rows [y_offset, y_offset + H)
    of the frame; table (cap, 37 + 3 * attr_width) f32 (shading/blend.py
    FIELDS); meta (8,) i32, blend_slots' (the live count and the union box
    are read on the device); consts f32: eye (3), ambient (3), the n_dir
    directional lights' directions then colors, the n_point point lights'
    positions then colors (3 each), and with a shadow map the light's
    view-projection (16); shadow (Hs, Ws) f32 or None; quads (rows, 13)
    i32, level_size and level_base (ntex * levels) i32, or None with levels
    0 -- all on one CUDA device."""
    dev = color.device
    H, W = depth.shape
    _check("color", color, torch.float32, (H, W, 3), dev)
    _check("depth", depth, torch.float32, (H, W), dev)
    _check("table", table, torch.float32, (table.shape[0], SLOT_COLUMNS + 3 * attr_width), dev)
    _check("meta", meta, torch.int32, (META,), dev)
    lights = 6 + 6 * (n_dir + n_point) + (16 if shadow is not None else 0)
    _check("consts", consts, torch.float32, (lights,), dev)
    hs = ws = 0
    if shadow is not None:
        _check("shadow", shadow, torch.float32, None, dev)
        hs, ws = shadow.shape
    if (quads is None) != (levels == 0):
        raise ValueError("quads and levels: both or neither")
    if quads is not None:
        _check("quads", quads, torch.int32, None, dev)
        ntex = level_size.shape[0] // levels
        for n, t in (("level_size", level_size), ("level_base", level_base)):
            _check(n, t, torch.int32, (ntex * levels,), dev)
    _launch("blend_composite", library().xr_blend_composite,
            table.data_ptr(), meta.data_ptr(), consts.data_ptr(), color.data_ptr(),
            depth.data_ptr(), _ptr(shadow), _ptr(quads), _ptr(level_size), _ptr(level_base),
            H, W, y_offset, subpixel, mode, attr_width, table.shape[1], table.shape[0], n_dir,
            n_point, hs, ws, 0 if quads is None else quads.shape[1], levels, bias,
            torch.cuda.current_stream(dev).cuda_stream)
    return color
