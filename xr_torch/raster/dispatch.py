"""Visibility dispatch of the port (port of ``xr/raster/dispatch.py``).

Raster paths and backends, all with the same result:
  brute         — every triangle against every pixel (``lists``); ``auto``
                  takes it at capacity <= 2048
  jnp           — the portable tile-list fold (``lists``)
  pallas_smem   — the per-tile list kernel (``smem``, CUDA ``vis_lists``)
  pallas_stream — the streaming kernel (``stream``, CUDA ``vis_stream``);
                  ``auto`` on the binned path
Whether a CUDA kernel or its plain version runs is decided by the tensors'
device alone, inside ``stream.vis_stream`` and ``smem.vis_lists``.

The reference's SMEM budget rule is kept: ``pallas_smem`` with record
windows past 900,000 bytes streams instead, so the backend that runs — and
with it ``bin_overflow``, which each backend counts its own way — is the
reference's for every config but one: ``backend="auto"`` always streams
here, the reference's choice on a TPU, while the reference off the TPU (its
CPU tests) takes the ``jnp`` lists for ``auto``. Frames are equal either
way; under overflow the counts are not (lists drop entries past
``bin_capacity``, the stream drops whole blocks past its budget). So a
comparison of ``bin_overflow`` with the reference on the CPU names the
backend on both sides (``pallas_stream`` with ``pallas_interpret=True``
there).
"""

from __future__ import annotations

import torch

from xr_torch.core.types import RenderConfig
from xr_torch.prof import spans
from xr_torch.raster import lists, smem, stream
from xr_torch.raster.records import NFIELDS

SMEM_BUDGET = 900_000


def _pad128(n: int) -> int:
    return (n + 127) // 128 * 128


def _smem_bytes(config: RenderConfig) -> int:
    """SMEM footprint of the reference's pallas_smem record windows."""
    small = NFIELDS * 4 * _pad128(config.bin_capacity) * 2  # double-buffered
    large = NFIELDS * 4 * _pad128(config.large_capacity)
    return small + large


def visibility_steps(config: RenderConfig, capacity: int, y_offset: int = 0) -> list:
    """The visibility of `config`'s path and backend as steps, each (the
    ``prof.span`` it runs under or None, fn): the first fn takes the
    triangles, each later one the value of the step before, and the last
    returns (tid (H,W) i32, zbuf (H,W) f32 +inf background, bin_overflow).
    The kernels' backends have two, bin_prep then vis; brute force and the
    ``jnp`` lists run as one step outside any span."""
    path = config.raster_path
    if path == "auto":
        path = "brute" if capacity <= 2048 else "binned"
    if path == "brute":
        def brute(tri):
            tid, zbuf = lists.visibility_brute(tri, config, y_offset=y_offset)
            return tid, zbuf, torch.zeros((), dtype=torch.int32, device=tid.device)

        return [(None, brute)]

    backend = config.backend
    if backend == "auto":
        backend = "pallas_stream"
    if backend == "pallas_smem" and _smem_bytes(config) > SMEM_BUDGET:
        backend = "pallas_stream"
    if backend == "pallas_stream":
        prepare, launch = stream.prepare, stream.vis_stream
    elif backend == "pallas_smem":
        prepare, launch = smem.prepare_lists, smem.vis_lists
    else:
        return [(None, lambda tri: lists.visibility_binned(tri, config, y_offset=y_offset))]
    return [("bin_prep", lambda tri: prepare(tri, config, y_offset)),
            ("vis", lambda inp: (*launch(inp, config), inp.dropped))]


def visibility(tri, config: RenderConfig, capacity: int, y_offset: int = 0):
    """Returns (tid (H,W) i32, zbuf (H,W) f32 +inf background, bin_overflow):
    the steps of visibility_steps in order, each under its span."""
    out = tri
    for name, fn in visibility_steps(config, capacity, y_offset):
        with spans((name,) if name else ()):
            out = fn(out)
    return out
