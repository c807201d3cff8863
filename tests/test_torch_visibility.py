"""Binning and the streaming visibility of the port against the reference,
from the reference's own TriBuf (config3 at golden size, t = 0.3).

Bins (sid, starts, raw_counts, large bucket, dropped) must be exact. The
port's visibility on the CPU runs the kernel's plain version; it is held
against the Pallas stream kernel in interpret mode: ids and dropped exact,
depth within 1e-6 (the interpreted kernel is compiled by XLA, which may
contract the depth sum; the port rounds every product, as the CUDA kernel
does). The cases are those that chip_smoke.py runs on the card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xr.core import math3d as rm3
from xr.pipeline.geometry import geometry as ref_geometry
from xr.raster import jnp_backend as ref_jb
from xr.raster import pallas_stream as ref_stream
from xr.scene import presets as ref_presets
from xr_torch import convert, kernels
from xr_torch.raster import binning, stream

# the suite runs several worker processes on shared cores: one torch
# thread each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

W, H = 192, 108
CASES = {
    "as_is": ({}, 0),
    # 8-row tiles and no medium class: the large bucket is non-empty
    "large_bucket": ({"medium_capacity": 0, "tile_h": 8}, 0),
    "painter": ({"depth_test": False}, 0),
    # a stream budget far too small: whole blocks drop, tiles go to BG
    "stream_overflow": ({"stream_expand": 0.001}, 0),
    # rows [32, 64) as one band of a sharded frame
    "band": ({"height": 32}, 32),
}


@pytest.fixture(scope="module")
def ref_tri():
    p = ref_presets.small_preset(ref_presets.config3_terrain(48, 48), W, H, bin_capacity=8192)
    cam, mm = p.animate(0.3, np)
    view, proj = rm3.camera_matrices(cam, W / H, np)
    tri = ref_geometry(p.scene.replace(model_matrices=mm), jnp.asarray(view),
                       jnp.asarray(proj), p.config, xp=jnp)
    return tri, p.config


@pytest.mark.parametrize("case", sorted(CASES))
def test_bins_exact(ref_tri, case):
    rtri, base = ref_tri
    over, yo = CASES[case]
    cfg = dataclasses.replace(base, **over)
    rb = ref_jb.bin_triangles(rtri, cfg, y_offset=yo)
    b = binning.bin_triangles(convert.tribuf_to_torch(rtri, "cpu"), convert.config_from(cfg), y_offset=yo)
    for f in ("sid", "starts", "raw_counts", "large_ids", "large_count", "dropped", "large_dropped"):
        a, r = getattr(b, f).numpy(), np.asarray(getattr(rb, f))
        assert a.shape == r.shape and (a == r).all(), f
    if case == "large_bucket":
        assert int(b.large_count) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_visibility_matches_pallas_interpret(ref_tri, case):
    rtri, base = ref_tri
    over, yo = CASES[case]
    cfg = dataclasses.replace(base, **over)
    rt, rz, rd = ref_stream.visibility_binned(rtri, cfg, y_offset=yo, interpret=True)
    kernels.reset_launches()
    t, z, d = stream.visibility_binned(
        convert.tribuf_to_torch(rtri, "cpu"), convert.config_from(cfg), y_offset=yo
    )
    assert kernels.launches["vis_stream"] == 0  # CPU tensors: the plain version
    rt, rz = np.asarray(rt), np.asarray(rz)
    assert t.dtype == torch.int32 and z.dtype == torch.float32
    assert (t.numpy() == rt).all()
    assert int(d) == int(rd)
    assert (np.isinf(z.numpy()) == np.isinf(rz)).all()
    fin = np.isfinite(rz)
    np.testing.assert_allclose(z.numpy()[fin], rz[fin], rtol=0, atol=1e-6)
    if case == "stream_overflow":
        assert int(d) > 0 and (rt == 2**31 - 1).sum() > (t.shape[0] * t.shape[1]) // 4
    else:
        assert int(d) == 0


def test_band_matches_full_frame(ref_tri):
    """A band at y_offset renders exactly the rows of the full frame."""
    rtri, base = ref_tri
    tri = convert.tribuf_to_torch(rtri, "cpu")
    cfg = convert.config_from(base)
    tf, zf, _ = stream.visibility_binned(tri, cfg)
    tb, zb, _ = stream.visibility_binned(tri, cfg.replace(height=32), y_offset=32)
    assert torch.equal(tb, tf[32:64]) and torch.equal(zb, zf[32:64])


def test_stream_blocks_matches_reference(ref_tri):
    rtri, base = ref_tri
    for over, _ in CASES.values():
        cfg = dataclasses.replace(base, **over)
        assert stream.stream_blocks(convert.config_from(cfg), rtri.capacity, rtri.num_src) == \
            ref_stream.stream_blocks(cfg, rtri.capacity, rtri.num_src)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """A tile_w other than 128 raises before anything is built; a CPU
    tensor never reaches a launch."""
    z = torch.zeros((4,), dtype=torch.int32)
    shape = dict(height=64, width=128, tile_h=64, ntx=1, subpixel=4, depth_test=True)
    with pytest.raises(ValueError, match="tile_w"):
        kernels.vis_stream(z, z, z, z, z, z, z[:1], tile_w=64, **shape)
    with pytest.raises(ValueError, match="tile_w"):
        kernels.vis_lists(z, z[None], z, z, z[:1], tile_w=256, **shape)
    with pytest.raises(ValueError, match="CUDA"):
        kernels._check("rec", z, torch.int32)
    assert not any(kernels.launches.values())
