"""The CUDA kernels against their plain PyTorch versions on the card:
identical tid and z bits and equal dropped counts on the same prepped
inputs — the stream kernel (B1) at 8-, 32-, 64- and 128-row tiles, the list
kernel (B2) in the list cases — and frames through Renderer on CUDA equal
to the frames on the CPU. These
tests need a CUDA device and skip without one. On a machine with a card
and no JAX, run them without the suite's conftest (which imports JAX):
``python -m pytest tests/test_torch_cuda.py --noconftest -q``."""

import dataclasses

import numpy as np
import pytest
import torch

from xr_torch import Renderer, convert, kernels
from xr_torch.core import math3d as m3
from xr_torch.pipeline.geometry import geometry
from xr_torch.raster import smem, stream
from xr_torch.scene import presets

pytestmark = pytest.mark.cuda

CASES = {
    "as_is": {},
    "large_bucket": {"medium_capacity": 0, "tile_h": 8},
    "painter": {"depth_test": False},
    "stream_overflow": {"stream_expand": 0.001},
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("requires a CUDA device")
    return torch.device("cuda", 0)


LIST_CASES = {
    "as_is": {},
    "large_bucket": {"medium_capacity": 0, "tile_h": 8},
    "painter": {"depth_test": False},
    "lists_overflow": {"bin_capacity": 64},
}


def _scene(cuda, t=0.3, preset=None):
    preset = preset or presets.config3_terrain(48, 48)
    p = presets.small_preset(preset, 192, 108, bin_capacity=8192)
    cam, mm = p.animate(t)
    return p, cam, convert.scene_to_torch(p.scene.replace(model_matrices=mm), cuda)


def _tri(cuda, p, cam, scene, cfg):
    view, proj = m3.camera_matrices(convert.camera_to_torch(cam, cuda), 192 / 108, cuda)
    return geometry(scene, view, proj, cfg)


def _same(kernel_out, plain_out):
    (tk, zk), (tp, zp) = kernel_out, plain_out
    assert torch.equal(tk, tp)
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))


def _stream_matches_plain(cuda, p, cam, scene, cfg):
    inp = stream.prepare(_tri(cuda, p, cam, scene, cfg), cfg)
    n0 = kernels.launches["vis_stream"]
    out = stream.vis_stream(inp, cfg)
    torch.cuda.synchronize()
    assert kernels.launches["vis_stream"] == n0 + 1
    _same(out, stream.vis_stream_plain(inp, cfg))
    return inp


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda, case):
    p, cam, scene = _scene(cuda)
    inp = _stream_matches_plain(cuda, p, cam, scene, dataclasses.replace(p.config, **CASES[case]))
    if case == "large_bucket":
        assert int(inp.large_count) > 0
    if case == "stream_overflow":
        assert int(inp.dropped) > 0


@pytest.mark.parametrize("tile_h", [8, 64, 128])
def test_stream_kernel_any_tile_height(cuda, tile_h):
    """Tiles of more than 32 rows run as several slabs (config2's 128x128)."""
    for preset in (presets.config3_terrain(48, 48), presets.config2_icospheres()):
        p, cam, scene = _scene(cuda, 0.4, preset)
        _stream_matches_plain(cuda, p, cam, scene, dataclasses.replace(p.config, tile_h=tile_h))


@pytest.mark.parametrize("case", sorted(LIST_CASES))
def test_list_kernel_matches_plain(cuda, case):
    p, cam, scene = _scene(cuda)
    cfg = dataclasses.replace(p.config, **LIST_CASES[case])
    inp = smem.prepare_lists(_tri(cuda, p, cam, scene, cfg), cfg)
    n0 = kernels.launches["vis_lists"]
    out = smem.vis_lists(inp, cfg)
    torch.cuda.synchronize()
    assert kernels.launches["vis_lists"] == n0 + 1
    _same(out, smem.vis_lists_plain(inp, cfg))
    if case == "large_bucket":
        assert int(inp.large_count) > 0
    if case == "lists_overflow":
        assert int(inp.dropped) > 0


@pytest.mark.parametrize("cap,dropped", [(8192, 0), (2048, 2079)])
def test_list_kernel_config2(cuda, cap, dropped):
    p, cam, scene = _scene(cuda, 0.4, presets.config2_icospheres())
    cfg = dataclasses.replace(p.config, bin_capacity=cap)
    inp = smem.prepare_lists(_tri(cuda, p, cam, scene, cfg), cfg)
    _same(smem.vis_lists(inp, cfg), smem.vis_lists_plain(inp, cfg))
    assert int(inp.dropped) == dropped


@pytest.mark.parametrize("name", ["config1", "config2", "config3"])
def test_cuda_frame_equals_cpu_frame(cuda, name):
    preset = {"config1": presets.config1_cube, "config2": presets.config2_icospheres,
              "config3": lambda: presets.config3_terrain(48, 48)}[name]()
    p, cam, scene = _scene(cuda, 1.7, preset)
    rc = Renderer(scene, p.config, cuda)
    fc = rc.readback(rc.step(scene, cam))
    cpu = convert.scene_to_torch(p.scene.replace(model_matrices=p.animate(1.7)[1]), "cpu")
    rh = Renderer(cpu, p.config, "cpu")
    fh = rh.readback(rh.step(cpu, cam))
    assert ((fc.depth == 1.0) == (fh.depth == 1.0)).all()
    np.testing.assert_allclose(fc.depth, fh.depth, rtol=0, atol=1e-6)
    assert np.abs(fc.color.astype(int) - fh.color.astype(int)).max() <= 1
