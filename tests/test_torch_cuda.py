"""The CUDA kernels against their plain PyTorch versions on the card:
identical tid and z bits and equal dropped counts on the same prepped
inputs — the stream kernel (B1) and the list kernel (B2) at 8-, 32-, 64-
and 128-row tiles and in their cases, both on config4's depth-only shadow
pass, on a scene where every covered pixel ties on z, on tiles whose walk
is cut into three or more work items, and launched repeatedly —
the gather kernels (P1-P3) bit for bit (P1 and P2 also on indices outside
the row, on odd shapes and launched repeatedly on two tables in turn), and frames through Renderer on CUDA
equal to the frames on the CPU (config4/4b: shadow edges may flip, so at
most max(2, 0.1 %) pixels past 1 LSB, the golden rule). These
tests need a CUDA device and skip without one. On a machine with a card
and no JAX, run them without the suite's conftest (which imports JAX):
``python -m pytest tests/test_torch_cuda.py --noconftest -q``."""

import dataclasses

import numpy as np
import pytest
import torch

from xr_torch import Renderer, convert, kernels
from xr_torch.app.renderer import shadow_config
from xr_torch.core import math3d as m3
from xr_torch.pipeline.geometry import geometry
from xr_torch.pipeline.shadow import light_matrices_for_scene
from xr_torch.raster import smem, stream
from xr_torch.scene import presets
from xr_torch.scene import procedural as proc
from xr_torch.tools import gather

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


def _lists_match_plain(cuda, p, cam, scene, cfg):
    inp = smem.prepare_lists(_tri(cuda, p, cam, scene, cfg), cfg)
    n0 = kernels.launches["vis_lists"]
    out = smem.vis_lists(inp, cfg)
    torch.cuda.synchronize()
    assert kernels.launches["vis_lists"] == n0 + 1
    _same(out, smem.vis_lists_plain(inp, cfg))
    return inp


MATCHES_PLAIN = {"vis_stream": _stream_matches_plain, "vis_lists": _lists_match_plain}


def _chunks(inp):
    """Chunks of each tile's walk, as the prep lists them for the kernel."""
    return (inp.item_start[1:] - inp.item_start[:-1]).cpu()


@pytest.mark.parametrize("tile_h", [8, 64, 128])
@pytest.mark.parametrize("kernel", sorted(MATCHES_PLAIN))
def test_stream_kernel_any_tile_height(cuda, kernel, tile_h):
    """Tiles of more than 32 rows run as several slabs (config2's 128x128),
    through the stream kernel and the list kernel."""
    for preset in (presets.config3_terrain(48, 48), presets.config2_icospheres()):
        p, cam, scene = _scene(cuda, 0.4, preset)
        MATCHES_PLAIN[kernel](cuda, p, cam, scene, dataclasses.replace(p.config, tile_h=tile_h))


def _tie_preset():
    """config3's terrain merged with a copy of itself: every covered pixel
    ties on z between a triangle and its copy, and the lower id must win."""
    p = presets.config3_terrain(48, 48)
    mesh = proc.with_vert_mat(proc.merge_meshes([p.scene.mesh, p.scene.mesh]))
    return p._replace(scene=p.scene.replace(mesh=mesh))


@pytest.mark.parametrize("depth_test", [True, False], ids=["depth", "painter"])
@pytest.mark.parametrize("kernel", sorted(MATCHES_PLAIN))
def test_kernels_on_z_ties_across_items(cuda, kernel, depth_test):
    p, cam, scene = _scene(cuda, 0.3, _tie_preset())
    cfg = dataclasses.replace(p.config, depth_test=depth_test)
    inp = MATCHES_PLAIN[kernel](cuda, p, cam, scene, cfg)
    assert int(_chunks(inp).max()) >= 3 and int(inp.dropped) == 0


@pytest.mark.parametrize("depth_test", [True, False], ids=["depth", "painter"])
@pytest.mark.parametrize("kernel", sorted(MATCHES_PLAIN))
def test_kernels_split_a_tile_into_items(cuda, kernel, depth_test):
    """config3 at golden size: the heaviest tile's walk is three or more
    chunks, merged through the packed key."""
    p, cam, scene = _scene(cuda)
    cfg = dataclasses.replace(p.config, depth_test=depth_test)
    inp = MATCHES_PLAIN[kernel](cuda, p, cam, scene, cfg)
    assert int(_chunks(inp).max()) >= 3 and int((_chunks(inp) == 1).sum()) >= 1


@pytest.mark.parametrize("kernel", sorted(MATCHES_PLAIN))
def test_repeated_launches_give_equal_bits(cuda, kernel):
    """The merge order varies from launch to launch; the output does not,
    and the scratch of one launch leaves nothing to the next."""
    p, cam, scene = _scene(cuda, 0.3, _tie_preset())
    tri = _tri(cuda, p, cam, scene, p.config)
    if kernel == "vis_stream":
        inp, launch = stream.prepare(tri, p.config), stream.vis_stream
    else:
        inp, launch = smem.prepare_lists(tri, p.config), smem.vis_lists
    first = launch(inp, p.config)
    for _ in range(60):
        last = launch(inp, p.config)
    torch.cuda.synchronize()
    _same(first, last)


@pytest.mark.parametrize("case", sorted(LIST_CASES))
def test_list_kernel_matches_plain(cuda, case):
    p, cam, scene = _scene(cuda)
    inp = _lists_match_plain(cuda, p, cam, scene,
                             dataclasses.replace(p.config, **LIST_CASES[case]))
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


PRESETS = {"config1": presets.config1_cube, "config2": presets.config2_icospheres,
           "config3": lambda: presets.config3_terrain(48, 48),
           "config4": presets.config4_phong, "config4b": presets.config4_blend}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_cuda_frame_equals_cpu_frame(cuda, name):
    p, cam, scene = _scene(cuda, 1.7, PRESETS[name]())
    p = p._replace(config=dataclasses.replace(p.config, shadow_map_size=min(
        p.config.shadow_map_size, 256)))
    rc = Renderer(scene, p.config, cuda)
    kernels.reset_launches()
    fc = rc.readback(rc.step(scene, cam))
    assert kernels.launches["vis_stream"] == (2 if name.startswith("config4") else
                                              int(name != "config1"))
    cpu = convert.scene_to_torch(p.scene.replace(model_matrices=p.animate(1.7)[1]), "cpu")
    rh = Renderer(cpu, p.config, "cpu")
    fh = rh.readback(rh.step(cpu, cam))
    assert ((fc.depth == 1.0) == (fh.depth == 1.0)).all()
    np.testing.assert_allclose(fc.depth, fh.depth, rtol=0, atol=1e-6)
    diff = np.abs(fc.color.astype(int) - fh.color.astype(int)).max(axis=-1)
    allowed = max(2, diff.size // 1000) if name.startswith("config4") else 0
    assert (diff > 1).sum() <= allowed
    for k in fh.stats:
        assert int(fc.stats[k]) == int(fh.stats[k]), k


@pytest.mark.parametrize("kernel", ["vis_stream", "vis_lists"])
def test_kernels_on_the_shadow_pass(cuda, kernel):
    """config4's depth-only pass from the light: 64x128 tiles (two slabs a
    tile), depth only, at a 512^2 map."""
    p, cam, scene = _scene(cuda, 0.0, presets.config4_phong())
    cfg = dataclasses.replace(shadow_config(p.config), width=512, height=512, bin_capacity=4096)
    lv, lp = (convert.tensor(m, cuda) for m in light_matrices_for_scene(scene))
    tri = geometry(scene, lv, lp, cfg)
    if kernel == "vis_stream":
        inp = stream.prepare(tri, cfg)
        _same(stream.vis_stream(inp, cfg), stream.vis_stream_plain(inp, cfg))
    else:
        inp = smem.prepare_lists(tri, cfg)
        _same(smem.vis_lists(inp, cfg), smem.vis_lists_plain(inp, cfg))
    assert int(inp.dropped) == 0


@pytest.mark.parametrize("name", ["lane_gather", "quad_gather", "quad_gather1"])
def test_gather_kernels_match_plain(cuda, name):
    rng = np.random.default_rng(5)
    tab = torch.from_numpy(rng.integers(0, 2**32, (16, 5000), dtype=np.uint32).view(np.int32))
    if name == "lane_gather":
        idx = rng.integers(-3, 5003, (1, 5000)).astype(np.int32)  # a few outside the row
        tabs = [tab, tab.view(torch.float32)]
    else:
        idx = rng.integers(-3, 5003, (7, 8, 128)).astype(np.int32)
        tabs = [tab]
    idx = torch.from_numpy(idx)
    for t in tabs:
        n0 = kernels.launches[name]
        got = getattr(gather, name)(idx.to(cuda), t.to(cuda))
        torch.cuda.synchronize()
        assert kernels.launches[name] == n0 + 1
        want = getattr(gather, name + "_plain")(idx, t)
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("S", [13, 16, 32])
@pytest.mark.parametrize("kind", ["uniform", "outside"])
def test_quad_gather_rows_and_repeated_launches(cuda, S, kind):
    """P2 gathers from the table it has just written row-major: 13 table
    rows take the word-by-word walk of a row; a launch's scratch leaves
    nothing to the next (another table in between, then the first again)."""
    rng = np.random.default_rng(S)
    PP = 5003
    lo, hi = (0, PP) if kind == "uniform" else (-300, PP + 300)
    tabs = [torch.from_numpy(rng.integers(0, 2**32, (S, PP), dtype=np.uint32).view(np.int32))
            for _ in range(2)]
    idx = torch.from_numpy(rng.integers(lo, hi, (9, 7, 129)).astype(np.int32))
    wants = [gather.quad_gather_plain(idx, t) for t in tabs]
    dev_idx, dev_tabs = idx.to(cuda), [t.to(cuda) for t in tabs]
    n0 = kernels.launches["quad_gather"]
    for k in (0, 1, 0, 0, 1):
        got = gather.quad_gather(dev_idx, dev_tabs[k])
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), wants[k])
        assert torch.equal(got.cpu(), gather.quad_gather_rows_plain(idx, tabs[k]))
    assert kernels.launches["quad_gather"] == n0 + 5


@pytest.mark.parametrize("S,W", [(8, 8192), (13, 5003), (32, 9999), (40, 641)])
@pytest.mark.parametrize("kind", ["uniform", "outside"])
def test_lane_gather_shapes_and_repeated_launches(cuda, S, W, kind):
    rng = np.random.default_rng(S + W)
    lo, hi = (0, W) if kind == "uniform" else (-W // 16, W + W // 16)
    tabs = [torch.from_numpy(rng.integers(0, 2**32, (S, W), dtype=np.uint32).view(np.int32))
            for _ in range(2)]
    idx = torch.from_numpy(rng.integers(lo, hi, (1, W)).astype(np.int32))
    wants = [gather.lane_gather_plain(idx, t) for t in tabs]
    dev_idx, dev_tabs = idx.to(cuda), [t.to(cuda) for t in tabs]
    n0 = kernels.launches["lane_gather"]
    for k in (0, 1, 0, 0, 1):
        got = gather.lane_gather(dev_idx, dev_tabs[k])
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), wants[k])
    assert kernels.launches["lane_gather"] == n0 + 5
    f32 = dev_tabs[0].view(torch.float32)
    got = gather.lane_gather(dev_idx, f32)
    assert got.dtype == torch.float32
    assert torch.equal(got.cpu().view(torch.int32), wants[0])
