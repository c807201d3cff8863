"""The CUDA kernels against their plain PyTorch versions on the card:
identical tid and z bits and equal dropped counts on the same prepped
inputs — the stream kernel (B1) and the list kernel (B2) at 8-, 32-, 64-
and 128-row tiles and in their cases, both on config4's depth-only shadow
pass, on a scene where every covered pixel ties on z, on tiles whose walk
is cut into three or more work items, and launched repeatedly —
the gather kernels (P1-P3) bit for bit (also on indices outside the row, on
odd shapes and launched repeatedly on two tables in turn), the stream kernel on config6's shadow pass, a frame
through present against readback, and frames through Renderer on CUDA
equal to the frames on the CPU (config4/4b: shadow edges may flip, so at
most max(2, 0.1 %) pixels past 1 LSB, the golden rule; config7 with its
measured capacities); both kernels under the bin options (bin_zorder,
bin_pairs=2 with the quad budget ample and 2), against their plain versions
and the option-free output, config7's config measured on the card against
the CPU's, and the app layer on the card (debug_checks with a NaN vertex,
a shade_hook reading frag.depth, recycle_framebuffers=False), both
kernels on screen bands (y_offset != 0, records above the band's first
row) and banded frames on the card equal to the unbanded ones, and the
blend kernel, in place, against its plain version and the whole-frame
composite bit for bit in f32 in each mode (config4b's panes, flat,
Gouraud, textured and Phong, a uniform and a ragged pyramid, one map
clamped), unbanded and in four bands, the pixels no fragment lands on
keeping their bits, the slot-table kernel against live_slots_plain bit for
bit (config4b's benchmark times, the mode cases, totals above the capacity,
a frame with every transparent record culled), both blend kernels built
without a spill, the
setup records of config5 and config7 at 1920x1080 on the card equal to
the CPU's bit for bit (the frame's camera matrices are the host's on
every device: CUDA's tan is not the CPU's), and the stream kernel under
the z gate (z_earlyout, with z_band_gate and z_chunk_gate) against the
reference's serial gate in plain PyTorch and against the ungated kernel,
on config5, config7 and config3 under bin_zorder, at 8-, 64- and 128-row
tiles and launched 300 times in a row, and on the stacked planes of
xr_torch/tools/layers.py; and tests/test_determinism.py's checks under the
z gate (a frame twice, a permuted mesh, the medium bin class). These
tests need a CUDA device and skip without one. On a machine with a card
and no JAX, run them without the suite's conftest (which imports JAX):
``python -m pytest tests/test_torch_cuda.py --noconftest -q``."""

import dataclasses

import numpy as np
import pytest
import torch

from xr_torch import Renderer, convert, kernels
from xr_torch.app import renderer
from xr_torch.app.renderer import has_shadow_pass, shadow_config
from xr_torch.core import fixedpoint as fp
from xr_torch.core import math3d as m3
from xr_torch.core import types
from xr_torch.core.types import MODE_FLAT, MODE_GOURAUD, MODE_PHONG, MODE_TEXTURED
from xr_torch.dist import shard
from xr_torch.pipeline.geometry import clip_capacity, geometry
from xr_torch.pipeline.shadow import light_matrices_for_scene
from xr_torch.raster import dispatch, smem, stream
from xr_torch.scene import presets
from xr_torch.scene import procedural as proc
from xr_torch.scene import texture
from xr_torch.shading import blend
from xr_torch.tools import gather, layers

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
    b1 = "vis_stream_zgate" if stream.gated(cfg) else "vis_stream"  # under z_earlyout
    n0 = kernels.launches[b1]
    out = stream.vis_stream(inp, cfg)
    torch.cuda.synchronize()
    assert kernels.launches[b1] == n0 + 1
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
           "config4": presets.config4_phong, "config4b": presets.config4_blend,
           "config7": lambda: presets.config7_terrain_lod(64, device="cpu")}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_cuda_frame_equals_cpu_frame(cuda, name):
    p, cam, scene = _scene(cuda, 1.7, PRESETS[name]())
    p = p._replace(config=dataclasses.replace(p.config, shadow_map_size=min(
        p.config.shadow_map_size, 256)))
    rc = Renderer(scene, p.config, cuda)
    rc.step(scene, cam)  # the capture; the checked frame replays it
    kernels.reset_launches()
    fc = rc.readback(rc.step(scene, cam))
    b1 = "vis_stream_zgate" if stream.gated(p.config) else "vis_stream"  # config7: z_earlyout
    assert kernels.launches[b1] == (2 if name.startswith("config4") else int(name != "config1"))
    assert kernels.launches["blend_composite"] == int(name == "config4b")
    assert kernels.launches["blend_slots"] == int(name == "config4b")
    assert sum(kernels.launches.values()) == kernels.launches[b1] + 2 * int(name == "config4b")
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


@pytest.mark.parametrize("kind", ["coherent", "uniform", "outside", "negative"])
@pytest.mark.parametrize("PP", [174_848, 100_003, 51_200, 37])
def test_quad_gather1_index_families_and_repeated_launches(cuda, PP, kind):
    """P3 at four table widths (with these many indices its slice design,
    where the sweep tool builds it, cuts 4, 2, 1 and 1 slices; an odd width
    ends a slice on single words), on four index families: the
    fetch tool's stride of 37 with a jitter, uniform, one in eight outside
    the row on either side, and all outside. Two tables in turn, one of them
    not on a 16-byte boundary: a launch keeps nothing."""
    rng = np.random.default_rng(PP)
    N = (max(4 * PP, 1000) + 77,)
    if kind == "coherent":
        i = ((np.arange(N[0], dtype=np.int64) * 37) % max(PP // 2, 1)
             + rng.integers(0, 64, N)) % PP
    elif kind == "uniform":
        i = rng.integers(0, PP, N)
    elif kind == "outside":
        i = rng.integers(-(PP // 16) - 2, PP + PP // 16 + 2, N)
        i[:3] = (-1, PP, -(2**31))
    else:
        i = np.concatenate([rng.integers(-2**31, 0, N[0] // 2), rng.integers(PP, 2**31, N[0] - N[0] // 2)])
    idx = torch.from_numpy(i.astype(np.int32))
    tabs = [torch.from_numpy(rng.integers(0, 2**32, (2, PP), dtype=np.uint32).view(np.int32))
            for _ in range(2)]
    wants = [gather.quad_gather1_plain(idx, t) for t in tabs]
    assert torch.equal(wants[0], gather.quad_gather1_slices_plain(idx, tabs[0]))
    dev_idx = idx.to(cuda)
    off = torch.cat([torch.zeros(1, dtype=torch.int32), tabs[1].reshape(-1)]).to(cuda)
    dev_tabs = [tabs[0].to(cuda), off[1:].view(2, PP)]
    assert dev_tabs[1].data_ptr() % 16 == 4
    n0 = kernels.launches["quad_gather1"]
    for k in (0, 1, 0, 0, 1):
        got = gather.quad_gather1(dev_idx, dev_tabs[k])
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), wants[k])
    assert kernels.launches["quad_gather1"] == n0 + 5
    assert kernels.quad_gather1_slices(PP) == gather.quad_gather1_slices(PP)
    # few indices for the table
    few = dev_idx[: max(PP // 8, 8)].contiguous()
    assert torch.equal(gather.quad_gather1(few, dev_tabs[0]).cpu(),
                       gather.quad_gather1_plain(few.cpu(), tabs[0]))


def test_present_equals_readback(cuda):
    """present() starts the frame's copy into pinned host memory and
    flush() hands it out: the bytes of step + readback, in arrays that own
    their memory and survive later frames."""
    p, cam, scene = _scene(cuda)
    r = Renderer(scene, p.config, cuda)
    want = r.readback(r.step(scene, cam))
    assert r.present(r.step(scene, cam)) is None
    other = r.step(scene, p.animate(1.1)[0])
    got = r.present(other)
    h_other = r.flush()
    for _ in range(3):  # later frames reuse the device buffers
        r.readback(r.step(scene, p.animate(2.0)[0]))
    assert np.array_equal(got.color, want.color) and np.array_equal(got.depth, want.depth)
    assert got.color.flags.owndata and got.depth.flags.owndata
    assert set(got.stats) == set(want.stats)
    for k in want.stats:
        assert got.stats[k].dtype == want.stats[k].dtype and got.stats[k] == want.stats[k], k
    assert not np.array_equal(h_other.color, want.color)
    assert r.flush() is None


def test_stream_kernel_on_config6_shadow_pass(cuda):
    """The loaded courtyard's depth-only pass from the light at a 512^2 map
    (32x128 tiles): the stream kernel against its plain version, nothing
    dropped."""
    p = presets.config6_asset()
    cam, mm = p.animate(0.4)
    scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), cuda)
    cfg = dataclasses.replace(shadow_config(p.config), width=512, height=512)
    lv, lp = (convert.tensor(m, cuda) for m in light_matrices_for_scene(scene))
    inp = stream.prepare(geometry(scene, lv, lp, cfg), cfg)
    _same(stream.vis_stream(inp, cfg), stream.vis_stream_plain(inp, cfg))
    assert int(inp.dropped) == 0


BIN_OPTIONS = {
    "zorder": {"bin_zorder": True, "z_earlyout": True},
    "pairs2": {"bin_pairs": 2},
    "pairs2_quad2": {"bin_pairs": 2, "bin_quad_capacity": 2},
    "zorder_pairs2": {"bin_zorder": True, "bin_pairs": 2},
}


@pytest.mark.parametrize("depth_test", [True, False], ids=["depth", "painter"])
@pytest.mark.parametrize("option", sorted(BIN_OPTIONS))
@pytest.mark.parametrize("kernel", sorted(MATCHES_PLAIN))
def test_kernels_under_bin_options(cuda, kernel, option, depth_test):
    """Segments out of id order and the same id twice in a walk: each
    kernel equals its plain version and its own option-free output."""
    p, cam, scene = _scene(cuda)
    base = dataclasses.replace(p.config, depth_test=depth_test)
    cfg = dataclasses.replace(base, **BIN_OPTIONS[option])
    inp = MATCHES_PLAIN[kernel](cuda, p, cam, scene, cfg)
    ref = MATCHES_PLAIN[kernel](cuda, p, cam, scene, base)
    launch = stream.vis_stream if kernel == "vis_stream" else smem.vis_lists
    _same(launch(inp, cfg), launch(ref, base))
    assert int(inp.dropped) == int(ref.dropped) == 0
    if option == "pairs2_quad2":
        assert int(inp.large_count) > int(ref.large_count)


def test_config7_config_on_the_card_equals_cpu(cuda):
    got = presets.config7_terrain_lod(64, device=cuda).config
    assert got == presets.config7_terrain_lod(64, device="cpu").config


def test_app_layer_on_the_card(cuda):
    """debug_checks: a clean frame has every nf_* at 0, a NaN vertex does
    not fault and strict readback names the input stage; a shade_hook
    reading frag.depth equals the CPU's hooked frame within 1 LSB; frames
    with recycle_framebuffers=False equal the recycled ones."""
    p, cam, scene = _scene(cuda)
    cfg = dataclasses.replace(p.config, debug_checks=True)
    r = Renderer(scene, cfg, cuda)
    f = r.readback(r.step(scene, cam))
    assert {k: int(v) for k, v in f.stats.items() if k.startswith("nf_")} == dict.fromkeys(
        ("nf_0_input", "nf_1_geometry", "nf_2_visibility", "nf_3_shading"), 0)
    pos = scene.mesh.positions.clone()
    pos[7, 1] = float("nan")
    bad = r.step(scene.replace(mesh=scene.mesh.replace(positions=pos)), cam)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="input stage"):
        r.readback(bad)

    def fog(color, scene_, mat_id, xp, frag=None):
        f = torch.clamp(frag.depth * 1.5, 0.0, 1.0)[..., None]
        return color * (1.0 - f) + f

    rc = Renderer(scene, p.config, cuda, shade_hook=fog)
    fc = rc.readback(rc.step(scene, cam))
    cpu = convert.scene_to_torch(p.scene.replace(model_matrices=p.animate(0.3)[1]), "cpu")
    rh = Renderer(cpu, p.config, "cpu", shade_hook=fog)
    fh = rh.readback(rh.step(cpu, cam))
    assert np.abs(fc.color.astype(int) - fh.color.astype(int)).max() <= 1

    fresh = Renderer(scene, p.config, cuda, recycle_framebuffers=False)
    plain = Renderer(scene, p.config, cuda)
    for t in (0.3, 0.6, 0.9):
        c = p.animate(t)[0]
        a, b = fresh.readback(fresh.step(scene, c)), plain.readback(plain.step(scene, c))
        assert np.array_equal(a.color, b.color) and np.array_equal(a.depth, b.depth)
    assert not fresh._pool


@pytest.mark.parametrize("kernel", sorted(MATCHES_PLAIN))
def test_kernels_on_bands_with_y_offset(cuda, kernel):
    """Bands 1 and 3 of four of config3 at 192x108 (padded to 128 rows,
    bands of 32): the full frame's records in band coordinates, many above
    the band's first row (negative local ys), bit-exact against the plain
    version."""
    p, cam, scene = _scene(cuda)
    _, hb, band = shard.band_config(dataclasses.replace(p.config, num_shards=4), 4)
    tri = _tri(cuda, p, cam, scene, p.config)
    prepare, launch, plain = {
        "vis_stream": (stream.prepare, stream.vis_stream, stream.vis_stream_plain),
        "vis_lists": (smem.prepare_lists, smem.vis_lists, smem.vis_lists_plain)}[kernel]
    for b in (1, 3):
        inp = prepare(tri, band, b * hb)
        by0 = (inp.rec[:, 16] & 0xFFFF) - 32768
        assert int(by0[tri.valid].min()) < 0
        out = launch(inp, band)
        _same(out, plain(inp, band))
        assert bool((out[0] != 2**31 - 1).any())


@pytest.mark.parametrize("name", ["config4b", "config5"])
def test_banded_frame_on_the_card_equals_unbanded(cuda, name):
    """config4b (shadow map, blend) and config5 at golden size in four
    bands on one card: B1 once a band (and once for the shadow map), the
    frame byte-equal to the unbanded one."""
    if name == "config5":
        preset, size, over = presets.config5_flythrough(64, 64), (192, 108), {}
    else:
        preset, size, over = presets.config4_blend(), (160, 100), {"shadow_map_size": 128}
    p = presets.small_preset(preset, *size, bin_capacity=8192, num_shards=4, **over)
    cam, mm = p.animate(1.0)
    scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), cuda)
    s = shard.ShardedRenderer(scene, p.config, devices=[cuda])
    s.readback(s.step(scene, cam))  # the step that captures (and counts its warm-up frame)
    kernels.reset_launches()
    banded = s.readback(s.step(scene, cam))
    b1 = "vis_stream_zgate" if stream.gated(p.config) else "vis_stream"  # config5: z_earlyout
    assert kernels.launches[b1] == 4 + (name == "config4b")
    assert kernels.launches["blend_composite"] == (4 if name == "config4b" else 0)
    assert kernels.launches["blend_slots"] == (1 if name == "config4b" else 0)
    assert sum(kernels.launches.values()) == (kernels.launches[b1]
                                              + kernels.launches["blend_composite"]
                                              + kernels.launches["blend_slots"])
    r = Renderer(scene, p.config, cuda)
    single = r.readback(r.step(scene, cam))
    assert banded.color.tobytes() == single.color.tobytes()
    assert banded.depth.tobytes() == single.depth.tobytes()
    for k in ("tris_setup", "clip_overflow", "bin_overflow"):
        assert int(banded.stats[k]) == int(single.stats[k]), k


@pytest.mark.parametrize("name", ["config5", "config7"])
def test_setup_records_on_the_card_equal_the_cpus(cuda, name):
    from xr_torch.app import renderer

    p = (presets.config5_flythrough(708, 708) if name == "config5"
         else presets.config7_terrain_lod(160, device=cuda))
    p = presets.small_preset(p, 1920, 1080)
    cam, mm = p.animate(1.0)
    tris = []
    for dev in ("cpu", cuda):
        scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), dev)
        _, view, proj = renderer.camera_matrices(scene, cam, p.config)
        tri = geometry(scene, view, proj, p.config)
        tris.append({k: getattr(tri, k).cpu() for k in ("xs", "ys", "z", "valid", "src_id",
                                                         "count")})
    for k in tris[0]:
        a, b = tris[0][k], tris[1][k]
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b), k


ZGATES = {"zmax": {}, "band": {"z_band_gate": True}, "chunk": {"z_chunk_gate": True},
          "band_chunk": {"z_band_gate": True, "z_chunk_gate": True}}


def _gated_matches(cuda, p, cam, scene, cfg, repeats=1):
    """The gated kernel (counted as vis_stream_zgate) against the reference's
    serial gate in plain PyTorch and against the ungated kernel, bit for
    bit, launched `repeats` times. Returns the plain gate's skips."""
    inp = stream.prepare(_tri(cuda, p, cam, scene, cfg), cfg)
    assert inp.item_order is not None
    t, z, skips = stream.vis_stream_plain_gated(inp, cfg)
    ungated = dataclasses.replace(cfg, z_earlyout=False, z_band_gate=False, z_chunk_gate=False)
    want = stream.vis_stream(inp, ungated)
    _same(want, (t, z))
    for _ in range(repeats):
        n0 = dict(kernels.launches)
        out = stream.vis_stream(inp, cfg)
        torch.cuda.synchronize()
        assert kernels.launches["vis_stream_zgate"] == n0["vis_stream_zgate"] + 1
        assert kernels.launches["vis_stream"] == n0["vis_stream"]
        _same(out, want)
    return skips


@pytest.mark.parametrize("gates", sorted(ZGATES))
@pytest.mark.parametrize("name", ["config5", "config7", "config3_zorder"])
def test_gated_kernel_matches_plain_and_ungated(cuda, name, gates):
    """config5 (t = 3) and config7 (t = 20) at golden size and config3 under
    bin_zorder, each under every set of the gate's flags."""
    preset, t, over = {
        "config5": (presets.config5_flythrough(64, 64), 3.0, {"num_shards": 1}),
        "config7": (presets.config7_terrain_lod(64, device="cpu"), 20.0, {}),
        "config3_zorder": (presets.config3_terrain(48, 48), 0.3, {"bin_zorder": True}),
    }[name]
    p, cam, scene = _scene(cuda, t, preset)
    cfg = dataclasses.replace(p.config, z_earlyout=True, **over, **ZGATES[gates])
    _gated_matches(cuda, p, cam, scene, cfg)


@pytest.mark.parametrize("name", ["config5_block8", "config3_zorder"])
def test_gated_kernel_repeated_launches(cuda, name):
    """300 launches in a row: the merge order and the seeding from the
    scratch vary, the bits do not. config5 in blocks of 8 records front to
    back (the gate skips there), and config3 under BIN_OPTIONS' bin_zorder
    + z_earlyout (the bin-options case that launches the gated kernel,
    counted as vis_stream_zgate, never as vis_stream)."""
    if name == "config5_block8":
        p, cam, scene = _scene(cuda, 3.0, presets.config5_flythrough(64, 64))
        cfg = dataclasses.replace(p.config, z_earlyout=True, num_shards=1, bin_zorder=True,
                                  stream_block=8)
    else:
        p, cam, scene = _scene(cuda)
        cfg = dataclasses.replace(p.config, **BIN_OPTIONS["zorder"])
    skips = _gated_matches(cuda, p, cam, scene, cfg, repeats=300)
    assert name != "config5_block8" or skips["record"] > 0


@pytest.mark.parametrize("tile_h", [8, 64, 128])
def test_gated_kernel_any_tile_height(cuda, tile_h):
    """Tiles of 8 rows (one band) and of several 32-row slabs, on config3
    and config2 with the gate and both refinements."""
    for preset in (presets.config3_terrain(48, 48), presets.config2_icospheres()):
        p, cam, scene = _scene(cuda, 0.4, preset)
        cfg = dataclasses.replace(p.config, tile_h=tile_h, **ZGATES["band_chunk"],
                                  z_earlyout=True)
        _gated_matches(cuda, p, cam, scene, cfg)


def _permuted(scene, perm):
    mesh = scene.mesh
    return scene.replace(mesh=mesh.replace(indices=mesh.indices[perm],
                                           material_id=mesh.material_id[perm]))


def _frames(cuda, scene, cfg, cam, n=1):
    """n frames through Renderer on the card after the step that captures;
    the gated kernel ran in each."""
    r = Renderer(scene, cfg, cuda)
    r.step(scene, cam)
    n0 = kernels.launches["vis_stream_zgate"]
    frames = [r.readback(r.step(scene, cam)) for _ in range(n)]
    assert kernels.launches["vis_stream_zgate"] == n0 + n
    return frames


def _same_frame(a, b):
    assert np.array_equal(a.color, b.color) and np.array_equal(a.depth, b.depth)


def _near_frame(card, cpu):
    """test_cuda_frame_equals_cpu_frame's rule: coverage equal, depth within
    1e-6, color within 1 LSB."""
    assert ((card.depth == 1.0) == (cpu.depth == 1.0)).all()
    np.testing.assert_allclose(card.depth, cpu.depth, rtol=0, atol=1e-6)
    assert np.abs(card.color.astype(int) - cpu.color.astype(int)).max() <= 1


@pytest.mark.parametrize("name", ["config3", "layers16"])
def test_render_twice_identical_under_the_gate(cuda, name):
    """tests/test_determinism.py on the card under z_earlyout: 20 frames of
    one camera are the same bytes, whatever order the chunks merge and
    publish their bounds in; and they are the CPU's frame (within the rule
    of test_cuda_frame_equals_cpu_frame)."""
    preset = presets.config3_terrain(48, 48) if name == "config3" else layers.layers16()
    p, cam, scene = _scene(cuda, 0.3, preset)
    cfg = dataclasses.replace(p.config, z_earlyout=True)
    frames = _frames(cuda, scene, cfg, cam, n=20)
    for f in frames[1:]:
        _same_frame(f, frames[0])
    cpu = convert.scene_to_torch(p.scene.replace(model_matrices=p.animate(0.3)[1]), "cpu")
    rh = Renderer(cpu, cfg, "cpu")
    _near_frame(frames[0], rh.readback(rh.step(cpu, cam)))


@pytest.mark.parametrize("name", ["config3", "layers16"])
def test_triangle_order_invariance_under_the_gate(cuda, name):
    """A permuted mesh moves records between chunks and, under the z gate,
    changes which (record, warp) pairs the live bounds skip: the frame's
    bytes stay the same (no two triangles tie on z)."""
    preset = presets.config3_terrain(48, 48) if name == "config3" else layers.layers16()
    p, cam, scene = _scene(cuda, 0.3, preset)
    cfg = dataclasses.replace(p.config, z_earlyout=True)
    perm = torch.from_numpy(np.random.default_rng(3).permutation(scene.mesh.num_triangles)).to(cuda)
    a = _frames(cuda, scene, cfg, cam)[0]
    b = _frames(cuda, _permuted(scene, perm), cfg, cam)[0]
    _same_frame(a, b)
    tri = _tri(cuda, p, cam, scene, cfg)
    inp = stream.prepare(tri, cfg)
    assert int(_chunks(inp).max()) >= 2


def test_medium_bin_class_is_routing_under_the_gate(cuda):
    """config4 at 256x128 in 16x128 tiles (the kernels' width), no shadow
    map, binned, z_earlyout: the medium class on, off, overflowing and wide
    give the same bytes."""
    p, cam, scene = _scene(cuda, 0.0, presets.config4_phong())
    p = presets.small_preset(p, 256, 128, tile_h=16, tile_w=128, bin_capacity=8192,
                             shadow_map_size=0, raster_path="binned", z_earlyout=True)
    frames = {name: _frames(cuda, scene, dataclasses.replace(p.config, **over), cam)[0]
              for name, over in (("on", {}), ("off", {"medium_capacity": 0}),
                                 ("overflowing", {"medium_capacity": 4}),
                                 ("wide", {"medium_span": 16}))}
    assert int(frames["off"].stats["bin_overflow"]) == 0
    for f in frames.values():
        _same_frame(f, frames["off"])


@pytest.mark.parametrize("name", ["layers16", "layers16_chunk", "layers16_rev",
                                  "layers16_rev_zorder"])
def test_gated_kernel_on_the_stacked_planes(cuda, name):
    """xr_torch/tools/layers.py at golden size, where the gate has most to
    skip (ids front to back, also under z_chunk_gate, whose staging drops
    records there, or back to front sorted again by bin_zorder) and least
    (back to front): the gated kernel equals the serial gate and the
    ungated kernel, 100 launches in a row."""
    p, cam, scene = _scene(cuda, 0.0, layers.layers16(reverse=name.startswith("layers16_rev")))
    cfg = dataclasses.replace(p.config, bin_zorder=name.endswith("zorder"),
                              z_chunk_gate=name.endswith("chunk"))
    _gated_matches(cuda, p, cam, scene, cfg, repeats=100)


GRAPH_PRESETS = {**PRESETS, "config5": lambda: presets.config5_flythrough(64, 64),
                 "config6": presets.config6_asset, "config6cap": presets.config6_capped}
GRAPH_CASES = {**{name: (name, {}) for name in GRAPH_PRESETS},
               "config2_smem": ("config2", {"backend": "pallas_smem"}),
               "config3_smem": ("config3", {"backend": "pallas_smem"}),
               "config3_jnp": ("config3", {"backend": "jnp"}),
               "config3_brute": ("config3", {"raster_path": "brute"}),
               "config3_debug": ("config3", {"debug_checks": True}),
               "config4_smem": ("config4", {"backend": "pallas_smem"}),
               "config4_jnp": ("config4", {"backend": "jnp"})}


def _graph_case(cuda, case, t=0.3):
    name, over = GRAPH_CASES[case]
    p, cam, scene = _scene(cuda, t, GRAPH_PRESETS[name]())
    cfg = dataclasses.replace(p.config, shadow_map_size=min(p.config.shadow_map_size, 256),
                              **over)
    return p._replace(config=cfg), scene


def _eager(r, scene, cam, light=None):
    """render_step on what Renderer r renders, with the launches it counts."""
    from xr_torch.app.renderer import render_step

    lv, lp = light or r._light or (None, None)
    kernels.reset_launches()
    f = render_step(scene, cam, r.config, lv, lp, capacity=r.capacity, shade_hook=r._hook)
    torch.cuda.synchronize()
    return f, dict(kernels.launches)


def _graphed(r, scene, cam, light=None):
    """r.step after its first (the capture), with the launches it counts:
    the visibility kernels its replayed graphs hold."""
    kernels.reset_launches()
    f = r.step(scene, cam, light)
    torch.cuda.synchronize()
    return f, dict(kernels.launches)


def _bit_equal(got, want):
    assert torch.equal(got.color, want.color)
    assert torch.equal(got.depth.view(torch.int32), want.depth.view(torch.int32))
    assert list(got.stats) == list(want.stats)
    for k, v in want.stats.items():
        assert got.stats[k].dtype == v.dtype and int(got.stats[k]) == int(v), k


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graphed_frame_equals_render_step(cuda, case):
    """Renderer on the card captures the frame at its first step and
    replays it: every frame, the first included, equals render_step's
    eager frame bit for bit, stats included, with the same kernel launches
    counted (a replay's from its graphs' kernel nodes); no segment runs
    eagerly, config4b's blend included."""
    p, scene = _graph_case(cuda, case)
    r = Renderer(scene, p.config, cuda)
    cam = p.animate(0.3)[0]
    _bit_equal(r.step(scene, cam), _eager(r, scene, cam)[0])  # the step that captures
    for t in (0.3, 1.1, 2.0):
        cam = p.animate(t)[0]
        got, n_got = _graphed(r, scene, cam)
        want, n_want = _eager(r, scene, cam)
        _bit_equal(got, want)
        assert n_got == n_want
    eager = [s.name for s in r._captured.program.segments if s.graph is None]
    assert eager == []
    assert n_got["blend_composite"] == n_got["blend_slots"] == int(p.config.blend)
    if r._light is not None:  # the light_matrices= override reaches the shadow pass
        lv, lp = r._light
        lv = np.array(lv, np.float32)
        lv[0, 3] += np.float32(0.75)  # the light's view moved sideways
        light = (lv, lp)
        got, _ = _graphed(r, scene, p.animate(1.1)[0], light)
        _bit_equal(got, _eager(r, scene, p.animate(1.1)[0], light)[0])
        assert not torch.equal(got.color, r.step(scene, p.animate(1.1)[0]).color)


def test_graphed_present_equals_readback(cuda):
    """10 distinct cameras through present/flush equal step + readback:
    the camera's staging ring never overwrites a copy in flight."""
    p, scene = _graph_case(cuda, "config4")
    cams = [p.animate(0.2 * i)[0] for i in range(10)]
    r = Renderer(scene, p.config, cuda)
    want = [r.readback(r.step(scene, c)) for c in cams]
    q = Renderer(scene, p.config, cuda)
    got = [q.present(q.step(scene, c)) for c in cams][1:] + [q.flush()]
    for g, w in zip(got, want):
        assert np.array_equal(g.color, w.color) and np.array_equal(g.depth, w.depth)
        assert {k: int(v) for k, v in g.stats.items()} == {k: int(v) for k, v in w.stats.items()}
    assert len({w.color.tobytes() for w in want}) == len(cams)


def test_graphed_frames_without_recycling(cuda):
    """recycle_framebuffers=False: every replayed frame has buffers of its
    own, which later replays leave as they were."""
    p, scene = _graph_case(cuda, "config3")
    r = Renderer(scene, p.config, cuda, recycle_framebuffers=False)
    cams = [p.animate(t)[0] for t in (0.3, 0.9, 1.5)]
    frames = [r.step(scene, c) for c in cams]
    assert len({f.color.data_ptr() for f in frames} | {f.depth.data_ptr() for f in frames}) == 6
    for f, c in zip(frames, cams):
        _bit_equal(f, _eager(r, scene, c)[0])
    assert not r._pool


def test_graphed_scene_swap_and_reshape(cuda):
    """A scene in other tensors of the same shapes is copied into the
    captured inputs (and the first scene renders again after it, its
    tensors untouched); an edit in place is seen; a scene of other shapes
    captures anew."""
    p, scene = _graph_case(cuda, "config3")
    cam = p.animate(0.5)[0]
    r = Renderer(scene, p.config, cuda)
    first = r.step(scene, cam)
    mm = scene.model_matrices.clone()
    raised = mm.clone()
    raised[:, 1, 3] += 0.25
    other = scene.replace(model_matrices=raised)
    got = r.step(other, cam)
    _bit_equal(got, _eager(r, other, cam)[0])
    assert torch.equal(scene.model_matrices, mm) and not torch.equal(got.color, first.color)
    _bit_equal(r.step(scene, cam), first)
    program = r._captured.program
    scene.model_matrices.mul_(1.5)
    _bit_equal(r.step(scene, cam), _eager(r, scene, cam)[0])
    scene.model_matrices.copy_(mm)
    small = convert.scene_to_torch(presets.config3_terrain(32, 32).scene.replace(
        model_matrices=p.animate(0.5)[1]), cuda)
    _bit_equal(r.step(small, cam), _eager(r, small, cam)[0])
    assert r._captured.program is not program


def test_graphed_hook_reading_the_host_raises(cuda):
    """A shade_hook that reads the card's values on the host cannot be
    captured, as it cannot be traced under jit: the step raises and names
    the shade stage."""
    p, scene = _graph_case(cuda, "config3")

    def host_read(color, scene_, mat_id, xp):
        return color * float(color.max())

    r = Renderer(scene, p.config, cuda, shade_hook=host_read)
    with pytest.raises(RuntimeError, match="shade stage"):
        r.step(scene, p.animate(0.3)[0])


BAND_GRAPH_CASES = {  # name: (preset, bands, overrides); golden size on one card
    "config4-2": ("config4", 2, {}),
    "config4-2-smem": ("config4", 2, {"backend": "pallas_smem"}),
    "config4b-4": ("config4b", 4, {}),
    "config5-4": ("config5", 4, {}),
}


def _band_graph_case(cuda, case, **renderer_kw):
    """The case's preset in its bands at golden size, the scene on the
    card, and a ShardedRenderer with every band on it."""
    name, n, over = BAND_GRAPH_CASES[case]
    p, _, scene = _scene(cuda, 1.0, GRAPH_PRESETS[name]())
    cfg = dataclasses.replace(p.config, num_shards=n,
                              shadow_map_size=min(p.config.shadow_map_size, 128), **over)
    p = p._replace(config=cfg)
    return p, scene, shard.ShardedRenderer(scene, cfg, devices=[cuda], **renderer_kw)


def _eager_banded(s, scene, cam):
    """render_step_sharded on what ShardedRenderer s renders, with the
    launches it counts."""
    lv, lp = s._light or (None, None)
    kernels.reset_launches()
    f = shard.render_step_sharded(scene, cam, s.config, s.mesh, lv, lp, s.capacity, s._hook)
    torch.cuda.synchronize()
    return f, dict(kernels.launches)


def _graphed_banded(s, scene, cam):
    kernels.reset_launches()
    f = s.step(scene, cam)
    torch.cuda.synchronize()
    return f, dict(kernels.launches)


@pytest.mark.parametrize("case", sorted(BAND_GRAPH_CASES))
def test_graphed_banded_frame_equals_render_step_sharded(cuda, case):
    """ShardedRenderer on the card captures its banded frame at its first
    step and replays it: every frame equals render_step_sharded's eager
    frame bit for bit, stats included, with the same visibility launches
    a frame (B1 or B2 once a band, plus the shadow map's; config5's gated
    B1 once a band; config4b's blend kernel once a band), and the unbanded
    Renderer's color, depth and tris_setup; no segment runs eagerly."""
    p, scene, s = _band_graph_case(cuda, case)
    n = p.config.num_shards
    cam = p.animate(1.0)[0]
    _bit_equal(s.step(scene, cam), _eager_banded(s, scene, cam)[0])  # the step that captures
    r = Renderer(scene, p.config, cuda)
    for t in (1.0, 1.7, 2.4):
        cam = p.animate(t)[0]
        got, n_got = _graphed_banded(s, scene, cam)
        want, n_want = _eager_banded(s, scene, cam)
        _bit_equal(got, want)
        assert n_got == n_want
        b = max(n_got, key=n_got.get)
        blends = n_got["blend_composite"]
        assert blends == (n if p.config.blend else 0)
        assert n_got["blend_slots"] == int(p.config.blend)  # once a device
        assert n_got[b] == n + has_shadow_pass(p.config) == (sum(n_got.values()) - blends
                                                             - n_got["blend_slots"])
        single = r.step(scene, cam)
        assert torch.equal(got.color, single.color)
        assert torch.equal(got.depth.view(torch.int32), single.depth.view(torch.int32))
        assert int(got.stats["tris_setup"]) == int(single.stats["tris_setup"])
    (program,) = s._captured.programs.values()
    eager = [g.name for g in program.segments if g.graph is None]
    assert eager == []


def test_graphed_banded_present_equals_readback(cuda):
    """Six distinct cameras through a graphed ShardedRenderer's present/
    flush equal its step + readback."""
    p, scene, s = _band_graph_case(cuda, "config4-2")
    cams = [p.animate(0.2 * i)[0] for i in range(6)]
    want = [s.readback(s.step(scene, c)) for c in cams]
    _, _, q = _band_graph_case(cuda, "config4-2")
    got = [q.present(q.step(scene, c)) for c in cams][1:] + [q.flush()]
    for g, w in zip(got, want):
        assert np.array_equal(g.color, w.color) and np.array_equal(g.depth, w.depth)
        assert {k: int(v) for k, v in g.stats.items()} == {k: int(v) for k, v in w.stats.items()}
    assert len({w.color.tobytes() for w in want}) == len(cams)


def test_graphed_banded_frames_without_recycling(cuda):
    """recycle_framebuffers=False: every replayed banded frame has buffers
    of its own, which later replays leave as they were."""
    p, scene, s = _band_graph_case(cuda, "config5-4", recycle_framebuffers=False)
    cams = [p.animate(t)[0] for t in (1.0, 2.0, 3.0)]
    frames = [s.step(scene, c) for c in cams]
    assert len({f.color.data_ptr() for f in frames} | {f.depth.data_ptr() for f in frames}) == 6
    for f, c in zip(frames, cams):
        _bit_equal(f, _eager_banded(s, scene, c)[0])
    assert not s._pool


def test_graphed_banded_scene_swap_and_reshape(cuda):
    """A scene in other tensors of the same shapes is copied into the
    captured inputs (the first scene renders again after it, its tensors
    untouched); an edit in place is seen; a scene of other shapes captures
    anew."""
    p, scene, s = _band_graph_case(cuda, "config5-4")
    cam = p.animate(1.5)[0]
    first = s.step(scene, cam)
    mm = scene.model_matrices.clone()
    raised = mm.clone()
    raised[:, 1, 3] += 0.25
    other = scene.replace(model_matrices=raised)
    got = s.step(other, cam)
    _bit_equal(got, _eager_banded(s, other, cam)[0])
    assert torch.equal(scene.model_matrices, mm) and not torch.equal(got.color, first.color)
    _bit_equal(s.step(scene, cam), first)
    captured = s._captured
    scene.model_matrices.mul_(1.25)
    _bit_equal(s.step(scene, cam), _eager_banded(s, scene, cam)[0])
    scene.model_matrices.copy_(mm)
    small = presets.config5_flythrough(48, 48)
    small = convert.scene_to_torch(small.scene.replace(model_matrices=small.animate(1.5)[1]),
                                   cuda)
    assert small.mesh.num_triangles < scene.mesh.num_triangles
    _bit_equal(s.step(small, cam), _eager_banded(s, small, cam)[0])
    assert s._captured is not captured


BLEND_MODES = {"flat": MODE_FLAT, "gouraud": MODE_GOURAUD, "textured": MODE_TEXTURED,
               "phong": MODE_PHONG}


def blend_modes_preset(mode, textures="uniform", presets=presets, texture=texture,
                       types=types):
    """config4b at golden size (160x100, a 128^2 shadow map) in `mode`,
    its panes textured: textures "uniform" (one 32^2 checkerboard, both
    panes, repeat), "ragged" (a 32^2 and a 16^2 checkerboard, the upper
    pane's map clamped) or None. presets, texture, types: the port's
    modules, or the reference's, which have the same names."""
    p = presets.small_preset(presets.config4_blend(), 160, 100, bin_capacity=8192,
                             shadow_map_size=128)
    m = p.scene.materials
    rows = [{"base_color": tuple(float(c) for c in m.base_color[i]), "ka": float(m.ka[i]),
             "kd": float(m.kd[i]), "ks": float(m.ks[i]), "shininess": float(m.shininess[i]),
             "alpha": float(m.alpha[i])} for i in range(len(m.ka))]
    pyr = None
    if textures == "uniform":
        pyr = texture.build_pyramid([texture.checkerboard(32, 4)])
        rows[4]["tex_id"] = rows[5]["tex_id"] = 0
    elif textures == "ragged":
        pyr = texture.build_ragged_pyramid([texture.checkerboard(32, 4),
                                            texture.checkerboard(16, 2)])
        rows[4]["tex_id"], rows[5]["tex_id"], rows[5]["tex_addr"] = 0, 1, 1
    scene = p.scene.replace(materials=types.Material.table(rows), textures=pyr)
    return p._replace(scene=scene, config=dataclasses.replace(p.config, mode=mode))


def blend_inputs(p, device, t=0.0, bands=1):
    """What the blend stage of p's frame at t composites over, on device:
    (tri, scene, eye, shadow, [(rgb, depth, y_offset, config) of each of
    `bands` bands])."""
    cam, mm = p.animate(t)
    scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), device)
    cfg = p.config
    cap = clip_capacity(scene.mesh.num_triangles, cfg)
    c, view, proj = renderer.camera_matrices(scene, cam, cfg)
    shadow = {}
    if has_shadow_pass(cfg):
        shadow, _ = renderer.shadow_pass(scene, cfg, *light_matrices_for_scene(scene), cap)
    tri, vis_tri = renderer.visible_triangles(scene, view, proj, cfg, cap)
    _, hb, band_cfg = shard.band_config(cfg, bands) if bands > 1 else (0, cfg.height, cfg)
    out = []
    for b in range(bands):
        tid, zbuf, _ = dispatch.visibility(vis_tri, band_cfg, cap, y_offset=b * hb)
        depth = torch.where(torch.isinf(zbuf), 1.0, zbuf)
        rgb = renderer.shade(tri, tid, scene, band_cfg, c.eye, shadow, None, depth, b * hb)
        out.append((rgb, depth, b * hb, band_cfg))
    return tri, scene, c.eye, shadow, out


def same_f32(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("textures", ["uniform", "ragged"])
@pytest.mark.parametrize("mode", sorted(BLEND_MODES))
def test_blend_kernel_matches_plain(cuda, mode, textures):
    """The blend kernel (composite_transparent on the card, one launch a
    call, in place) against its plain version (blend_composite_plain on
    the card's tensors) and the whole-frame composite from the records,
    bit for bit in f32, unbanded and in each of four bands (a band the
    panes miss included); every pixel no fragment lands on keeps its
    input's bits."""
    p = blend_modes_preset(BLEND_MODES[mode], textures)
    changed = 0
    for bands in (1, 4):
        tri, scene, eye, shadow, per_band = blend_inputs(p, cuda, bands=bands)
        slots = blend.live_slots(tri, scene, p.config)
        for rgb, depth, yo, cfg in per_band:
            kernels.reset_launches()
            color = rgb.clone()
            got, overflow = blend.composite_transparent(color, depth, tri, scene, cfg, eye,
                                                        y_offset=yo, live=slots, **shadow)
            torch.cuda.synchronize()
            assert kernels.launches["blend_composite"] == 1 and got is color
            plain = blend.blend_composite_plain(rgb.clone(), depth, tri, scene, cfg, eye,
                                                y_offset=yo, live=slots, **shadow)
            whole, _ = blend.composite_whole_frame(rgb, depth, tri, scene, cfg, eye,
                                                   y_offset=yo, **shadow)
            assert same_f32(got, plain), (bands, yo)
            assert same_f32(got, whole), (bands, yo)
            assert int(overflow) == 0
            kept = ~(fragment_pixels(slots, depth, cfg, yo))
            assert torch.equal(got.view(torch.int32)[kept], rgb.view(torch.int32)[kept])
            changed += int((got != rgb).any(-1).sum())
    assert changed > 100


def fragment_pixels(slots, depth, cfg, y_offset=0):
    """(H, W) bool: the pixels of depth's rows (from y_offset) that a live
    slot's fragment lands on (blend.fragment_mask)."""
    live = blend.live_records(None, None, cfg, slots)
    H, W = depth.shape
    px = fp.pixel_center_fixed(torch.arange(W, device=depth.device), cfg.subpixel)
    py = fp.pixel_center_fixed(torch.arange(y_offset, y_offset + H, device=depth.device),
                               cfg.subpixel)
    rec = blend.unpack_slots(live.table[: live.count], cfg.attr_width)
    return blend.fragment_mask(rec, px, py, depth)[0].any(0)


def _blend_slot_scene(case):
    """(preset, t, config overrides) of a slot-table case: config4b at
    golden size at a t of the benchmark cell's range, every material
    transparent (totals far above the capacity), or the panes collapsed to
    a point (every transparent record culled)."""
    p = presets.small_preset(presets.config4_blend(), 160, 100, bin_capacity=8192,
                             shadow_map_size=128)
    kind, _, arg = case.partition("-")
    if kind == "config4b":
        return p, float(arg), {}
    if kind == "all_transparent":
        m = p.scene.materials
        mats = m.replace(alpha=np.full_like(m.alpha, 0.5))
        return p._replace(scene=p.scene.replace(materials=mats)), 0.3, {"blend_capacity": int(arg)}
    assert kind == "culled"
    pos = p.scene.mesh.positions.copy()
    pos[-8:] = pos[0]  # the two panes' eight vertices (merged last)
    return p._replace(scene=p.scene.replace(mesh=p.scene.mesh.replace(positions=pos))), 0.3, {}


BLEND_SLOT_CASES = ([f"config4b-{t}" for t in (0.05, 3.0, 6.05, 9.0, 16.0)]
                    + ["all_transparent-32", "all_transparent-300", "all_transparent-1",
                       "culled"])


def _same_slots(got, want, label):
    """The slot-table kernel's SlotTable against its plain version's: the
    meta vector, ids and table rows up to the live count, the chunk boxes."""
    n = int(want.count)
    assert torch.equal(got.meta, want.meta), (label, got.meta.tolist(), want.meta.tolist())
    assert torch.equal(got.ids[:n], want.ids[:n]), label
    assert torch.equal(got.boxes, want.boxes), label
    assert same_f32(got.table[:n], want.table[:n]), label


@pytest.mark.parametrize("case", BLEND_SLOT_CASES)
def test_blend_slots_kernel_matches_plain(cuda, case):
    """The slot-table kernel (live_slots on the card, one launch) against
    its plain version (live_slots_plain on the card's records), bit for
    bit: config4b's frames at the benchmark cell's t, totals above the
    capacity (every material transparent), and a frame whose transparent
    records are all culled (count 0: the composite writes nothing)."""
    p, t, over = _blend_slot_scene(case)
    cfg = dataclasses.replace(p.config, **over)
    cam, mm = p.animate(t)
    scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), cuda)
    c, view, proj = renderer.camera_matrices(scene, cam, cfg)
    cap = clip_capacity(scene.mesh.num_triangles, cfg)
    tri, vis_tri = renderer.visible_triangles(scene, view, proj, cfg, cap)
    kernels.reset_launches()
    got = blend.live_slots(tri, scene, cfg)
    torch.cuda.synchronize()
    assert kernels.launches["blend_slots"] == sum(kernels.launches.values()) == 1
    want = blend.live_slots_plain(tri, scene, cfg)
    _same_slots(got, want, case)
    total = int(blend.transparent_mask(tri, scene).sum())
    assert int(got.total) == total and int(got.overflow) == max(total - cfg.blend_capacity, 0)
    if case.startswith("all_transparent"):
        assert total > cfg.blend_capacity
    if case == "culled":
        assert total == 0 and int(got.count) == 0
        tid, zbuf, _ = dispatch.visibility(vis_tri, cfg, cap)
        depth = torch.where(torch.isinf(zbuf), 1.0, zbuf)
        rgb = renderer.shade(tri, tid, scene, cfg, c.eye, {}, None, depth)
        color = rgb.clone()
        out, overflow = blend.composite_transparent(color, depth, tri, scene, cfg, c.eye,
                                                    live=got)
        assert out is color and same_f32(out, rgb) and int(overflow) == 0


@pytest.mark.parametrize("textures", ["uniform", "ragged"])
@pytest.mark.parametrize("mode", sorted(BLEND_MODES))
def test_blend_slots_kernel_matches_plain_in_each_mode(cuda, mode, textures):
    """The slot-table kernel against its plain version in the card tests'
    eight mode cases (the LOD terms and texture fields of each pyramid)."""
    p = blend_modes_preset(BLEND_MODES[mode], textures)
    tri, scene, _, _, _ = blend_inputs(p, cuda)
    _same_slots(blend.live_slots(tri, scene, p.config),
                blend.live_slots_plain(tri, scene, p.config), (mode, textures))


def test_blend_kernels_build_without_spills(cuda, tmp_path):
    """ptxas's report of csrc/blend.cu: both blend kernels, no spill."""
    import subprocess

    out = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                          str(tmp_path / "blend.o"), str(kernels.CSRC / "blend.cu")],
                         capture_output=True, text=True, check=True)
    log = out.stdout + out.stderr
    for key in ("blend_composite", "blend_slots"):
        usage = kernels.ptxas_usage(log, key)
        assert usage is not None and usage["spill_bytes"] == 0, (key, usage)
