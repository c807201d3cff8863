"""The port's whole frame on the CPU (config1, config2, config3, config5,
config6 and config6cap at golden size): it matches the checked-in golden by the golden rule (no pixel more
than 1 LSB off, coverage within 1e-6 of the manifest), and the reference
Renderer on the same scene by the device-vs-oracle rule (coverage exact,
depth within 1e-6, color within 1 LSB), with equal stats; the shadow-mapped
config6 and config6cap by the shadow-edge rules of tests/test_goldens.py
and tests/test_torch_phong.py. Also the Renderer's buffers and present
queue, the layout axes, the options ported since the first slice (Phong,
shadows and blending on the small terrain, the z early-out flags, the
identity record layout, the bin options, debug_checks, num_shards, which
Renderer ignores as the reference's does), the overflow count of the stream
backend against the reference's, and the presets' configs field by field
(config7's measured at n0=160)."""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from xr.app.renderer import Renderer as RefRenderer
from xr.cpu_ref.margins import shadow_flip_risk
from xr.scene import presets as ref_presets
from xr_torch import Renderer, convert, kernels
from xr_torch.core.image import read_png
from xr_torch.scene import presets

# the suite runs several worker processes on shared cores: one torch
# thread each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


PORT = {
    "config1": presets.config1_cube,
    "config2": presets.config2_icospheres,
    "config3": lambda: presets.config3_terrain(48, 48),
    "config5": lambda: presets.config5_flythrough(64, 64),
    "config6": presets.config6_asset,
    "config6cap": presets.config6_capped,
}
REF = {
    "config1": ref_presets.config1_cube,
    "config2": ref_presets.config2_icospheres,
    "config3": lambda: ref_presets.config3_terrain(48, 48),
    "config5": lambda: ref_presets.config5_flythrough(64, 64),
    "config6": ref_presets.config6_asset,
    "config6cap": ref_presets.config6_capped,
}
SHADOWED = ("config6", "config6cap")  # the shadow-edge rule of tests/test_goldens.py:51-56


def _manifest(name="config3"):
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as f:
        return json.load(f)[name]


def _port_frame(t, m, name="config3", **over):
    p = presets.small_preset(PORT[name](), m["width"], m["height"], **{**m["overrides"], **over})
    cam, mm = p.animate(t)
    scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), "cpu")
    r = Renderer(scene, p.config, "cpu")
    kernels.reset_launches()
    frame = r.readback(r.step(scene, cam))
    assert not any(kernels.launches.values())  # CPU tensors: the plain versions
    return frame


def _check_golden(frame, name, m):
    golden = read_png(os.path.join(GOLDEN_DIR, f"{name}.png"))
    assert frame.color.shape == golden.shape and frame.color.dtype == np.uint8
    diff = np.abs(frame.color.astype(int) - golden.astype(int))
    npix = golden.shape[0] * golden.shape[1]
    allowed = max(2, int(npix * 0.001)) if name in SHADOWED else 0
    assert (diff.max(axis=-1) > 1).sum() <= allowed, f"max diff {diff.max()}"
    cov = float((frame.depth < 1.0).mean())
    assert abs(cov - m["coverage"]) < 1e-6


def test_port_frame_matches_golden():
    m = _manifest()
    _check_golden(_port_frame(m["t"], m), "config3", m)


@pytest.mark.parametrize("name", ["config1", "config2"])
def test_flat_and_gouraud_frames_match_golden(name):
    m = _manifest(name)
    _check_golden(_port_frame(m["t"], m, name), name, m)


def _ref_frame(name, t, **over):
    m = _manifest(name)
    p = ref_presets.small_preset(REF[name](), m["width"], m["height"],
                                 **{**m["overrides"], **over})
    cam, mm = p.animate(t, np)
    scene = p.scene.replace(model_matrices=mm)
    r = RefRenderer(scene, p.config)
    return r.readback(r.step(scene, cam), strict=False), scene, cam, p.config


def _check_against_reference(name, t):
    m = _manifest(name)
    ref, _, _, _ = _ref_frame(name, t)
    frame = _port_frame(t, m, name)
    assert ((frame.depth == 1.0) == (ref.depth == 1.0)).all(), "coverage mismatch"
    np.testing.assert_allclose(frame.depth, ref.depth, rtol=0, atol=1e-6)
    assert np.abs(frame.color.astype(int) - ref.color.astype(int)).max() <= 1
    assert set(frame.stats) == set(ref.stats)
    for k in ref.stats:
        assert int(frame.stats[k]) == int(ref.stats[k]), k


@pytest.mark.parametrize("t", [0.3, 1.7])
def test_port_frame_matches_reference_renderer(t):
    _check_against_reference("config3", t)


@pytest.mark.parametrize("name", ["config1", "config2"])
def test_flat_and_gouraud_frames_match_reference_renderer(name):
    _check_against_reference(name, 1.1)


@functools.lru_cache(maxsize=None)
def _golden_port_frame(name):
    m = _manifest(name)
    return _port_frame(m["t"], m, name)


@pytest.mark.parametrize("name", ["config5", "config6", "config6cap"])
def test_deep_and_asset_frames_match_golden(name):
    _check_golden(_golden_port_frame(name), name, _manifest(name))


@pytest.mark.parametrize("name", ["config5", "config6", "config6cap"])
def test_deep_and_asset_frames_match_reference_renderer(name):
    """Coverage and stats exact; depth within 1e-6 (the device-vs-oracle
    rule) at all but 0.1 % of the pixels and within 1e-5 at those
    (torch.tan and numpy's differ by an ulp
    at config5's 60 degree fov, so one element of the projection does, and
    a vertex that lies on a rounding boundary snaps to the neighbouring
    quarter pixel: 8 pixels of config5 differ by up to 2.7e-6); color
    within 1 LSB; on the
    shadow-mapped config6/6cap outside the pixels ``shadow_flip_risk``
    marks (inside: at most 180 LSB), and at most max(2, npix / 1000) pixels
    past 1 LSB in all (the goldens' 128^2 shadow map is coarse)."""
    m = _manifest(name)
    ref, rscene, rcam, rcfg = _ref_frame(name, m["t"])
    frame = _golden_port_frame(name)
    assert ((frame.depth == 1.0) == (ref.depth == 1.0)).all(), "coverage mismatch"
    zdiff = np.abs(frame.depth - ref.depth)
    assert zdiff.max() <= 1e-5 and (zdiff > 1e-6).sum() <= zdiff.size // 1000
    assert set(frame.stats) == set(ref.stats)
    for k in ref.stats:
        assert int(frame.stats[k]) == int(ref.stats[k]), k
    diff = np.abs(frame.color.astype(int) - ref.color.astype(int)).max(axis=-1)
    if name in SHADOWED:
        risk = shadow_flip_risk(rscene, rcam, rcfg)
        assert (diff * ~risk).max() <= 1 and (diff * risk).max() <= 180
        assert int((diff > 1).sum()) <= max(2, diff.size // 1000)
    else:
        assert diff.max() <= 1


def test_texture_cap_touches_color_only():
    """config6cap drops only the 512 map's top mip: geometry, depth and
    stats are config6's. At the golden's 128x72 every pixel of that map is
    minified past its level 1, where the capped chain holds the same
    texels, so the colors agree to the u8 rounding too."""
    a, b = _golden_port_frame("config6"), _golden_port_frame("config6cap")
    assert (a.depth == b.depth).all()
    assert np.abs(a.color.astype(int) - b.color.astype(int)).max() <= 1
    for k in a.stats:
        assert int(a.stats[k]) == int(b.stats[k]), k


@pytest.mark.parametrize("name", sorted(presets.ALL_PRESETS))
def test_preset_config_equals_reference_field_by_field(name):
    """The capacities define the overflow semantics: every field equal
    (config7's are measured, by its dry pass on the CPU here)."""
    kw = {"device": "cpu"} if name == "config7" else {}
    got = dataclasses.asdict(presets.ALL_PRESETS[name](**kw).config)
    want = dataclasses.asdict(ref_presets.ALL_PRESETS[name]().config)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k] and type(got[k]) is type(want[k]), k


def test_stream_overflow_count_equals_reference_stream_backend():
    """Under overflow each backend counts bin_overflow its own way, and the
    port's "auto" streams where the reference on the CPU takes its lists:
    with the stream backend named on both sides (the reference's kernel in
    interpret mode) the counts, the depth and the frame agree."""
    over = {"backend": "pallas_stream", "stream_expand": 0.001}
    m = _manifest("config3")
    ref, _, _, _ = _ref_frame("config3", m["t"], pallas_interpret=True, **over)
    p = presets.small_preset(PORT["config3"](), m["width"], m["height"],
                             **{**m["overrides"], **over})
    cam, mm = p.animate(m["t"])
    scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), "cpu")
    r = Renderer(scene, p.config, "cpu")
    with pytest.raises(RuntimeError, match="bin_overflow"):
        r.readback(r.step(scene, cam))
    got = r.readback(r.step(scene, cam), strict=False)
    assert int(got.stats["bin_overflow"]) == int(ref.stats["bin_overflow"]) > 0
    for k in ref.stats:
        assert int(got.stats[k]) == int(ref.stats[k]), k
    assert ((got.depth == 1.0) == (ref.depth == 1.0)).all()
    np.testing.assert_allclose(got.depth, ref.depth, rtol=0, atol=1e-6)
    assert np.abs(got.color.astype(int) - ref.color.astype(int)).max() <= 1
    # "auto" is the stream backend in the port: the same count
    auto = presets.small_preset(p, m["width"], m["height"], backend="auto")
    ra = Renderer(scene, auto.config, "cpu")
    assert int(ra.readback(ra.step(scene, cam), strict=False).stats["bin_overflow"]) == int(
        got.stats["bin_overflow"])


def test_config2_backends_render_the_same_frame():
    """auto (the stream kernel), jnp and pallas_smem give one frame; at
    golden size pallas_smem streams by the SMEM budget rule, so with a
    4224-entry cap (inside the budget, above the fullest tile's 4127
    entries) the list kernel's plain version runs too."""
    m = _manifest("config2")
    want = _port_frame(m["t"], m, "config2")
    for over in ({"backend": "jnp"}, {"backend": "pallas_smem"},
                 {"backend": "pallas_smem", "bin_capacity": 4224}):
        got = _port_frame(m["t"], m, "config2", **over)
        assert (got.color == want.color).all() and (got.depth == want.depth).all(), over
        for k in want.stats:
            assert int(got.stats[k]) == int(want.stats[k]), (over, k)


def test_config1_brute_equals_binned():
    m = _manifest("config1")
    want = _port_frame(m["t"], m, "config1")
    got = _port_frame(m["t"], m, "config1", raster_path="binned")
    assert (got.color == want.color).all() and (got.depth == want.depth).all()


def _small(**over):
    over = {"raster_path": "binned", **over}  # 16x16 terrain: auto would pick brute
    p = presets.small_preset(presets.config3_terrain(16, 16), 64, 48, **over)
    cam, mm = p.animate(0.3)
    return p, cam, convert.scene_to_torch(p.scene.replace(model_matrices=mm), "cpu")


def test_present_flush_and_buffer_reuse():
    p, cam, scene = _small()
    r = Renderer(scene, p.config, "cpu")
    f0 = r.step(scene, cam)
    assert r.present(f0) is None
    f1 = r.step(scene, p.animate(0.6)[0])
    h0 = r.present(f1)  # frame 0's host copy; its buffers go back to the pool
    f2 = r.step(scene, cam)
    assert f2.color.data_ptr() == f0.color.data_ptr()  # reused output buffer
    h1 = r.flush()
    assert r.flush() is None
    h2 = r.readback(f2)
    assert (h0.color == h2.color).all() and (h0.depth == h2.depth).all()
    assert not (h1.color == h0.color).all()


def test_host_frame_survives_the_next_step():
    """A host Frame owns its arrays: present() hands frame N-1's device
    buffers back to the pool once its host copy is taken, and the next step
    overwrites them; the host copy must not change (on the CPU, .numpy() of
    the buffer would alias it)."""
    p, cam, scene = _small()
    r = Renderer(scene, p.config, "cpu")
    r.present(r.step(scene, cam))
    h0 = r.present(r.step(scene, p.animate(0.6)[0]))  # frame 0's buffers go to the pool
    keep = h0.color.copy()
    f2 = r.step(scene, p.animate(0.9)[0])  # written into frame 0's buffers
    assert not (f2.color.numpy() == keep).all()
    assert (h0.color == keep).all()


# layout axes of the reference that are bit-identical by construction: the
# port accepts their other values and renders the same frame
LAYOUT_AXES = [("deferred_fetch", "fields"), ("record_split", 2), ("lod_fetch", "recompute"),
               ("tex_fetch", "twolevel"), ("tex_split", 2), ("corner_fetch", "percorner"),
               ("mip_math", "closed"), ("record_pack", "bits")]


@pytest.mark.parametrize("axis,value", LAYOUT_AXES, ids=[a for a, _ in LAYOUT_AXES])
def test_layout_axes_render_the_same_frame(axis, value):
    p, cam, scene = _small()
    base = Renderer(scene, p.config, "cpu")
    want = base.readback(base.step(scene, cam))
    p2, _, _ = _small(**{axis: value})
    r = Renderer(scene, p2.config, "cpu")
    got = r.readback(r.step(scene, cam))
    assert (got.color == want.color).all() and (got.depth == want.depth).all()


# options of earlier unported-option cases that the port runs now: Phong on
# the textured terrain (the texture through uv slot 6), with a shadow map,
# blending with no transparent material, the z early-out flags (they cannot
# change the frame), the identity record layout (capacity >= T +
# clip_budget * 7), the two bin options, also through the list kernel
# (the reference's in interpret mode), debug_checks (its nf_* stats), and
# num_shards, which both Renderers ignore (config5's preset sets 4 bands
# and z_earlyout; the bands are ShardedRenderer's, tests/test_torch_shard.py)
PORTED_OPTIONS = {"num_shards=2": {"num_shards": 2},
                  "num_shards=4": {"num_shards": 4, "z_earlyout": True},
                  "blend": {"blend": True}, "mode": {"mode": 3},
                  "shadow_map_size": {"mode": 3, "shadow_map_size": 64},
                  "z_earlyout": {"z_earlyout": True},
                  "z_gates": {"z_earlyout": True, "z_chunk_gate": True, "z_band_gate": True},
                  "identity_layout": {"clip_expand": 8.0},
                  "bin_zorder": {"bin_zorder": True}, "bin_pairs": {"bin_pairs": 2},
                  "debug_checks": {"debug_checks": True},
                  "backend-bin_zorder": {"backend": "pallas_smem", "bin_zorder": True,
                                         "pallas_interpret": True},
                  "backend-bin_pairs": {"backend": "pallas_smem", "bin_pairs": 2,
                                        "pallas_interpret": True}}


@pytest.mark.parametrize("name", sorted(PORTED_OPTIONS))
def test_formerly_unported_options_render_the_reference_frame(name):
    over = {"raster_path": "binned", **PORTED_OPTIONS[name]}
    p, cam, scene = _small(**over)
    r = Renderer(scene, p.config, "cpu")
    got = r.readback(r.step(scene, cam))
    rp = ref_presets.small_preset(ref_presets.config3_terrain(16, 16), 64, 48, **over)
    rcam, mm = rp.animate(0.3, np)
    rscene = rp.scene.replace(model_matrices=mm)
    rr = RefRenderer(rscene, rp.config)
    ref = rr.readback(rr.step(rscene, rcam))
    assert ((got.depth == 1.0) == (ref.depth == 1.0)).all()
    np.testing.assert_allclose(got.depth, ref.depth, rtol=0, atol=1e-6)
    assert set(got.stats) == set(ref.stats)
    for k in ref.stats:
        assert int(got.stats[k]) == int(ref.stats[k]), k
    diff = np.abs(got.color.astype(int) - ref.color.astype(int)).max(axis=-1)
    risk = shadow_flip_risk(rscene, rcam, rp.config)
    assert (diff * ~risk).max() <= 1 and (diff * risk).max() <= 180


Z_FLAGS = [{"z_earlyout": True}, {"z_earlyout": True, "z_chunk_gate": True},
           {"z_earlyout": True, "z_band_gate": True},
           {"z_earlyout": True, "z_chunk_gate": True, "z_band_gate": True}]


@pytest.mark.parametrize("backend", ["pallas_stream", "pallas_smem", "jnp"])
def test_z_flags_render_the_same_frame(backend):
    """The early-out and its gates on and off: one frame, one set of stats,
    through each backend's plain version."""
    p, cam, scene = _small(backend=backend)
    base = Renderer(scene, p.config, "cpu")
    want = base.readback(base.step(scene, cam))
    for flags in Z_FLAGS:
        r = Renderer(scene, dataclasses.replace(p.config, **flags), "cpu")
        got = r.readback(r.step(scene, cam))
        assert (got.color == want.color).all() and (got.depth == want.depth).all(), flags
        assert all(int(got.stats[k]) == int(want.stats[k]) for k in want.stats), flags


def test_z_chunk_gate_keeps_the_block_size_check():
    """As in the reference: under z_chunk_gate the stream's block size is a
    multiple of the 8 records one aggregate gates."""
    p, cam, scene = _small(backend="pallas_stream", z_earlyout=True, z_chunk_gate=True,
                           stream_block=100)
    with pytest.raises(AssertionError, match="CHUNK_G"):
        Renderer(scene, p.config, "cpu").step(scene, cam)
