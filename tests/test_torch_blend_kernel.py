"""The blend stage as the card captures it (xr_torch/shading/blend.py), on
the CPU, where the kernels (csrc/blend.cu) stand as their plain versions:
- the live slots the card keeps on the device (blend.live_slots: the meta
  vector with the live count, the transparent total, the overflow and the
  union of the live boxes cut to the frame, the source-ordered ids, each
  live chunk's screen box, each slot's box and record in the slot table)
  against the host values, computed here in numpy from the records and
  with the reference's _src_ordered_ids: config4b at golden size at
  chip_smoke.py's BLEND_CROP_TIMES, and the scenes of
  tests/test_torch_blend.py (FAR_PANES, CROP_CASES); the plain version's
  host read (live_records) holds the same values;
- totals above the capacity (every material transparent) and a frame
  whose transparent records are all culled (count 0) through the plain
  paths of live_slots and composite_transparent: the meta vector's host
  values, the whole-frame composite bit for bit, the overflow, and no
  pixel written at count 0;
- both kernels' names map to their own launch counts, and both wrappers
  refuse CPU tensors;
- the slot table's layout is the one csrc/blend.cu reads;
- blend_composite_plain (from the slot table, cropped to the live boxes)
  against composite_transparent and the whole-frame composite from the
  records (blend.composite_whole_frame), bit for bit in f32, in each of
  the four modes on the card tests' scenes (config4b's panes textured from
  a uniform or a ragged pyramid, one map clamped: tests/test_torch_cuda.py
  blend_modes_preset), unbanded and in four bands;
- blend_composite_plain against the JAX package's
  xr.shading.blend.composite_transparent on the same numpy inputs (the
  reference's records; color, opaque depth and shadow map drawn from a
  seed), in each mode and both pyramids: resolved to u8, within 1 LSB at
  all but max(2, npix / 1000) pixels (the goldens' rule,
  tests/test_goldens.py), with the same overflow count.
At golden size, one torch thread.
"""

import dataclasses
import functools
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_blend import CROP_CASES, FAR_PANES, _config4b, _panes
from test_torch_cuda import (BLEND_MODES, _blend_slot_scene, blend_inputs, blend_modes_preset,
                             same_f32)

from xr.core import math3d as rm3
from xr.core import types as rtypes
from xr.pipeline import geometry as rgeom
from xr.pipeline.shadow import light_matrices_for_scene as ref_light_matrices
from xr.scene import presets as ref_presets
from xr.scene import texture as rtx
from xr.shading import blend as rblend
from xr_torch import convert, kernels
from xr_torch.app import renderer
from xr_torch.core import shade_math as sm
from xr_torch.core.types import MODE_PHONG, Lights
from xr_torch.pipeline.geometry import clip_capacity
from xr_torch.shading import blend

BLEND_CROP_TIMES = (0.05, 3.0, 6.05, 9.0, 16.0)  # chip_smoke.py's, in config4b_1080p's frames


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SLOT_CASES = {
    **{f"config4b-t{t}": (lambda t=t: _config4b(t)) for t in BLEND_CROP_TIMES},
    **{f"panes-{k}": (lambda k=k: _panes(k)) for k in FAR_PANES},
    **CROP_CASES,
}


def _first_center(v, sub):
    return -((sub // 2 - v) // sub)


@pytest.mark.parametrize("case", list(SLOT_CASES))
def test_live_slots_on_the_device_equal_the_host_values(case):
    scene_np, cam, cfg, _ = SLOT_CASES[case]()
    scene = convert.scene_to_torch(scene_np, "cpu")
    cap = clip_capacity(scene.mesh.num_triangles, cfg)
    _, view, proj = renderer.camera_matrices(scene, cam, cfg)
    tri, _ = renderer.visible_triangles(scene, view, proj, cfg, cap)
    slots = blend.live_slots(tri, scene, cfg)

    # the host values, in numpy
    bc, ch = cfg.blend_capacity, min(cfg.blend_chunk, cfg.blend_capacity)
    nchunks, sub = -(-bc // ch), cfg.subpixel
    t = {k: getattr(tri, k).numpy() for k in ("xs", "ys", "mat_id", "src_id", "valid")}
    alpha = scene.materials.alpha.numpy()
    tmask = t["valid"] & (alpha[t["mat_id"]] < 1.0)
    ids, total = rblend._src_ordered_ids(types.SimpleNamespace(src_id=t["src_id"]), tmask,
                                         nchunks * ch, np)
    count = min(int(total), bc)
    assert int(slots.count) == count and slots.count.dtype == torch.int32
    assert slots.ids.tolist() == ids.tolist()
    live_boxes = []
    for c in range(nchunks):
        sl = ids[c * ch : min((c + 1) * ch, count)]
        if len(sl):
            ys, xs = t["ys"][sl], t["xs"][sl]
            want = (_first_center(ys.min(), sub), _first_center(ys.max() + 1, sub),
                    _first_center(xs.min(), sub), _first_center(xs.max() + 1, sub))
            live_boxes.append(want)
            assert tuple(slots.boxes[c].tolist()) == want, c
        else:
            y0, y1, x0, x1 = slots.boxes[c].tolist()
            assert y1 <= y0 and x1 <= x0, c
    # each slot's row: its record and its own box
    rec = blend.unpack_slots(slots.table, cfg.attr_width)
    live = ids[:count]
    assert slots.table.shape == (bc, blend.columns(cfg.attr_width)["width"])
    assert rec.xs[:count].tolist() == t["xs"][live].tolist()
    assert rec.ys[:count].tolist() == t["ys"][live].tolist()
    assert rec.mat_id[:count].tolist() == t["mat_id"][live].tolist()
    assert rec.alpha[:count].tolist() == alpha[t["mat_id"][live]].tolist()
    for j, r in enumerate(live):
        ys, xs = t["ys"][r], t["xs"][r]
        assert rec.box[j].tolist() == [_first_center(ys.min(), sub),
                                       _first_center(ys.max() + 1, sub),
                                       _first_center(xs.min(), sub),
                                       _first_center(xs.max() + 1, sub)], j
    assert torch.equal(rec.z[:count], tri.z[torch.from_numpy(live).long()])
    assert slots.meta.tolist() == _host_meta(t, tmask, cfg)
    # the plain version's host read: the same count, ids and live boxes
    host = blend.live_records(tri, scene, cfg, slots)
    assert host.count == count and host.boxes == live_boxes and host.ids is slots.ids
    assert blend.live_records(tri, scene, cfg, slots) is host  # read once


def _host_meta(t, tmask, cfg):
    """The meta vector in numpy from the records t (xs, ys, src_id) and the
    transparent mask: count, total, overflow, 0, and the union of the live
    chunks' boxes cut to the frame."""
    bc, ch = cfg.blend_capacity, min(cfg.blend_chunk, cfg.blend_capacity)
    nchunks, sub = -(-bc // ch), cfg.subpixel
    ids, total = rblend._src_ordered_ids(types.SimpleNamespace(src_id=t["src_id"]), tmask,
                                         nchunks * ch, np)
    count, far = min(int(total), bc), 2**30
    live = ids[:count]
    ys, xs = t["ys"][live], t["xs"][live]
    union = (_first_center(ys.min() if count else far, sub),
             _first_center(ys.max() + 1 if count else 1 - far, sub),
             _first_center(xs.min() if count else far, sub),
             _first_center(xs.max() + 1 if count else 1 - far, sub))
    H, W = cfg.height, cfg.width
    return [count, int(total), max(int(total) - bc, 0), 0, min(max(union[0], 0), H),
            min(max(union[1], 0), H), min(max(union[2], 0), W), min(max(union[3], 0), W)]


@pytest.mark.parametrize("case", ["all_transparent-32", "all_transparent-1", "culled"])
def test_overflow_and_count_zero_through_the_plain_paths(case):
    """live_slots and composite_transparent on the CPU (the plain versions)
    where the total passes the capacity and where every transparent record
    is culled: the meta vector's host values; the composite, in place,
    equal to the whole-frame composite bit for bit with the same overflow;
    at count 0 not one pixel written."""
    p, t, over = _blend_slot_scene(case)
    p = p._replace(config=dataclasses.replace(p.config, **over))
    cfg = p.config
    tri, scene, eye, shadow, ((rgb, depth, _, _),) = blend_inputs(p, "cpu", t=t)
    slots = blend.live_slots(tri, scene, cfg)
    host = {k: getattr(tri, k).numpy() for k in ("xs", "ys", "src_id")}
    tmask = blend.transparent_mask(tri, scene).numpy()
    meta = _host_meta(host, tmask, cfg)
    assert slots.meta.tolist() == meta
    if case == "culled":
        assert meta[:3] == [0, 0, 0]
    else:
        assert meta[1] > cfg.blend_capacity and meta[0] == cfg.blend_capacity
    color = rgb.clone()
    got, overflow = blend.composite_transparent(color, depth, tri, scene, cfg, eye, **shadow)
    whole, whole_overflow = blend.composite_whole_frame(rgb, depth, tri, scene, cfg, eye,
                                                        **shadow)
    assert got is color and same_f32(got, whole)
    assert int(overflow) == int(whole_overflow) == meta[2]
    assert same_f32(got, rgb) == (case == "culled")


def test_slot_table_layout_is_the_kernels():
    """csrc/blend.cu's column constants are blend.FIELDS' columns, and a
    table unpacks to the Slots it was packed from."""
    src = (kernels.CSRC / "blend.cu").read_text()
    decl = re.search(r"constexpr int (kXs = 0,.*?);", src, re.S).group(1)
    got = {k: int(v) for k, v in re.findall(r"k(\w+) = (\d+)", decl)}
    names = {"Xs": "xs", "Ys": "ys", "Z": "z", "InvW": "inv_w", "Face": "face_rgb",
             "Lod": "lod", "Alpha": "alpha", "Base": "base_color", "Ka": "ka", "Kd": "kd",
             "Ks": "ks", "Shin": "shininess", "TexId": "tex_id", "TexAddr": "tex_addr",
             "TexBase": "tex_base", "MatId": "mat_id", "Box": "box", "Attr": "attr_w"}
    cols = blend.columns(8)
    assert {names[k]: v for k, v in got.items()} == {n: cols[n][0] for n, _ in blend.FIELDS}
    p = blend_modes_preset(MODE_PHONG, "ragged")
    tri, scene, _, _, _ = blend_inputs(p, "cpu")
    ids = torch.arange(7, dtype=torch.int64) * 3
    s = blend.record_slots(tri, ids, scene, p.config)
    back = blend.unpack_slots(blend.pack_slots(s), p.config.attr_width)
    for name, _ in blend.FIELDS:
        a, b = getattr(s, name), getattr(back, name)
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int32) if a.is_floating_point()
                                                  else a, b.view(torch.int32)
                                                  if b.is_floating_point() else b), name


@pytest.mark.parametrize("textures", ["uniform", "ragged"])
@pytest.mark.parametrize("mode", sorted(BLEND_MODES))
def test_plain_is_the_composite(mode, textures):
    p = blend_modes_preset(BLEND_MODES[mode], textures)
    changed = 0
    for bands in (1, 4):
        tri, scene, eye, shadow, per_band = blend_inputs(p, "cpu", bands=bands)
        slots = blend.live_slots(tri, scene, p.config)
        for rgb, depth, yo, cfg in per_band:
            got = blend.blend_composite_plain(rgb.clone(), depth, tri, scene, cfg, eye,
                                              y_offset=yo, live=slots, **shadow)
            via, overflow = blend.composite_transparent(rgb.clone(), depth, tri, scene, cfg, eye,
                                                        y_offset=yo, **shadow)
            whole, _ = blend.composite_whole_frame(rgb, depth, tri, scene, cfg, eye, y_offset=yo,
                                                   **shadow)
            assert same_f32(got, via) and same_f32(got, whole), (bands, yo)
            assert int(overflow) == 0
            changed += int((got != rgb).any(-1).sum())
    assert changed > 100


def _ref_inputs(mode, textures, seed):
    """The reference's numpy scene, config and records, and color, depth
    and shadow map drawn from a seed, for the reference's composite."""
    p = blend_modes_preset(BLEND_MODES[mode], textures, ref_presets, rtx, rtypes)
    cam, mm = p.animate(0.0, np)
    scene = p.scene.replace(model_matrices=mm)
    cfg = p.config
    view, proj = rm3.camera_matrices(cam, cfg.width / cfg.height, np)
    tri = rgeom.geometry(scene, view, proj, cfg, np)
    rng = np.random.default_rng(seed)
    H, W = cfg.height, cfg.width
    color = rng.uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)
    depth = rng.uniform(0.3, 1.0, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.3] = 1.0
    shadow = {}
    if mode == "phong":
        lv, lp = ref_light_matrices(scene)
        n = cfg.shadow_map_size
        shadow = {"shadow_depth": rng.uniform(0.2, 1.0, (n, n)).astype(np.float32),
                  "light_viewproj": (np.asarray(lp, np.float32) @ np.asarray(lv, np.float32))}
    return scene, cfg, cam, tri, color, depth, shadow


@pytest.mark.parametrize("textures", ["uniform", "ragged"])
@pytest.mark.parametrize("mode", sorted(BLEND_MODES))
def test_plain_matches_the_reference(mode, textures):
    scene, cfg, cam, tri, color, depth, shadow = _ref_inputs(mode, textures, seed=7)
    on_jax = functools.partial(jax.tree_util.tree_map, jnp.asarray)
    want, want_of = rblend.composite_transparent(
        jnp.asarray(color), jnp.asarray(depth), on_jax(tri), on_jax(scene), cfg,
        np.asarray(cam.eye), xp=jnp, **on_jax(shadow))
    pcfg = convert.config_from(cfg)
    got, got_of = blend.composite_transparent(
        torch.from_numpy(color), torch.from_numpy(depth), convert.tribuf_to_torch(tri, "cpu"),
        convert.scene_to_torch(scene, "cpu"), pcfg, torch.from_numpy(np.asarray(cam.eye)),
        **{k: torch.from_numpy(v) for k, v in shadow.items()})
    assert int(got_of) == int(want_of) == 0
    g = sm.resolve_u8(got).numpy().astype(int)
    w = sm.resolve_u8(torch.from_numpy(np.array(want))).numpy().astype(int)
    diff = np.abs(g - w).max(axis=-1)
    assert (diff > 1).sum() <= max(2, diff.size // 1000), (diff > 1).sum()
    assert (np.asarray(want) != color).any(-1).sum() > 100  # the panes composite


def test_blend_kernel_names_map_to_its_launch_count():
    names = {"void xrb::blend_composite_kernel(xrb::Args)": "blend_composite",
             "_ZN3xrb22blend_composite_kernelENS_4ArgsE": "blend_composite"}
    assert {n: kernels.launch_name(n) for n in names} == names
    assert "blend_composite" in kernels.launches
    assert kernels.CSRC / "blend.cu" in kernels.SOURCES


def test_slot_kernel_name_maps_to_its_launch_count():
    """The slot-table kernel counts under blend_slots (graph_launches reads
    it in replays), by words that no other kernel's name holds."""
    names = {"void xrb::slot_table_kernel(xrb::SlotArgs)": "blend_slots",
             "_ZN3xrb17slot_table_kernelENS_8SlotArgsE": "blend_slots"}
    assert {n: kernels.launch_name(n) for n in names} == names
    assert "blend_slots" in kernels.launches
    src = (kernels.CSRC / "blend.cu").read_text()
    kernel_names = re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\) )?(\w+)\(", src)
    assert sorted(kernel_names) == ["blend_composite_kernel", "slot_table_kernel"]
    for other, words in kernels.KERNEL_NAMES.items():
        if other != "blend_slots":
            assert not all(w in "slot_table_kernel" for w in words), other
    assert not all(w in "blend_composite_kernel" for w in kernels.KERNEL_NAMES["blend_slots"])


def test_slot_kernel_refuses_cpu_tensors():
    """The slot-table wrapper launches on CUDA tensors or raises: no
    fallback; live_slots on CPU records runs the plain version."""
    p = blend_modes_preset(MODE_PHONG, "ragged")
    tri, scene, _, _, _ = blend_inputs(p, "cpu")
    call = blend.slots_call(tri, scene, p.config)
    assert call.keywords["uv_slot"] == 6 and call.args[2] is scene.textures.base_size_per_tex
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()
    kernels.reset_launches()
    slots = blend.live_slots(tri, scene, p.config)
    assert not any(kernels.launches.values())
    assert same_f32(slots.table, blend.live_slots_plain(tri, scene, p.config).table)


def test_blend_kernel_refuses_cpu_tensors():
    """The wrapper launches on CUDA tensors or raises: no fallback."""
    p = blend_modes_preset(MODE_PHONG)
    tri, scene, eye, shadow, ((rgb, depth, yo, cfg),) = blend_inputs(p, "cpu")
    slots = blend.live_slots(tri, scene, cfg)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.blend_composite(rgb, depth, slots.table, slots.meta,
                                torch.zeros(6 + 6 * 4 + 16), shadow["shadow_depth"], None,
                                None, None, mode=cfg.mode, attr_width=cfg.attr_width,
                                y_offset=0, subpixel=cfg.subpixel, n_dir=2, n_point=2,
                                bias=cfg.shadow_bias, levels=0)
    assert dataclasses.is_dataclass(slots) and slots.host is None


def _emulated_kernel(calls):
    """kernels.blend_composite in plain torch from the kernel's own inputs
    (the slot table, the constants vector, the texture tables as a ragged
    pyramid): every live slot over the whole frame (band), in order."""

    def emulate(color, depth, table, meta, consts, shadow, quads, level_size, level_base, *,
                mode, attr_width, y_offset, subpixel, n_dir, n_point, bias, levels):
        calls.append({"mode": mode, "attr_width": attr_width, "subpixel": subpixel,
                      "bias": bias, "levels": levels})
        c = iter(torch.split(consts, [3, 3] + [3 * n_dir] * 2 + [3 * n_point] * 2
                             + ([16] if shadow is not None else [])))
        eye, ambient = next(c), next(c)
        lights = Lights(*(next(c).view(-1, 3) for _ in range(4)), ambient)
        lvp = next(c).view(4, 4) if shadow is not None else None
        pyr = None
        if levels:
            ntex = level_size.shape[0] // levels
            pyr = types.SimpleNamespace(quads=quads, level_size=level_size.view(ntex, levels),
                                        level_offset=level_base.view(ntex, levels),
                                        base_size_per_tex=None, num_levels=levels)
        scene = types.SimpleNamespace(lights=lights, textures=pyr)
        cfg = types.SimpleNamespace(mode=mode, shadow_bias=bias, mip_math="table")
        H, W = depth.shape
        px = torch.arange(W, dtype=torch.int32) * subpixel + subpixel // 2
        py = (torch.arange(H, dtype=torch.int32) + y_offset) * subpixel + subpixel // 2
        rec = blend.unpack_slots(table[: int(meta[0])], attr_width)
        return blend._composite_slots(color, depth, rec, scene, cfg, eye, px, py, shadow, lvp)

    return emulate


@pytest.mark.parametrize("textures", ["uniform", "ragged"])
@pytest.mark.parametrize("mode", sorted(BLEND_MODES))
def test_kernel_inputs_hold_the_composite(monkeypatch, mode, textures):
    """What composite_transparent hands the kernel on a card (blend._launch:
    the slot table, the count, the constants vector, the shadow map, the
    texture tables and the scalars) composites, in plain torch over the
    whole band, the plain version's frame bit for bit: the kernel's inputs
    carry every value its plain version reads."""
    calls = []
    monkeypatch.setattr(kernels, "blend_composite", _emulated_kernel(calls))
    p = blend_modes_preset(BLEND_MODES[mode], textures)
    tri, scene, eye, shadow, per_band = blend_inputs(p, "cpu", bands=2)
    slots = blend.live_slots(tri, scene, p.config)
    for rgb, depth, yo, cfg in per_band:
        got = blend._launch(rgb.clone(), depth, slots, scene, cfg, eye, shadow.get("shadow_depth"),
                            shadow.get("light_viewproj"), yo)
        want = blend.blend_composite_plain(rgb, depth, tri, scene, cfg, eye, y_offset=yo,
                                           live=slots, **shadow)
        assert same_f32(got, want), yo
    assert calls[0] == {"mode": p.config.mode, "attr_width": p.config.attr_width,
                        "subpixel": p.config.subpixel, "bias": p.config.shadow_bias,
                        "levels": 0 if scene.textures is None else scene.textures.num_levels}
