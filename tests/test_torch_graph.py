"""The captured frame's stages on the CPU (xr_torch/app/graph.py): the
stages Renderer captures on a card, split into the segments it captures,
run in order on the static inputs it captures them on (recorded at one
camera, refilled with another), equal ``render_step``'s eager frame bit
for bit for every preset at golden size: color, depth and every stat. Each
segment that is captured on a card runs under a guard that fails on any
read of a tensor to the host and on any tensor made from host values
(``Tensor.item``, ``tolist``, ``__int__``, ``__index__``, ``__float__``,
``__bool__``, ``numpy``, ``cpu``, ``nonzero``, ``masked_select``,
``unique``, ``torch.tensor``, ``torch.as_tensor``, ``torch.from_numpy``,
and an index that is a list or a boolean mask): a captured stage may
neither read the card's values (capture fails on it) nor copy a constant
from the host each frame. Only the kernels' plain versions, which stand
for the CUDA kernels here (the visibility kernels' and the blend
composite's), may read, and no segment runs eagerly. Also: a
second scene of the same shapes renders its own frame, the
``light_matrices`` override reaches the shadow pass, and the pieces the
program is built from. The graphs themselves are captured and replayed
only on a card (tests/test_torch_cuda.py)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from xr_torch import convert
from xr_torch.core.types import Frame
from xr_torch.app import graph
from xr_torch.app import renderer as rd
from xr_torch.raster import lists, records, smem, stream
from xr_torch.scene import presets
from xr_torch.shading import blend

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
PRESETS = {
    "config1": presets.config1_cube,
    "config2": presets.config2_icospheres,
    "config3": lambda: presets.config3_terrain(48, 48),
    "config4": presets.config4_phong,
    "config4b": presets.config4_blend,
    "config5": lambda: presets.config5_flythrough(64, 64),
    "config6": presets.config6_asset,
    "config7": lambda: presets.config7_terrain_lod(64, device="cpu"),
}
HOST_READS = ([(torch.Tensor, n) for n in ("item", "tolist", "__int__", "__index__",
                                           "__float__", "__bool__", "numpy", "cpu", "nonzero",
                                           "masked_select", "unique")]
              + [(torch, n) for n in ("tensor", "as_tensor", "from_numpy", "nonzero",
                                      "masked_select", "unique")])


def _host_index(idx) -> bool:
    """An index that copies from the host (a list) or reads the card's
    values to size its result (a boolean mask)."""
    return any(isinstance(i, list) or (isinstance(i, torch.Tensor) and i.dtype == torch.bool)
               for i in (idx if isinstance(idx, tuple) else (idx,)))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Guard:
    """Runs a frame's segments; `stage` is the captured one running, None
    outside one; `eager` the names of the segments that ran eagerly."""

    def __init__(self):
        self.stage, self.eager = None, []

    def run(self, stages, values: dict) -> dict:
        """The stages' segments (graph.segments) in order, as a replay runs
        them: those a card captures under the guard, host ones eagerly."""
        for seg in graph.segments(stages):
            if seg.host:
                self.eager.append(seg.name)
            self.stage = None if seg.host else seg.name
            try:
                values.update(seg.compute(values))
            finally:
                self.stage = None
        return values


@pytest.fixture
def guard(monkeypatch):
    """Fails a host read in a segment that is captured on a card; the
    kernels' plain versions are exempt. Returns the _Guard."""
    g = _Guard()

    def refuse(name, orig):
        def wrapped(*a, **k):
            if g.stage is not None:
                raise AssertionError(f"{name} in the captured {g.stage} stage")
            return orig(*a, **k)
        return wrapped

    for owner, name in HOST_READS:
        monkeypatch.setattr(owner, name, refuse(name, getattr(owner, name)))

    def refuse_index(name, orig):
        def wrapped(t, idx, *a):
            if g.stage is not None and _host_index(idx):
                raise AssertionError(f"{name} with a list or a mask in the captured {g.stage} "
                                     "stage")
            return orig(t, idx, *a)
        return wrapped

    for name in ("__getitem__", "__setitem__"):
        monkeypatch.setattr(torch.Tensor, name, refuse_index(name, getattr(torch.Tensor, name)))

    def exempt(fn):
        def wrapped(*a, **k):
            stage, g.stage = g.stage, None
            try:
                return fn(*a, **k)
            finally:
                g.stage = stage
        return wrapped

    monkeypatch.setattr(stream, "vis_stream_plain", exempt(stream.vis_stream_plain))
    monkeypatch.setattr(smem, "vis_lists_plain", exempt(smem.vis_lists_plain))
    monkeypatch.setattr(blend, "blend_composite_plain", exempt(blend.blend_composite_plain))
    return g


def _preset(name):
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as f:
        m = json.load(f)[name]
    return presets.small_preset(PRESETS[name](), m["width"], m["height"], **m["overrides"]), m["t"]


class _Frames:
    """A preset's scene; its frame's static inputs (FrameInputs) and
    stages, as Renderer captures them on a card, made and run once at a
    first camera; and render_step."""

    def __init__(self, guard, p, t, hook=None):
        self.guard, self.p, self.hook = guard, p, hook
        cam, mm = p.animate(t)
        self.scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), "cpu")
        self.cap = rd.clip_capacity(self.scene.mesh.num_triangles, p.config)
        self.light = (rd.light_matrices_for_scene(self.scene)
                      if rd.has_shadow_pass(p.config) else None)
        self.inputs = rd.FrameInputs(self.scene, self._host(cam), "cpu")
        self.stages = rd.frame_stages(p.config, self.cap, hook)
        # the warm-up frame a card runs before it captures: makes the constants
        graph.run_stages(self.stages, dict(self.inputs.values))

    def _host(self, cam, light=None):
        return rd.host_inputs(cam, self.p.config, *(light or self.light or (None, None)))

    def replayed(self, cam, scene=None, light=None):
        """The inputs refilled with these, then the segments on them."""
        self.inputs.load(scene or self.scene, self._host(cam, light))
        v = self.guard.run(self.stages, dict(self.inputs.values))
        return Frame(color=v["color"], depth=v["depth"], stats=v["stats"])

    def eager(self, cam, scene=None, light=None):
        lv, lp = light or self.light or (None, None)
        return rd.render_step(scene or self.scene, cam, self.p.config, lv, lp,
                              capacity=self.cap, shade_hook=self.hook)


def _bit_equal(got, want):
    assert torch.equal(got.color, want.color)
    assert torch.equal(got.depth.view(torch.int32), want.depth.view(torch.int32))
    assert list(got.stats) == list(want.stats)
    for k, v in want.stats.items():
        assert got.stats[k].dtype == v.dtype and int(got.stats[k]) == int(v), k


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_replayed_stages_equal_render_step(guard, name):
    """Inputs made at one camera, refilled with the golden one, the
    segments run under the guard: render_step's frame bit for bit, and no
    segment eager (config4b's blend too)."""
    p, t = _preset(name)
    fr = _Frames(guard, p, t + 0.5)
    cam = p.animate(t)[0]
    _bit_equal(fr.replayed(cam), fr.eager(cam))
    assert guard.eager == []


def test_second_scene_renders_its_own_frame(guard):
    """A scene of the same shapes in other tensors renders its own frame
    (copied into the captured inputs, its own tensors untouched), the first
    scene its own again after it; an edit in place is seen. A shade_hook
    reading frag.depth replays with shade."""
    p, t = _preset("config3")

    def fog(color, scene_, mat_id, xp, frag=None):
        f = xp.clamp(frag.depth * 1.5, 0.0, 1.0)[..., None]
        return color * (1.0 - f) + f

    fr = _Frames(guard, p, t, hook=fog)
    cam = p.animate(t)[0]
    first = fr.replayed(cam)
    _bit_equal(first, fr.eager(cam))
    mm = fr.scene.model_matrices.clone()
    mm[:, 1, 3] += 0.25  # the terrain raised
    other = fr.scene.replace(model_matrices=mm)
    got = fr.replayed(cam, other)
    _bit_equal(got, fr.eager(cam, other))
    assert not torch.equal(got.color, first.color)
    assert not torch.equal(mm, fr.scene.model_matrices)
    _bit_equal(fr.replayed(cam), first)
    fr.scene.model_matrices.mul_(1.25)
    _bit_equal(fr.replayed(cam), fr.eager(cam))


def test_light_override_reaches_the_shadow_pass(guard):
    """step(..., light_matrices=) in the captured frame: render_step's
    frame with the same light, not the fitted light's."""
    p, t = _preset("config4")
    fr = _Frames(guard, p, t)
    cam = p.animate(t)[0]
    fitted = fr.replayed(cam)
    lv = np.array(fr.light[0], np.float32)
    lv[0, 3] += np.float32(0.75)  # the light's view moved sideways
    light = (lv, fr.light[1])
    got = fr.replayed(cam, light=light)
    _bit_equal(got, fr.eager(cam, light=light))
    assert not torch.equal(got.color, fitted.color)
    _bit_equal(fr.replayed(cam), fitted)


def test_segments_merge_runs_under_the_same_spans():
    """Consecutive stages under the same spans are one segment, unless one
    of them reads the host."""
    def fn(v):
        return {}

    stages = [graph.Stage(("a",), fn), graph.Stage(("a",), fn), graph.Stage(("a", "b"), fn),
              graph.Stage((), fn), graph.Stage((), fn, host=True), graph.Stage((), fn),
              graph.Stage((), fn)]
    segs = graph.segments(stages)
    assert [(s.name, s.host, len(s.fns)) for s in segs] == [
        ("a", False, 2), ("a/b", False, 1), ("unspanned", False, 1), ("unspanned", True, 1),
        ("unspanned", False, 2)]


def test_copy_into_refuses_a_value_that_follows_the_data():
    """A replay copies tensors into the captured ones; a value that is not
    a tensor must be what it was at capture, else the stage read the host."""
    dst = {"a": torch.zeros(3), "n": 4, "t": (torch.zeros(2), None)}
    graph.copy_into(dst, {"a": torch.ones(3), "n": 4, "t": (torch.full((2,), 2.0), None)}, "x")
    assert dst["a"].tolist() == [1.0] * 3 and dst["t"][0].tolist() == [2.0, 2.0]
    with pytest.raises(RuntimeError, match="x stage gave 5"):
        graph.copy_into(dst, {"a": torch.ones(3), "n": 5, "t": (torch.zeros(2), None)}, "x")
    with pytest.raises(RuntimeError, match="in place of the captured"):
        graph.copy_into(dst, {"a": torch.ones(4), "n": 4, "t": (torch.zeros(2), None)}, "x")


def test_static_leaves_copy_what_changed():
    """StaticLeaves copies a leaf that is another tensor or was written
    since, skips the same tensor unwritten, and never writes the caller's."""
    a, b = torch.arange(4.0), torch.ones(2)
    s = graph.StaticLeaves({"a": a, "b": b, "n": 3})
    assert s.tree["a"] is not a and torch.equal(s.tree["a"], a)
    s.tree["a"].zero_()  # a write the load below must not see: a is unchanged
    s.load({"a": a, "b": b, "n": 3})
    assert not torch.equal(s.tree["a"], a)
    a.add_(1.0)
    s.load({"a": a, "b": b, "n": 3})
    assert torch.equal(s.tree["a"], a)
    c = torch.full((2,), 7.0)
    s.load({"a": a, "b": c, "n": 3})
    assert torch.equal(s.tree["b"], c) and torch.equal(b, torch.ones(2))


def test_staging_ring_fills_its_tensors():
    """The camera's staging: every named value lands in its view, in f32;
    a value of another size raises."""
    ring = convert.StagingRing({"m": (4, 4), "e": (3,), "f": ()}, "cpu")
    m = np.arange(16, dtype=np.float64).reshape(4, 4) / 3.0
    ring.load({"m": m, "e": (1, 2, 3), "f": 0.5})
    assert torch.equal(ring.tensors["m"], torch.from_numpy(m.astype(np.float32)))
    assert ring.tensors["e"].tolist() == [1.0, 2.0, 3.0] and float(ring.tensors["f"]) == 0.5
    with pytest.raises(ValueError):
        ring.load({"m": m, "e": (1, 2), "f": 0.5})


def test_constants_are_made_once():
    """A frame's constants (convert.constant) are one tensor per (values,
    dtype, device), so no frame copies them from the host again."""
    a = convert.constant([[0.0, 1.0], [2.0, 3.0]], "cpu")
    assert convert.constant(((0.0, 1.0), (2.0, 3.0)), torch.device("cpu")) is a
    assert convert.constant(7, "cpu", torch.int32).dtype == torch.int32
    assert convert.constant(7, "cpu", torch.int32) is not convert.constant(7, "cpu")


def test_static_trip_count_folds_the_same():
    """The jnp lists' fold with the capacity as its trip count (a capture's,
    which cannot read the data's) equals the fold with the data's."""
    p, t = _preset("config3")
    cfg = dataclasses.replace(p.config, backend="jnp", bin_capacity=512)
    cam, mm = p.animate(t)
    scene = convert.scene_to_torch(p.scene.replace(model_matrices=mm), "cpu")
    values = rd.frame_inputs(scene, cam, cfg)
    cap = rd.clip_capacity(scene.mesh.num_triangles, cfg)
    tri = rd.visible_triangles(scene, values["view"], values["proj"], cfg, cap)[1]
    want = lists.visibility_binned(tri, cfg)
    ids = torch.tensor([5, 1, 9, 2, 7, 3, 8, 4, 6, 0], dtype=torch.int32)
    n = torch.tensor([3, 0, 7], dtype=torch.int32)
    starts = torch.tensor([0, 3, 3], dtype=torch.int32)
    free = list(records.id_chunks(ids, starts, n, 10))
    bound = list(records.id_chunks(ids, starts, n, 10, bound=24))
    assert len(bound) == 3 and torch.equal(bound[0], free[0])
    assert all(bool((c == 10).all()) for c in bound[1:])
    orig = records.id_chunks

    def bounded(ids, starts, n, C, stride=1, bound=None):
        return orig(ids, starts, n, C, stride, bound=int(ids.shape[0]))

    lists.id_chunks = bounded
    try:
        got = lists.visibility_binned(tri, cfg)
    finally:
        lists.id_chunks = orig
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernel_names_map_to_the_launch_counts():
    """kernels.launch_name: the fold kernel of each visibility launch, by
    its name demangled or mangled (a graph's kernel nodes give the
    mangled), maps to its launches key; the clear kernels and other
    kernels map to none."""
    from xr_torch import kernels

    names = {
        "void xr::zgate_fold_kernel<xr::StreamWalk, 3>(int const*)": "vis_stream_zgate",
        "_ZN2xr17zgate_fold_kernelINS_10StreamWalkELi1EEEvPKiT_": "vis_stream_zgate",
        "void xr::fold_kernel<xr::StreamWalk>(int const*, xr::StreamWalk, int)": "vis_stream",
        "_ZN2xr11fold_kernelINS_10StreamWalkEEEvPKiT_": "vis_stream",
        "void xr::fold_kernel<xr::ListWalk>(int const*, xr::ListWalk, int)": "vis_lists",
        "void xr::clear_kernel<xr::StreamWalk>(int const*, unsigned long*, int*, xr::Frame)": None,
        "void xr::zgate_clear_kernel<xr::StreamWalk>(int const*, unsigned long*)": None,
        "void at::native::vectorized_elementwise_kernel<4>(int)": None,
    }
    assert {n: kernels.launch_name(n) for n in names} == names

