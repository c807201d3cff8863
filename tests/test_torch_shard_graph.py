"""The banded frame's stages on the CPU (xr_torch/dist/shard.py
``sharded_stages``): the stages ShardedRenderer captures on each card,
split into the segments it captures, run in order on the static inputs it
captures them on (renderer.FrameInputs of each device, made at one camera,
refilled with another), equal ``render_step_sharded``'s eager frame bit for
bit (color, depth, every stat) in the cases of tests/test_torch_shard.py
(which holds that eager frame to the reference's ShardedRenderer) and with
a shade_hook. Each segment that is captured on a card runs under the guard
of tests/test_torch_graph.py, which fails on any host read, list or mask
index, or tensor made from host values; no segment runs eagerly, the
blend case's composite too (its plain version reads the live slots once a
device). Also: a second scene of the same shapes renders its own
frame, the segments carry the unbanded frame's span names and are as many,
and a mesh of two devices (the CPU as "cpu" and as "cpu:0") gathers the
frame of one. The graphs themselves are captured and replayed only on a
card (tests/test_torch_cuda.py)."""

import pytest
import torch
from test_torch_graph import _bit_equal, guard, one_thread  # noqa: F401  (fixtures)
from test_torch_shard import CASES, _port_case

from xr_torch.app import graph
from xr_torch.app import renderer as rd
from xr_torch.core.types import Frame
from xr_torch.dist import shard

GUARDED = ["config2-n4", "phong-shadow", "blend", "padded-height", "debug_checks",
           "pallas_stream", "config5-golden"]


def _fog(color, scene_, mat_id, xp, frag=None):
    f = xp.clamp(frag.depth * 1.5, 0.0, 1.0)[..., None]
    return color * (1.0 - f) + f


class _Bands:
    """A case's scene; each device's static inputs (FrameInputs) and
    stages, as ShardedRenderer captures them on cards, made and run once
    at a first camera; and render_step_sharded."""

    def __init__(self, guard, name, hook=None, devices=("cpu",)):
        self.p, self.cam, self.scene = _port_case(name)
        self.guard, self.hook, cfg = guard, hook, self.p.config
        self.mesh = shard.make_band_mesh(cfg.num_shards, list(devices))
        self.cap = rd.clip_capacity(self.scene.mesh.num_triangles, cfg)
        self.light = rd.light_matrices_for_scene(self.scene) if rd.has_shadow_pass(cfg) else None
        self.stages = shard.sharded_stages(cfg, self.mesh, self.cap, hook)
        first = self.p.animate(CASES[name][3] + 0.5)[0]
        self.inputs = {d: rd.FrameInputs(self.scene, self._host(first), d) for d in self.stages}
        for d, stages in self.stages.items():  # the warm-up frame: makes the constants
            graph.run_stages(stages, dict(self.inputs[d].values))

    def _host(self, cam):
        return rd.host_inputs(cam, self.p.config, *(self.light or (None, None)))

    def replayed(self, cam, scene=None):
        """Every device's inputs refilled with these, its segments on them,
        then the gather of several devices (eager, as on cards)."""
        values = {}
        for d, stages in self.stages.items():
            self.inputs[d].load(scene or self.scene, self._host(cam))
            values[d] = self.guard.run(stages, dict(self.inputs[d].values))
        v = (values[self.mesh[0]] if len(values) == 1
             else shard.gather_bands(values, self.p.config, self.mesh))
        return Frame(color=v["color"], depth=v["depth"], stats=v["stats"])

    def eager(self, cam, scene=None, mesh=None):
        lv, lp = self.light or (None, None)
        return shard.render_step_sharded(scene or self.scene, cam, self.p.config,
                                         mesh or self.mesh, lv, lp, self.cap, self.hook)


@pytest.mark.parametrize("name", GUARDED)
def test_banded_segments_equal_render_step_sharded(guard, name):
    """Inputs made at one camera, refilled with the case's, the segments
    run under the guard: render_step_sharded's frame bit for bit, and no
    segment eager."""
    fr = _Bands(guard, name)
    got = fr.replayed(fr.cam)
    assert got.color.shape == (fr.p.config.height, fr.p.config.width, 3)
    _bit_equal(got, fr.eager(fr.cam))
    assert guard.eager == []


def test_banded_segments_with_a_shade_hook(guard):
    """A shade_hook reading frag.depth (each band's rows of it) replays
    with every band's shade: the eager frame, not the hookless one."""
    fr = _Bands(guard, "config2-n4", hook=_fog)
    got = fr.replayed(fr.cam)
    _bit_equal(got, fr.eager(fr.cam))
    plain = _Bands(guard, "config2-n4")
    assert not torch.equal(got.color, plain.eager(fr.cam).color)


def test_banded_second_scene_renders_its_own_frame(guard):
    """A scene of the same shapes in other tensors renders its own banded
    frame (its tensors untouched), the first scene its own again after it;
    an edit in place is seen."""
    fr = _Bands(guard, "phong-shadow")
    first = fr.replayed(fr.cam)
    _bit_equal(first, fr.eager(fr.cam))
    mm = fr.scene.model_matrices.clone()
    mm[:, 1, 3] += 0.25  # every object raised
    other = fr.scene.replace(model_matrices=mm)
    got = fr.replayed(fr.cam, other)
    _bit_equal(got, fr.eager(fr.cam, other))
    assert not torch.equal(got.color, first.color)
    assert not torch.equal(mm, fr.scene.model_matrices)
    _bit_equal(fr.replayed(fr.cam), first)
    fr.scene.model_matrices.mul_(1.25)
    _bit_equal(fr.replayed(fr.cam), fr.eager(fr.cam))


@pytest.mark.parametrize("name", sorted(CASES))
def test_banded_segments_carry_the_unbanded_spans(name):
    """Every band's work under the unbanded frame's spans, ordered by kind:
    the banded frame's segments have the unbanded frame's names, host
    flags and count, whatever the number of bands."""
    p, _, scene = _port_case(name)
    cap = rd.clip_capacity(scene.mesh.num_triangles, p.config)
    mesh = shard.make_band_mesh(p.config.num_shards, ["cpu"])
    (banded,) = shard.sharded_stages(p.config, mesh, cap).values()
    unbanded = rd.frame_stages(p.config, cap)
    names = [(s.name, s.host) for s in graph.segments(banded)]
    assert names == [(s.name, s.host) for s in graph.segments(unbanded)]
    assert all(not h for _, h in names)
    assert ("blend", False) in names if p.config.blend else ("blend", False) not in names
    assert len(banded) > len(unbanded)  # several bands' stages in one segment


@pytest.mark.parametrize("name", ["config2-n4", "blend"])
def test_two_devices_gather_the_frame_of_one(guard, name):
    """A mesh of two devices (bands 0 and 2 on one, 1 and 3 on the other):
    each device's segments under the guard, then the gather of the rows
    and stats across devices, equal the frame of a mesh of one device bit
    for bit, eagerly and from the segments."""
    fr = _Bands(guard, name, devices=("cpu", "cpu:0"))
    assert len(fr.stages) == 2
    one = fr.eager(fr.cam, mesh=shard.make_band_mesh(fr.p.config.num_shards, ["cpu"]))
    _bit_equal(fr.eager(fr.cam), one)
    _bit_equal(fr.replayed(fr.cam), one)
    assert guard.eager == []
