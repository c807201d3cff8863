"""Capture-once frames: the port's counterpart of the reference Renderer's
``jax.jit`` of ``render_step`` (``xr/app/renderer.py:326-332``), which runs
the frame as one compiled program with its constants baked in.

A frame is a list of ``Stage``s: the ``prof.span`` names a stage runs
under, outermost first, and a function of the frame's values so far (a
dict: the inputs, then what each stage returned) that returns new values.
``run_stages`` runs them eagerly. ``FrameProgram`` merges consecutive stages
under the same spans into one ``Segment`` and captures each segment into a
``torch.cuda.CUDAGraph`` on a CUDA device at construction; ``replay``
then replays the graphs in order, each under its spans, so a trace still
gives every stage its own device time (a kernel of a graph carries the
correlation id of the graph's launch). Every graph of a frame allocates
from one memory pool and is captured and replayed in the same order, so a
segment may reuse what an earlier one freed.

Capture reads no value: a graph replays the kernels it recorded, with the
arguments it recorded, on the tensors it recorded. So the inputs must stay
in the tensors the program was captured on (the caller refills them: see
``StaticLeaves`` and ``convert.StagingRing``), and a stage may not read the
card's values on the host (``.item()``, ``.tolist()``, ``int(t)``, a
boolean index, a copy from pageable memory): capture fails on it and
raises, naming the stage. A stage that needs such a read is marked
``host``: it runs eagerly at every replay, on the tensors it was captured
on, and its values are copied into tensors of their own (placeholders) that
the later graphs were captured on. Before capturing, the program builds the
kernel library and runs the frame once eagerly on a side stream, which
makes every constant of the frame (``convert.constant``) and gives the
placeholders their shapes.

A replayed graph calls no launch wrapper (and a wrapper counts nothing at
capture): each segment reads the visibility kernels its graph holds from
the graph the driver built (``kernels.graph_launches``), and each replay
counts those (``kernels.count_replay``). So a frame's first ``replay``
counts what an eager frame does; the warm-up frame's own launches count
as they run.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from xr_torch import kernels
from xr_torch.prof import spans


class Stage(NamedTuple):
    """One stage of a frame: fn(values) returns new values (a dict; None
    drops a value no later stage reads) under the spans `spans`. host:
    the stage reads the card's values on the host and is never captured."""

    spans: tuple
    fn: Callable
    host: bool = False


def run_stages(stages, values: dict) -> dict:
    """Run the stages eagerly in order, each under its spans; returns the
    frame's values."""
    for st in stages:
        with spans(st.spans):
            values.update(st.fn(values))
    return values


def _is_dataclass(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def tree_map(fn, x):
    """fn applied to every tensor of a tree of dicts, lists, tuples (named
    or not) and dataclasses; other leaves are kept."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if _is_dataclass(x):
        return dataclasses.replace(x, **{f.name: tree_map(fn, getattr(x, f.name))
                                         for f in dataclasses.fields(x) if f.init})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(tree_map(fn, v) for v in x)
    return x


def leaves(x):
    """The leaves of a tree (see tree_map) in a fixed order."""
    if isinstance(x, dict):
        for v in x.values():
            yield from leaves(v)
    elif _is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from leaves(getattr(x, f.name))
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from leaves(v)
    else:
        yield x


def signature(x) -> tuple:
    """What a captured program is specialised to: the tree's structure,
    each tensor's shape, dtype and device, and every other leaf's value
    (the program captures anew where it differs, as ``jit`` retraces)."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    if isinstance(x, dict):
        return ("dict",) + tuple((k, signature(v)) for k, v in x.items())
    if _is_dataclass(x) or isinstance(x, (list, tuple)):
        items = ([getattr(x, f.name) for f in dataclasses.fields(x)] if _is_dataclass(x)
                 else list(x))
        return (type(x).__name__,) + tuple(signature(v) for v in items)
    return ("value", x)


def copy_into(dst, src, where: str) -> None:
    """Write the tree src into the tensors of dst, a tree of the same
    structure, shapes and dtypes whose other leaves src must equal."""
    d, s = list(leaves(dst)), list(leaves(src))
    if len(d) != len(s):
        raise RuntimeError(f"the frame's {where} stage changed the structure of its values")
    for a, b in zip(d, s):
        if isinstance(a, torch.Tensor):
            if not isinstance(b, torch.Tensor) or b.shape != a.shape or b.dtype != a.dtype:
                raise RuntimeError(f"the frame's {where} stage gave {_what(b)} in place of the "
                                   f"captured {_what(a)}")
            if b is not a:
                a.copy_(b)
        elif not (a is b or a == b):
            raise RuntimeError(
                f"the frame's {where} stage gave {b!r} where it gave {a!r} at capture: a "
                "value that is not a tensor follows the card's values, so the stage cannot "
                "be replayed")


def _what(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"a {tuple(x.shape)} {x.dtype} tensor"
    return repr(x)


class StaticLeaves:
    """A tree of tensors (a Scene) held in tensors of its own, which a
    program is captured on: ``load`` copies each leaf of a tree of the same
    signature into them, skipping a leaf that is the same tensor as last
    time with no write since (its version counter), so the same scene
    costs nothing and a scene in other tensors, or one edited in place, is
    seen. The caller's tensors are never written. device: where the held
    tensors lie (default: each leaf's own device); a load copies across
    devices."""

    def __init__(self, tree, device=None):
        self.tree = tree_map(torch.clone if device is None
                             else (lambda t: t.to(device, copy=True)), tree)
        self._dst = [t for t in leaves(self.tree) if isinstance(t, torch.Tensor)]
        self._src = [(t, t._version) for t in leaves(tree) if isinstance(t, torch.Tensor)]

    def load(self, tree) -> None:
        src = [t for t in leaves(tree) if isinstance(t, torch.Tensor)]
        for i, (s, d) in enumerate(zip(src, self._dst)):
            last, version = self._src[i]
            if s is last and s._version == version:
                continue
            d.copy_(s)
            self._src[i] = (s, s._version)


@dataclasses.dataclass
class Segment:
    """Consecutive stages under the same spans: what they read and wrote
    at capture, and their graph (None where they run eagerly) with the
    visibility kernels it holds."""

    spans: tuple
    fns: list
    host: bool
    inputs: Optional[dict] = None
    outputs: Optional[dict] = None
    graph: Optional[torch.cuda.CUDAGraph] = None
    launches: dict = dataclasses.field(default_factory=dict)

    @property
    def name(self) -> str:
        return "/".join(self.spans) or "unspanned"

    def compute(self, values: dict) -> dict:
        """Run the stages on `values` (not changed); their new values."""
        values, new = dict(values), {}
        for fn in self.fns:
            out = fn(values)
            values.update(out)
            new.update(out)
        return new

    def run(self) -> None:
        """One replay: the graph, or the stages again on the captured
        inputs with their values copied into the captured outputs."""
        if self.graph is not None:
            self.graph.replay()
            kernels.count_replay(self.launches)
        else:
            copy_into(self.outputs, self.compute(self.inputs), self.name)


def segments(stages) -> list:
    """The stages merged into segments: a run of stages under the same
    spans that reads nothing on the host is one segment."""
    out = []
    for st in stages:
        last = out[-1] if out else None
        if last is not None and not st.host and not last.host and last.spans == st.spans:
            last.fns.append(st.fn)
        else:
            out.append(Segment(tuple(st.spans), [st.fn], st.host))
    return out


class FrameProgram:
    """A frame's stages captured on a CUDA device on its static inputs (a
    dict of the tensors the caller refills before each replay). ``values``
    is the frame's values after a replay: the captured outputs of every
    stage."""

    def __init__(self, stages, inputs: dict, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a frame is captured on a CUDA device, not on {self.device}")
        self.segments = segments(stages)
        self.values = dict(inputs)
        with torch.cuda.device(self.device):
            self._capture()

    def _capture(self) -> None:
        kernels.library()
        placeholders = iter(self._warm_up())
        pool = torch.cuda.graph_pool_handle()
        for seg in self.segments:
            seg.inputs = dict(self.values)
            if seg.host:
                seg.outputs = next(placeholders)
            else:
                seg.graph = torch.cuda.CUDAGraph()
                try:
                    with torch.cuda.graph(seg.graph, pool=pool):
                        seg.outputs = seg.compute(seg.inputs)
                        seg.launches = kernels.graph_launches(
                            torch.cuda.current_stream(self.device))
                except Exception as e:
                    raise RuntimeError(
                        f"capture of the frame's {seg.name} stage failed (a captured stage "
                        f"may not read the card's values on the host): {e}") from e
            self.values.update(seg.outputs)

    def _warm_up(self) -> list:
        """One eager frame on a side stream: makes the frame's constants
        and lazily built state before any capture. Returns an empty tree
        like each host segment's values, in order."""
        here = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(here)
        out = []
        with torch.cuda.stream(side):
            values = dict(self.values)
            for seg in self.segments:
                try:
                    new = seg.compute(values)
                except Exception as e:
                    raise RuntimeError(f"the frame's {seg.name} stage failed: {e}") from e
                if seg.host:
                    out.append(tree_map(torch.empty_like, new))
                values.update(new)
        here.wait_stream(side)
        return out

    def replay(self) -> dict:
        """One frame on the current static inputs; returns ``values``."""
        with torch.cuda.device(self.device):
            for seg in self.segments:
                with spans(seg.spans):
                    try:
                        seg.run()
                    except Exception as e:
                        raise RuntimeError(
                            f"replay of the frame's {seg.name} stage failed: {e}") from e
        return self.values
