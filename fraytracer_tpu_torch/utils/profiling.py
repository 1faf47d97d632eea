"""Observability: the port's spans and the layer tables of its captured
graphs, march statistics, and profiler hooks (counterpart of
``fraytracer_tpu.utils.profiling``).

The reference's observability is one Stopwatch and two printfn lines
(Program.fs:87-96); SURVEY.md §5 calls for structured per-run reports:
rays/s, march-iteration statistics and profiler traces.

**Spans.**  :func:`span` marks a phase of the program: the layers of a
frame's device work (``cull``, ``march``, ``surface``, ``shade``,
``wavefront``, ``loss``, ``vjp``) where that work is issued, and the host
phases of a call (``frame``, ``step``, ``spectral``, ``graph.*``) on the
entry and replay path (``render.py``, ``ops/graph.py``).  A span costs a
few flag reads when nothing watches it; it records where something does:

* a ``torch.profiler`` session (:func:`trace`, or any other): the span is
  a ``record_function`` range named ``ft.<name>``, in the same timeline as
  the device ops and on the same clock;
* a recorder (:func:`spans`): the span's name, parent and host times from
  ``time.perf_counter_ns()``, with no profiler;
* a graph's capture (:func:`capture_layers`, which
  ``ops/graph.py::_FrameGraph`` opens around its capture): the span takes
  the count of the capture's op nodes (kernels, memcpys, memsets: what a
  replay runs on the device, in capture order) at its entry and exit,
  through ``ft_capture_ops`` (``csrc/capture.cu``).  That builds the
  graph's *layer table*, which says which layer issued which of a
  replay's device ops; a replay runs no host code, so nothing else can.
  :func:`graph_layers` lists the tables of the graphs captured in the
  process.

The open spans form one stack shared by every thread: a step's backward
runs on autograd's own thread while the thread that called
``torch.autograd.grad`` waits inside its ``vjp`` span, and the spans the
backward opens nest under it.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import json
import os
import threading
import time
import weakref
from typing import TYPE_CHECKING, Optional

import torch

from ..scene.flatten import FlatScene
from ..types import Rays

if TYPE_CHECKING:
    from ..ops.march import MarchConfig

# march-step histogram bucket edges (the JAX report's)
HIST_EDGES = (0, 8, 16, 32, 64, 128, 256, 1 << 30)
# the profiler's names of the spans
PREFIX = "ft."

_profiler_on = torch._C._autograd._profiler_enabled
_lock = threading.Lock()
_stack: list = []          # the spans open now, innermost last, any thread
_recorder: "SpanRecorder | None" = None
_table: "LayerTable | None" = None
_watching = False          # a recorder or a capture's table is on
_tables: list = []         # weak references to the sealed layer tables


class _Off:
    """What :func:`span` returns while nothing watches: one shared object a
    name, entered and left at no cost; as a decorator, it spans each call
    of the function by :func:`span` at the time of the call."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


_OFF: dict = {}


class _Span(_Off):
    """An open span: the profiler range, the recorder's row and the layer
    table's entry it holds, where each was on at its entry."""

    __slots__ = ("rf", "recorder", "row", "table", "entry")

    def __enter__(self):
        with _lock:
            parent = _stack[-1] if _stack else None
        self.rf = None
        if _profiler_on():
            self.rf = torch.autograd.profiler.record_function(
                PREFIX + self.name)
            self.rf.__enter__()
        self.recorder, self.table = _recorder, _table
        if self.recorder is not None:
            self.row = self.recorder.open(self.name, (
                parent.row if parent is not None
                and parent.recorder is self.recorder else None))
        if self.table is not None:
            self.entry = self.table.open(self.name, (
                parent.entry if parent is not None
                and parent.table is self.table else None))
        with _lock:
            _stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.table is not None:
            self.table.close(self.entry)
        if self.recorder is not None:
            self.recorder.close(self.row)
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        with _lock:
            if _stack and _stack[-1] is self:
                _stack.pop()
            else:
                _stack.remove(self)
        return False


def _watch() -> None:
    global _watching
    _watching = _recorder is not None or _table is not None


def span(name: str):
    """A context manager that marks the phase ``name`` (module docstring);
    as a decorator (``@span(name)``), the same around each call.  While no
    profiler session, recorder or capture is on, it is one shared object
    per name that does nothing."""
    if not _watching and not _profiler_on():
        try:
            return _OFF[name]
        except KeyError:
            off = _OFF[name] = _Off(name)
            return off
    return _Span(name)


Record = collections.namedtuple("Record", "name parent start_ns end_ns")


class SpanRecorder:
    """The spans closed or open while :func:`spans` records: one row a span
    in the order they opened, its parent's row (or ``None``) and its host
    times in ns (``end_ns`` 0 while open)."""

    def __init__(self):
        self._rows = []

    def open(self, name: str, parent) -> int:
        self._rows.append([name, parent, time.perf_counter_ns(), 0])
        return len(self._rows) - 1

    def close(self, row: int) -> None:
        self._rows[row][3] = time.perf_counter_ns()

    @property
    def records(self) -> list:
        return [Record(*r) for r in self._rows]

    def totals(self) -> dict:
        """Name → ``{"calls", "ns", "self_ns"}`` over the closed spans:
        their count, summed host time and summed time less their
        children's."""
        out = {}
        child = [0] * len(self._rows)
        for name, parent, t0, t1 in self._rows:
            if t1 and parent is not None:
                child[parent] += t1 - t0
        for i, (name, _parent, t0, t1) in enumerate(self._rows):
            if not t1:
                continue
            t = out.setdefault(name, {"calls": 0, "ns": 0, "self_ns": 0})
            t["calls"] += 1
            t["ns"] += t1 - t0
            t["self_ns"] += t1 - t0 - child[i]
        return out


@contextlib.contextmanager
def spans():
    """Record every span opened in the scope, on any thread, with its
    parent and host times: ``with spans() as rec: ...`` then
    ``rec.records`` or ``rec.totals()``."""
    global _recorder
    rec, prev = SpanRecorder(), _recorder
    _recorder = rec
    _watch()
    try:
        yield rec
    finally:
        _recorder = prev
        _watch()


class _NodeCounter:
    """The op nodes of the graph being captured on ``stream`` (a
    ``cudaStream_t`` as an int), by ``ft_capture_ops``."""

    def __init__(self, stream: int):
        from ..ops.cuda.build import check, library
        self._fn, self._check = library().ft_capture_ops, check
        self._stream = stream
        self._n = ctypes.c_longlong()

    def count(self) -> int:
        self._check(self._fn(self._stream, None, 0, ctypes.byref(self._n)),
                    "ft_capture_ops")
        return self._n.value

    def kinds(self) -> str:
        """Each op node's kind (``k`` kernel, ``c`` memcpy, ``s`` memset),
        in the graph's order."""
        n = self.count()
        buf = ctypes.create_string_buffer(max(n, 1))
        self._check(self._fn(self._stream, buf, n, ctypes.byref(self._n)),
                    "ft_capture_ops")
        return buf.raw[:min(n, self._n.value)].decode()


class LayerTable:
    """The layer table of one captured graph: ``layers``, one entry a span
    opened inside the capture, ``[name, parent entry or None, first op,
    ops]`` in the order they opened; ``anchors``, ``(op, kernel)`` at each
    launch of a port kernel (its CUDA function's name); ``kinds``, each op's
    kind; ``n_ops``; ``replays``, counted by the graph's owner.  Ops are
    numbered from the capture's first; an op inside no span is the body's
    own (camera rays, block order, the flag)."""

    def __init__(self, name: str, counter):
        self.name, self._counter = name, counter
        self.layers, self.anchors = [], []
        self.kinds, self.n_ops, self.replays = "", 0, 0

    def open(self, name: str, parent) -> int:
        self.layers.append([name, parent, self._counter.count(), 0])
        return len(self.layers) - 1

    def close(self, entry: int) -> None:
        e = self.layers[entry]
        e[3] = self._counter.count() - e[2]

    def anchor(self, kernel: str) -> None:
        self.anchors.append((self._counter.count() - 1, kernel))

    def seal(self) -> None:
        self.kinds = self._counter.kinds()
        self.n_ops = len(self.kinds)
        self._counter = None

    def self_ops(self) -> dict:
        """Layer name → its entries' ops less their children's; ``""``: the
        ops in no span."""
        out = {"": self.n_ops}
        for name, parent, _first, n in self.layers:
            out[name] = out.get(name, 0) + n
            pname = "" if parent is None else self.layers[parent][0]
            out[pname] -= n
        return out

    def as_dict(self) -> dict:
        return {"name": self.name, "n_ops": self.n_ops,
                "replays": self.replays,
                "layers": [tuple(e) for e in self.layers],
                "anchors": list(self.anchors), "kinds": self.kinds,
                "self_ops": self.self_ops()}


@contextlib.contextmanager
def capture_layers(name: str, counter=None):
    """Build the layer table of the graph captured in the scope (entered
    inside ``torch.cuda.graph``): spans count its op nodes, and
    :func:`anchor` notes the port's kernels.  ``counter``: what counts the
    nodes (``count()``, ``kinds()``), by default the capture of the current
    stream.  The table is sealed and listed by :func:`graph_layers` when the
    scope ends without an error."""
    global _table
    if counter is None:
        counter = _NodeCounter(torch.cuda.current_stream().cuda_stream)
    table, prev = LayerTable(name, counter), _table
    _table = table
    _watch()
    try:
        yield table
    finally:
        _table = prev
        _watch()
    table.seal()
    _tables.append(weakref.ref(table))


def anchor(kernel: str) -> None:
    """Note, inside a capture that builds a layer table, that the op just
    issued is the port kernel ``kernel``."""
    table = _table
    if table is not None:
        table.anchor(kernel)


def graph_layers() -> list:
    """The layer table (:meth:`LayerTable.as_dict`) of every captured graph
    still alive in the process, in capture order."""
    _tables[:] = [r for r in _tables if r() is not None]
    return [t.as_dict() for t in (r() for r in _tables) if t is not None]


@dataclasses.dataclass
class RenderStats:
    """Structured per-render report (SURVEY.md §5 metrics)."""

    n_rays: int
    wall_s: float
    rays_per_sec: float
    hit_fraction: float
    steps_mean: float
    steps_max: int
    steps_histogram: dict  # bucket -> count

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def march_stats(scene: FlatScene, rays: Rays,
                cfg: Optional[MarchConfig] = None,
                repeats: int = 3) -> RenderStats:
    """March a ray batch and report timing and iteration statistics.
    ``wall_s`` is the best of ``repeats`` marches after an untimed one,
    each between device synchronizations.  The step histogram is the
    tuning signal of the fixed-trip masked march: a long tail means lanes
    of a warp waiting on the slowest.  ``cfg``: ``MarchConfig()`` when
    ``None``."""
    from ..ops.march import MarchConfig, march
    cfg = MarchConfig() if cfg is None else cfg
    dev = rays.origin.device
    m = march(scene, rays, cfg)
    best = float("inf")
    for _ in range(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        m = march(scene, rays, cfg)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)

    steps = m.steps.cpu()
    hist = {}
    for lo, hi in zip(HIST_EDGES[:-1], HIST_EDGES[1:]):
        c = int(((steps >= lo) & (steps < hi)).sum())
        if c:
            hist[f"{lo}-{hi if hi < (1 << 30) else 'inf'}"] = c

    n = m.hit.numel()
    return RenderStats(
        n_rays=n,
        wall_s=best,
        rays_per_sec=n / best,
        hit_fraction=float(m.hit.float().mean()),
        steps_mean=float(steps.float().mean()),
        steps_max=int(steps.max()),
        steps_histogram=hist,
    )


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` over the scope (CPU, and the card when there is
    one), written as a Chrome trace ``trace_<pid>.json`` into ``log_dir``
    (view it in Perfetto or ``chrome://tracing``); the port's spans are its
    ``ft.*`` ranges.  No-op for ``None``."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


@contextlib.contextmanager
def stopwatch(label: str = "render"):
    """The reference's Stopwatch (Program.fs:89-96), as a context manager."""
    t0 = time.perf_counter()
    yield
    print(f"{label}: {time.perf_counter() - t0:.2f} sec", flush=True)
