"""Calls captured as CUDA graphs: the counterpart of ``jax.jit``.

The JAX package jits the frame, the step and the spectral frame, and the
sharded form of each: a call is one device program per scene structure,
shapes and config, and its data-dependent branches are ``lax.cond``s on
the device.  Here every such entry point (``render.py``'s frame and step,
``ops/wavefront.py``'s spectral frame, ``parallel/mesh.py``'s sharded
frame, spectral frame and step) hands its body to :func:`run`, which
keeps one captured CUDA graph (:class:`_FrameGraph`) a :func:`key`:

* A call is captured where :func:`capturable` holds: the kernels, every
  tensor on a CUDA device, and a step or a call that autograd need not
  see.  Otherwise the body runs eagerly: on the CPU, on the "torch"
  backend (whose plain march ends its loop on a host read), or where a
  tensor requires grad while grad is enabled.
* A key's first call runs the body with its host reads deferred
  (``ops/deferred.py``) and captures it.  A later call copies the scene's,
  the camera's and the args' tensors into the graph's inputs, replays it
  and reads one device flag, set where an overflowing candidate table, a
  material repair or a failing certificate needs the eager body, which
  then runs again (exact, and counted).
* One first-run rule: where the key's first run raised the flag and its
  culled march calls (sites, numbered in their fixed order) overflowed,
  those sites are promoted to full-group tables (the tables the eager
  re-run and JAX's fallback march on) and the body runs once more,
  deferred; it is captured unless that run raises the flag too.  A flag
  with no overflowed site (a material repair, a failing certificate)
  leaves the key uncaptured: its calls run eagerly, counted.
* Every graph is captured into one memory pool a device, so the graphs of
  many keys hold about one frame's peak together.
* The sharded bodies' ranks run together: each decision on the flag
  (capture or not, promote and run again, replay or re-run eagerly) is
  taken on the flag ORed over the mesh's group (``deferred.Frame.agree``),
  so that every rank issues the same collectives; a first run that raised
  the flag anywhere runs again on every rank.
* A graph that holds a group's collectives is released before the group
  is destroyed (:func:`release`, ``parallel/mesh.py::teardown``): NCCL
  does not finalize a communicator while a graph that captured its
  collectives lives.
"""
from __future__ import annotations

import dataclasses
import time
import weakref

import torch
import torch.distributed as dist

from ..utils.profiling import capture_layers, span
from . import cuda as ops_cuda, deferred
from .cuda.build import on_device


def _inputs(scene, camera) -> list:
    """A call's tensors: the scene's leaves, then the camera's."""
    return list(scene.tensors().values()) + [
        camera.position, camera.forward, camera.up_scaled,
        camera.right_scaled]


def key(kind: str, scene, camera, cfg, args=(), extra=()) -> tuple:
    """What a captured call is kept under, as ``jax.jit`` keys it: its
    ``kind`` (the entry point: "frame", "step", "spectral"), the scene's
    static fields, the camera's ``ortho_scale``, each tensor of the scene,
    the camera and ``args`` by shape, dtype and device, the config and
    ``extra``, the call's other static parts (a loss function, an image
    size, a rank) — never the scene object nor a parameter's value."""
    leaves = tuple((tuple(x.shape), x.dtype, x.device)
                   for x in _inputs(scene, camera) + list(args))
    return (kind, scene.plan, scene.kind_counts, scene.prim_material,
            scene.mat_kind, scene.light_kind, camera.ortho_scale,
            tuple(scene.prim_params), leaves, cfg) + tuple(extra)


def capturable(scene, camera, cfg, args=(), grad: bool = False) -> bool:
    """True when the call runs as a captured graph: the kernels, every
    tensor of the scene, the camera and ``args`` on a CUDA device, and a
    step (``grad``) or none that autograd must see."""
    xs = _inputs(scene, camera) + list(args)
    return (cfg.march.backend == "cuda" and all(x.is_cuda for x in xs)
            and (grad or not (torch.is_grad_enabled()
                              and any(x.requires_grad for x in xs))))


def eager(body, scene, camera, cfg, args=(), grad: bool = False):
    """The body's eager call; a step's (``grad``) on new leaves made from
    the scene's tensors, which require grad."""
    if grad:
        scene = scene.with_tensors({k: v.detach().requires_grad_(True)
                                    for k, v in scene.tensors().items()})
    return body(scene, camera, cfg, *args)


class _FrameGraph:
    """A call's body captured in a CUDA graph: the counterpart of a
    ``jax.jit`` executable.  It holds copies of the scene's, the camera's
    and ``args``' tensors as the graph's inputs (the scene's requiring
    grad in a step: the leaves its ``autograd.grad`` differentiates), the
    body's outputs and the flag of its deferred frame in the graph's
    memory, and the kernel launches recorded at its capture, which each
    replay adds to the counts (the Python wrappers do not run on a
    replay).  Its deferred frame also keeps the device constants the graph
    reads (``deferred.device_constant``).

    ``body(scene, camera, cfg, *args)`` returns a tuple of tensors.  Made
    by the first call of a key: the body runs once, its host reads
    deferred; that run also makes the device constants, whose copies from
    host data cannot be captured, and sets up autograd's worker thread for
    a step.  A run that raised the flag and saw sites overflow (its
    stacked overflow bools read once), or that has a group, promotes those
    sites and runs once more, deferred: the counterpart of JAX's
    ``lax.cond`` fallback taken per call site.  Then, unless the last run
    raised the flag, the body is captured.  ``first``: the last run's
    outputs, or ``None`` where it raised the flag; ``graph``: the graph,
    or ``None`` (the key runs eagerly); ``capture_s``: the runs and the
    capture together, the counterpart of JAX's compile time.  A failure
    in any raises.

    ``group``: the process group whose ranks make and replay this key's
    graph together (``parallel/mesh.py``).  Every run of the body ends with
    the flag ORed over the group, so that every rank takes each decision
    alike: with a flag set anywhere no rank captures; a first run that
    raised it is run again on every rank (each promoting its own
    overflowed sites: promotion changes a rank's tables, not its
    collectives); a replay's outputs stand on every rank or none.  On NCCL
    that reduction is the captured body's last collective; gloo's
    collectives run on host threads and cannot be captured, so on gloo it
    runs after the replay.  The deferred first run issues the body's
    collectives eagerly, so no collective is the first of its communicator
    inside a capture.  ``finish(scene, outputs)``: the work that follows a
    replay whose flag is clear, and the first run (a gloo body's
    collectives, eagerly); the call's result is what it returns.

    ``layers``: the graph's layer table (``utils/profiling.py``), named
    ``name``, built by the spans of its capture; it counts the replays."""

    def __init__(self, body, scene, camera, cfg, args=(), grad: bool = False,
                 group=None, finish=None, name: str = "frame"):
        t0 = time.perf_counter()
        self.name, self.layers = name, None
        self.device = scene.device
        self.inputs = [x.detach().clone()
                       for x in _inputs(scene, camera) + list(args)]
        names = list(scene.tensors())
        for x in self.inputs[:len(names) if grad else 0]:
            x.requires_grad_(True)
        graph_scene = scene.with_tensors(dict(zip(names, self.inputs)))
        position, forward, up, right = self.inputs[len(names):len(names) + 4]
        graph_camera = dataclasses.replace(
            camera, position=position, forward=forward, up_scaled=up,
            right_scaled=right)
        graph_args = self.inputs[len(names) + 4:]
        self.body = lambda: body(graph_scene, graph_camera, cfg, *graph_args)
        self.frame = deferred.Frame(self.device, group)
        self.agree_in_graph = (group is not None
                               and dist.get_backend(group) == "nccl")
        self.finish = finish
        self.graph, self.launches, self.collectives = None, {}, {}
        if group is not None:
            _grouped.add(self)
        with torch.no_grad(), on_device(self.device):
            out = self._run(agree=True)
            flagged = bool(self.frame.flag)
            if flagged:
                sites = self.frame.overflowed_sites()
                # with a group the flag was set on some rank: every rank
                # runs again, as the collectives of the run need
                if sites or group is not None:
                    self.frame.promoted = sites
                    out = self._run(agree=True)
                    flagged = bool(self.frame.flag)
            self.first = None if flagged else out
            if self.first is not None:
                if finish is not None:
                    self.first = finish(scene, out)
                self._capture()
        self.capture_s = time.perf_counter() - t0

    def _run(self, agree: bool):
        """The body with its host reads deferred to the frame, its sites
        numbered from 0, the flag cleared first and, with ``agree``, ORed
        over the group last: what the capture records."""
        self.frame.overflows.clear()
        with deferred.deferring(self.frame):
            self.frame.flag.zero_()
            out = self.body()
        if agree:
            self.frame.agree()
        return out

    def _capture(self) -> None:
        """Capture the body into the device's graph memory pool."""
        graph = torch.cuda.CUDAGraph()
        self.frame.programs.clear()
        index = self.device.index if self.device.index is not None \
            else torch.cuda.current_device()
        if index not in _pools:
            _pools[index] = torch.cuda.graph_pool_handle()
        before = ops_cuda.launch_counts()
        issued = dict(deferred.COLLECTIVES)
        # a group's NCCL watchdog thread may query the events of earlier
        # eager collectives while the capture runs; in the global mode
        # such a call from another thread would invalidate the capture
        mode = "global" if self.frame.group is None else "thread_local"
        try:
            with torch.no_grad(), on_device(self.device), \
                    torch.cuda.graph(graph, pool=_pools[index],
                                     capture_error_mode=mode), \
                    capture_layers(self.name) as layers:
                self.outputs = self._run(agree=self.agree_in_graph)
        except BaseException:
            # a capture that fails leaves its pool bound to it: the
            # device's next capture takes a new pool
            del _pools[index]
            raise
        after = ops_cuda.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        self.collectives = {k: v - issued[k]
                            for k, v in deferred.COLLECTIVES.items()
                            if v != issued[k]}
        # captured, not launched: the replays count them
        ops_cuda.add_launch_counts({k: -v for k, v in self.launches.items()})
        _add_collectives({k: -v for k, v in self.collectives.items()})
        self.graph, self.layers = graph, layers
        ops_cuda.GRAPH["captures"] += 1

    def replay(self, scene, camera, args=()):
        """The body on ``scene``, ``camera`` and ``args`` (this graph's
        key): clones of the outputs, or ``None`` when the replay raised the
        flag."""
        with torch.no_grad(), on_device(self.device):
            with span("graph.copy_in"):
                for dst, src in zip(self.inputs,
                                    _inputs(scene, camera) + list(args)):
                    dst.copy_(src)
            with span("graph.launch"):
                self.graph.replay()
            if self.frame.group is not None and not self.agree_in_graph:
                with span("graph.agree"):
                    self.frame.agree()
            with span("graph.out"):
                out = tuple(x.clone() for x in self.outputs)
                flagged = bool(self.frame.flag)  # the body's one host read
            if not flagged and self.finish is not None:
                with span("graph.finish"):
                    out = self.finish(scene, out)
        ops_cuda.add_launch_counts(self.launches)
        _add_collectives(self.collectives)
        ops_cuda.GRAPH["replays"] += 1
        if self.layers is not None:
            self.layers.replays += 1
        return None if flagged else out

    def release(self) -> bool:
        """Destroy the captured graph (its pool's blocks go back to the
        pool) and drop its outputs: the key's later calls run eagerly.
        True where there was a graph."""
        had = self.graph is not None
        if had:
            self.graph.reset()
        self.graph, self.outputs = None, ()
        return had


def _add_collectives(delta: dict) -> None:
    for k, v in delta.items():
        deferred.COLLECTIVES[k] += v


# A graph's memory is its pool's, and every graph of a device shares one
# (device index → pool, made at the device's first capture): a replay
# writes each of its pool's tensors before it reads it, and the tensors a
# graph keeps (its outputs, its lowered programs) are live and so never
# handed to another capture.
_pools: dict = {}
_graphs: "dict[tuple, _FrameGraph]" = {}
# every live graph made with a group, wherever its key is kept
_grouped: "weakref.WeakSet[_FrameGraph]" = weakref.WeakSet()


def release(group=None) -> int:
    """Release the graph of every key made with ``group`` (with any group
    where ``None``), wherever the key is kept, and forget this module's
    keys of them: a graph that captured NCCL collectives keeps its
    communicator from being finalized.  Call it with the group's work
    finished on the device.  Returns the graphs destroyed."""
    gone = [fg for fg in list(_grouped)
            if group is None or fg.frame.group is group]
    for k in [k for k, fg in _graphs.items() if fg in gone]:
        del _graphs[k]
    for fg in gone:
        _grouped.discard(fg)
    return sum(fg.release() for fg in gone)


def find(kind: str, scene, camera, cfg, args=(), extra=()):
    """What the first call of this :func:`key` made, if any: its
    ``capture_s``, its ``graph`` (``None`` for a key run eagerly) and its
    ``frame.promoted``, the sites that build full-group tables."""
    return _graphs.get(key(kind, scene, camera, cfg, args, extra))


def run(body, scene, camera, cfg, args=(), *, name: str, extra=(),
        grad: bool = False, group=None, capture=None, finish=None,
        graphs=None):
    """``body(scene, camera, cfg, *args)`` through its key's graph (module
    docstring): made by the key's first call, else replayed; the eager
    body (:func:`eager`) where the call is not :func:`capturable`, where
    the key runs eagerly or where the flag is set, counted in the latter
    two.

    ``name``: the key's kind and the graph's layer table's name;
    ``extra``: the key's other static parts; ``grad``: a step, whose body
    differentiates the scene's leaves; ``group``, ``finish``: the graph's
    (:class:`_FrameGraph`); ``capture``: the body the graph holds where it
    is not ``body`` (a gloo body, whose collectives ``finish`` runs after
    the replay), ``False`` where none can be captured (the call runs
    eagerly, counted as an eager frame); ``graphs``: where the key's graph
    is kept (this module's by default)."""
    graphs = _graphs if graphs is None else graphs
    with span("graph.key"):
        k = key(name, scene, camera, cfg, args, extra) \
            if capturable(scene, camera, cfg, args, grad) else None
        fg = None if k is None else graphs.get(k)
    if k is None:
        return eager(body, scene, camera, cfg, args, grad)
    if fg is None and capture is not False:
        with span("graph.capture"):
            fg = graphs[k] = _FrameGraph(
                capture or body, scene, camera, cfg, args, grad=grad,
                group=group, finish=finish, name=name)
        out, fg.first = fg.first, None
    elif fg is None or fg.graph is None:
        # the key's first run raised the flag, or no body of it can be
        # captured: its calls run eagerly, as a replay that raised the flag
        # would pay the graph, then the eager body
        ops_cuda.GRAPH["eager_frames"] += 1
        with span("graph.eager"):
            return eager(body, scene, camera, cfg, args, grad)
    else:
        out = fg.replay(scene, camera, args)
    if out is None:
        # an overflowing table, a material repair or a failing certificate
        ops_cuda.GRAPH["eager_reruns"] += 1
        with span("graph.eager"):
            out = eager(body, scene, camera, cfg, args, grad)
    return out
