"""Checks and test doubles for the port's deferred frames on the CPU, shared
by the graph tests and by the ranks that the sharding tests spawn (this
module imports no JAX, so a rank may import it).

* :class:`NoHostRead`: a dispatch mode that raises at an op reading the
  device on the host, or at a tensor of more than one element made from
  host data; :func:`no_host_read` takes it off inside the kernels' plain
  versions, which the card does not run.
* :func:`graph_route`: the graph route of ``ops/graph.py`` taken on the
  CPU, where nothing can be captured: a capture records the body's outputs
  and a replay runs the captured body again, deferred, into them.
* :func:`forced_repair`: every surface pass marks some hit lanes as
  unresolved, so that the frame needs a material repair (the eager frame
  repairs them; a deferred frame raises its flag).
"""
import contextlib
import types

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from fraytracer_tpu_torch.ops import cuda as ops_cuda, graph
from fraytracer_tpu_torch.ops.cuda import gather, march_kernel as mk

_aten = torch.ops.aten
HOST_READS = {_aten._local_scalar_dense, _aten.nonzero, _aten.masked_select,
              _aten.unique_consecutive, _aten._unique, _aten._unique2,
              _aten.unique_dim, _aten.unique_dim_consecutive}
# the kernels' plain versions: the card runs the kernels in their place
PLAIN_VERSIONS = ((mk, "march_plain"), (mk, "surface_plain"),
                  (gather, "block_gather_plain"))


class NoHostRead(TorchDispatchMode):
    """Raise at an op that reads the device on the host, or at a tensor of
    more than one element made from host data."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        assert func.overloadpacket not in HOST_READS, f"host read {func}"
        assert not (func.overloadpacket is _aten.lift_fresh
                    and args[0].numel() > 1), "host data in the frame"
        return func(*args, **(kwargs or {}))


def suspended(real):
    """``real`` run with the dispatch modes taken off."""
    def plain(*a, **k):
        with _disable_current_modes():
            return real(*a, **k)
    return plain


@contextlib.contextmanager
def patched(pairs):
    """Set ``(owner, name, value)`` attributes over the scope."""
    old = [(owner, name, getattr(owner, name)) for owner, name, _v in pairs]
    try:
        for owner, name, value in pairs:
            setattr(owner, name, value)
        yield
    finally:
        for owner, name, value in reversed(old):
            setattr(owner, name, value)


@contextlib.contextmanager
def no_host_read():
    """:class:`NoHostRead` over the scope, but inside the plain versions."""
    with patched([(m, n, suspended(getattr(m, n)))
                  for m, n in PLAIN_VERSIONS]), NoHostRead():
        yield


def recorded_capture(self):
    """Stands in for ``graph._FrameGraph._capture``: the captured body's run
    gives the graph's outputs, and its replay runs the body again, deferred
    (the flag agreed as the capture would agree it), into them."""
    self.outputs = self._run(agree=self.agree_in_graph)

    def replay():
        for dst, src in zip(self.outputs,
                            self._run(agree=self.agree_in_graph)):
            dst.copy_(src)
    self.graph = types.SimpleNamespace(replay=replay, reset=lambda: None)
    ops_cuda.GRAPH["captures"] += 1


@contextlib.contextmanager
def graph_route():
    """Every call routed as on the card (:func:`recorded_capture`), with
    no graph made before the scope and none kept after it; the counts set
    to 0."""
    ops_cuda.reset_launch_counts()
    with patched([(graph, "capturable", lambda *a: True),
                  (graph, "_graphs", {}),
                  (graph._FrameGraph, "_capture", recorded_capture)]):
        yield


@contextlib.contextmanager
def forced_repair(on: bool = True):
    """Every seventh lane of each surface pass's output marked unresolved
    over the scope (nothing when ``on`` is false)."""
    real = mk.surface_kernel

    def marked(*a, **k):
        normal, midx, code = real(*a, **k)
        lane = torch.arange(midx.shape[0], device=midx.device)
        return normal, torch.where(lane % 7 == 3, -1, midx), code
    with patched([(mk, "surface_kernel", marked)] if on else []):
        yield
