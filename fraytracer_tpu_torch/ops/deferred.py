"""Frames that read nothing on the host: the counterpart of the JAX
package's ``lax.cond``s.

``jax.jit`` compiles a frame into one device program, so its
data-dependent branches are ``lax.cond``s on the device: the culled
march's overflow fallback (``ops/pallas/march_kernel.py:1915-1919``, taken
at ``:2048`` and ``:2095``), ``resolve_material``'s repair tiers
(``ops/shade.py:80-84``, ``:105-111``) and, in a step's backward and the
non-fused surface pass, the exactness certificate of ``point_eval``'s
candidate lists (``ops/march.py:320``, ``ops/point_eval.py:399``).  The
port's eager frame reads a count or the certificate on the host at each
of them instead.  Inside :func:`deferring`, those sites read nothing:
each ORs the condition of its branch into the frame's flag, a bool on the
frame's device, and goes on as if the branch needed no repair.  Whoever
ran the frame reads the flag once at its end and, where it is set, runs
the frame (or the step) again eagerly (``ops/graph.py``): that re-run takes
the branches as the eager frame always has, so a flagged result is exact.
A step's backward runs in its forward's frame (``ops/march.py::_MarchFn``
hands it over: autograd may run a backward on a thread of its own, where
the context variable is unset), and so does a checkpointed region's
recomputation (:func:`in_current`).

The culled march calls of a frame come in a fixed order under its key (its
Python control flow is static), so a :class:`Frame` numbers them: each is
a *site*, and the frame keeps each site's overflow bool (``None`` where
its tables cannot overflow).  A site may be *promoted*: it then builds its
tables on the full group at once, the tables the eager re-run and JAX's
fallback march on, and cannot overflow — the counterpart of a ``lax.cond``
taken per call site (a captured call's first run promotes the sites it saw
overflow, ``ops/graph.py``).

A :class:`Frame` also keeps the scene's lowered kernel program for the
frame's marches (``ops/cuda/march_kernel.py::lower_program``), so that the
lowering of the parameter values runs inside the frame, once, and never
comes from a memo made outside it: a captured frame then recomputes it on
every replay.  And it keeps the device constants the frame reads
(:func:`device_constant`), so that they live as long as a graph captured
from it, whatever their caches evict.

A frame that ranks of a process group run together (``parallel/mesh.py``)
carries the group: its flag decides which collectives the ranks issue next
(an eager re-run, a capture, a promoted run), so every rank must read the
same flag.  :meth:`Frame.agree` ORs the flags over the group, one
``all_reduce(MAX)``; inside a graph captured on NCCL that is one more
captured collective, on gloo it runs eagerly after the replay.
:data:`COLLECTIVES` counts the collectives issued over process groups.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools

import torch
import torch.distributed as dist

# collectives issued over process groups, by kind: each counted where it is
# issued (:meth:`Frame.agree`, ``parallel/mesh.py``); those a graph
# captured are counted again at each replay (``ops/graph.py``), as its
# kernel launches are
COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0}


class Frame:
    """A deferred frame's state: ``flag`` (bool ``[]`` on ``device``) is
    set where a branch needs the eager re-run; ``programs`` holds the
    lowered programs of the frame's marches, ``constants`` the device
    constants it read; ``overflows`` the overflow bool of each culled
    march call (site) of the current run in call order (``None`` where
    the call cannot overflow), ``promoted`` the sites that build
    full-group tables; ``group`` the process group whose ranks run the
    frame together (``None``: this process alone)."""

    def __init__(self, device, group=None):
        self.flag = torch.zeros((), dtype=torch.bool, device=device)
        self.group = group
        self.programs = {}
        self.constants = {}
        self.overflows = []
        self.promoted = frozenset()

    def raise_if(self, cond: torch.Tensor) -> None:
        """OR a bool scalar tensor into the flag, on the device."""
        self.flag.logical_or_(cond)

    def agree(self) -> None:
        """OR the flag over the frame's group, on the device: one
        ``all_reduce(MAX)`` of it as an int32, which every rank of the
        group issues at the same point; nothing without a group."""
        if self.group is None:
            return
        flag = self.flag.to(torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        COLLECTIVES["all_reduce"] += 1
        self.flag.copy_(flag != 0)

    def next_site_promoted(self) -> bool:
        """Whether the culled march call about to build its tables (the
        next site) is promoted."""
        return len(self.overflows) in self.promoted

    def add_site(self, overflow: torch.Tensor | None) -> None:
        """Record the next site's overflow bool, and raise the flag on
        it."""
        self.overflows.append(overflow)
        if overflow is not None:
            self.raise_if(overflow)

    def overflowed_sites(self) -> frozenset:
        """The sites of the last run whose tables overflowed: the stacked
        bools read on the host, once."""
        armed = [(i, o) for i, o in enumerate(self.overflows)
                 if o is not None]
        if not armed:
            return frozenset()
        hit = torch.stack([o.reshape(()) for _i, o in armed]).tolist()
        return frozenset(i for (i, _o), h in zip(armed, hit) if h)


_current: contextvars.ContextVar = contextvars.ContextVar(
    "deferred_frame", default=None)


def current() -> Frame | None:
    """The frame being run by :func:`deferring`, else ``None`` (the eager
    frame, which reads its branches on the host)."""
    return _current.get()


@contextlib.contextmanager
def deferring(frame: Frame):
    """Run the scope's frame with its host reads deferred to ``frame``."""
    token = _current.set(frame)
    try:
        yield frame
    finally:
        _current.reset(token)


def in_current(fn):
    """``fn`` bound to the frame :func:`deferring` runs now, if any: it
    runs in that frame wherever it is called.  For functions that run
    later on another thread, as a ``torch.utils.checkpoint`` region's
    recomputation does on autograd's thread in the backward of CUDA
    tensors, where the context variable is unset."""
    frame = current()
    if frame is None:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with deferring(frame):
            return fn(*args, **kwargs)
    return run


def device_constant(maxsize: int):
    """Cache a function that copies host data to a device, as
    ``functools.lru_cache(maxsize)`` does, and keep each tensor it returns
    inside :func:`deferring` in that frame's ``constants``.  A frame
    captured in a CUDA graph reads them by address, so they live as long as
    the frame, and its capture finds the copies its eager run made (a copy
    from host data cannot be captured) whatever the cache evicted since."""
    def wrap(make):
        cached = functools.lru_cache(maxsize=maxsize)(make)

        @functools.wraps(make)
        def get(*args):
            frame = current()
            if frame is None:
                return cached(*args)
            key = (make, args)
            if key not in frame.constants:
                frame.constants[key] = cached(*args)
            return frame.constants[key]
        get.cache_info, get.cache_clear = cached.cache_info, cached.cache_clear
        return get
    return wrap
