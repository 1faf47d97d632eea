"""The traced window: ``torch.profiler`` over a run of calls, and the
arithmetic the per-layer metrics share (a frozen copy of the busy / span
union that ``chip_smoke.py::profile_frame`` takes).

Device times come from the profiler's device events (CUPTI), clipped to
the window, which is the host's span of the ``bench.window`` annotation
on the profiler's own clock, so host gaps between calls count as idle.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses

WINDOW = "bench.window"
# idle gaps shorter than this are summed together, not attributed
SMALL_GAP_US = 5.0


@dataclasses.dataclass
class Trace:
    """Device ops ``(name, start µs, end µs)`` in start order, the window's
    ``(start, end)`` µs, and the host ops ``(name, start, end)``."""

    ops: list
    window: tuple
    host: list

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_s(self) -> float:
        """Seconds in which at least one device op ran (their union)."""
        return sum(b - a for a, b in union(self.ops)) * 1e-6

    def ms(self, match) -> float:
        """Summed device ms of the ops whose name ``match`` accepts."""
        return sum(b - a for n, a, b in self.ops if match(n)) * 1e-3


def union(ops) -> list:
    """The merged ``(start, end)`` intervals of ``ops``."""
    out = []
    for _n, a, b in sorted(ops, key=lambda x: x[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def short(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0]
    return base.replace("void ", "").split("<")[0][:96]


@contextlib.contextmanager
def traced(result: dict):
    """Profile the body; on exit ``result["trace"]`` holds its
    :class:`Trace` (``None`` when the profiler saw no device op)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield
    evs = prof.events()
    win = [e for e in evs if e.name == WINDOW
           and e.device_type == DeviceType.CPU]
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    ops, host = [], []
    for e in evs:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.is_user_annotation or e.name == WINDOW:
                continue
            a, b = max(a, w0), min(b, w1)
            if b > a:
                ops.append((e.name, a, b))
        elif e.name != WINDOW:
            host.append((e.name, a, b))
    ops.sort(key=lambda x: x[1])
    result["trace"] = Trace(ops, (w0, w1), host) if ops else None


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device ops that took most time (by short name), and the longest
    idle gaps of the device grouped by the innermost host op running at
    each gap's middle."""
    by = {}
    for n, a, b in tr.ops:
        k = short(n)
        by[k] = by.get(k, 0.0) + (b - a) * 1e-6
    busy = union(tr.ops)
    gaps = []
    edges = [tr.window[0]] + [x for ab in busy for x in ab] + [tr.window[1]]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    host = sorted(tr.host, key=lambda x: x[1])
    starts = [h[1] for h in host]
    idle = {}
    for a, b in gaps:
        name = f"gaps under {SMALL_GAP_US} us"
        if b - a >= SMALL_GAP_US:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid) - 1
            name = "no host op"
            # the latest-started host op still running at mid: the
            # innermost of those that hold it
            for j in range(i, max(i - 2048, -1), -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    order = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in order],
            "idle_gaps": [[k, v] for k, v in gaps_top]}
