"""Timing of short kernels on the card: what the probe program and
``chip_smoke.py`` read kernel times with.

A pair of CUDA events around one host call of a kernel that runs a few
microseconds brackets the host's launch path, not the kernel:
:func:`device_ms` keeps the device busy while the call is issued, so the
events bracket the kernels alone; :func:`back_to_back_ms` reads the rate at
which the host can launch.
"""
from __future__ import annotations

import math
import statistics
import time

import torch


def back_to_back_ms(fn, reps: int = 200) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls, by one pair of
    CUDA events (milliseconds).  For kernels this short it reads the rate
    at which the host can launch, not the kernel: the launch floor."""
    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


_PLUG_FLOATS = 1 << 26   # the plug's buffer: 256 MiB, ~0.1 ms a fill


def device_ms(fn, reps: int = 50) -> float:
    """Device time of one call of ``fn`` (milliseconds), median of ``reps``:
    a pair of CUDA events around each call, recorded while the device is
    still busy with a plug of buffer fills queued just before (sized to
    twice the host's time for the call), so that the call's launches wait
    in the queue and the events bracket the kernels, not the host's launch
    latency.  The reading includes the events' own cost: hold it against
    the empty kernel's reading by the same method."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    host_s = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        host_s = min(host_s, time.perf_counter() - t0)
        torch.cuda.synchronize()
    plug = torch.empty(_PLUG_FLOATS, dtype=torch.float32, device="cuda")
    pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    plug.zero_()
    pair[0].record()
    for _ in range(10):
        plug.zero_()
    pair[1].record()
    torch.cuda.synchronize()
    fill_s = pair[0].elapsed_time(pair[1]) / 10 * 1e-3
    fills = max(1, math.ceil((2 * host_s + 1e-4) / fill_s))
    times = []
    for _ in range(reps):
        for _ in range(fills):
            plug.zero_()
        pair[0].record()
        fn()
        pair[1].record()
        torch.cuda.synchronize()
        times.append(pair[0].elapsed_time(pair[1]))
    return statistics.median(times)
