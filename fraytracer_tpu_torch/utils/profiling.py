"""Observability: march statistics and profiler hooks (counterpart of
``fraytracer_tpu.utils.profiling``).

The reference's observability is one Stopwatch and two printfn lines
(Program.fs:87-96); SURVEY.md §5 calls for structured per-run reports:
rays/s, march-iteration statistics and profiler traces.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Optional

import torch

from ..ops.march import MarchConfig, march
from ..scene.flatten import FlatScene
from ..types import Rays

# march-step histogram bucket edges (the JAX report's)
HIST_EDGES = (0, 8, 16, 32, 64, 128, 256, 1 << 30)


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
                cfg: MarchConfig = MarchConfig(),
                repeats: int = 3) -> RenderStats:
    """March a ray batch and report timing and iteration statistics.
    ``wall_s`` is the best of ``repeats`` marches after an untimed one,
    each between device synchronizations.  The step histogram is the
    tuning signal of the fixed-trip masked march: a long tail means lanes
    of a warp waiting on the slowest."""
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
    (view it in Perfetto or ``chrome://tracing``).  No-op for ``None``."""
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
