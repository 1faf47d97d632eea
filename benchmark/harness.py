"""One run of one cell: set-up, the measured (or traced) window, the check
against the plain reference, and the result line.

The harness holds nothing of a particular cell.  ``workloads/<cell>.json``
names the configuration (``configs/<config>.json``), the traffic kind
(``traffic/<kind>.py``, whose ``Traffic`` sets the cell up, issues one
call and checks what the calls produced) and its parameters;
``BENCHMARK.json`` lists which metrics the cell reports, each read by
``metrics/<metric>.py``.  A new cell, mix or metric is new files.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "fraytracer_tpu")


class NoCard(RuntimeError):
    """The machine lacks the cards the cell asks for."""


class Forbidden(RuntimeError):
    """A module that no run may load was loaded."""


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_json(path) -> dict:
    return json.loads(Path(path).read_text())


def merged(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys laid over it, nested dicts merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark as a module (names may hold
    dots, so files are loaded by path)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    key = f"benchmark.{kind}.{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """The forbidden top-level names among the loaded modules' (each name
    compared whole: ``fraytracer_tpu_torch`` is not ``fraytracer_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cell_metrics(manifest: dict, cell: str, section: str) -> list:
    """The entries of ``section`` that cell ``cell`` reports."""
    return [m for m in manifest[section]
            if "workloads" not in m or cell in m["workloads"]]


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it (or why not)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"


class Run:
    """What one run knows: its cell, configuration and seed, and what the
    window measured.  Traffic and metric files read it."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 overrides: dict | None = None):
        self.cell, self.seed = cell, int(seed)
        self.seconds, self.trace = float(seconds), bool(trace)
        self.workload = load_json(BENCH / "workloads" / f"{cell}.json")
        self.config = merged(
            load_json(BENCH / "configs" / f"{self.workload['config']}.json"),
            (overrides or {}).get("config", {}))
        self.params = merged(self.workload.get("params", {}),
                             (overrides or {}).get("params", {}))
        self.overrides = overrides or {}
        # what other ranks of a run over several cards report to rank 0:
        # (rank, busy s, window s, memory peak bytes) each
        self.peers: list = []
        self.device = None
        self.setup_s = None
        self.latencies: list = []
        self.window_s = None
        self.counts = {}
        self.tr = None

    @property
    def completed(self) -> int:
        return len(self.latencies)

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def window(run: Run, traffic, seconds=None, calls=None) -> None:
    """Calls back to back, each issued when the last has returned and the
    device is synchronized, until ``seconds`` have passed (the call that
    crosses the mark completes) or ``calls`` were made."""
    from . import program
    c0 = program.graph_counts()
    lat = []
    w0 = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        traffic.call(len(lat))
        run.sync()
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        if calls is not None and len(lat) >= calls:
            break
        if seconds is not None and t1 - w0 >= seconds:
            break
    run.latencies, run.window_s = lat, t1 - w0
    c1 = program.graph_counts()
    run.counts = {k: c1[k] - c0[k] for k in c1}


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, overrides=None,
             patch=None) -> dict:
    """One run; returns the result object (the last line's).  ``device``
    ``None`` takes the card and raises :class:`NoCard` without one;
    tests pass the CPU, small ``overrides`` and a ``patch(module)`` that
    breaks the traffic module's timed path before set-up."""
    import torch

    from . import trace as T
    run = Run(cell, seed, seconds, trace, overrides)
    chips = int(run.workload["chips"])
    if device is None:
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < chips:
            raise NoCard(f"{torch.cuda.device_count()} cards, the cell "
                         f"asks for {chips}")
        device = torch.device("cuda", 0)
    run.device = torch.device(device)
    manifest = load_json(ROOT / "BENCHMARK.json")
    traffic_mod = load_module("traffic", run.workload["traffic"])
    if patch is not None:
        patch(traffic_mod)
    traffic = traffic_mod.Traffic(run)
    run.sync()
    run.setup_s = time.perf_counter() - t_start
    log(f"set-up {run.setup_s:.3f} s ({cell}, seed {seed})")
    if trace:
        got = {}
        with T.traced(got):
            window(run, traffic, calls=int(run.params["trace_calls"]))
        run.tr = got["trace"]
    else:
        window(run, traffic, seconds=run.seconds)
    log(f"window {run.window_s:.3f} s, {run.completed} calls, "
        f"graph counts {run.counts}")
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise Forbidden(f"modules loaded that no run may load: {found}")
    traffic.release()
    peak = max([peak] + [p[3] for p in run.peers])
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    judged, failed = traffic.check()
    log(f"check {time.perf_counter() - t_ref:.3f} s")
    correct = all(v <= lim for v, lim in judged.values())

    metrics = {}
    section = "per_layer" if trace else "end_to_end"
    for m in cell_metrics(manifest, cell, section):
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(run.device)
                    if run.device.type == "cuda" else "cpu"),
           "count": chips, "memory_peak_bytes": int(peak)}
    if run.device.type == "cuda":
        dev["power"] = power_limit()
    result = {"correct": bool(correct), "attempted": run.completed,
              "failed": int(failed), "metrics": metrics, "device": dev}
    if trace and run.tr is not None:
        busy = [run.tr.busy_s()] + [p[1] for p in run.peers]
        dev["busy_s"] = statistics.fmean(busy)
        dev["window_s"] = run.tr.window_s
        result["breakdown"] = T.breakdown(run.tr)
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in judged.items()}
    if run.latencies:
        lat = sorted(run.latencies)
        log(f"latency ms: median {1e3 * statistics.median(lat):.4f}, "
            f"min {1e3 * lat[0]:.4f}, max {1e3 * lat[-1]:.4f}")
    for k, (v, lim) in judged.items():
        log(f"compared {k} {v!r} limit {lim!r}")
    return result
