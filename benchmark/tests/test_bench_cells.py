"""Each cell end to end at a tiny size on the CPU: the traffic loop drives
the port's plain versions, the reference agrees with it, and the result
line carries the cell's metrics and its compared numbers; then the timed
path broken underneath, once for each fault the cell can have, and the
run comes out not correct."""
import contextlib
import json
import time

import pytest
import torch
from conftest import ROOT, TINY

from benchmark import harness

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MAN["workloads"]]


def run(cell, seed=11, trace=False, patch=None, overrides=TINY,
        seconds=0.3):
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(),
                            device="cpu", overrides=overrides, patch=patch)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_agrees_with_the_reference(cell):
    # a window of several calls, so that a tail is defined
    r = run(cell, seconds=2.0)
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    names = {m["name"] for m in harness.cell_metrics(MAN, cell,
                                                     "end_to_end")}
    # a tail needs two calls in the window, which a loaded CPU may not give
    assert set(r["metrics"]) <= names and "setup_s" in r["metrics"]
    assert r["attempted"] < 2 or set(r["metrics"]) == names
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "compared"
    limits = json.loads((ROOT / "benchmark/workloads" /
                         f"{cell}.json").read_text())["params"]["limits"]
    assert set(r["compared"]) == set(limits)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_checks_alike(cell):
    # the CPU profiler sees no device op: the per-layer readers that need
    # the trace return nothing, and the check is the same
    r = run(cell, trace=True)
    assert r["correct"], r["compared"]
    assert "busy_s" not in r["device"]


def _shifted(mod):
    class Shifted(mod.Traffic):
        def render(self):
            return super().render() + 0.1
    mod.Traffic = Shifted


def _blocked(mod):
    class Blocked(mod.Traffic):
        def render(self):
            img = super().render().clone()
            img[: img.shape[0] // 4] = 0.0
            return img
    mod.Traffic = Blocked


FRAME_FAULTS = {"answer_shifted": _shifted, "answer_quarter_blank": _blocked}


@pytest.mark.parametrize("fault", FRAME_FAULTS)
@pytest.mark.parametrize("cell", ["tori1000.frame", "spectral1000.frame"])
def test_frame_fault_is_not_correct(cell, fault):
    r = run(cell, patch=FRAME_FAULTS[fault])
    assert not r["correct"], r["compared"]


def _unchanged(mod):
    class Unchanged(mod.Traffic):
        update = staticmethod(lambda scene, grads, lr: scene)
    mod.Traffic = Unchanged


def _half(img, target):
    h = img.shape[0] // 2
    return torch.mean((img[:h] - target[:h]) ** 2)


def _half_batch(mod):
    class HalfBatch(mod.Traffic):
        loss_fn = staticmethod(_half)
    mod.Traffic = HalfBatch


FIT_FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_batch}


@pytest.mark.parametrize("fault", FIT_FAULTS)
def test_fit_fault_is_not_correct(fault):
    r = run("tori1000.fit", patch=FIT_FAULTS[fault])
    assert not r["correct"], r["compared"]


FAULTS = {**FRAME_FAULTS, **FIT_FAULTS}


class _Done:
    """A finished collective's handle."""

    def wait(self):
        return True


def drop_exchange():
    """In a rank: the gradient all-reduce of the sharded step left out
    (the asynchronous ones; the losses' and the flag's stay)."""
    from fraytracer_tpu_torch.parallel import mesh
    real = mesh.dist

    class NoExchange:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def all_reduce(tensor, *a, async_op=False, **kw):
            if async_op:
                return _Done()
            return real.all_reduce(tensor, *a, **kw)
    mesh.dist = NoExchange()


@contextlib.contextmanager
def restored_exchange():
    """This process's ``mesh.dist`` put back after a run whose rank 0
    (this process) took ``drop_exchange``."""
    from fraytracer_tpu_torch.parallel import mesh
    real = mesh.dist
    try:
        yield
    finally:
        mesh.dist = real


def _no_exchange(mod):
    class NoExchange(mod.Traffic):
        rank_patch = "test_bench_cells:drop_exchange"
    mod.Traffic = NoExchange


SHARDED = "tori1000.fit.x4"


def test_sharded_fit_runs_on_four_gloo_ranks_and_agrees():
    r = run(SHARDED)
    assert r["correct"], r["compared"]
    assert r["device"]["count"] == 4


def test_sharded_fit_without_the_exchange_is_not_correct():
    with restored_exchange():
        r = run(SHARDED, patch=_no_exchange)
    assert not r["correct"], r["compared"]


FAULTS["no_exchange"] = _no_exchange
