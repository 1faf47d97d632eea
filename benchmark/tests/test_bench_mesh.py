"""The four-card fit ``tori1000x4.fit`` (traffic ``fit_mesh``): on four
gloo ranks on the CPU at a tiny size it agrees with the plain float64 fit
and closes its group through the port's teardown; with the gradients'
exchange left out it is not correct; and on four cards (marker ``cuda``)
it runs and tears its NCCL group down within the teardown's deadline."""
import time

import pytest
import torch
from conftest import TINY
from test_bench_cells import _no_exchange, restored_exchange

from benchmark import harness

CELL = "tori1000x4.fit"


def run(device="cpu", patch=None, overrides=TINY, seconds=0.3, trace=False):
    return harness.run_cell(CELL, 1618033988, seconds, trace,
                            time.perf_counter(), device=device,
                            overrides=overrides, patch=patch)


def mesh_counts():
    from fraytracer_tpu_torch.parallel import mesh
    return mesh.counts()


def test_runs_on_four_gloo_ranks_agrees_and_tears_down():
    before = mesh_counts()["teardown_s"]
    r = run()
    assert r["correct"], r["compared"]
    assert r["device"]["count"] == 4 and r["attempted"] >= 1
    assert "step_ms" in r["metrics"] and "setup_s" in r["metrics"]
    after = mesh_counts()
    assert after["teardown_s"] != before and after["all_reduce"] > 0


def test_without_the_exchange_is_not_correct():
    with restored_exchange():
        r = run(patch=_no_exchange)
    assert not r["correct"], r["compared"]


@pytest.mark.cuda
def test_tears_down_on_four_cards():
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards: the cell's NCCL group spans four")
    from fraytracer_tpu_torch.parallel import mesh
    before = mesh.counts()["graphs_released"]
    r = run(device=None, trace=True)
    assert r["correct"], r["compared"]
    after = mesh.counts()
    # the step's graph, which holds the group's collectives, released
    assert after["graphs_released"] > before
    assert 0 < after["teardown_s"] < mesh.TEARDOWN_S
    print(f"teardown {after}; metrics {r['metrics']}", flush=True)
