"""The control of each cell's check: the plain reference in the precision
below the configuration's (bfloat16 for float32), put in the program's
place, has to come out not correct.  On the CPU at a tiny size; on the
card (marked ``cuda``) at the cell's own size, on three seeds, printing
the readings the limits were set from."""
import json
import time

import pytest
import torch
from conftest import ROOT, TINY

from benchmark import harness

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MAN["workloads"]]


def chips(cell: str) -> int:
    return json.loads((ROOT / "benchmark/workloads" /
                       f"{cell}.json").read_text())["chips"]
SEEDS = (271828182, 314159265, 1618033988)


def control(cell, seed, device, overrides):
    run = harness.Run(cell, seed, 0.0, True, overrides)
    run.device = torch.device(device)
    traffic = harness.load_module("traffic",
                                  run.workload["traffic"]).Traffic(run)
    traffic.call(0)
    traffic.release()
    return traffic.control()


def failing(readings: dict) -> list:
    return [k for k, (v, lim) in readings.items() if not v <= lim]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_cpu(cell):
    readings = control(cell, 5, "cpu", TINY)
    assert failing(readings), readings


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_the_cells_size(cell):
    if torch.cuda.device_count() < chips(cell):
        pytest.skip(f"needs {chips(cell)} CUDA cards: the control runs at "
                    "the cell's size")
    passed = []
    for seed in SEEDS:
        t0 = time.perf_counter()
        readings = control(cell, seed, "cuda", None)
        print(f"control {cell} seed {seed}: "
              + ", ".join(f"{k} {v!r} (limit {lim!r})"
                          for k, (v, lim) in readings.items())
              + f"; {time.perf_counter() - t0:.1f} s", flush=True)
        if not failing(readings):
            passed.append(seed)
    assert not passed


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", [
    ("tori1000.frame", "answer_shifted"),
    ("tori1000.frame", "answer_quarter_blank"),
    ("spectral1000.frame", "answer_quarter_blank"),
    ("tori1000.fit", "half_batch"),
    ("tori1000.fit.x4", "no_exchange")])
def test_faults_at_the_cells_size(cell, fault):
    """Each fault planted in the timed path at the cell's own size, on
    three seeds: the readings of the limits' upper ends."""
    if torch.cuda.device_count() < chips(cell):
        pytest.skip(f"needs {chips(cell)} CUDA cards: the fault runs at "
                    "the cell's size")
    from test_bench_cells import FAULTS, restored_exchange
    passed = []
    for seed in SEEDS:
        with restored_exchange():
            r = harness.run_cell(cell, seed, 1.0, False, time.perf_counter(),
                                 patch=FAULTS[fault])
        print(f"fault {fault} {cell} seed {seed}: "
              + ", ".join(f"{k} {v['value']!r} (limit {v['limit']!r})"
                          for k, v in r["compared"].items()), flush=True)
        if r["correct"]:
            passed.append(seed)
    assert not passed
