"""``BENCHMARK.json`` and the files it names: every configuration,
workload and metric file parses and is found by its name; names, units
and lines keep to the benchmark's contract; each per-layer metric moves
one end-to-end metric that every cell it lists reports."""
import json
import re

import pytest
from conftest import ROOT

from benchmark import harness

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def metrics():
    return MAN["end_to_end"] + MAN["per_layer"]


def line_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MAN) == KEYS
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= len(MAN["command"]) <= 32
    assert all(line_ok(w) and not w.startswith("/") and ".." not in w
               for w in MAN["command"])
    assert (ROOT / MAN["command"][1]).is_file()
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and line_ok(entry["why"])
    assert line_ok(entry["source"]) and entry["source"].startswith("https://")
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    spec = json.loads((ROOT / entry["file"]).read_text())
    assert spec["name"] == entry["name"]
    assert spec["source"] == entry["source"]
    assert spec["reduced"] == entry["reduced"] == []
    assert any(w["config"] == entry["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("entry", MAN["workloads"], ids=lambda w: w["name"])
def test_workload_files(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert line_ok(entry["why"]) and entry["chips"] in (1, 4)
    w = json.loads((ROOT / "benchmark/workloads" /
                    f"{entry['name']}.json").read_text())
    assert {k: w[k] for k in ("name", "config", "traffic", "chips",
                              "why")} == entry
    assert (ROOT / "benchmark/traffic" / f"{w['traffic']}.py").is_file()
    mod = harness.load_module("traffic", w["traffic"])
    assert hasattr(mod, "Traffic")
    assert set(w["params"]["limits"])


def test_names_are_unique_and_cells_pair_once():
    for group in (MAN["configs"], MAN["workloads"], metrics()):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("m", metrics(), ids=lambda m: m["name"])
def test_metric_entries(m):
    keys = {"name", "unit", "better", "source"}
    if m in MAN["end_to_end"]:
        keys |= {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert line_ok(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert set(m) - {"workloads"} == keys
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if "roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"
    assert hasattr(harness.load_module("metrics", m["name"]), "read")


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_its_cells_report(m):
    e2e = {x["name"]: x for x in MAN["end_to_end"]}
    assert m["moves"] in e2e
    cells = [w["name"] for w in MAN["workloads"]]
    for cell in m.get("workloads", cells):
        assert cell in cells
        names = [x["name"] for x in harness.cell_metrics(MAN, cell,
                                                         "end_to_end")]
        assert m["moves"] in names


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in MAN["workloads"]:
        e2e = [x["name"] for x in harness.cell_metrics(MAN, w["name"],
                                                       "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(MAN, w["name"], "per_layer")


def test_layers_are_named_alike():
    by_layer = {}
    for m in MAN["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())
