"""What a run may load and where it may run: no JAX, no ``jaxlib``, no
``flax`` and no JAX package (``fraytracer_tpu``, compared by whole
top-level name) after a run's imports; the plain reference loads nothing
of the port; a run without a card, or without the port beside it, prints
no result and fails."""
import json
import shutil
import subprocess
import sys
import types

from conftest import ROOT

from benchmark import harness

PY = sys.executable


def _python(code: str, cwd=ROOT):
    return subprocess.run([PY, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=600)


def test_a_run_loads_no_jax_and_no_jax_package():
    code = f"""
import json, sys, time
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r})
from conftest import TINY
from benchmark import harness
r = harness.run_cell("tori1000.frame", 3, 0.2, False, time.perf_counter(),
                     device="cpu", overrides=TINY)
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"tops": tops, "correct": r["correct"]}}))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "fraytracer_tpu_torch" in got["tops"]
    for name in harness.FORBIDDEN:
        assert name not in got["tops"]
    assert got["correct"]


def test_the_reference_loads_nothing_of_the_port():
    code = """
import sys
import benchmark.reference.render, benchmark.reference.spectral
import benchmark.reference.fit, benchmark.scenes, benchmark.checks
print(sorted({m.split(".")[0] for m in sys.modules}))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"fraytracer_tpu_torch", "fraytracer_tpu", "jax",
                       "jaxlib", "flax"}


def test_a_forbidden_module_is_named():
    sys.modules["jax"] = types.ModuleType("jax")
    try:
        assert harness.forbidden_modules() == ["jax"]
    finally:
        del sys.modules["jax"]
    sys.modules["fraytracer_tpu_torch_x"] = types.ModuleType("x")
    try:
        assert harness.forbidden_modules() == []
    finally:
        del sys.modules["fraytracer_tpu_torch_x"]


def test_without_a_card_no_result():
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [PY, "benchmark/run.py", "--workload", "tori1000.frame", "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "is_available" in out.stderr


def test_without_the_port_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = f"""
import sys, time
sys.path.insert(0, {str(tmp_path)!r})
sys.path.insert(0, {str(tmp_path / 'benchmark' / 'tests')!r})
from conftest import TINY
from benchmark import harness
harness.run_cell("tori1000.frame", 3, 0.2, False, time.perf_counter(),
                 device="cpu", overrides=TINY)
print("a result")
"""
    out = _python(code, cwd=tmp_path)
    assert out.returncode != 0
    assert "a result" not in out.stdout
    assert "fraytracer_tpu_torch" in out.stderr
