"""``benchmark/layers.py`` on synthetic traces: replays' blocks found by
their anchors and split exactly by the layer table, with ops before and
after each replay; a shifted block, a missing op, a misplaced anchor, an
eager call or a program without tables gives nothing."""
import types

import pytest

from benchmark import harness, layers
from benchmark.trace import Trace

K1 = "void march_kernel<NoPrimHook>(float const*, int)"
K3 = "void surface_kernel(float const*, int)"
EW = "void at::native::elementwise_kernel<128, 4>(int, float)"
RED = "void at::native::reduce_kernel<512, 1>(float)"
CP = "Memcpy DtoD (Device -> Device)"
SET = "Memset (Device)"
DTOH = "Memcpy DtoH (Device -> Pinned)"

# a frame's graph: the flag (root), a march holding its table build and
# K1, a copy, K3 in the surface pass, a set in the shading
FRAME = {"name": "frame", "n_ops": 6, "replays": 3, "kinds": "kkkcks",
         "layers": [("march", None, 1, 3), ("cull", 0, 1, 1),
                    ("surface", None, 4, 1), ("shade", None, 5, 1)],
         "anchors": [(2, "march_kernel"), (4, "surface_kernel")]}
BODY = [EW, RED, K1, CP, K3, SET]
DUR = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]      # µs
# a step's graph: the frame's forward, then the loss and its backward
STEP = {"name": "step", "n_ops": 9, "replays": 2, "kinds": "kkkckskkk",
        "layers": [("march", None, 1, 3), ("cull", 0, 1, 1),
                   ("surface", None, 4, 1), ("shade", None, 5, 1),
                   ("loss", None, 6, 1), ("vjp", None, 7, 2),
                   ("cull", 5, 7, 1)],
        "anchors": [(2, "march_kernel"), (4, "surface_kernel")]}


def trace(calls, body=BODY, dur=DUR):
    """``calls`` replays of ``body``, each between two input copies and
    an output clone with the flag read; 10 µs between calls."""
    ops, t = [], 0.0
    for _ in range(calls):
        seq = [(CP, 0.5), (CP, 0.5)] + list(zip(body, dur)) + [
            (CP, 0.5), (DTOH, 0.25)]
        for name, d in seq:
            ops.append((name, t, t + d))
            t += d
        t += 10.0
    return Trace(ops, (0.0, t), [])


def fake_run(tr, calls, **counts):
    c = {"replays": calls, "eager_reruns": 0, "eager_frames": 0}
    c.update(counts)
    return types.SimpleNamespace(tr=tr, completed=calls, counts=c)


@pytest.fixture
def tables(monkeypatch):
    box = {"tables": [FRAME]}
    monkeypatch.setattr(layers, "graph_tables", lambda: box["tables"])
    return box


def metric(name, run):
    return harness.load_module("metrics", name).read(run)


def test_exact_split_with_ops_around_each_replay(tables):
    run = fake_run(trace(3), 3)
    ms = {k: metric(f"layers.{k}_ms.frame", run)
          for k in ("cull", "march", "shade", "other")}
    assert ms == pytest.approx({"cull": 2e-3, "march": 7e-3,
                                "shade": 11e-3, "other": 1e-3})
    # the split adds up to the graph; the ops around it are outside
    graph = sum(DUR) * 1e-3
    assert sum(ms.values()) == pytest.approx(graph)
    outside = run.tr.ms(lambda n: True) / 3 - graph
    assert outside == pytest.approx(1.75e-3)
    assert metric("layers.wavefront_ms.frame", run) == 0.0


def test_step_split_and_the_longer_table_first(tables):
    tables["tables"] = [FRAME, STEP]
    body = BODY + [EW, RED, EW]
    run = fake_run(trace(2, body, DUR + [7.0, 8.0, 9.0]), 2)
    got = {k: metric(f"layers.{k}_ms.step", run)
           for k in ("cull", "forward", "vjp", "other")}
    # the frame's table matches the step's forward too: the step wins
    assert got == pytest.approx({"cull": 2e-3 + 8e-3,
                                 "forward": (3 + 4 + 5 + 6 + 7) * 1e-3,
                                 "vjp": 9e-3, "other": 1e-3})


@pytest.mark.parametrize("fault", ["shifted", "missing", "anchor",
                                   "one_replay_short"])
def test_a_block_that_does_not_match_gives_nothing(tables, fault):
    body, dur = list(BODY), list(DUR)
    if fault == "shifted":         # an op the table does not hold
        body.insert(3, EW)
        dur.insert(3, 1.0)
    elif fault == "missing":       # an op of the table left out
        del body[5], dur[5]
    elif fault == "anchor":        # the port's kernels swapped
        body[2], body[4] = K3, K1
    tr = trace(3, body, dur)
    if fault == "one_replay_short":
        tr.ops.pop(10 + 2 + 5)     # the second replay's last op
    run = fake_run(tr, 3)
    for k in ("cull", "march", "shade", "other"):
        assert metric(f"layers.{k}_ms.frame", run) is None, k


def test_eager_calls_or_no_tables_give_nothing(tables):
    assert metric("layers.march_ms.frame",
                  fake_run(trace(3), 3, eager_reruns=1)) is None
    assert metric("layers.march_ms.frame",
                  fake_run(trace(3), 3, replays=2)) is None
    assert metric("layers.march_ms.frame",
                  fake_run(None, 3)) is None
    tables["tables"] = None
    assert metric("layers.march_ms.frame", fake_run(trace(3), 3)) is None


def test_a_program_without_tables(monkeypatch):
    # the parent's port has no ``utils.profiling.graph_layers``
    from benchmark import program
    monkeypatch.setattr(program, "port", lambda: types.SimpleNamespace(
        utils=types.SimpleNamespace()))
    assert layers.graph_tables() is None
    assert metric("layers.cull_ms.frame", fake_run(trace(3), 3)) is None
