"""The port's spans and layer tables (``fraytracer_tpu_torch/utils/
profiling.py``): the shared no-op while nothing watches, the ``ft.*``
ranges a profiler sees in an eager frame and step, the recorder, and the
layer table of a capture, here driven by a fake node counter (a CPU
cannot capture a graph).  The test marked ``cuda`` holds the table of a
real capture against the profiled replay on the card.

Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py
"""
import importlib
import threading

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import fraytracer_tpu_torch as ft
from fraytracer_tpu_torch.scene.generators import (spectral_csg_scene,
                                                   torus_csg_scene)
from fraytracer_tpu_torch.utils import profiling as P

trender = importlib.import_module("fraytracer_tpu_torch.render")


def _small(device="cpu", n_tori=64, size=32):
    scene = ft.flatten(torus_csg_scene(19, n_tori), device=device)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), device=device)
    cfg = ft.RenderConfig(width=size, height=size, march=ft.MarchConfig(
        relax_omega=1.4))
    return scene, cam, cfg


def _mse(img):
    return torch.mean(img ** 2)


def _mse_to(img, target):
    return torch.mean((img - target) ** 2)


def _ft_events(prof):
    return sorted(((e.name[len(P.PREFIX):], e.time_range.start,
                    e.time_range.end) for e in prof.events()
                   if e.name.startswith(P.PREFIX)
                   and e.device_type == DeviceType.CPU),
                  key=lambda e: e[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_off_is_the_shared_noop():
    s = P.span("march")
    assert s is P.span("march") and s is not P.span("cull")
    with s as entered:
        assert entered is s
    # an object taken while nothing watched stays a no-op under a profiler
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with s:
            torch.zeros(4).add_(1)
        assert P.span("march") is not s
    assert _ft_events(prof) == []
    assert P.span("march") is s


def test_decorator_spans_each_call():
    @P.span("cull")
    def build(x):
        return x + 1

    assert build(1) == 2
    with P.spans() as rec:
        build(1)
        build(2)
    assert [r.name for r in rec.records] == ["cull", "cull"]


def test_profiler_sees_nested_spans_in_an_eager_frame_and_step():
    scene, cam, cfg = _small()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ft.render_with_stats(scene, cam, cfg)
    ev = _ft_events(prof)
    names = [e[0] for e in ev]
    assert names[:2] == ["frame", "graph.key"]
    frame = ev[0]
    by = {n: [e for e in ev if e[0] == n] for n in set(names)}
    assert len(by["march"]) == 3 and len(by["cull"]) == 3
    assert all(_inside(e, frame) for e in ev[1:])
    surface, shade = by["surface"][0], by["shade"][0]
    assert surface[2] <= shade[1]
    # the primary march in the surface pass, the shadow marches in the
    # shading, each site's table build in its march
    assert _inside(by["march"][0], surface)
    assert all(_inside(m, shade) for m in by["march"][1:])
    assert all(_inside(c, m) for c, m in zip(by["cull"], by["march"]))

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ft.render_value_and_grad(_mse, scene, cam, cfg)
    ev = _ft_events(prof)
    step = ev[0]
    assert step[0] == "step" and all(_inside(e, step) for e in ev[1:])
    order = [e[0] for e in ev if e[0] in ("march", "loss", "vjp")]
    assert order == ["march", "march", "march", "loss", "vjp"]


def test_recorder_keeps_parents_and_times():
    scene, cam, cfg = _small()
    with P.spans() as rec:
        with P.span("outer"):
            with P.span("inner"):
                pass
        ft.render_with_stats(scene, cam, cfg)
    assert P.span("outer") is P.span("outer")
    rows = rec.records
    assert rows[0].name == "outer" and rows[0].parent is None
    assert rows[1] == (("inner", 0) + rows[1][2:])
    for r in rows:
        assert 0 < r.start_ns <= r.end_ns
        if r.parent is not None:
            p = rows[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    names = [r.name for r in rows]
    frame = names.index("frame")
    assert rows[frame].parent is None
    cull = [r for r in rows if r.name == "cull"]
    assert len(cull) == 3 and all(rows[r.parent].name == "march"
                                  for r in cull)
    tot = rec.totals()
    assert tot["march"]["calls"] == 3 and tot["cull"]["calls"] == 3
    assert all(0 <= t["self_ns"] <= t["ns"] for t in tot.values())
    assert tot["frame"]["self_ns"] < tot["frame"]["ns"]


class FakeCounter:
    """Stands in for the capture's node counter: ``issue(kinds)`` adds
    ops."""

    def __init__(self):
        self.ops = ""

    def issue(self, kinds):
        self.ops += kinds

    def count(self):
        return len(self.ops)

    def kinds(self):
        return self.ops


def test_layer_table_nesting_self_counts_and_anchors():
    c = FakeCounter()
    with P.capture_layers("step", counter=c) as t:
        c.issue("ks")                          # the flag, camera rays
        with P.span("march"):
            c.issue("k")
            with P.span("cull"):
                c.issue("kkc")
            c.issue("k")
            P.anchor("march_kernel")
        c.issue("k")
        with P.span("vjp"):
            # the backward opens its spans on autograd's own thread while
            # this one waits: they nest under vjp all the same
            def backward():
                with P.span("cull"):
                    c.issue("kk")
                c.issue("c")
            th = threading.Thread(target=backward)
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()
        c.issue("k")
    assert t.layers == [["march", None, 2, 5], ["cull", 0, 3, 3],
                        ["vjp", None, 8, 3], ["cull", 2, 8, 2]]
    assert t.anchors == [(6, "march_kernel")]
    assert t.kinds == "kskkkckkkkck" and t.n_ops == 12
    assert t.self_ops() == {"": 4, "march": 2, "cull": 5, "vjp": 1}
    # outside the capture the spans are off again
    assert P.span("march") is P.span("march")
    listed = [d for d in P.graph_layers() if d["layers"] == [
        ("march", None, 2, 5), ("cull", 0, 3, 3), ("vjp", None, 8, 3),
        ("cull", 2, 8, 2)]]
    assert len(listed) == 1 and listed[0]["name"] == "step"
    assert listed[0]["replays"] == 0 and listed[0]["n_ops"] == 12


def test_failed_capture_lists_no_table():
    c = FakeCounter()
    before = len(P.graph_layers())
    with pytest.raises(RuntimeError):
        with P.capture_layers("frame", counter=c):
            with P.span("march"):
                c.issue("k")
                raise RuntimeError("capture failed")
    assert len(P.graph_layers()) == before
    assert P.span("march") is P.span("march")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _kind(name):
    # a graph may run a memcpy node as one of the driver's copy kernels
    return "c" if name.startswith(("Memcpy", "memcpy")) else \
        "s" if name.startswith("Memset") else "k"


def _short(name):
    return name.split("(")[0].replace("void ", "").split("<")[0].strip()


def _call(kind, dev):
    """A call of ``kind`` (frame, step, spectral) on a small scene, and its
    graph once the key is captured."""
    if kind == "spectral":
        scene = ft.flatten(spectral_csg_scene(19, 96), device=dev)
        cam = ft.look_at((0, 0, -10), (0, 0, 0), device=dev)
        cfg = ft.WavefrontConfig(depth=3, num_bins=4,
                                 march=ft.MarchConfig(relax_omega=1.4))

        def call():
            return ft.render_spectral_with_stats(scene, cam, 64, 64, cfg)

        def graph():
            return trender.spectral_graph(scene, cam, 64, 64, cfg)
        return call, graph
    scene, cam, cfg = _small(dev, n_tori=96, size=128)
    if kind == "frame":
        return (lambda: ft.render_with_stats(scene, cam, cfg),
                lambda: trender.frame_graph(scene, cam, cfg))
    target = torch.zeros((128, 128, 3), device=dev)

    def step():
        loss, grads = ft.render_value_and_grad(_mse_to, scene, cam, cfg,
                                               target)
        return (loss,) + tuple(grads.values())
    return step, lambda: trender.step_graph(_mse_to, scene, cam, cfg, target)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["frame", "step", "spectral"])
def test_replay_ops_are_the_layer_table(dev, kind):
    """One replay under the profiler: the graph's device ops are exactly
    the table's (their number, each op's kind, the port's kernels at the
    anchors), the replay's other ops are copies, and its outputs are
    those of a replay without the profiler; the table build's two kernels
    are anchors of each culled site's `cull` entry."""
    trender._graphs.clear()
    call, graph = _call(kind, dev)
    call()
    fg = graph()
    assert fg is not None and fg.graph is not None and fg.layers is not None
    want = call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = call()
        torch.cuda.synchronize()
    for a, b in zip(got, want):
        # the frame is bit for bit; the backward's and the bounce image's
        # atomic adds sum in another order
        assert torch.equal(a, b) if kind == "frame" else torch.allclose(
            a.double(), b.double(), rtol=1e-5,
            atol=2e-4 * float(b.abs().max()))
    ops = sorted(((e.name, e.time_range.start) for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation), key=lambda o: o[1])
    t = fg.layers
    assert t.replays == 2 and t.n_ops == len(t.kinds) > 0
    a0, k0 = t.anchors[0]
    starts = [i - a0 for i, (n, _s) in enumerate(ops) if _short(n) == k0]
    hits = [p for p in starts if p >= 0 and p + t.n_ops <= len(ops)
            and "".join(_kind(n) for n, _s in ops[p:p + t.n_ops]) == t.kinds
            and all(_short(ops[p + a][0]) == k for a, k in t.anchors)]
    assert len(hits) == 1, (len(ops), t.n_ops, starts)
    p = hits[0]
    # outside the graph a replay copies: its inputs in, its outputs out,
    # the flag to the host
    outside = ops[:p] + ops[p + t.n_ops:]
    assert all(_kind(n) == "c" for n, _s in outside), outside
    assert 0 < len(outside) <= len(fg.inputs) + len(fg.outputs) + 1
    # every kernel of the port in the block is an anchor
    port = {k for _a, k in t.anchors}
    assert sorted(i for i, (n, _s) in enumerate(ops[p:p + t.n_ops])
                  if _short(n) in port) == [a for a, _k in t.anchors]
    # the table build's kernels: a cones and a select launch inside a
    # `cull` entry before each culled march launch, nothing else there
    culls = [(first, first + n) for name, _par, first, n in t.layers
             if name == "cull"]
    build = [(a, k) for a, k in t.anchors if k.startswith("cull_")]
    marches = [a for a, k in t.anchors if k == "march_kernel"]
    assert [k for _a, k in build] == \
        ["cull_cones_kernel", "cull_select_kernel"] * len(marches)
    for (a0, _k0), (a1, _k1) in zip(build[::2], build[1::2]):
        lo, hi = next(c for c in culls if c[0] <= a0 < c[1])
        assert lo <= a1 < hi
    assert all(b < m for (b, _k), m in zip(build[1::2], marches))
