"""Port parity, the sharded training step (``parallel/mesh.py::
make_train_step``) on 2 gloo ranks spawned on the CPU, once for the file
(the counterparts of ``tests/test_sharding.py``'s train-step tests, at its
shapes: 16×32, 24 tori, ε 0.02, 64 steps):

* two steps lower the loss, and every rank's scene is the same bit for
  bit after each step (the all-reduced gradients are the same on every
  rank);
* against the port's one-process step (``render`` + ``backward`` + SGD):
  loss rtol 1e-4, ``mat_albedo`` atol 1e-5, as JAX's test holds its own;
* chunked (4 chunks, each all-reduce overlapping the next chunk) against
  monolithic (``grad_chunks=1``): loss rtol 1e-5, leaves atol 1e-6 / rtol
  1e-5;
* against JAX's ``make_train_step`` on a 2-device virtual mesh, the scene
  carried across from JAX's arrays: the summed gradients (recovered from
  a step at ``lr = 2**20``) within 5e-5 of each leaf's largest |g|, the frame-gradient
  bound of ``tests/test_torch_grad.py`` where no lane differs.

Both routes run: "torch" (the dense plain march) and "cuda" (the kernels'
plain versions; 24 tori stay under the culling threshold).

The graph step's glue (``make_train_step`` is one captured CUDA graph a key
and rank on the card): (a) the step's bodies run deferred under
``torch_deferred.NoHostRead`` — the whole step, captured on NCCL, and the
rank's part, captured on gloo — on the culled (threshold 16) and the dense
"cuda" route read nothing on the host and are their eager forms bit for
bit, flag clear; routed as on the card (``torch_deferred.graph_route``),
(b) a flag forced on rank 0 alone (a material repair) at the key's first
call: both ranks run the first run again, no rank captures, both run the
eager step at that call and the next;
(c) replays give the gloo graph's step (the rank's part, then one
``all_reduce``, then the update) bit for bit, within the chunked bound of
the eager step, and a flag forced on rank 0 at a later replay makes both
ranks run the eager step; the graph counts agree on both ranks.

The mesh layer's spans, counters and teardown, in the same world: (d) the
step's spans nest as ``parallel/mesh.py`` opens them, and its collectives
are counted by kind; (e) two steps on the benchmark's seeded fit scene
(``benchmark/configs/tori1000.json`` cut to 24 tori at 16×32) agree with
the plain float64 fit of ``benchmark/reference/fit.py`` within the
single-process bounds above; (f) last, ``mesh.teardown`` releases the
step's graphs and destroys the group, and a second call does nothing.
"""
import json
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import fraytracer_tpu_torch as tft
from fraytracer_tpu_torch.parallel import mesh as tmesh
from fraytracer_tpu_torch.parallel.multihost import run_ranks

ROOT = Path(__file__).resolve().parents[1]
W, H = 16, 32
LR = 1e-4
# a step at this rate recovers its gradients, (s - s') / LR_G: a power of
# two (exact scaling), large (the rounding is one of lr·g, not of s)
LR_G = 2.0 ** 20
CAM = ((0.0, 0.0, -10.0), (0.0, 0.0, 0.0))
ROUTES = ("torch", "cuda")
# (e): the fit cell's seed-drawn start, rate (on the mean) and perturbation
FIT_SEED, FIT_LR, FIT_PERTURB = 2718281828, 0.5, 0.05


def config(route, **march):
    return tft.RenderConfig(width=W, height=H, epsilon=0.02, length=30.0,
                            march=tft.MarchConfig(max_steps=64,
                                                  backend=route, **march))


def camera():
    return tft.look_at(*CAM, fov_degrees=60.0, device="cpu")


def leaves(scene):
    return {k: v.detach().numpy().copy() for k, v in scene.tensors().items()}


def live(scene):
    """The scene on new leaves that require grad (a step body's input)."""
    return scene.with_tensors({k: v.detach().requires_grad_(True)
                               for k, v in scene.tensors().items()})


def _graph_cases(scene, target, mesh):
    """(a), (b) and (c) of the module docstring, on one rank."""
    from fraytracer_tpu_torch.ops import cuda as ops_cuda, deferred
    from fraytracer_tpu_torch.ops import graph as tgraph
    from torch_deferred import forced_repair, graph_route, no_host_read
    cam = camera()
    out = {}
    for name, march in (("culled", {"cull_threshold": 16}),
                        ("dense", {"cull": False})):
        cfg = config("cuda", **march)
        for body in ("_step_overlapped", "_step_local"):
            def run():
                if body == "_step_local":
                    return tmesh._step_local(mesh, 4, live(scene), cam, cfg,
                                             target)
                return tmesh._step_overlapped(mesh, LR, 4, live(scene), cam,
                                              cfg, target)
            want = run()
            frame = deferred.Frame("cpu", mesh.group)
            with no_host_read(), deferred.deferring(frame):
                got = run()
            frame.agree()
            out[f"deferred_{name}{body}"] = (
                all(torch.equal(a, b) for a, b in zip(got, want))
                and len(got) == len(want), bool(frame.flag))
    cfg = config("cuda")
    step = tmesh.make_train_step(cfg, mesh, lr=LR)
    want = step(scene, cam, target)
    with forced_repair(mesh.rank == 0):
        forced = step(scene, cam, target)
    reduced = tmesh._step_reduced(mesh, LR, scene, tmesh._step_local(
        mesh, 4, live(scene), cam, cfg, target))
    graph = (scene.with_tensors(dict(zip(scene.tensors(), reduced[1:]))),
             reduced[0])

    def same(a, b):
        return torch.equal(a[1], b[1]) and all(
            torch.equal(x, y) for x, y in zip(a[0].tensors().values(),
                                              b[0].tensors().values()))

    def call(step, want, force=False):
        with forced_repair(force and mesh.rank == 0):
            return same(step(scene, cam, target), want)
    with graph_route():
        step = tmesh.make_train_step(cfg, mesh, lr=LR)
        calls = [call(step, forced, force=True), call(step, want)]
        out["capture"] = (calls, ops_cuda.graph_counts(), [
            fg.graph is None for fg in step.graphs.values()], tgraph._graphs)
    with graph_route():
        step = tmesh.make_train_step(cfg, mesh, lr=LR)
        calls = [call(step, graph), call(step, graph),
                 call(step, forced, force=True), call(step, graph)]
        out["replay"] = (calls, ops_cuda.graph_counts())
    out["graph_step"] = (float(graph[1]), leaves(graph[0]),
                         float(want[1]), leaves(want[0]))
    return out


def fit_spec() -> dict:
    """The fit cell's configuration cut to 24 tori at 16×32."""
    spec = json.loads((ROOT / "benchmark/configs/tori1000.json").read_text())
    spec["scene"]["n_tori"] = 24
    spec["render"].update(width=W, height=H)
    return spec


def _span_case(scene, target, mesh):
    """(d): one eager step recorded by ``profiling.spans()``: each span's
    name and its parent's index, and the collectives it issued."""
    from fraytracer_tpu_torch.utils import profiling
    step = tmesh.make_train_step(config("cuda", cull_threshold=16), mesh,
                                 lr=LR)
    before = tmesh.counts()
    with profiling.spans() as rec:
        step(scene, camera(), target)
    after = tmesh.counts()
    return ([(r.name, r.parent) for r in rec.records],
            {k: after[k] - before[k] for k in ("all_reduce", "all_gather",
                                               "all_to_all")})


def _reference_case(mesh):
    """(e): the losses (each over the frame's values) and the leaves after
    each of two steps on the fit scene, its target the port's frame."""
    from benchmark import program, scenes
    spec = fit_spec()
    arrays, start = scenes.perturbed(spec, FIT_PERTURB, FIT_SEED)
    cam = program.camera(spec["camera"], "cpu")
    cfg = program.render_config(spec["render"], spec["march"])
    target = tft.render(program.scene(arrays, "cpu"), cam, cfg)
    step = tmesh.make_train_step(cfg, mesh, lr=FIT_LR / target.numel())
    s, losses, states = program.scene(start, "cpu"), [], []
    for _ in range(2):
        s, loss = step(s, cam, target)
        losses.append(float(loss) / target.numel())
        states.append(leaves(s))
    return losses, states


def _teardown_case(scene, target, mesh):
    """(f): a step captured and replayed (``graph_route``), then
    ``teardown`` twice: what each call left."""
    from torch_deferred import graph_route
    with graph_route():
        step = tmesh.make_train_step(config("cuda"), mesh, lr=LR)
        for _ in range(2):
            step(scene, camera(), target)
        captured = [fg.graph is not None for fg in step.graphs.values()]
        before = tmesh.counts()
        t0 = time.perf_counter()
        tmesh.teardown(mesh)
        seconds = time.perf_counter() - t0
        after = tmesh.counts()
        tmesh.teardown(mesh)
        return dict(captured=captured, before=before, after=after,
                    again=tmesh.counts(), seconds=seconds,
                    released=[fg.graph is None
                              for fg in step.graphs.values()],
                    initialized=dist.is_initialized())


def _train_rank(scene, target):
    mesh = tmesh.make_mesh(devices="cpu")
    cam = camera()
    out = {}
    for route in ROUTES:
        cfg = config(route)
        step = tmesh.make_train_step(cfg, mesh, lr=LR)
        s1, l1 = step(scene, cam, target)
        s2, l2 = step(s1, cam, target)
        sm, lm = tmesh.make_train_step(cfg, mesh, lr=LR, grad_chunks=1)(
            scene, cam, target)
        g1, _l = tmesh.make_train_step(cfg, mesh, lr=LR_G)(scene, cam,
                                                           target)
        out[route] = dict(loss=(float(l1), float(l2)), s1=leaves(s1),
                          s2=leaves(s2), mono=leaves(sm), mono_loss=float(lm),
                          grad={k: (leaves(scene)[k] - v) / LR_G
                                for k, v in leaves(g1).items()},
                          requires_grad=any(
                              x.requires_grad for x in s1.tensors().values()))
    out.update(_graph_cases(scene, target, mesh))
    out["spans"] = _span_case(scene, target, mesh)
    out["reference"] = _reference_case(mesh)
    out["teardown"] = _teardown_case(scene, target, mesh)
    return out


@pytest.fixture(scope="module")
def jax_scene():
    import fraytracer_tpu as jft
    from fraytracer_tpu.scene.generators import torus_csg_scene
    return jft.flatten(torus_csg_scene(seed=19, n_tori=24))


@pytest.fixture(scope="module")
def scene(jax_scene):
    from test_torch_grad import port_of
    return port_of(jax_scene)


@pytest.fixture(scope="module")
def target():
    return torch.full((H, W, 3), 0.05)


@pytest.fixture(scope="module")
def ranks(scene, target):
    return run_ranks(_train_rank, 2, scene, target, device="cpu",
                     timeout=300)


@pytest.mark.parametrize("route", ROUTES)
def test_train_step_decreases_loss_and_stays_replicated(ranks, scene, route):
    r0, r1 = (r[route] for r in ranks)
    l1, l2 = r0["loss"]
    assert l2 < l1 and np.isfinite(l2)
    assert r1["loss"] == r0["loss"]
    for s in ("s1", "s2", "mono"):
        for k in r0[s]:
            np.testing.assert_array_equal(r1[s][k], r0[s][k], err_msg=k)
    assert not r0["requires_grad"]
    assert np.abs(r0["s1"]["mat_albedo"]
                  - scene.mat_albedo.detach().numpy()).sum() > 0


@pytest.mark.parametrize("route", ROUTES)
def test_train_step_matches_single_process(ranks, scene, target, route):
    s = scene.with_tensors({k: v.detach().clone().requires_grad_(True)
                            for k, v in scene.tensors().items()})
    img = tft.render(s, camera(), config(route))
    loss = torch.sum((img - target) ** 2)
    loss.backward()
    r0 = ranks[0][route]
    np.testing.assert_allclose(r0["loss"][0], loss.item(), rtol=1e-4)
    want = (s.mat_albedo - LR * s.mat_albedo.grad).detach().numpy()
    np.testing.assert_allclose(r0["s1"]["mat_albedo"], want, atol=1e-5)


@pytest.mark.parametrize("route", ROUTES)
def test_train_step_chunked_overlap_matches_monolithic(ranks, route):
    r0 = ranks[0][route]
    np.testing.assert_allclose(r0["loss"][0], r0["mono_loss"], rtol=1e-5)
    for k in r0["s1"]:
        np.testing.assert_allclose(r0["s1"][k], r0["mono"][k], atol=1e-6,
                                   rtol=1e-5, err_msg=k)


def test_train_step_matches_jax(ranks, jax_scene, target):
    import jax
    import fraytracer_tpu as jft
    from fraytracer_tpu.ops.march import MarchConfig as JMC
    from fraytracer_tpu.parallel.mesh import make_mesh, make_train_step
    from test_torch_grad import assert_leaves_close, jax_grads
    cfg = jft.RenderConfig(width=W, height=H, epsilon=0.02, length=30.0,
                           march=JMC(max_steps=64))
    s1, loss = make_train_step(cfg, make_mesh(2), lr=LR_G)(
        jax_scene, jft.look_at(*CAM, fov_degrees=60.0),
        jax.numpy.asarray(target.numpy()))
    want = jax_grads(jax.tree.map(
        lambda a, b: (np.asarray(a) - np.asarray(b)) / LR_G, jax_scene, s1))
    for route in ROUTES:
        got = ranks[0][route]["grad"]
        assert_leaves_close(got, want, 5e-5)
    np.testing.assert_allclose(ranks[0]["torch"]["loss"][0], float(loss),
                               rtol=1e-4)


@pytest.mark.parametrize("body", ["_step_overlapped", "_step_local"])
@pytest.mark.parametrize("route", ["culled", "dense"])
def test_deferred_step_reads_nothing_on_the_host(ranks, scene, route, body):
    from fraytracer_tpu_torch.ops.cuda import cull
    assert cull._cull_pairs(scene.kind_counts, scene.plan, 16)
    for r in ranks:
        assert r[f"deferred_{route}{body}"] == (True, False)


def test_flag_on_one_rank_at_the_first_step_keeps_every_rank_eager(ranks):
    for r in ranks:
        calls, counts, eager_key, module_graphs = r["capture"]
        assert calls == [True, True] and eager_key == [True]
        # the step keeps its graphs: none in ops/graph.py's
        assert module_graphs == {}
        assert counts == {"captures": 0, "replays": 0, "eager_reruns": 1,
                          "eager_frames": 1}


def test_flag_on_one_rank_at_a_replay_reruns_every_rank(ranks):
    for r in ranks:
        calls, counts = r["replay"]
        assert calls == [True] * 4
        assert counts == {"captures": 1, "replays": 3, "eager_reruns": 1,
                          "eager_frames": 0}
    # the gloo graph's step: the ranks agree, and it is the eager step's
    # within float32 reassociation (chunks summed before ranks)
    a, b = (r["graph_step"] for r in ranks)
    assert a[0] == b[0]
    np.testing.assert_allclose(a[0], a[2], rtol=1e-5)
    for k in a[1]:
        np.testing.assert_array_equal(a[1][k], b[1][k], err_msg=k)
        np.testing.assert_allclose(a[1][k], a[3][k], atol=1e-6, rtol=1e-5,
                                   err_msg=k)


def test_sharded_step_spans_nest_in_the_chunks(ranks):
    for r in ranks:
        records, issued = r["spans"]
        names = [n for n, _p in records]

        def chain(i):
            out = []
            while i is not None:
                out.append(records[i][0])
                i = records[i][1]
            return out
        assert names.count("mesh.chunk") == 4
        # each chunk's gradient all_reduce issued, then the losses' and
        # the waits
        assert names.count("mesh.reduce") == 5
        assert names.count("mesh.update") == 1
        for i, (name, parent) in enumerate(records):
            if name.startswith("mesh."):
                assert parent is None or records[parent][0].startswith(
                    "graph."), name
            elif not name.startswith("graph."):
                # the layers of a chunk's forward and backward
                assert "mesh.chunk" in chain(i), name
        for i in (i for i, (n, _p) in enumerate(records)
                  if n == "mesh.chunk"):
            children = {n for n, p in records if p == i}
            assert {"loss", "vjp", "surface", "shade"} <= children
            under = {n for j, (n, _p) in enumerate(records)
                     if chain(j)[1:].count("mesh.chunk")}
            assert {"march", "cull"} <= under
        assert issued == {"all_reduce": 5, "all_gather": 0, "all_to_all": 0}


def test_sharded_step_matches_the_benchmark_reference(ranks):
    from benchmark import scenes
    from benchmark.reference import fit as ref_fit, render as ref
    spec = fit_spec()
    arrays, start = scenes.perturbed(spec, FIT_PERTURB, FIT_SEED)
    args = (arrays.light_kind, spec["camera"], spec["render"], spec["march"])
    target, _res = ref_fit.frame(ref.leaves_of(arrays, "cpu", torch.float64),
                                 *args)
    losses, _first, states = ref_fit.fit(
        ref.leaves_of(start, "cpu", torch.float64), *args, target, FIT_LR, 2)
    got_losses, got_states = ranks[0]["reference"]
    assert ranks[1]["reference"][0] == got_losses
    np.testing.assert_allclose(got_losses, losses, rtol=1e-4)
    for got, want in zip(got_states, states[1:]):
        np.testing.assert_allclose(got["mat_albedo"],
                                   want["mat_albedo"].numpy(), atol=1e-5)


def test_teardown_releases_the_step_graphs_and_destroys_the_group(ranks):
    for r in ranks:
        t = r["teardown"]
        assert t["captured"] == [True] and t["released"] == [True]
        assert t["after"]["graphs_released"] > t["before"]["graphs_released"]
        assert t["before"]["all_reduce"] > 0
        assert not t["initialized"]
        assert 0 < t["after"]["teardown_s"] <= t["seconds"] < 10
        # a second call does nothing
        assert t["again"] == t["after"]


def test_teardown_wait_past_its_deadline_aborts_and_raises(monkeypatch):
    aborted, hung = threading.Event(), threading.Event()
    monkeypatch.setattr(tmesh, "TEARDOWN_S", 0.2)
    group = types.SimpleNamespace(abort=aborted.set)
    with pytest.raises(TimeoutError, match="destroy_process_group.*aborted"):
        tmesh._bounded("destroy_process_group", hung.wait, group)
    assert aborted.is_set()
    hung.set()
    with pytest.raises(ValueError, match="raised"):
        tmesh._bounded("a wait", lambda: int("raised"), group)
