"""The compiled step's glue on the CPU: ``render.render_value_and_grad`` is
``jax.value_and_grad`` of a loss of the frame, as the JAX package jits it
(``cli fit``, the bench's fwd+bwd).  On the card the step is one captured
CUDA graph a key; here it runs eagerly, and the step the card captures runs
eagerly with its host reads deferred (``ops/deferred.py``).

* (a) ``render_value_and_grad`` against ``jax.value_and_grad`` of the same
  loss (``mean((render - target)²)``, the target seeded numpy), weights
  carried across with ``from_jax_arrays``: the culled and the dense kernel
  path against JAX's Pallas kernels in interpret mode, the plain march
  against ``jnp``.  The loss within rtol 1e-5; the gradients within the
  bounds ``tests/test_torch_grad.py`` holds frames to against JAX: 2% of
  each live leaf's max |g| on the 48-torus frame (hits land elsewhere in
  the ε shell), 5e-5 on the two-primitive frame.
* (b) The deferred step, forward and backward, reads nothing on the host
  (``test_torch_frame_graph.NoHostRead``): the culled and the dense torus
  step, the non-fused culled step on the separated lattice (``point_eval``
  on both sides, the backward's lists of 16 of 100 certified) and
  ``blend96`` (the backward's candidate lists); a step that raises no flag
  is the eager step bit for bit, and the flag is raised exactly where the
  eager step's certificate fails.
* (c) The flag, routed as on the card (the graph step taken on the CPU):
  an overflowing table (``cull_m`` 8) and a failing certificate (lists of
  1) raise it at the key's first step.  The overflowed site (the primary
  march) is promoted to full-group tables and the step runs once more
  deferred: with tables of 8 for the primary march alone that run raises
  no flag and is captured with the site, and that call and the replay are
  the eager step bit for bit.  With tables of 8 everywhere the shadow
  marches overflow in that run, and a failing certificate leaves no site
  to promote: nothing is captured, the call runs again eagerly and the
  key's later steps run eagerly, each equal to the eager step bit for
  bit, and counted.
* (d) A backward driven from a fresh thread, which does not inherit the
  forward's context variables (autograd runs a CUDA backward on a thread of
  its own), still defers to the forward's frame.

Sizes: 32²–64² frames, at most 100 tori."""
import dataclasses
import functools
import importlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fraytracer_tpu as jft
import fraytracer_tpu_torch as tft
from fraytracer_tpu.ops.march import MarchConfig as JMC
from fraytracer_tpu.scene import generators as JG
from fraytracer_tpu_torch.ops import cuda as ops_cuda, deferred, graph
from fraytracer_tpu_torch.ops import point_eval
from fraytracer_tpu_torch.ops.march import MarchConfig as TMC
from fraytracer_tpu_torch.scene import generators as TG, nodes as TN
from test_torch_frame_graph import (CULL, NoHostRead, blend_pair,  # noqa
                                    no_host_read)
from test_torch_grad import (assert_leaves_close, jax_grads, port_of,
                             two_prim_scene)
from test_torch_render import port_camera
from test_torch_scene import scene_pair
from test_torch_vjp import lattice
from torch_deferred import recorded_capture

trender = importlib.import_module("fraytracer_tpu_torch.render")


def mse(img, target):
    return torch.mean((img - target) ** 2)


def sum_sq(img):
    return torch.sum(img ** 2)


def eager_step(loss_fn, scene, cam, cfg, *args):
    """The eager step as ``render_value_and_grad`` returns it."""
    out = graph.eager(functools.partial(trender._step, loss_fn), scene, cam,
                      cfg, args, grad=True)
    return out[0], dict(zip(scene.tensors(), out[1:]))


def assert_same_step(got, want):
    assert torch.equal(got[0], want[0])
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k


# ---------------------------------------------------------------------------
# (a) against jax.value_and_grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,size,jbackend,march", [
    ("tori48", 64, "pallas_interpret", dict(cull=True)),
    ("tori48", 32, "pallas_interpret", dict(cull=False)),
    ("two_prim", 32, "jnp", dict(backend="torch")),
], ids=["culled", "dense", "plain"])
def test_value_and_grad_matches_jax(name, size, jbackend, march):
    if name == "two_prim":
        js = two_prim_scene(jft, jft.flatten)
        eye, steps, rel = (0, 0, -6), 128, 5e-5
    else:
        js = jft.flatten(JG.torus_csg_scene(seed=19, n_tori=48))
        eye, steps, rel = (0, 0, -10), 96, 2e-2
    target = np.random.default_rng(5).uniform(
        0.0, 0.5, (size, size, 3)).astype(np.float32)
    jcam = jft.look_at(eye, (0, 0, 0), fov_degrees=60.0)
    jcfg = jft.RenderConfig(width=size, height=size, march=JMC(
        max_steps=steps, backend=jbackend,
        cull=march.get("cull", True)))
    jloss, g = jax.value_and_grad(lambda s: jnp.mean(
        (jft.render(s, jcam, jcfg) - target) ** 2))(js)
    want = jax_grads(g)
    ts = port_of(js)
    cam = tft.look_at(eye, (0, 0, 0), fov_degrees=60.0, device="cpu")
    cfg = tft.RenderConfig(width=size, height=size,
                           march=TMC(max_steps=steps, **march))
    loss, grads = tft.render_value_and_grad(mse, ts, cam, cfg,
                                            torch.from_numpy(target))
    assert loss.ndim == 0 and not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert grads.keys() == want.keys()
    got = {k: v.numpy() for k, v in grads.items()}
    live = [k for k, v in want.items() if np.abs(v).max() > 0]
    assert {"prim_params/sphere" if name == "two_prim" else
            "prim_params/torus", "mat_albedo", "background"} <= set(live)
    assert_leaves_close(got, want, rel, live)
    # a leaf JAX's gradient does not reach is zero here too
    for k in set(want) - set(live):
        assert not got[k].any(), k
    # the scene's own tensors are not made leaves of autograd
    assert all(x.grad is None and not x.requires_grad
               for x in ts.tensors().values())


# ---------------------------------------------------------------------------
# (b) the deferred step reads nothing on the host
# ---------------------------------------------------------------------------

def lattice_pair(blend=False):
    """The separated lattice of ``test_torch_vjp`` (100 tori), the port's
    scene, with the fov-20 camera that keeps hits near the tori."""
    ts = tft.flatten(lattice(TN, TG, side=10, blend=blend), device="cpu")
    return ts, tft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=20.0,
                           device="cpu")


def step_case(name):
    """(scene, camera, config) of a named step."""
    cam = port_camera()
    march = dict(backend="cuda", **CULL)
    if name == "culled":
        ts = scene_pair("torus96")[1]
    elif name == "dense":
        ts = scene_pair("torus96")[1]
        march = dict(backend="cuda", cull=False, relax_omega=1.4)
    elif name == "lattice_nonfused":
        # the forward's normals and materials through culled_surface_eval,
        # the backward's hit distance through lists of 16 of 100
        ts, cam = lattice_pair()
        march.update(fuse_surface=False, bwd_cull_m=16)
    elif name == "blend":
        ts = blend_pair()[1]
    elif name == "blend_lattice":
        # the backward's lists of 32 of 101 certify at 32²
        ts, cam = lattice_pair(blend=True)
        march.update(bwd_cull_m=32)
    elif name == "blend_lattice_m1":
        # lists of 1 can certify nothing: the certificate fails
        ts, cam = lattice_pair(blend=True)
        march.update(bwd_cull_m=1)
    elif name == "overflow":
        ts = scene_pair("torus96")[1]
        march.update(cull_m=8, cull_m_shadow=8)
    elif name == "overflow_primary":
        # tables of 8 for the primary march alone
        ts = scene_pair("torus96")[1]
        march.update(cull_m=8, cull_m_shadow=96)
    else:
        raise ValueError(name)
    return ts, cam, tft.RenderConfig(width=32, height=32,
                                     march=TMC(**march))


def stats_delta(fn):
    before = dict(point_eval.STATS)
    out = fn()
    return out, {k: point_eval.STATS[k] - before[k] for k in before}


@pytest.mark.parametrize("name", ["culled", "dense", "lattice_nonfused",
                                  "blend"])
def test_deferred_step_reads_nothing_on_the_host(no_host_read, name):
    ts, cam, cfg = step_case(name)
    # the eager step fills the caches of device constants, as the graph
    # step's first call does before its capture
    want, route = stats_delta(lambda: eager_step(sum_sq, ts, cam, cfg))
    frame = deferred.Frame("cpu")
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in ts.tensors().items()}
    with no_host_read, deferred.deferring(frame):
        out, deferred_route = stats_delta(lambda: trender._step(
            sum_sq, ts.with_tensors(leaves), cam, cfg))
    assert deferred_route == {k: 0 for k in route}
    got = (out[0], dict(zip(ts.tensors(), out[1:])))
    if name == "lattice_nonfused":
        # one certificate in the forward, one in the backward, both pass
        assert route == {"certificate_reads": 2, "culled": 2, "dense": 0}
    elif name == "blend":
        assert route["certificate_reads"] == 1
    else:
        assert route["certificate_reads"] == 0
    # the flag is raised exactly where the eager step took a dense branch
    assert bool(frame.flag) == (route["dense"] > 0)
    if not bool(frame.flag):
        assert_same_step(got, want)
    assert float(want[1]["prim_params/torus"].abs().sum()) > 0


# ---------------------------------------------------------------------------
# (c) the flag, routed as on the card
# ---------------------------------------------------------------------------

def routed_steps(monkeypatch, ts, cam, cfg, calls=2):
    """``calls`` steps of ``render_value_and_grad`` routed as on the card
    (the graph step taken on the CPU, a capture recorded: ``recorded``,
    the promoted sites each capture saw), from counts of 0: ``(steps,
    graph counts, the key's graph, recorded)``."""
    recorded = []

    def capture(self):
        recorded.append(self.frame.promoted)
        recorded_capture(self)
    monkeypatch.setattr(graph, "capturable", lambda *a: True)
    monkeypatch.setattr(graph, "_graphs", {})
    monkeypatch.setattr(graph._FrameGraph, "_capture", capture)
    ops_cuda.reset_launch_counts()
    steps = [tft.render_value_and_grad(sum_sq, ts, cam, cfg)
             for _ in range(calls)]
    counts = ops_cuda.graph_counts()
    ops_cuda.reset_launch_counts()
    return steps, counts, trender.step_graph(sum_sq, ts, cam, cfg), recorded


def first_step_sites(ts, cam, cfg):
    """The sites the key's first run, deferred, saw overflow; it raises
    the flag."""
    frame = deferred.Frame("cpu")
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in ts.tensors().items()}
    with deferred.deferring(frame):
        trender._step(sum_sq, ts.with_tensors(leaves), cam, cfg)
    assert bool(frame.flag)
    return frame.overflowed_sites()


@pytest.mark.parametrize("name", ["overflow", "blend_lattice_m1"])
def test_flagged_step_reruns_eagerly(monkeypatch, name):
    ts, cam, cfg = step_case(name)
    want = eager_step(sum_sq, ts, cam, cfg)
    sites = first_step_sites(ts, cam, cfg)
    # the overflow's primary march, promoted; the certificate leaves none
    assert sites == ({0} if name == "overflow" else set())
    if name == "blend_lattice_m1":
        # the certificate, not the forward, raised it: lists of 32 do not
        _ts, _cam, ok_cfg = step_case("blend_lattice")
        frame = deferred.Frame("cpu")
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in ts.tensors().items()}
        with deferred.deferring(frame):
            trender._step(sum_sq, ts.with_tensors(leaves), cam, ok_cfg)
        assert not bool(frame.flag)
    steps, counts, fg, recorded = routed_steps(monkeypatch, ts, cam, cfg)
    for got in steps:
        assert_same_step(got, want)
    assert fg.graph is None and not recorded
    assert fg.frame.promoted == sites and bool(fg.frame.flag)
    assert counts == {"captures": 0, "replays": 0, "eager_reruns": 1,
                      "eager_frames": 1}


def test_overflowing_step_captures_the_promoted_step(monkeypatch):
    ts, cam, cfg = step_case("overflow_primary")
    want = eager_step(sum_sq, ts, cam, cfg)
    sites = first_step_sites(ts, cam, cfg)
    assert sites == {0}
    steps, counts, fg, recorded = routed_steps(monkeypatch, ts, cam, cfg)
    for got in steps:
        assert_same_step(got, want)
    assert recorded == [sites] and fg.frame.promoted == sites
    assert fg.graph is not None and not bool(fg.frame.flag)
    assert counts == {"captures": 1, "replays": 1, "eager_reruns": 0,
                      "eager_frames": 0}


def step_key(loss_fn, scene, cam, cfg, *args):
    """The key ``render_value_and_grad`` keeps a step under."""
    return graph.key("step", scene, cam, cfg, args, (loss_fn,))


def test_step_key():
    """A step's key is its frame's static parts, the loss function and the
    args' shapes, dtypes and devices; never a value."""
    ts, cam, cfg = step_case("culled")
    t = torch.zeros(32, 32, 3)
    key = step_key(mse, ts, cam, cfg, t)
    moved = {k: v + 0.25 for k, v in ts.tensors().items()}
    assert step_key(mse, ts.with_tensors(moved), cam, cfg, t + 1) == key
    assert step_key(sum_sq, ts, cam, cfg) != key
    assert step_key(mse, ts, cam, cfg, torch.zeros(32, 32, 4)) != key
    assert step_key(mse, ts, cam, dataclasses.replace(
        cfg, width=64), t) != key
    assert graph.key("frame", ts, cam, cfg) not in (key, step_key(
        sum_sq, ts, cam, cfg))
    # the CPU stays eager
    assert not graph.capturable(ts, cam, cfg, (t,), grad=True)


# ---------------------------------------------------------------------------
# (d) the backward on another thread
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["certificate", "checkpoint"])
def test_backward_on_another_thread_defers_to_the_forward_frame(
        no_host_read, case):
    """Autograd runs the backward of CUDA tensors on a worker thread of its
    own, where a context variable set around the forward is unset.  Here
    the forward runs deferred on this thread and the backward on a fresh
    ``threading.Thread`` under ``NoHostRead``; the backward must still run
    in the forward's frame.  ``certificate``: the backward's candidate
    lists (lists of 1 never certify) read no certificate, raise the frame's
    flag and keep their device constants in that frame.  ``checkpoint``:
    the frame traced in two checkpointed ray tiles (``tile_rays_pallas``),
    whose recomputation in the backward (marches, material repair) reads
    nothing on the host either."""
    if case == "certificate":
        ts, cam, cfg = step_case("blend_lattice_m1")
    else:
        ts, cam, cfg = step_case("culled")
        cfg = dataclasses.replace(cfg, tile_rays_pallas=512)
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in ts.tensors().items()}
    # the eager step, on this thread
    want = torch.autograd.grad(
        sum_sq(trender._frame(ts.with_tensors(leaves), cam, cfg)[0]),
        list(leaves.values()), allow_unused=True)
    frame = deferred.Frame("cpu")
    with deferred.deferring(frame):
        img, _n = trender._frame(ts.with_tensors(leaves), cam, cfg)
        loss = sum_sq(img)
    assert not bool(frame.flag)
    kept = set(frame.constants)
    before = dict(point_eval.STATS)
    out = {}

    def backward():
        assert deferred.current() is None
        with no_host_read:
            out["grads"] = torch.autograd.grad(
                loss, list(leaves.values()), allow_unused=True)
    worker = threading.Thread(target=backward)
    worker.start()
    worker.join()
    assert "grads" in out, "the backward failed"
    assert point_eval.STATS == before, "the backward read the certificate"
    if case == "certificate":
        assert bool(frame.flag)
        assert {key[0].__name__ for key in set(frame.constants) - kept} >= {
            "_layout_on"}
    else:
        assert not bool(frame.flag)
        for a, b in zip(out["grads"], want):
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b)
