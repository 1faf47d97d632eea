"""Port parity, the sharded frame (``fraytracer_tpu_torch/parallel/mesh.py``)
on gloo ranks spawned on the CPU: 2 ranks (32-row bands of a 64² frame)
and 4 ranks (16-row bands), started once each for the file.

* ``render_sharded`` gathered against the port's one-process ``render``,
  bit for bit on the "torch" route and, with bands of whole 32×32 blocks
  (the 96-torus scene, culled), on the "cuda" route; 16-row bands are not
  blocked, their tiles differ from the frame's, and they meet the culled
  ε-shell bounds of ``tests/test_torch_render.py`` (pixels at |Δ| ≥ 2e-3
  are hit or shadow flips or shell hits: ≤ 1% of the frame, median < 1e-5);
* against JAX's ``render_sharded`` on the 8-device virtual mesh (2
  devices), the scene carried across from JAX's arrays, with the
  cross-framework frame bounds: outcome flips ≤ 0.5% of pixels, max |Δ|
  < 2e-3 off them, median < 1e-5;
* the rows-must-divide error, the exposure max (rtol 1e-6);
* the graph frame's glue on the 2 ranks (``render_sharded`` is one captured
  CUDA graph a key and rank on the card): (a) the band's frame run
  deferred under ``torch_deferred.NoHostRead``, culled and dense, reads
  nothing on the host and is its eager form bit for bit, flag clear;
  routed as on the card (``torch_deferred.graph_route``) at 32², a flag
  forced on rank 0 alone (a material repair) (b) at the key's first call:
  both ranks run the first run again, no rank captures, both run the
  eager frame at that call and the next, (c) at a later replay: both run
  the eager frame again; each call is its eager
  frame bit for bit and the graph counts agree on both ranks.

The ranks import this module; JAX is imported only in the test process.
"""
import numpy as np
import pytest
import torch

import fraytracer_tpu_torch as tft
from fraytracer_tpu_torch.parallel import mesh as tmesh
from fraytracer_tpu_torch.parallel.multihost import run_ranks

SIZE = 64
CAM = ((0.0, 0.0, -10.0), (0.0, 0.0, 0.0))


def config(backend, height=SIZE, width=SIZE, **march):
    return tft.RenderConfig(width=width, height=height, epsilon=0.01,
                            length=30.0,
                            march=tft.MarchConfig(backend=backend,
                                                  relax_omega=1.4, **march))


def camera():
    return tft.look_at(*CAM, fov_degrees=60.0, device="cpu")


def _render_rank(scene):
    """One rank: its rows of the frame on both routes, the exposure max
    and the rows-must-divide error."""
    mesh = tmesh.make_mesh(devices="cpu")
    assert mesh.axis == "rays" and mesh.backend == "gloo"
    out = {"rank": mesh.rank, "size": mesh.size}
    for route in ("torch", "cuda"):
        img = tmesh.render_sharded(scene, camera(), config(route), mesh)
        out[route] = img.numpy()
    out["max"] = float(tmesh.exposure_max_sharded(torch.from_numpy(
        out["cuda"]), mesh))
    try:
        tmesh.render_sharded(scene, camera(), config("cuda", SIZE - 1),
                             mesh)
    except ValueError as e:
        out["divide_error"] = str(e)
    if mesh.size == 2:
        out.update(_graph_cases(scene, mesh))
    return out


def _graph_cases(scene, mesh):
    """One of 2 ranks: (a), (b) and (c) of the module docstring."""
    from fraytracer_tpu_torch.ops import cuda as ops_cuda, deferred
    from fraytracer_tpu_torch.ops import graph
    from torch_deferred import forced_repair, graph_route, no_host_read
    cam = camera()
    out = {}
    for name, march in (("culled", {}), ("dense", {"cull": False})):
        cfg = config("cuda", **march)
        want, wn = tmesh._band_frame(mesh, scene, cam, cfg)
        frame = deferred.Frame("cpu", mesh.group)
        with no_host_read(), deferred.deferring(frame):
            img, n = tmesh._band_frame(mesh, scene, cam, cfg)
        frame.agree()
        out[f"deferred_{name}"] = (torch.equal(img, want)
                                   and int(n) == int(wn), bool(frame.flag))
    cfg = config("cuda", 32, 32)
    want = tmesh.render_sharded(scene, cam, cfg, mesh)
    with forced_repair(mesh.rank == 0):
        forced = tmesh.render_sharded(scene, cam, cfg, mesh)

    def call(want, force=False):
        with forced_repair(force and mesh.rank == 0):
            return torch.equal(tmesh.render_sharded(scene, cam, cfg, mesh),
                               want)
    with graph_route():
        same = [call(forced, force=True), call(want)]
        out["capture"] = (same, ops_cuda.graph_counts(), [
            fg.graph is None for fg in graph._graphs.values()])
    with graph_route():
        same = [call(want), call(want), call(forced, force=True),
                call(want)]
        out["replay"] = (same, ops_cuda.graph_counts())
    return out


@pytest.fixture(scope="module")
def jax_scene():
    import fraytracer_tpu as jft
    from fraytracer_tpu.scene.generators import torus_csg_scene
    return jft.flatten(torus_csg_scene(seed=19, n_tori=96))


@pytest.fixture(scope="module")
def scene(jax_scene):
    from test_torch_grad import port_of
    return port_of(jax_scene)


@pytest.fixture(scope="module")
def ranks(scene):
    """{2: [rank reports], 4: [...]}: the ranks spawned once per size."""
    return {n: run_ranks(_render_rank, n, scene, device="cpu",
                         timeout=300) for n in (2, 4)}


@pytest.fixture(scope="module")
def single(scene):
    return {route: tft.render(scene, camera(), config(route)).numpy()
            for route in ("torch", "cuda")}


def gathered(reports, route):
    return np.concatenate([r[route] for r in reports])


def test_bands_of_whole_blocks_equal_the_frame(ranks, single, scene):
    from fraytracer_tpu_torch.ops.cuda import cull
    assert cull._cull_pairs(scene.kind_counts, scene.plan, 48)
    reports = ranks[2]
    assert [r["rank"] for r in reports] == [0, 1]
    assert [r["cuda"].shape for r in reports] == [(32, SIZE, 3)] * 2
    for route in ("torch", "cuda"):
        np.testing.assert_array_equal(gathered(reports, route),
                                      single[route])


def test_bands_of_16_rows_meet_the_shell_bounds(ranks, single):
    reports = ranks[4]
    assert [r["cuda"].shape for r in reports] == [(16, SIZE, 3)] * 4
    np.testing.assert_array_equal(gathered(reports, "torch"),
                                  single["torch"])
    diff = np.abs(gathered(reports, "cuda") - single["cuda"]).max(-1)
    assert (diff >= 2e-3).mean() <= 0.01
    assert float(np.median(diff)) < 1e-5


def test_matches_jax_render_sharded(ranks, jax_scene, scene):
    import fraytracer_tpu as jft
    from fraytracer_tpu.ops.march import MarchConfig as JMC
    from fraytracer_tpu.parallel.mesh import make_mesh, render_sharded
    from test_torch_render import jax_masks, port_masks
    jcfg = JMC(backend="jnp", relax_omega=1.4)
    jimg = np.asarray(render_sharded(
        jax_scene, jft.look_at(*CAM, fov_degrees=60.0),
        jft.RenderConfig(width=SIZE, height=SIZE, epsilon=0.01,
                         length=30.0, march=jcfg), make_mesh(2)))
    timg = gathered(ranks[2], "torch")
    flipped = np.zeros((SIZE, SIZE), bool)
    for a, b in zip(jax_masks(jax_scene, jcfg, SIZE, SIZE),
                    port_masks(scene, config("torch").march, SIZE, SIZE)):
        flipped |= a != b
    assert flipped.mean() <= 0.005
    diff = np.abs(timg - jimg).max(-1)
    assert diff[~flipped].max() < 2e-3
    assert float(np.median(diff)) < 1e-5


def test_rows_must_divide(ranks):
    for reports in ranks.values():
        for r in reports:
            assert "must divide by mesh size" in r["divide_error"]


def test_exposure_allreduce_max(ranks):
    for reports in ranks.values():
        want = gathered(reports, "cuda").max()
        for r in reports:
            np.testing.assert_allclose(r["max"], want, rtol=1e-6)


@pytest.mark.parametrize("route", ["culled", "dense"])
def test_deferred_band_frame_reads_nothing_on_the_host(ranks, route):
    for r in ranks[2]:
        assert r[f"deferred_{route}"] == (True, False)


def test_flag_on_one_rank_at_the_first_call_keeps_every_rank_eager(ranks):
    for r in ranks[2]:
        same, counts, eager_key = r["capture"]
        assert same == [True, True] and eager_key == [True]
        assert counts == {"captures": 0, "replays": 0, "eager_reruns": 1,
                          "eager_frames": 1}


def test_flag_on_one_rank_at_a_replay_reruns_every_rank(ranks):
    for r in ranks[2]:
        same, counts = r["replay"]
        assert same == [True] * 4
        assert counts == {"captures": 1, "replays": 3, "eager_reruns": 1,
                          "eager_frames": 0}


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialize"):
        tmesh.make_mesh(devices="cpu")
