"""Port parity, the sharded spectral wavefront (``parallel/mesh.py::
render_spectral_sharded``) on gloo ranks spawned on the CPU, once for the
file:

* 2 ranks, ``rebalance=False``, against the port's one-process
  ``render_spectral``: on the "torch" route (24 tori, 16×32, depth 2, the
  shapes of ``tests/test_sharding.py``) within 1e-5 — the sharded queue
  has no shared primary round, the frame is the same; on the "cuda" route
  (``spectral_csg_scene(19, 64)``, 32×64: bands of whole 32×32 blocks,
  culled marches, the block-tier compaction) against the same queue on a
  1-rank mesh and against ``render_spectral``, within the mean of the
  culled spectral bound of ``tests/test_torch_wavefront_culled.py`` (the
  test says why not its max);
* 4 ranks on JAX's asymmetric sphere-and-plane scene
  (``tests/test_sharding.py:125-161``, the rebalanced exchange at work):
  the rebalanced frame equals the local one within 1e-5 on both routes,
  its live lanes are spread more evenly (imbalance < 1.5 and no worse than
  with local queues), and the per-rank counts on the "torch" route are
  within 0.5% of JAX's on a 4-device mesh;
* the graph spectral frame's glue on the 2 ranks (one captured CUDA graph a
  key and rank on the card): (a) the rank's rounds (the body captured on
  gloo) and the whole rebalanced frame (captured on NCCL, its exchanges
  inside), run deferred under ``torch_deferred.NoHostRead`` on the culled
  scene at 16² (depth 3), read nothing on the host and are their eager forms bit for bit,
  flag clear; routed as on the card (``torch_deferred.graph_route``), (b) a
  flag forced on rank 0 alone (a material repair) at the key's first call:
  both ranks run the promoted second run (two deferred runs each), no rank
  captures, both run the eager frame at that call and the next; (c) a
  capture and a replay (the counts' ``all_gather`` after it) give the
  eager frame bit for bit; the graph counts agree on both ranks.
"""
import numpy as np
import pytest
import torch

import fraytracer_tpu_torch as tft
from fraytracer_tpu_torch.parallel import mesh as tmesh
from fraytracer_tpu_torch.parallel.multihost import run_ranks
from fraytracer_tpu_torch.scene import generators as TG

CAM = ((0.0, 0.0, -10.0), (0.0, 0.0, 0.0))
TORUS = dict(width=16, height=32, depth=2, epsilon=0.02, max_steps=48)
CULLED = dict(width=32, height=64, depth=3, epsilon=0.01, max_steps=192)
ASYM = dict(width=16, height=32, depth=3, epsilon=1e-3, max_steps=96)
# the graph glue's frames: the culled scene, 8-row bands (not blocked)
GLUE = dict(width=16, height=16, depth=3, epsilon=0.01, max_steps=96)


def wcfg(route, case):
    return tft.WavefrontConfig(
        depth=case["depth"], epsilon=case["epsilon"], length=30.0,
        march=tft.MarchConfig(max_steps=case["max_steps"], backend=route))


def camera():
    return tft.look_at(*CAM, fov_degrees=60.0, device="cpu")


def asymmetric(N):
    """A glass sphere near the top rows and a floor: secondary rays start
    on few ranks only (``tests/test_sharding.py:134-143``)."""
    return N.Scene(
        root=N.union(
            N.sphere((0, 0.9, 0), 0.8, material=N.dielectric(ior=1.5)),
            N.plane((0, 1, 0), -1.4, material=N.solid(0.7, 0.7, 0.7))),
        lights=[N.directional_light((0.3, -1.0, 0.5), (1.0, 1.0, 1.0))],
        background=(0.05, 0.05, 0.08))


def scenes():
    return {"torus": tft.flatten(TG.torus_csg_scene(19, 24), device="cpu"),
            "culled": tft.flatten(TG.spectral_csg_scene(19, 64),
                                  device="cpu"),
            "asym": tft.flatten(asymmetric(tft), device="cpu")}


def _spectral_rank(runs):
    """One rank: each run's rows and counts; a run on a mesh of fewer
    ranks than the world (``n``) reports on its members only."""
    sc = scenes()
    out = {}
    for name, scene_name, case, route, rebalance, n in runs:
        mesh = tmesh.make_mesh(n, devices="cpu")
        if mesh is None:
            continue
        img, counts = tmesh.render_spectral_sharded(
            sc[scene_name], camera(), case["width"], case["height"],
            wcfg(route, case), mesh, rebalance=rebalance)
        out[name] = (img.numpy(), counts.numpy())
    if any(run[0] == "cuda" for run in runs):
        out.update(_graph_cases(sc["culled"]))
    return out


def _graph_cases(scene):
    """(a), (b) and (c) of the module docstring, on one of 2 ranks."""
    from fraytracer_tpu_torch.ops import cuda as ops_cuda, deferred
    from fraytracer_tpu_torch.ops import graph
    from torch_deferred import (forced_repair, graph_route, no_host_read,
                                patched)
    mesh = tmesh.make_mesh(devices="cpu")
    cam, w, h, cfg = camera(), GLUE["width"], GLUE["height"], \
        wcfg("cuda", GLUE)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    out = {}
    for body, rebalance in ((tmesh._spectral_rounds, False),
                            (tmesh._spectral_band, True)):
        want = body(mesh, w, h, rebalance, scene, cam, cfg)
        frame = deferred.Frame("cpu", mesh.group)
        with no_host_read(), deferred.deferring(frame):
            got = body(mesh, w, h, rebalance, scene, cam, cfg)
        frame.agree()
        out[f"deferred_{body.__name__}"] = (same(got, want), bool(frame.flag))
    want = tmesh.render_spectral_sharded(scene, cam, w, h, cfg, mesh)
    with forced_repair(mesh.rank == 0):
        forced = tmesh.render_spectral_sharded(scene, cam, w, h, cfg, mesh)
    runs = []
    real_run = graph._FrameGraph._run

    def counted(self, agree):
        runs.append(agree)
        return real_run(self, agree)

    def call(want, force=False):
        with forced_repair(force and mesh.rank == 0):
            return same(tmesh.render_spectral_sharded(scene, cam, w, h, cfg,
                                                      mesh), want)
    with graph_route(), patched([(graph._FrameGraph, "_run", counted)]):
        calls = [call(forced, force=True), call(want)]
        out["capture"] = (calls, ops_cuda.graph_counts(), len(runs), [
            fg.graph is None for fg in graph._graphs.values()])
    with graph_route():
        calls = [call(want), call(want)]
        out["replay"] = (calls, ops_cuda.graph_counts())
    return out


RUNS_2 = [("torch", "torus", TORUS, "torch", False, None),
          ("cuda", "culled", CULLED, "cuda", False, None),
          ("cuda_1", "culled", CULLED, "cuda", False, 1)]
RUNS_4 = [(f"{route}_{'reb' if reb else 'local'}", "asym", ASYM, route, reb,
           None) for route in ("torch", "cuda") for reb in (False, True)]


@pytest.fixture(scope="module")
def ranks():
    return {2: run_ranks(_spectral_rank, 2, RUNS_2, device="cpu",
                         timeout=300),
            4: run_ranks(_spectral_rank, 4, RUNS_4, device="cpu",
                         timeout=300)}


def gathered(reports, name):
    return np.concatenate([r[name][0] for r in reports])


def test_spectral_sharded_matches_single_torch_route(ranks):
    scene = scenes()["torus"]
    want = tft.render_spectral(scene, camera(), TORUS["width"],
                               TORUS["height"], wcfg("torch", TORUS))
    np.testing.assert_allclose(gathered(ranks[2], "torch"), want.numpy(),
                               atol=1e-5)
    counts = ranks[2][0]["torch"][1]
    assert counts.shape == (2, TORUS["depth"])
    assert (counts[:, 0] == 8 * 16 * TORUS["width"]).all()
    for r in ranks[2]:
        np.testing.assert_array_equal(r["torch"][1], counts)


@pytest.mark.parametrize("body", ["_spectral_rounds", "_spectral_band"])
def test_deferred_sharded_spectral_reads_nothing_on_the_host(ranks, body):
    for r in ranks[2]:
        assert r[f"deferred_{body}"] == (True, False)


def test_flag_on_one_rank_promotes_and_keeps_every_rank_eager(ranks):
    for r in ranks[2]:
        calls, counts, runs, eager_key = r["capture"]
        assert calls == [True, True] and eager_key == [True]
        assert runs == 2, "the promoted run is not collective"
        assert counts == {"captures": 0, "replays": 0, "eager_reruns": 1,
                          "eager_frames": 1}


def test_sharded_spectral_replay_is_the_eager_frame(ranks):
    for r in ranks[2]:
        calls, counts = r["replay"]
        assert calls == [True, True]
        assert counts == {"captures": 1, "replays": 1, "eager_reruns": 0,
                          "eager_frames": 0}


def test_spectral_sharded_culled_route(ranks):
    """The "cuda" route's frame over 2 ranks, against the same queue on a
    1-rank mesh and against ``render_spectral``, within the mean of the
    culled spectral bound (< 2e-3).  Its max (5e-2) is not asserted, and
    the two sharded forms are not equal: the block-tier compaction keeps
    the densest whole 1024-lane blocks of a queue, so when a band's
    children overflow its capacity each rank drops its own least dense
    blocks where one rank drops the frame's (up to 0.079 on 36 of 6,144
    values here); ``render_spectral`` marches one lane a pixel in round 0
    where this queue marches one a bin, so other lanes share a warp's
    window and hits land elsewhere in the ε shell; and on this frame the
    port's one-process culled and dense routes differ by up to 0.079
    already (2 of 2,048 pixels above 5e-2)."""
    from fraytracer_tpu_torch.ops.cuda import cull
    scene = scenes()["culled"]
    assert cull._cull_pairs(scene.kind_counts, scene.plan, 48)
    got = gathered(ranks[2], "cuda")
    assert got.shape == (CULLED["height"], CULLED["width"], 3)
    assert np.isfinite(got).all()
    assert "cuda_1" not in ranks[2][1]
    one, one_counts = ranks[2][0]["cuda_1"]
    counts = ranks[2][0]["cuda"][1]
    assert (counts[:, 0] == 8 * 32 * CULLED["width"]).all()
    assert counts[:, 0].sum() == one_counts[0, 0]
    assert (counts[:, 1] > 0).all()
    want = tft.render_spectral(scene, camera(), CULLED["width"],
                               CULLED["height"], wcfg("cuda", CULLED))
    for ref in (one, want.numpy()):
        d = np.abs(got - ref)
        assert d.mean() < 2e-3, d.mean()


def imbalance(counts):
    """max / mean of the ranks' live lanes, over rounds ≥ 1 with any."""
    c = np.asarray(counts, np.float64)[:, 1:]
    tot = c.sum(axis=0)
    live = tot > 0
    return float((c.max(axis=0)[live] / (tot[live] / c.shape[0])).max())


@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_spectral_rebalanced_matches_and_balances(ranks, route):
    local, reb = (ranks[4][0][f"{route}_{k}"][1] for k in ("local", "reb"))
    np.testing.assert_allclose(gathered(ranks[4], f"{route}_reb"),
                               gathered(ranks[4], f"{route}_local"),
                               atol=1e-5)
    assert local[:, 1].sum() > 0
    assert imbalance(reb) <= imbalance(local) + 1e-6
    assert imbalance(reb) < 1.5
    # the exchange moves lanes, it makes and loses none
    np.testing.assert_array_equal(reb.sum(0)[:2], local.sum(0)[:2])


def test_spectral_rebalanced_counts_match_jax(ranks):
    import fraytracer_tpu as jft
    from fraytracer_tpu.ops.march import MarchConfig as JMC
    from fraytracer_tpu.ops.wavefront import WavefrontConfig
    from fraytracer_tpu.parallel.mesh import (make_mesh,
                                              render_spectral_sharded)
    jcfg = WavefrontConfig(depth=ASYM["depth"], epsilon=ASYM["epsilon"],
                           length=30.0,
                           march=JMC(max_steps=ASYM["max_steps"]))
    mesh = make_mesh(4)
    for key, reb in (("torch_local", False), ("torch_reb", True)):
        jimg, jc = render_spectral_sharded(
            jft.flatten(asymmetric(jft)),
            jft.look_at(*CAM, fov_degrees=60.0), ASYM["width"],
            ASYM["height"], jcfg, mesh, rebalance=reb)
        got = ranks[4][0][key][1]
        jc = np.asarray(jc)
        assert got.shape == jc.shape == (4, ASYM["depth"])
        assert (np.abs(got - jc) <= 0.005 * np.maximum(jc, 1)).all(), \
            (key, got, jc)
        d = np.abs(gathered(ranks[4], key) - np.asarray(jimg))
        assert d.max() < 5e-2 and d.mean() < 2e-3, (key, d.max(), d.mean())
