"""Port parity, the multi-process runtime (``fraytracer_tpu_torch/parallel/
multihost.py``) on the CPU: the counterparts of ``tests/test_multihost.py``
— two processes joined by ``initialize(coordinator, 2, pid)`` render the
32², 32-torus frame with rows sharded over the global mesh, and every
process gathers the whole frame — held against the port's one-process
frame; then ``initialize()`` alone (a world of one), the dry run
(``parallel/dryrun.py``) and the scaling report (``parallel/scaling.py``)
on 2 CPU ranks."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import fraytracer_tpu_torch as tft
from fraytracer_tpu_torch.parallel import mesh as tmesh
from fraytracer_tpu_torch.parallel import multihost
from fraytracer_tpu_torch.scene.generators import torus_csg_scene

SIZE = 32


def frame():
    scene = tft.flatten(torus_csg_scene(seed=19, n_tori=32), device="cpu")
    cam = tft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0,
                      device="cpu")
    cfg = tft.RenderConfig(width=SIZE, height=SIZE,
                           march=tft.MarchConfig(backend="torch",
                                                 max_steps=128))
    return scene, cam, cfg


def _host_rank():
    assert dist.get_world_size() == 2
    mesh = multihost.global_mesh(devices="cpu")
    scene, cam, cfg = frame()
    rows = tmesh.render_sharded(scene, cam, cfg, mesh)
    return {"rank": dist.get_rank(), "rows": rows.numpy(),
            "start": mesh.rank * rows.shape[0],
            "full": multihost.gather_image_to_host(rows),
            "max": float(tmesh.exposure_max_sharded(rows, mesh))}


@pytest.fixture(scope="module")
def worker_outputs():
    return multihost.run_ranks(_host_rank, 2, device="cpu", timeout=300)


@pytest.fixture(scope="module")
def single():
    scene, cam, cfg = frame()
    return tft.render(scene, cam, cfg).numpy()


def test_two_process_render_matches_single(worker_outputs, single):
    for out in worker_outputs:
        np.testing.assert_allclose(out["full"], single, atol=1e-6,
                                   err_msg=f"gathered frame (rank "
                                   f"{out['rank']})")


def test_two_process_shards_tile_the_frame(worker_outputs, single):
    covered = np.zeros(SIZE, bool)
    for out in worker_outputs:
        start, rows = out["start"], out["rows"]
        assert not covered[start:start + rows.shape[0]].any(), "overlap"
        covered[start:start + rows.shape[0]] = True
        np.testing.assert_allclose(rows, single[start:start + len(rows)],
                                   atol=1e-6)
    assert covered.all()


def test_two_process_collective_max(worker_outputs, single):
    for out in worker_outputs:
        np.testing.assert_allclose(out["max"], single.max(), atol=1e-6)


def test_initialize_without_a_cluster_is_a_world_of_one(single):
    assert not dist.is_initialized()
    multihost.initialize()
    try:
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        multihost.initialize()          # a second call is a no-op
        mesh = multihost.global_mesh(devices="cpu")
        assert (mesh.size, mesh.rank, mesh.device) == (1, 0,
                                                       torch.device("cpu"))
        scene, cam, cfg = frame()
        rows = tmesh.render_sharded(scene, cam, cfg, mesh)
        np.testing.assert_array_equal(
            multihost.gather_image_to_host(rows), single)
    finally:
        dist.destroy_process_group()


def test_initialize_needs_all_three_explicit_arguments():
    with pytest.raises(ValueError, match="together"):
        multihost.initialize("127.0.0.1:1", 2)
    assert not dist.is_initialized()


def test_dryrun_multichip_on_two_cpu_ranks():
    from fraytracer_tpu_torch.parallel.dryrun import dryrun_multichip
    out = dryrun_multichip(2, device="cpu")
    assert [r["rank"] for r in out] == [0, 1]
    assert {r["backend"] for r in out} == {"gloo"}
    assert np.isfinite(out[0]["loss"]) and out[0]["loss"] == out[1]["loss"]


def test_scaling_report_over_two_cpu_ranks():
    """``parallel/scaling.py`` over 2 spawned gloo ranks: the gathered frame
    equals the one-process frame and the report names what ran."""
    from fraytracer_tpu_torch.parallel.scaling import scaling_report
    rep = scaling_report(32, 16, ranks=2, device="cpu", reps=1)
    assert (rep["scaling_ranks"], rep["scaling_backend"],
            rep["scaling_cards"]) == (2, "gloo", 0)
    assert rep["scaling_max_abs_diff"] == 0.0
    assert rep["scaling_t_sharded_s"] > 0 and rep["scaling_t_single_s"] > 0
    assert all(k.startswith("scaling_") for k in rep)
