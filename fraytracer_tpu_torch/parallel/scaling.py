"""Scaling report of the sharded render (counterpart of
``tools/scaling_report.py``).

    python -m fraytracer_tpu_torch.parallel.scaling [size] [tori]
        [--ranks N] [--device cuda|cpu] [--backend nccl|gloo]

Times ``render_sharded`` over N ranks against the one-process ``render``
of the same frame (the seed-19 torus scene, the culled kernels), asserts
that the gathered frame equals the one-process frame (atol 1e-5, as the
JAX report does), and prints one JSON line whose keys all start with
``scaling_`` (the bench merges it into its own record).  It measures what
ran and says so — ranks, backend, cards: one rank on one card measures the
sharded path's overhead, several ranks sharing one card (gloo) their
contention for it; neither is multi-card scaling, and no figure here is
extrapolated to cards that were not there.  N = 1 runs in this process;
more ranks are spawned (``multihost.run_ranks``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _setup(tori: int, device):
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.scene.generators import torus_csg_scene
    scene = ft.flatten(torus_csg_scene(seed=19, n_tori=tori), device=device)
    camera = ft.look_at((0.0, 0.0, -10.0), (0.0, 0.0, 0.0),
                        fov_degrees=60.0, device=device)
    return scene, camera


def _config(size: int):
    import fraytracer_tpu_torch as ft
    return ft.RenderConfig(width=size, height=size, epsilon=0.01,
                           length=30.0,
                           march=ft.MarchConfig(max_steps=192,
                                                bound_skip=True,
                                                relax_omega=1.4))


def _best(fn, device, reps: int, barrier=None) -> float:
    """Best of ``reps`` calls after one untimed call, each between device
    synchronizations (and barriers of the ranks, when given)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        _sync(device)
        if barrier:
            barrier()
        t0 = time.perf_counter()
        fn()
        _sync(device)
        if barrier:
            barrier()
        best = min(best, time.perf_counter() - t0)
    return best


def _sharded_rank(size: int, tori: int, device: str, reps: int) -> dict:
    """One rank: its best sharded frame time (ranks start and end each
    frame together) and its rows."""
    import torch.distributed as dist

    from fraytracer_tpu_torch.parallel.mesh import make_mesh, render_sharded
    mesh = make_mesh(devices=None if device == "cuda" else device)
    scene, camera = _setup(tori, mesh.device)
    cfg = _config(size)
    out = {}

    def frame():
        out["rows"] = render_sharded(scene, camera, cfg, mesh)

    t = _best(frame, mesh.device, reps,
              barrier=lambda: dist.barrier(group=mesh.group))
    return {"t": t, "rows": out["rows"].cpu().numpy(),
            "backend": mesh.backend, "device": str(mesh.device)}


def scaling_report(size: int = 256, tori: int = 100, ranks: int = 1,
                   device: str = "cuda", backend=None, reps: int = 3) -> dict:
    """The report as a dict (see the module docstring)."""
    import torch

    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.bench import device_label
    from fraytracer_tpu_torch.ops.cuda import launch_counts, probe
    from .mesh import teardown
    from .multihost import default_backend, initialize, run_ranks

    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu to run the "
                         "kernels' plain versions)")
    dev = torch.device(device if device == "cpu" else "cuda")
    backend = backend or default_backend(device)
    # the backend warm-up of a process (context, library, W), untimed
    probe.warm(torch.ones((8, 128), dtype=torch.float32, device=dev))
    scene, camera = _setup(tori, dev)
    cfg = _config(size)
    out = {}

    def single():
        out["img"] = ft.render(scene, camera, cfg)

    t_single = _best(single, dev, reps)
    img_1 = out["img"].cpu().numpy()
    if ranks == 1:
        initialize(backend=backend)
        rank = [_sharded_rank(size, tori, device, reps)]
        teardown()
    else:
        rank = run_ranks(_sharded_rank, ranks, size, tori, device, reps,
                         device=device, backend=backend)
    img_n = np.concatenate([r["rows"] for r in rank])
    np.testing.assert_allclose(img_n, img_1, atol=1e-5)
    t_sharded = rank[0]["t"]
    cards = min(ranks, torch.cuda.device_count()) if dev.type == "cuda" \
        else 0
    return {
        "scaling_sharding_overhead": t_sharded / t_single,
        "scaling_t_single_s": t_single,
        "scaling_t_sharded_s": t_sharded,
        "scaling_ranks": ranks,
        "scaling_backend": rank[0]["backend"],
        "scaling_cards": cards,
        "scaling_device": device_label(dev),
        "scaling_measures": (
            f"sharded render over {ranks} rank(s) on {cards} card(s) "
            f"({rank[0]['backend']}) against one process; not multi-card "
            "scaling"),
        "scaling_max_abs_diff": float(np.abs(img_n - img_1).max()),
        "scaling_image_size": size,
        "scaling_n_tori": tori,
        # this process's launches: W, the one-process frames and, with one
        # rank, the sharded frames
        "scaling_kernel_launches": launch_counts(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("size", type=int, nargs="?", default=256)
    ap.add_argument("tori", type=int, nargs="?", default=100)
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", choices=("nccl", "gloo"))
    args = ap.parse_args(argv)
    print(json.dumps(scaling_report(args.size, args.tori, args.ranks,
                                    args.device, args.backend)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
