"""Multi-rank dry run: n spawned ranks render one sharded frame and take one
sharded training step at tiny shapes (counterpart of
``__graft_entry__.dryrun_multichip``: a 16 × 4n frame of 16 tori).

    python -m fraytracer_tpu_torch.parallel.dryrun N [--device cuda|cpu]
        [--backend nccl|gloo]

On the card each rank takes ``cuda:<rank mod cards>``; NCCL needs a card a
rank, so ranks that share a card name ``--backend gloo``.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional


def _dryrun_rank(device: str) -> dict:
    import torch

    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.scene.generators import torus_csg_scene
    from fraytracer_tpu_torch.parallel.mesh import (make_mesh, make_train_step,
                                                    render_sharded)

    mesh = make_mesh(devices=None if device == "cuda" else device)
    h = 4 * mesh.size   # rows divisible by the mesh size
    cfg = ft.RenderConfig(width=16, height=h, epsilon=0.02, length=30.0,
                          march=ft.MarchConfig(max_steps=48, bound_skip=True))
    scene = ft.flatten(torus_csg_scene(seed=19, n_tori=16),
                       device=mesh.device)
    camera = ft.look_at((0.0, 0.0, -10.0), (0.0, 0.0, 0.0),
                        fov_degrees=60.0, device=mesh.device)
    img = render_sharded(scene, camera, cfg, mesh)
    if img.shape != (4, 16, 3) or not bool(torch.isfinite(img).all()):
        raise RuntimeError(f"rank {mesh.rank}: rows {tuple(img.shape)}")
    target = torch.zeros((h, 16, 3), dtype=torch.float32, device=mesh.device)
    new_scene, loss = make_train_step(cfg, mesh, lr=1e-3)(scene, camera,
                                                          target)
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"rank {mesh.rank}: loss {float(loss)}")
    return {"rank": mesh.rank, "backend": mesh.backend,
            "device": str(mesh.device), "loss": float(loss),
            "albedo": new_scene.mat_albedo.cpu().numpy()}


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: Optional[str] = None) -> list:
    """One sharded frame and one sharded training step on ``n_devices``
    spawned ranks; returns each rank's report (its loss, and the updated
    albedo, equal on every rank)."""
    from .multihost import run_ranks
    out = run_ranks(_dryrun_rank, n_devices, device, device=device,
                    backend=backend)
    for r in out[1:]:
        if r["loss"] != out[0]["loss"] \
                or (r["albedo"] != out[0]["albedo"]).any():
            raise RuntimeError("the ranks' scenes diverged")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", choices=("nccl", "gloo"))
    args = ap.parse_args(argv)
    out = dryrun_multichip(args.n, args.device, args.backend)
    print(f"dryrun_multichip({args.n}) ok: {out[0]['backend']} ranks on "
          f"{sorted({r['device'] for r in out})}, loss {out[0]['loss']:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
