"""Command line of the port: the ``render`` subcommand of the JAX CLI
(reference ``FrayTracer.Console``, Program.fs:14-100).

    python -m fraytracer_tpu_torch.cli render --size 1024 --out x.png

renders the seed-19 1000-torus scene through the CUDA kernels (``--device
cuda``, the default) and prints the frame time.  Without a GPU it stops
with an error unless ``--device cpu`` is given, which runs the kernels'
plain PyTorch versions.
"""
from __future__ import annotations

import argparse
import sys
import time


def _scene_by_name(name: str, seed: int, n: int):
    from .scene import generators as G
    if name == "torus-csg":
        return G.torus_csg_scene(seed=seed, n_tori=n)
    if name == "csg-demo":
        return G.csg_demo_scene(seed=seed)
    raise SystemExit(f"unknown scene {name!r} (torus-csg, csg-demo)")


def cmd_render(args) -> int:
    import torch

    import fraytracer_tpu_torch as ft
    from .image.io import save_image
    from .ops.march import MarchConfig

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port's kernels need a GPU "
                         "(pass --device cpu to run their plain versions)")
    device = torch.device(args.device)
    scene = ft.flatten(_scene_by_name(args.scene, args.seed, args.tori),
                       device=device)
    camera = ft.look_at(tuple(args.camera), tuple(args.target),
                        fov_degrees=args.fov, device=device)
    cfg = ft.RenderConfig(width=args.size, height=args.size,
                          epsilon=args.epsilon, length=args.length,
                          gamma=args.gamma,
                          march=MarchConfig(max_steps=args.max_steps,
                                            backend="cuda", cull=False,
                                            relax_omega=1.4))
    print("Rendering...", flush=True)
    t0 = time.perf_counter()
    img = ft.render(scene, camera, cfg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"Time = {time.perf_counter() - t0:.2f} sec")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    out = ft.tonemap(img, gen, cfg.gamma)
    save_image(args.out, out.cpu().numpy())
    print(f"Wrote {args.out}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fraytracer-torch",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("render", help="render a scene to an image file")
    sp.add_argument("--scene", default="torus-csg")
    sp.add_argument("--seed", type=int, default=19)
    sp.add_argument("--tori", type=int, default=1000)
    sp.add_argument("--size", type=int, default=512)
    sp.add_argument("--epsilon", type=float, default=0.01)
    sp.add_argument("--length", type=float, default=30.0)
    sp.add_argument("--gamma", type=float, default=2.2)
    sp.add_argument("--fov", type=float, default=60.0)
    sp.add_argument("--max-steps", type=int, default=192)
    sp.add_argument("--camera", type=float, nargs=3,
                    default=[0.0, 0.0, -10.0])
    sp.add_argument("--target", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (kernels, default) or cpu (plain versions)")
    sp.add_argument("--out", default="result.png")
    sp.set_defaults(fn=cmd_render)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
