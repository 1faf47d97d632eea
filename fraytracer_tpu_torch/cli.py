"""Command line of the port: the ``render``, ``spectral``, ``fit`` and
``bench`` subcommands of the JAX CLI (reference ``FrayTracer.Console``,
Program.fs:14-100).

    python -m fraytracer_tpu_torch.cli render --size 1024 --out x.png
    python -m fraytracer_tpu_torch.cli spectral --depth 4 --out s.png
    python -m fraytracer_tpu_torch.cli fit --size 256 --tori 100 --steps 50
    python -m fraytracer_tpu_torch.cli bench [--quick]

``render`` draws the seed-19 1000-torus scene through the culled CUDA
kernels and prints the frame time; ``spectral`` renders a scene through
the spectral wavefront (8 wavelength bins, ``--depth`` bounce rounds:
dispersion, reflection, refraction); ``fit`` is the inverse-rendering demo
(perturb the geometry, descend the image L2 back to the target); ``bench``
runs ``fraytracer_tpu_torch.bench``.  All default to ``--device cuda``;
without a GPU they stop with an error unless ``--device cpu`` is given,
which runs the kernels' plain PyTorch versions.
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
    if name == "glass":
        from .models import glass_demo_scene
        return glass_demo_scene()
    raise SystemExit(f"unknown scene {name!r} (torus-csg, csg-demo, glass)")


def _device(args):
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port's kernels need a GPU "
                         "(pass --device cpu to run their plain versions)")
    return torch.device(args.device)


def cmd_render(args) -> int:
    import torch

    import fraytracer_tpu_torch as ft
    from .image.io import save_image
    from .ops.march import MarchConfig

    device = _device(args)
    scene = ft.flatten(_scene_by_name(args.scene, args.seed, args.tori),
                       device=device)
    camera = ft.look_at(tuple(args.camera), tuple(args.target),
                        fov_degrees=args.fov, device=device)
    cfg = ft.RenderConfig(width=args.size, height=args.size,
                          epsilon=args.epsilon, length=args.length,
                          gamma=args.gamma,
                          march=MarchConfig(max_steps=args.max_steps,
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


def cmd_spectral(args) -> int:
    import torch

    import fraytracer_tpu_torch as ft
    from .image.io import save_image
    from .ops.march import MarchConfig

    device = _device(args)
    scene = ft.flatten(_scene_by_name(args.scene, args.seed, args.tori),
                       device=device)
    camera = ft.look_at(tuple(args.camera), tuple(args.target),
                        fov_degrees=args.fov, device=device)
    cfg = ft.WavefrontConfig(depth=args.depth, epsilon=args.epsilon,
                             length=args.length,
                             march=MarchConfig(max_steps=args.max_steps,
                                               relax_omega=1.4))
    print(f"Spectral rendering (depth {args.depth}, "
          f"{cfg.num_bins} bins)...", flush=True)
    t0 = time.perf_counter()
    img = ft.render_spectral(scene, camera, args.size, args.size, cfg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"Time = {time.perf_counter() - t0:.2f} sec")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    out = ft.tonemap(img, gen, args.gamma)
    save_image(args.out, out.cpu().numpy())
    print(f"Wrote {args.out}")
    return 0


def _image_mse(img, target):
    """The fit's loss: the mean squared difference to the target image."""
    import torch
    return torch.mean((img - target) ** 2)


def cmd_fit(args) -> int:
    """Inverse rendering: perturb every geometry parameter (an explicit
    ``torch.Generator``), descend the image L2 back to the target by SGD
    on every floating scene leaf, with the checkpoint save/resume round
    trip mid-run and a loss-curve + parameter-recovery report (JSON).
    The loss and its gradient are ``render_value_and_grad``'s (JAX jits
    ``value_and_grad`` and the update as one step): on the card one
    captured CUDA graph a step; the SGD update is a few elementwise ops on
    the leaves, outside it."""
    import dataclasses
    import json

    import torch

    import fraytracer_tpu_torch as ft
    from .ops.march import MarchConfig
    from .utils.checkpoint import load_scene, save_scene

    device = _device(args)
    camera = ft.look_at(tuple(args.camera), tuple(args.target),
                        fov_degrees=args.fov, device=device)
    cfg = ft.RenderConfig(width=args.size, height=args.size,
                          epsilon=args.epsilon, length=args.length,
                          march=MarchConfig(max_steps=args.max_steps))
    target_scene = ft.flatten(_scene_by_name(args.scene, args.seed,
                                             args.tori), device=device)
    target = ft.render(target_scene, camera, cfg)
    gen = torch.Generator(device=device).manual_seed(7)
    scene = dataclasses.replace(target_scene, prim_params={
        k: v + args.perturb * torch.randn(v.shape, generator=gen,
                                          dtype=v.dtype, device=device)
        for k, v in target_scene.prim_params.items()})

    def param_err(s) -> float:
        return float(sum((a - b).abs().sum() for a, b in zip(
            s.prim_params.values(), target_scene.prim_params.values())))

    def step(s):
        """One SGD step on every floating leaf → (new scene, loss)."""
        loss, grads = ft.render_value_and_grad(_image_mse, s, camera, cfg,
                                               target)
        with torch.no_grad():
            new = s.with_tensors({f: v - args.lr * grads[f]
                                  for f, v in s.tensors().items()})
        return new, float(loss)

    err0 = param_err(scene)
    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        scene, loss = step(scene)
        losses.append(loss)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {loss:.6f}", flush=True)
        if args.checkpoint and i == args.steps // 2:
            # checkpoint/resume round trip mid-run (utils/checkpoint)
            save_scene(args.checkpoint, scene)
            scene = load_scene(args.checkpoint, device=device)
            print(f"checkpointed + resumed at step {i}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    err1 = param_err(scene)
    report = {
        "backend": args.device, "size": args.size, "scene": args.scene,
        "tori": args.tori, "steps": args.steps, "lr": args.lr,
        "perturb": args.perturb,
        "n_params": sum(v.numel() for v in scene.prim_params.values()),
        "loss_first": losses[0], "loss_last": losses[-1],
        "param_l1_before": err0, "param_l1_after": err1,
        "param_recovery": 1.0 - err1 / max(err0, 1e-12),
        "wall_s": round(wall, 2), "losses": losses,
    }
    if args.out_report:
        with open(args.out_report, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out_report}", flush=True)
    print(f"fit: loss {losses[0]:.6f} -> {losses[-1]:.6f}, param L1 "
          f"{err0:.4f} -> {err1:.4f} "
          f"({report['param_recovery'] * 100:.1f}% recovered)", flush=True)
    return 0


def cmd_bench(args) -> int:
    from . import bench
    argv = ["--device", args.device]
    if args.quick:
        argv.append("--quick")
    if args.no_bwd:
        argv.append("--no-bwd")
    if args.no_spectral:
        argv.append("--no-spectral")
    return bench.main(argv)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fraytracer-torch",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
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
        sp.add_argument("--target", type=float, nargs=3,
                        default=[0.0, 0.0, 0.0])
        device(sp)

    def device(sp):
        sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (kernels, default) or cpu (plain "
                             "versions)")

    sp = sub.add_parser("render", help="render a scene to an image file")
    common(sp)
    sp.add_argument("--out", default="result.png")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("spectral", help="spectral wavefront render")
    common(sp)
    sp.add_argument("--depth", type=int, default=4)
    sp.add_argument("--out", default="spectral.png")
    sp.set_defaults(fn=cmd_spectral)

    sp = sub.add_parser("fit", help="inverse rendering demo")
    common(sp)
    sp.add_argument("--steps", type=int, default=50)
    sp.add_argument("--lr", type=float, default=0.5)
    sp.add_argument("--perturb", type=float, default=0.05)
    sp.add_argument("--checkpoint", default="",
                    help="npz path: save+resume mid-run (empty = skip)")
    sp.add_argument("--out-report", default="",
                    help="JSON loss-curve/recovery report path")
    sp.set_defaults(fn=cmd_fit)

    sp = sub.add_parser("bench", help="run the benchmark")
    sp.add_argument("--quick", action="store_true")
    sp.add_argument("--no-bwd", action="store_true")
    sp.add_argument("--no-spectral", action="store_true")
    device(sp)
    sp.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
