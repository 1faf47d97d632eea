"""Benchmark of the port: forward and forward + backward frame times on
the CSG scene, the spectral wavefront's frame time, the 10,000-torus frame
and the sharded render's scaling report (counterpart of the JAX package's
``bench.py``, its warm-up, forward, fwd+bwd, spectral, ``tori_10k`` and
scaling sections).

Workload = the reference's de-facto benchmark: the 1000-random-tori CSG
scene at 1024x1024 with 2 lights, epsilon 0.01, ray budget 30, through the
culled CUDA kernels.  The spectral section renders
``spectral_csg_scene`` (the same tori, a quarter of them dispersive glass
and a tenth mirrors) at ``min(size, 512)``², 8 wavelength bins, depth 4.
On the card at ``size >= 1024`` and ``tori >= 1000``, ``bench_10k.py``
renders 10,000 tori at ``size``² in a process of its own (field
``tori_10k``).  Last, ``parallel/scaling.py`` in a process of its own times
the sharded render at ``min(size, 256)``² / ``min(tori, 100)`` tori over one
rank (NCCL on the card, gloo on the CPU) against one process: its
``scaling_*`` fields name the ranks, backend and cards that ran.

    python -m fraytracer_tpu_torch.bench [--size 1024] [--tori 1000]
        [--quick] [--repeats 3] [--no-bwd] [--no-spectral] [--no-scaling]
        [--device cuda|cpu]

Prints ONE JSON line per finished stage, each a superset of the last (a
reader takes the LAST line): the headline ``rays_per_sec_per_chip_fwd``
as soon as the forward timing and the ray count are known, then the
fwd+bwd fields, then the spectral fields, ``tori_10k``, the scaling
fields.  Times are medians of frames bracketed by a device synchronize
(the spectral frame: the best of 2 rounds of 4); ``device`` names the card
and its power limit.  On the card the forward frame is the graph frame
(``render.py``): ``capture_s`` is its first call's eager run and capture
(JAX's ``compile_time_s``), ``fwd_time_sustained_s`` 32 frames chained
between two synchronizes over 32 (JAX's headline loop) and
``fwd_time_eager_s`` the same of the eager frame (``render_grid``).  The
fwd+bwd step is ``render_value_and_grad`` (on the card one captured CUDA
graph, forward and backward): ``fwd_bwd_time_s`` the median of
``3·repeats`` steps, ``fwd_bwd_time_eager_s`` the same of the eager step
(``render_grid`` and ``backward``), ``fwd_bwd_time_sustained_s`` 8 steps
chained between two synchronizes over 8 (JAX's ``KB``) and
``fwd_bwd_capture_s`` the step's eager run and capture (JAX's
``fwd_bwd_compile_s``).  The spectral frame is ``render_spectral_with_stats``
(on the card one captured CUDA graph): ``spectral_time_s`` its best of 2
rounds of 4, ``spectral_time_eager_s`` the same of the eager frame and
``spectral_capture_s`` the first call's deferred runs and capture.
Progress goes to stderr.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SUSTAINED = 32      # chained frames of the sustained time (JAX's K)
SUSTAINED_STEPS = 8  # chained fwd+bwd steps of theirs (JAX's KB)
# fields of the headline record that a merged report may not overwrite
PROTECTED = ("metric", "value", "unit", "image_size", "n_tori", "n_rays",
             "n_rays_primary")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def emit(result: dict) -> None:
    """Print the full (current) result as one JSON line."""
    print(json.dumps(result), flush=True)


def device_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (the
    device type for the CPU)."""
    if device.type != "cuda":
        return device.type
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    import torch
    return out or torch.cuda.get_device_name(device)


def run_json(module: str, *argv: str, timeout: float) -> dict:
    """``python -m module argv`` in a process of its own; its last stdout
    line parsed as JSON.  Raises with the process's stderr when it fails."""
    proc = subprocess.run([sys.executable, "-m", module, *argv],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=str(ROOT))
    if proc.returncode != 0:
        raise SystemExit(f"{module} exited {proc.returncode}:\n"
                         f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def sum_sq(img):
    """The fwd+bwd stage's loss: the L2 of the image against zero."""
    return (img ** 2).sum()


def chained(fn, sync, frames: int) -> float:
    """Seconds a call of ``fn``: ``frames`` calls made in a row between two
    ``sync``s, over their count."""
    sync()
    t0 = time.perf_counter()
    for _ in range(frames):
        fn()
    sync()
    return (time.perf_counter() - t0) / frames


def timed(fn, sync, frames: int):
    """Seconds of each of ``frames`` calls of ``fn``, each bracketed by
    ``sync`` (a device synchronize)."""
    out = []
    for _ in range(frames):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        out.append(time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--tori", type=int, default=1000)
    ap.add_argument("--quick", action="store_true",
                    help="256x256, 100 tori (smoke)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="rounds of 5 forward frames / 3 fwd+bwd steps")
    ap.add_argument("--no-bwd", action="store_true",
                    help="skip the fwd+bwd timing")
    ap.add_argument("--no-spectral", action="store_true",
                    help="skip the spectral wavefront timing")
    ap.add_argument("--no-scaling", action="store_true",
                    help="skip the sharded render's scaling report")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (kernels, default) or cpu (plain versions)")
    args = ap.parse_args(argv)
    if args.quick:
        args.size, args.tori = 256, 100

    import torch

    import fraytracer_tpu_torch as ft
    from .ops.cuda import launch_counts, probe
    from .ops.march import MarchConfig
    from .ops.wavefront import _spectral_frame, spectral_graph
    from .render import frame_graph, step_graph
    from .scene.generators import torus_csg_scene

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port's kernels need a GPU "
                         "(pass --device cpu to run their plain versions)")
    device = torch.device(args.device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    # One-time backend warm-up, measured apart: the first launch of a
    # process pays for the CUDA context, the kernel library (built with
    # nvcc when the sources changed, else loaded) and the launch itself.
    # A trivial kernel isolates that from the first frame's time.
    t0 = time.perf_counter()
    w = probe.warm(torch.ones((8, 128), dtype=torch.float32, device=device))
    warm_sum = float(w.sum())
    warmup_s = time.perf_counter() - t0
    if warm_sum != 2048.0:
        raise SystemExit(f"warm-up kernel returned {warm_sum}, want 2048")
    log(f"backend warmup {warmup_s:.2f}s")

    scene = ft.flatten(torus_csg_scene(seed=19, n_tori=args.tori),
                       device=device)
    camera = ft.look_at((0.0, 0.0, -10.0), (0.0, 0.0, 0.0),
                        fov_degrees=60.0, device=device)
    cfg = ft.RenderConfig(width=args.size, height=args.size, epsilon=0.01,
                          length=30.0,
                          march=MarchConfig(max_steps=192, bound_skip=True,
                                            relax_omega=1.4))

    log(f"fwd render {args.size}x{args.size}, {args.tori} tori on "
        f"{args.device}...")
    t0 = time.perf_counter()
    img, n_rays_dev = ft.render_with_stats(scene, camera, cfg)
    checksum = float(img.sum())
    first_s = time.perf_counter() - t0
    if img.grad_fn is not None:
        raise SystemExit("a forward-only frame built an autograd graph")
    # the first call's eager run and capture of the graph frame (the
    # counterpart of JAX's compile_time_s); None where no graph is made
    graph = frame_graph(scene, camera, cfg)
    capture_s = graph.capture_s if graph is not None else None

    frames = 5 * args.repeats
    times = timed(lambda: ft.render_with_stats(scene, camera, cfg), sync,
                  frames)
    fwd_s = statistics.median(times)
    # JAX's headline loop: SUSTAINED frames chained between two
    # synchronizes, of the graph frame and of the eager frame
    rays = ft.camera_rays(camera, args.size, args.size, cfg.epsilon,
                          cfg.length)
    sustained_s, eager_s = (
        chained(fn, sync, SUSTAINED) for fn in (
            lambda: ft.render_with_stats(scene, camera, cfg),
            lambda: ft.render_grid(scene, rays, cfg)))
    n_rays = float(n_rays_dev)
    n_primary = float(args.size * args.size)
    log(f"n_rays={n_rays:.0f}, fwd={fwd_s * 1e3:.2f}ms (median of {frames})")
    result = {
        "metric": "rays_per_sec_per_chip_fwd",
        "value": n_rays / fwd_s,
        "unit": "rays/s",
        "image_size": args.size,
        "n_tori": args.tori,
        # total = primary + shadow rays actually marched (<= 3 per pixel)
        "n_rays": n_rays,
        "n_rays_primary": n_primary,
        "rays_per_sec_primary_only": n_primary / fwd_s,
        "fwd_time_s": fwd_s,
        "fwd_time_min_s": min(times),
        "timing_method": f"median of {frames} frames, each bracketed by a "
                         "device synchronize",
        "fwd_time_sustained_s": sustained_s,
        "fwd_time_eager_s": eager_s,
        "sustained_method": f"{SUSTAINED} frames chained between two "
                            "device synchronizes, over their count; eager: "
                            "the same of render_grid",
        "capture_s": capture_s,
        "first_frame_s": round(first_s, 4),
        "backend_warmup_s": round(warmup_s, 4),
        "image_checksum": checksum,
        "backend": "cuda" if on_card else "cpu",
        "device": device_label(device),
        # kernel launches of this process so far: the warm-up kernel once,
        # then 1 + 5·repeats + 2·SUSTAINED frames
        "kernel_launches": launch_counts(),
    }
    emit(result)  # the headline is safe whatever happens below

    if not args.no_bwd:
        # fwd+bwd: the value and gradient of the L2-vs-zero image loss
        # w.r.t. every floating scene leaf (JAX's jitted fwd_bwd); on the
        # card one captured CUDA graph a step (render_value_and_grad)
        def fwd_bwd():
            return ft.render_value_and_grad(sum_sq, scene, camera, cfg)

        def fwd_bwd_eager():
            s = scene.with_tensors({k: v.detach().requires_grad_(True)
                                    for k, v in scene.tensors().items()})
            torch.sum(ft.render_grid(s, rays, cfg)[0] ** 2).backward()

        t0 = time.perf_counter()
        _loss, grads = fwd_bwd()
        gsum = float(sum(grads[f"prim_params/{k}"].abs().sum()
                         for k in scene.prim_params))
        result["fwd_bwd_first_s"] = round(time.perf_counter() - t0, 4)
        graph = step_graph(sum_sq, scene, camera, cfg)
        result["fwd_bwd_capture_s"] = (graph.capture_s
                                       if graph is not None else None)
        steps = 3 * args.repeats
        times = timed(fwd_bwd, sync, steps)
        result["fwd_bwd_time_s"] = statistics.median(times)
        result["fwd_bwd_time_min_s"] = min(times)
        result["fwd_bwd_over_fwd"] = result["fwd_bwd_time_s"] / fwd_s
        result["fwd_bwd_steps"] = steps
        result["fwd_bwd_time_eager_s"] = statistics.median(
            timed(fwd_bwd_eager, sync, steps))
        result["fwd_bwd_time_sustained_s"] = chained(fwd_bwd, sync,
                                                     SUSTAINED_STEPS)
        result["fwd_bwd_method"] = (
            f"median of {steps} render_value_and_grad steps, each "
            "bracketed by a device synchronize; eager: the same of "
            "render_grid + backward; sustained: "
            f"{SUSTAINED_STEPS} steps chained between two synchronizes, "
            "over their count")
        result["grad_abs_sum_prim_params"] = gsum
        # the backward launches no kernel of the port: one frame's worth a
        # step on top of the forward stage's counts
        result["kernel_launches"] = launch_counts()
        log(f"fwd+bwd {result['fwd_bwd_time_s'] * 1e3:.2f}ms "
            f"({result['fwd_bwd_over_fwd']:.2f}x fwd, median of {steps}), "
            f"eager {result['fwd_bwd_time_eager_s'] * 1e3:.2f}ms, "
            f"sustained {result['fwd_bwd_time_sustained_s'] * 1e3:.2f}ms")
        emit(result)

    if not args.no_spectral:
        # the spectral wavefront: 8 bins, a depth-4 bounce queue over the
        # CSG scene with glass and mirror tori (a purely diffuse scene
        # skips the queue and would measure nothing); the queue holds
        # size² · 8 lanes
        from .scene.generators import spectral_csg_scene
        spec_size = min(args.size, 512)
        sscene = ft.flatten(spectral_csg_scene(seed=19, n_tori=args.tori),
                            device=device)
        wcfg = ft.WavefrontConfig(depth=4, epsilon=0.01, length=30.0,
                                  march=cfg.march)

        def spectral():
            return ft.render_spectral_with_stats(sscene, camera, spec_size,
                                                 spec_size, wcfg)

        def spectral_eager():
            return _spectral_frame(sscene, camera, spec_size, spec_size,
                                   wcfg)

        def best_of_2x4(fn):
            return min(chained(fn, sync, 4) for _ in range(2))

        log(f"spectral {spec_size}x{spec_size}x{wcfg.num_bins} bins, depth "
            f"{wcfg.depth} (glass + mirror scene)...")
        _img, n_spec = spectral()
        sync()
        # the first call's deferred runs (two where a site was promoted)
        # and capture of the graph spectral frame; None where no graph is
        # made
        graph = spectral_graph(sscene, camera, spec_size, spec_size, wcfg)
        result["spectral_capture_s"] = (graph.capture_s
                                        if graph is not None else None)
        result["spectral_time_s"] = best_of_2x4(spectral)
        result["spectral_time_eager_s"] = best_of_2x4(spectral_eager)
        result["spectral_method"] = (
            "best of 2 rounds of 4 render_spectral_with_stats calls (on "
            "the card the graph spectral frame), each round between two "
            "device synchronizes, over 4; eager: the same of the eager "
            "frame (ops/wavefront.py::_spectral_frame)")
        result["spectral_size"] = spec_size
        result["spectral_rays_marched"] = float(n_spec)
        result["spectral_rays_per_sec"] = (float(n_spec)
                                           / result["spectral_time_s"])
        # + the first call's spectral frames (one a deferred run) and 8
        # graph and 8 eager spectral frames' launches
        result["kernel_launches"] = launch_counts()
        log(f"spectral {result['spectral_time_s']:.3f}s (best of 2 x 4 "
            f"frames), eager {result['spectral_time_eager_s']:.3f}s, "
            f"{float(n_spec):.0f} rays")
        emit(result)

    if on_card and args.size >= 1024 and args.tori >= 1000:
        # the 10× scene: 10,000 tori with tables sized from the scene's own
        # candidate counts, and the table build timed alone; in a process
        # of its own, as the JAX bench runs it
        log(f"10,000 tori at {args.size}^2 (bench_10k)...")
        result["tori_10k"] = run_json("fraytracer_tpu_torch.bench_10k",
                                      str(args.size), "10000", timeout=900)
        emit(result)

    if not args.no_scaling:
        # the sharded render over one rank against one process; the report
        # names ranks, backend and cards, and claims no multi-card scaling
        size, tori = min(args.size, 256), min(args.tori, 100)
        log(f"scaling report {size}^2, {tori} tori (parallel.scaling)...")
        extra = run_json("fraytracer_tpu_torch.parallel.scaling", str(size),
                         str(tori), "--device", args.device, timeout=600)
        clobber = set(extra) & set(PROTECTED)
        if clobber:
            raise SystemExit(f"the scaling report would overwrite "
                             f"{sorted(clobber)}")
        result.update(extra)
        emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
