"""10,000-primitive benchmark (counterpart of ``tools/bench_10k.py``).

The reference's grid has O(1) lookup with an O(cells·K) one-time build
(SdfBoundary.fs:225-282); the culled kernels rebuild per-tile candidate
tables every march.  This measures the 10× scene: the frame time, the
table build's time alone, and the candidate counts that size the tables —
picked from the scene's own rays with 30% headroom, as a user of the API
would (a tile past its table re-runs its march with full tables, so
headroom trades memory for never taking that path).

    python -m fraytracer_tpu_torch.bench_10k [size] [tori] [--device cuda|cpu]

Prints ONE JSON line (``tori10k_*`` keys; the bench merges it under
``tori_10k``).  On the CPU it renders a 64² smoke frame and prints
``{"tori10k_ok": true, ...}``, as the JAX tool does off the TPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

FRAMES = 5      # timed frames (median)
BUILDS = 5      # timed table builds (median)
HEADROOM = 1.3


def log(msg: str) -> None:
    print(f"[10k] {msg}", file=sys.stderr, flush=True)


def round_up(x: int, q: int = 128) -> int:
    return int(-(-x // q) * q)


def setup(size: int, tori: int, device):
    """The seed-19 torus scene of ``tori`` tori, the bench's camera and
    march configuration, and the frame's flat primary rays in 32×32 block
    order (the culled tiles)."""
    import fraytracer_tpu_torch as ft
    from .camera import auto_block, to_blocks
    from .scene.generators import torus_csg_scene
    scene = ft.flatten(torus_csg_scene(seed=19, n_tori=tori), device=device)
    camera = ft.look_at((0.0, 0.0, -10.0), (0.0, 0.0, 0.0),
                        fov_degrees=60.0, device=device)
    base = ft.MarchConfig(max_steps=192, bound_skip=True, relax_omega=1.4)
    b = auto_block(size, size)
    flat = ft.camera_rays(camera, size, size, 0.01, 30.0).map(
        lambda x: to_blocks(x, size, size, b))
    return scene, camera, base, flat


def cand_count(scene, rays, apex=None) -> int:
    """The largest candidate count of a 1024-lane tile of ``rays``, as the
    culled march's tables count it (the tile's cone, the OR of its four
    sub-tiles' masks; JAX ``bench_10k.py:53``, whose one pair is the
    scene's tori); ``apex``: the converging cone of point-light shadow
    rays.  The tables are built one chunk long: the count is the whole
    mask's."""
    from .ops.cuda.cull import CAND_UNROLL
    from .ops.cuda.march_kernel import march_tables
    from .ops.march import MarchConfig
    tables = march_tables(scene, rays, MarchConfig(cull_m=CAND_UNROLL),
                          cone_apex=apex)[3]
    return max(int(q.count.max()) for q in tables.tables)


def table_sizes(scene, base, flat) -> dict:
    """Table rows for the frame: the largest candidate count a tile of the
    primary march and of the shadow marches, × 1.3 rounded up to 128 (JAX
    ``bench_10k.py:96-117``).  Shadow rays leave the primary march's hits
    backed off by ε toward the lights, from the lanes whose normal faces
    them."""
    import torch

    from .ops.march import march_surface
    from .ops.shade import light_dir_and_dist
    from .scene.nodes import LIGHT_POINT
    from .types import Rays
    with torch.no_grad():
        c_prim = cand_count(scene, flat)
        m_prim = round_up(int(c_prim * HEADROOM))
        res, nrm, _midx = march_surface(
            scene, flat, dataclasses.replace(base, cull_m=m_prim))
        pos = flat.at(res.t - flat.epsilon)
        c_shadow = 0
        for li in range(scene.num_lights):
            ldir, budget, _scale = light_dir_and_dist(scene, li, pos)
            facing = res.hit & ((nrm * ldir).sum(-1) > 0.0)
            sh = Rays(origin=pos, direction=ldir,
                      length=torch.where(facing, budget, 0.0),
                      epsilon=flat.epsilon)
            apex = scene.light_vec[li] \
                if scene.light_kind[li] == LIGHT_POINT else None
            c_shadow = max(c_shadow, cand_count(scene, sh, apex))
    return {"cand_max_primary": c_prim, "cull_m": m_prim,
            "cand_max_shadow": c_shadow,
            "cull_m_shadow": round_up(int(c_shadow * HEADROOM))}


def primary_tables(scene, cfg, flat):
    """The primary march's candidate tables, as ``cuda_march_raw`` builds
    them."""
    from .ops.cuda.march_kernel import march_tables
    return march_tables(scene, flat, cfg)[3]


def run(size: int = 1024, tori: int = 10000, device: str = "cuda") -> dict:
    """The 10k frame on the card (see the module docstring)."""
    import torch

    import fraytracer_tpu_torch as ft
    from .bench import device_label, timed
    from .ops.cuda import launch_counts, probe, reset_launch_counts

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu for the smoke "
                         "frame)")
    dev = torch.device(device)

    def sync():
        torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    probe.warm(torch.ones((8, 128), dtype=torch.float32, device=dev))
    warmup_s = time.perf_counter() - t0
    warm_launches = launch_counts()["warm"]
    scene, camera, base, flat = setup(size, tori, dev)
    t0 = time.perf_counter()
    sizes = table_sizes(scene, base, flat)
    sync()
    sizing_s = time.perf_counter() - t0
    log(f"primary max count {sizes['cand_max_primary']} -> cull_m "
        f"{sizes['cull_m']}; shadow max count {sizes['cand_max_shadow']} "
        f"-> cull_m_shadow {sizes['cull_m_shadow']}")
    mcfg = dataclasses.replace(base, cull_m=sizes["cull_m"],
                               cull_m_shadow=sizes["cull_m_shadow"])
    cfg = ft.RenderConfig(width=size, height=size, epsilon=0.01,
                          length=30.0, march=mcfg)

    reset_launch_counts()
    t0 = time.perf_counter()
    img, n_rays = ft.render_with_stats(scene, camera, cfg)
    sync()
    first_s = time.perf_counter() - t0
    launches = launch_counts()
    times = timed(lambda: ft.render_with_stats(scene, camera, cfg), sync,
                  FRAMES)
    fwd_s = statistics.median(times)
    # the eager frame's peak (a replay of the graph frame allocates
    # nothing but its outputs' copies)
    torch.cuda.reset_peak_memory_stats(dev)
    ft.render_grid(scene, ft.camera_rays(camera, size, size, 0.01, 30.0),
                   cfg)
    sync()
    peak = torch.cuda.max_memory_allocated(dev)
    n_rays = float(n_rays)
    log(f"frame {fwd_s * 1e3:.2f} ms (median of {FRAMES}), {n_rays:.0f} "
        f"rays, peak {peak / 2**20:.1f} MiB")

    with torch.no_grad():
        tables = primary_tables(scene, mcfg, flat)
        build = timed(lambda: primary_tables(scene, mcfg, flat), sync,
                      BUILDS)
    prep_ms = statistics.median(build) * 1e3
    table_bytes = sum(t.table.numel() * 4 + t.keys.numel() * 4
                      + t.hsuf.numel() * 4 + t.misc.numel() * 4
                      for t in tables.tables)
    log(f"primary table build {prep_ms:.2f} ms (median of {BUILDS}), "
        f"{table_bytes} bytes of tables")
    return {
        "tori10k_rays_per_sec": n_rays / fwd_s,
        "tori10k_fwd_time_s": fwd_s,
        "tori10k_fwd_time_min_s": min(times),
        "tori10k_first_frame_s": first_s,
        "tori10k_n_rays": n_rays,
        "tori10k_n_tori": tori,
        "tori10k_image_size": size,
        "tori10k_cull_m": sizes["cull_m"],
        "tori10k_cull_m_shadow": sizes["cull_m_shadow"],
        "tori10k_cand_max_primary": sizes["cand_max_primary"],
        "tori10k_cand_max_shadow": sizes["cand_max_shadow"],
        "tori10k_prep_ms_primary": prep_ms,
        "tori10k_sizing_s": sizing_s,
        "tori10k_table_bytes_primary": table_bytes,
        "tori10k_peak_mem_bytes": peak,
        "tori10k_backend_warmup_s": warmup_s,
        "tori10k_warm_launches": warm_launches,
        # the first frame's launches (counts set to 0 just before it)
        "tori10k_frame_launches": launches,
        "tori10k_image_checksum": float(img.sum()),
        "tori10k_device": device_label(dev),
    }


def smoke(tori: int) -> dict:
    """The CPU smoke frame: 64², the kernels' plain versions."""
    import torch

    import fraytracer_tpu_torch as ft
    scene, camera, base, _flat = setup(64, tori, "cpu")
    img = ft.render(scene, camera, ft.RenderConfig(width=64, height=64,
                                                   march=base))
    if not bool(torch.isfinite(img).all()):
        raise SystemExit("non-finite smoke frame")
    return {"tori10k_ok": True, "tori10k_backend": "cpu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("size", type=int, nargs="?", default=1024)
    ap.add_argument("tori", type=int, nargs="?", default=10000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    out = smoke(args.tori) if args.device == "cpu" \
        else run(args.size, args.tori)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
