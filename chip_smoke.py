"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and the exit code is not 0):

1. device  — the card's name and power limit (nvidia-smi), torch/CUDA.
2. build   — compile the kernels from fraytracer_tpu_torch/csrc (nvcc).
3. kernels — each kernel against its plain PyTorch version on the same
   CUDA tensors: K4 block gather (exact), K1/K2/K3 on small scenes, then
   each kernel's time beside its plain version's at the main path's shapes.
4. main    — the forward frame: render_with_stats at 1024² on the seed-19
   1000-torus scene (max_steps 192, bound_skip, relax_omega 1.4, cull=False)
   with launch counts read around it alone; then, counted apart, the
   material-repair block tier (K4) on the frame's hit points with lanes
   marked unresolved (the dense frame leaves no -1 material on hit lanes,
   so it never takes that tier itself); a tone-mapped PNG is written
   under fraytracer_tpu_torch/_build/.
5. parity  — a 256² frame through the kernels against the plain versions.

The second-to-last line of output is the card's name and power limit, the
line before it a JSON object with each kernel's launches, error and times;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import torch

EPS = 0.01
BENCH_N_TORI = 1000
SIZE = 1024
SRC = "fraytracer_tpu_torch/csrc"
TPU = "fraytracer_tpu/ops/pallas"


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median device time of ``fn`` (ms) over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


@contextlib.contextmanager
def plain_route():
    """Send the "cuda" backend's host glue to the plain versions (on CUDA
    tensors) instead of the kernels, for kernel-vs-plain comparisons."""
    from fraytracer_tpu_torch.ops.cuda import gather, march_kernel as mk
    saved = (mk.march_kernel, mk.surface_kernel, gather._gather_blocks)
    mk.march_kernel = mk.march_plain
    mk.surface_kernel = mk.surface_plain
    gather._gather_blocks = gather.block_gather_plain
    try:
        yield
    finally:
        mk.march_kernel, mk.surface_kernel, gather._gather_blocks = saved


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def scenes(dev):
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.scene import generators as G
    all_kinds = ft.Scene(root=ft.union(
        ft.sphere((0, 0, 0), 0.8, material=ft.solid(1, 0, 0)),
        ft.capsule((-2, -1, 0), (-2, 1, 0), 0.3,
                   material=ft.solid(0, 1, 0)),
        ft.torus((2, 0, 0), (0, 1, 0.3), 0.7, 0.2,
                 material=ft.solid(0, 0, 1)),
        ft.triangle((-1, 1.5, 0), (1, 1.5, 0), (0, 2.5, 0.5), 0.1),
        ft.box((0, -2, 0), (0.6, 0.4, 0.5), 0.05,
               material=ft.solid(1, 1, 0)),
        ft.cone((2, -2.5, 0), (2, -1, 0), 0.6, 0.1),
        ft.plane((0, 1, 0), -3.5, material=ft.solid(0.5, 0.5, 0.5)),
    ))
    smooth = ft.Scene(root=ft.subtract(
        ft.intersect(ft.smooth_union(0.3, ft.sphere((0, 0, 0), 1.0),
                                     ft.sphere((0.8, 0.3, 0), 0.7)),
                     ft.sphere((0, 0, 0), 1.5)),
        ft.box((0.3, 0.5, -0.7), (0.4, 0.4, 0.4), 0.05)))
    return {
        "torus96": (ft.flatten(G.torus_csg_scene(19, 96), dev), 256, 30.0),
        "all_kinds": (ft.flatten(all_kinds, dev), 256, 40.0),
        "smooth_subtract": (ft.flatten(smooth, dev), 128, 30.0),
    }


def primary_lanes(scene, size, length, dev, omega=1.4):
    """Flat primary rays in 32x32 block order with the root-bound start and
    clamped budget, as cuda_march_raw hands them to K1."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops.march import bound_skip_start
    from fraytracer_tpu_torch.render import _to_blocks
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    rays = ft.camera_rays(cam, size, size, EPS, length)
    rays = rays.map(lambda x: _to_blocks(x, size, size, 32).contiguous())
    t0, miss0, t_exit = bound_skip_start(scene, rays)
    ln = torch.where(miss0, 0.0, torch.minimum(rays.length, t_exit))
    return dict(origin=rays.origin, direction=rays.direction,
                length=ln.contiguous(), epsilon=rays.epsilon,
                t0=t0.contiguous()), dict(max_steps=192, omega=omega)


def compare_march(k, p, label):
    """Kernel vs plain K1 outputs: hit masks equal on >= 99.9% of lanes;
    t within 1e-4 on lanes that both hit with the same step count (a lane
    whose d crossed epsilon one step apart differs by up to a step)."""
    tk, hk, _dk, sk = k
    tp, hp, _dp, sp = p
    agree = (hk == hp).float().mean().item()
    same = hk & hp & (sk == sp)
    n_both = int((hk & hp).sum())
    frac_same = int(same.sum()) / max(n_both, 1)
    err = (tk - tp).abs()[same].max().item() if same.any() else 0.0
    log(f"  {label}: hit agreement {agree:.6f}, both-hit lanes {n_both}, "
        f"same step count {frac_same:.6f}, max |dt| {err:.3e}")
    check(agree >= 0.999, f"{label}: hit agreement {agree}")
    check(frac_same >= 0.999, f"{label}: step-count agreement {frac_same}")
    check(err <= 1e-4, f"{label}: t error {err}")
    return err


def compare_surface(k, p, hit, label):
    """Kernel vs plain K3 on the same (t, hit) inputs: code equal on
    >= 99.9% of hit lanes; normals within 1e-4 and materials equal there."""
    nk, mk_, ck = k
    np_, mp, cp = p
    same = hit & (ck == cp)
    frac = int(same.sum()) / max(int(hit.sum()), 1)
    nerr = (nk - np_).abs()[same].max().item() if same.any() else 0.0
    mfrac = ((mk_ == mp) | ~same).float().mean().item()
    log(f"  {label}: code agreement {frac:.6f}, max |dn| {nerr:.3e}, "
        f"material agreement {mfrac:.6f}")
    check(frac >= 0.999, f"{label}: code agreement {frac}")
    check(nerr <= 1e-4, f"{label}: normal error {nerr}")
    check(mfrac >= 0.999, f"{label}: material agreement {mfrac}")
    check(bool(((~hit) | (nk.norm(dim=-1) - 1).abs().lt(1e-3)).all()),
          f"{label}: kernel normals not unit")
    return nerr


def phase_kernels(dev):
    from fraytracer_tpu_torch.ops.cuda import march_kernel as mk
    from fraytracer_tpu_torch.ops.cuda.gather import (
        BLOCK, block_gather, block_gather_plain, flat_block_gather)

    # K4: exact on random blocks, repeats and a different output count
    g = torch.Generator(device="cpu").manual_seed(0)
    xf = torch.randn(16, 8, 128, generator=g).to(dev)
    xi = torch.randint(-1000, 1000, (16, 8, 128), generator=g,
                       dtype=torch.int32).to(dev)
    for idx in ([3, 3, 0, 15, 7], list(range(15, -1, -1)) + [2, 2, 9]):
        it = torch.tensor(idx, dtype=torch.int32, device=dev)
        for x in (xf, xi):
            check(torch.equal(block_gather(x, it),
                              block_gather_plain(x, it)), "K4 mismatch")
    pay = torch.randn(4 * BLOCK, 3, generator=g).to(dev)
    it = torch.tensor([2, 0, 1], dtype=torch.int32, device=dev)
    check(torch.equal(flat_block_gather(pay, it, 3),
                      pay.reshape(4, -1)[it.long()].reshape(-1, 3)),
          "K4 [N, 3] mismatch")
    log("  K4 block gather: exact on float32/int32, repeats, Bo != B, [N,3]")

    for name, (scene, size, length) in scenes(dev).items():
        lanes, kw = primary_lanes(scene, size, length, dev)
        k = mk.march_kernel(scene, **lanes, **kw)
        p = mk.march_plain(scene, **lanes, **kw)
        compare_march(k, p, f"K1 {name} {size}^2")
        ok_ = mk.march_kernel(scene, **lanes, **kw, occlusion=True)
        op_ = mk.march_plain(scene, **lanes, **kw, occlusion=True)
        agree = (ok_[0] == op_[0]).float().mean().item()
        log(f"  K2 {name}: hit agreement {agree:.6f}, occlusion == march "
            f"{bool(torch.equal(ok_[0], k[1]))}")
        check(agree >= 0.999, f"K2 {name}: {agree}")
        check(torch.equal(ok_[0], k[1]), f"K2 {name}: occlusion != march")
        if name != "smooth_subtract":
            args = (lanes["origin"], lanes["direction"], k[0],
                    lanes["epsilon"], k[1])
            compare_surface(mk.surface_kernel(scene, *args),
                            mk.surface_plain(scene, *args), k[1],
                            f"K3 {name}")
    torch.cuda.synchronize()


def lane_efficiency(steps):
    """Useful ray evaluations over the evaluations the warps issue: a warp
    of 32 consecutive lanes steps as long as its slowest lane."""
    per_warp = steps[: steps.numel() // 32 * 32].view(-1, 32)
    issued = 32 * int(per_warp.amax(1).sum())
    return int(per_warp.sum()) / max(issued, 1)


def phase_kernel_times(dev, bench_scene):
    """Each kernel beside its plain version at the main path's shapes
    (1024² primary rays on the 1000-torus scene)."""
    from fraytracer_tpu_torch.ops import shade
    from fraytracer_tpu_torch.ops.cuda import march_kernel as mk
    from fraytracer_tpu_torch.ops.cuda.gather import (
        _gather_blocks, block_gather_plain, BLOCK)
    out = {}
    lanes, kw = primary_lanes(bench_scene, SIZE, 30.0, dev)
    k = mk.march_kernel(bench_scene, **lanes, **kw)
    ms = cuda_ms(lambda: mk.march_kernel(bench_scene, **lanes, **kw))
    t0 = time.perf_counter()
    p = mk.march_plain(bench_scene, **lanes, **kw)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = compare_march(k, p, f"K1 bench {SIZE}^2")
    out["march"] = (ms, plain_ms, err, int((k[1] != p[1]).sum()),
                    k[1].numel())
    evals = int(k[3].sum())
    log(f"  K1 bench: {evals} ray evaluations ({evals / k[3].numel():.2f} "
        f"per ray), {evals * bench_scene.num_prims / (ms * 1e-3):.4g} "
        f"primitive evaluations/s, SIMT lane efficiency "
        f"{lane_efficiency(k[3]):.4f}")

    # K2 on the frame's first shadow batch (directional light, facing lanes)
    hitk = k[1]
    pos = lanes["origin"] + (k[0] - lanes["epsilon"])[:, None] \
        * lanes["direction"]
    normal, _m, _c = mk.surface_kernel(bench_scene, lanes["origin"],
                                       lanes["direction"], k[0],
                                       lanes["epsilon"], hitk)
    ldir, budget, _s = shade.light_dir_and_dist(bench_scene, 0, pos)
    facing = hitk & ((normal * ldir).sum(-1) > 0)
    from fraytracer_tpu_torch.ops.march import bound_skip_start
    from fraytracer_tpu_torch.types import Rays
    srays = Rays(origin=pos.contiguous(), direction=ldir.contiguous(),
                 length=torch.where(facing, budget, 0.0),
                 epsilon=lanes["epsilon"])
    st0, smiss, sexit = bound_skip_start(bench_scene, srays)
    slanes = dict(origin=srays.origin, direction=srays.direction,
                  length=torch.where(smiss, 0.0, torch.minimum(
                      srays.length, sexit)).contiguous(),
                  epsilon=srays.epsilon, t0=st0.contiguous())
    ok_ = mk.march_kernel(bench_scene, **slanes, **kw, occlusion=True)
    ms = cuda_ms(lambda: mk.march_kernel(bench_scene, **slanes, **kw,
                                         occlusion=True))
    evals = int(ok_[1].sum())
    log(f"  K2 bench: {evals} ray evaluations, "
        f"{evals * bench_scene.num_prims / (ms * 1e-3):.4g} primitive "
        f"evaluations/s, SIMT lane efficiency {lane_efficiency(ok_[1]):.4f}")
    t0 = time.perf_counter()
    op_ = mk.march_plain(bench_scene, **slanes, **kw, occlusion=True)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    flips = int((ok_[0] != op_[0]).sum())
    agree = 1.0 - flips / ok_[0].numel()
    log(f"  K2 bench shadow rays: {int(facing.sum())} facing, "
        f"{flips} flips ({agree:.6f} agreement)")
    check(agree >= 0.999, f"K2 bench agreement {agree}")
    # max |hit_kernel - hit_plain| over the boolean output
    out["occlusion"] = (ms, plain_ms, float(flips > 0), flips,
                        ok_[0].numel())

    # K3 on the frame's primary hits (same inputs to both)
    args = (lanes["origin"], lanes["direction"], k[0], lanes["epsilon"], hitk)
    kk = mk.surface_kernel(bench_scene, *args)
    ms = cuda_ms(lambda: mk.surface_kernel(bench_scene, *args))
    t0 = time.perf_counter()
    pp = mk.surface_plain(bench_scene, *args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = compare_surface(kk, pp, hitk, f"K3 bench {SIZE}^2")
    out["surface"] = (ms, plain_ms, err, int((hitk & (kk[2] != pp[2])).sum()),
                      int(hitk.sum()))

    # K4 at the block tier's shape: 16 blocks of the frame's [N, 3] points
    xb = pos.contiguous().reshape(-1, BLOCK * 3)
    bidx = torch.arange(0, 16 * 37, 37, dtype=torch.int32, device=dev)
    gk = _gather_blocks(xb, bidx)
    ms = cuda_ms(lambda: _gather_blocks(xb, bidx), reps=20)
    plain_ms = cuda_ms(lambda: block_gather_plain(xb, bidx), reps=20)
    gp = block_gather_plain(xb, bidx)
    err = (gk - gp).abs().max().item()
    check(err == 0.0, "K4 bench mismatch")
    out["block_gather"] = (ms, plain_ms, err, int((gk != gp).sum()),
                           gk.numel())
    for name, (a, b, e, nd, n) in out.items():
        log(f"  time {name}: kernel {a:.3f} ms, plain {b:.3f} ms "
            f"(err {e:.3e}, {nd} of {n} outputs differ)")
    return out


# ---------------------------------------------------------------------------
# phase 4/5: the forward frame
# ---------------------------------------------------------------------------

def bench_config(size, backend="cuda"):
    import fraytracer_tpu_torch as ft
    return ft.RenderConfig(width=size, height=size, epsilon=EPS, length=30.0,
                           march=ft.MarchConfig(max_steps=192,
                                                bound_skip=True,
                                                backend=backend, cull=False,
                                                relax_omega=1.4))


def phase_main(dev, scene, build_dir):
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.image.io import save_image
    from fraytracer_tpu_torch.ops import cuda as ops_cuda
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    cfg = bench_config(SIZE)

    ops_cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, n_rays = ft.render_with_stats(scene, cam, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = ops_cuda.launch_counts()
    log(f"  launches in the main path: {counts}")
    check(counts["march"] >= 1, "K1 not launched by the frame")
    check(counts["surface"] >= 1, "K3 not launched by the frame")
    check(counts["occlusion"] == scene.num_lights,
          f"K2 launched {counts['occlusion']} times, want "
          f"{scene.num_lights}")
    repair = forced_repair(scene, cam, cfg)

    check(bool(torch.isfinite(img).all()), "non-finite pixels")
    check(img.shape == (SIZE, SIZE, 3), f"image shape {tuple(img.shape)}")
    bg = scene.background
    share = (img - bg).abs().amax(-1).gt(1e-6).float().mean().item()
    log(f"  frame {SIZE}^2: n_rays {int(n_rays)}, non-background share "
        f"{share:.4f}, first frame {first_s * 1e3:.1f} ms")
    check(0.25 <= share <= 0.45, f"non-background share {share}")

    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, n_rays = ft.render_with_stats(scene, cam, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"  frame {SIZE}^2: median of 5 {med * 1e3:.2f} ms "
        f"({[round(t * 1e3, 2) for t in times]}), "
        f"{int(n_rays) / med:.4g} rays/s")
    profile_frame(scene, cam, cfg, build_dir / "chip_smoke_frame_trace.json")
    gen = torch.Generator(device=dev).manual_seed(19)
    png = build_dir / "chip_smoke_frame.png"
    save_image(str(png), ft.tonemap(img, gen, cfg.gamma).cpu().numpy())
    log(f"  wrote {png}")
    return counts, repair, int(n_rays), first_s, med, share


def forced_repair(scene, cam, cfg):
    """The material-repair block tier (K4) on the frame's own hit points.
    The dense surface pass leaves no -1 material on hit lanes, so the
    frame never takes this tier; here the hit lanes of 5 blocks are marked
    unresolved and repaired.  Returns the launch counts of the repair
    call alone."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops import cuda as ops_cuda, sdf, shade
    from fraytracer_tpu_torch.ops.cuda.gather import BLOCK
    from fraytracer_tpu_torch.render import _to_blocks
    rays = ft.camera_rays(cam, SIZE, SIZE, EPS, cfg.length).map(
        lambda x: _to_blocks(x, SIZE, SIZE, 32).contiguous())
    h = shade.surface_hit(scene, rays, cfg.march)
    nb = h.hit.numel() // BLOCK
    hit_blocks = torch.nonzero(h.hit.reshape(nb, BLOCK).any(1)).squeeze(1)
    pick = hit_blocks[torch.linspace(0, hit_blocks.numel() - 1, 5,
                                     device=hit_blocks.device).long()]
    lane = torch.arange(BLOCK, device=h.hit.device)
    marked = torch.zeros(nb, BLOCK, dtype=torch.bool, device=h.hit.device)
    marked[pick] = (lane % 5 == 0)[None, :]
    bad = marked.reshape(-1) & h.hit
    midx = torch.where(bad, -1, h.material)
    ops_cuda.reset_launch_counts()
    fixed = shade.resolve_material(scene, h.position, h.hit, midx,
                                   backend="cuda")
    counts = ops_cuda.launch_counts()
    want = sdf.material_index_at(scene, h.position[bad])
    same_k3 = (fixed[bad] == h.material[bad]).float().mean().item()
    log(f"  forced repair: {int(bad.sum())} hit lanes of blocks "
        f"{pick.tolist()} marked -1; launches {counts}; repaired material "
        f"equal to K3's on {same_k3:.6f} of them")
    check(counts["block_gather"] == 1, "K4 not launched by the repair")
    check(torch.equal(fixed[bad], want)
          and torch.equal(fixed[~bad], midx[~bad]),
          "block-tier repair disagrees with the dense argmin")
    return counts


def profile_frame(scene, cam, cfg, trace_path):
    """One frame under torch.profiler: device time by kernel and the
    device's idle share between the frame's first and last kernel; the
    Chrome trace goes to ``trace_path``."""
    import fraytracer_tpu_torch as ft
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ft.render_with_stats(scene, cam, cfg)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    prof.export_chrome_trace(str(trace_path))
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        log("  profile: no device events (device breakdown not measured)")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    by_name = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"  profile: {len(evs)} device ops, busy {busy / 1e3:.3f} ms of a "
        f"{span / 1e3:.3f} ms device span (idle share "
        f"{1 - busy / span:.4f}); host wall {wall_us / 1e3:.3f} ms "
        "under the profiler")
    for name, us in top:
        log(f"    {us / 1e3:9.3f} ms  {name[:70]}")
    ours = [e for e in sorted(evs, key=lambda e: e.time_range.start)
            if e.name.startswith(("march_kernel", "surface_kernel",
                                  "block_gather_kernel"))]
    log("  profile, port kernels in launch order: " + ", ".join(
        f"{e.name.split('(')[0]} {e.time_range.elapsed_us() / 1e3:.3f} ms"
        for e in ours))


def frame_and_masks(scene, cam, cfg):
    """Render + the primary hit mask and per-light occlusion masks (the
    lanes where two frames may legitimately differ)."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops import shade
    from fraytracer_tpu_torch.ops.march import march_occlusion
    img = ft.render(scene, cam, cfg)
    rays = ft.camera_rays(cam, cfg.width, cfg.height, cfg.epsilon,
                          cfg.length)
    h = shade.surface_hit(scene, rays, cfg.march)
    masks = [h.hit]
    for i in range(scene.num_lights):
        ldir, budget, _s = shade.light_dir_and_dist(scene, i, h.position)
        facing = h.hit & ((h.normal * ldir).sum(-1) > 0)
        sr = ft.Rays(origin=h.position, direction=ldir,
                     length=torch.where(facing, budget, 0.0),
                     epsilon=rays.epsilon)
        masks += [facing, march_occlusion(scene, sr, cfg.march)]
    return img, masks


def phase_parity(dev, scene):
    import fraytracer_tpu_torch as ft
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    cfg = bench_config(256)
    ik, mk_ = frame_and_masks(scene, cam, cfg)
    with plain_route():
        ip, mp = frame_and_masks(scene, cam, cfg)
    flipped = torch.zeros_like(mk_[0])
    for a, b in zip(mk_, mp):
        flipped |= a != b
    diff = (ik - ip).abs().amax(-1)
    mx = diff[~flipped].max().item()
    med = diff.median().item()
    log(f"  frame 256^2 kernels vs plain: {int(flipped.sum())} flipped "
        f"pixels, max |diff| elsewhere {mx:.3e}, median {med:.3e}")
    check(flipped.float().mean().item() <= 0.005, "too many flipped pixels")
    check(mx < 2e-3, f"max diff {mx}")
    check(med < 1e-5, f"median diff {med}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops.cuda import build
    from fraytracer_tpu_torch.scene.generators import torus_csg_scene

    smi = nvidia_smi()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | {kind} | torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    build.library()
    log(f"[build] {build.BuildInfo.path.name} built={build.BuildInfo.built} "
        f"in {time.perf_counter() - t0:.2f} s")
    for line in build.BuildInfo.log.splitlines():
        if "entry function" in line or "registers" in line:
            log(f"  ptxas: {line.strip()}")

    log("[kernels] kernel vs plain on the card")
    phase_kernels(dev)
    scene = ft.flatten(torus_csg_scene(19, BENCH_N_TORI), device=dev)
    times = phase_kernel_times(dev, scene)

    log(f"[main] forward frame {SIZE}^2, {BENCH_N_TORI} tori")
    counts, repair, n_rays, first_s, med, _share = phase_main(
        dev, scene, build.BUILD_DIR)

    log("[parity] 256^2 frame, kernels vs plain on the card")
    phase_parity(dev, scene)

    mk = f"{TPU}/march_kernel.py"
    rows = [("march", f"{SRC}/march.cu", f"{mk}:1637"),
            ("occlusion", f"{SRC}/march.cu", f"{mk}:1637"),
            ("surface", f"{SRC}/march.cu", f"{mk}:1606"),
            ("block_gather", f"{SRC}/gather.cu", f"{TPU}/gather.py:37")]
    # "launches": the main path's frame alone (K4 0: the dense frame never
    # takes the repair's block tier); "forced_repair_launches": the forced
    # block-tier repair.  "differing": discrete outputs (hit bit, leaf
    # code, gathered element) where kernel and plain version disagree, out
    # of "compared"
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": counts[name],
                "forced_repair_launches": repair[name],
                "max_abs_err": times[name][2], "ms": times[name][0],
                "plain_ms": times[name][1], "differing": times[name][3],
                "compared": times[name][4]} for name, src, rep in rows]
    log(f"[summary] frame first {first_s * 1e3:.1f} ms, median "
        f"{med * 1e3:.2f} ms, n_rays {n_rays}")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
