"""Sphere tracing (the hot loop) as a batched, masked march.

Counterpart of ``fraytracer_tpu.ops.march``, forward only.  Termination
semantics match the reference (``SdfForm.tryTrace``, SdfForm.fs:93-104):
miss when the travel budget is exhausted, hit when the scene distance drops
below ``epsilon``, otherwise step forward by the distance.

Backends (``MarchConfig.backend``):

* ``"torch"`` — the plain dense march over every primitive, the
  counterpart of JAX ``"jnp"``; it ignores ``relax_omega`` like
  ``_march_raw`` does.
* ``"cuda"`` — the hand-written CUDA kernels (``ops/cuda``), the
  counterpart of JAX ``"pallas"``.  For CPU tensors the kernel wrappers run
  their plain versions, so CPU tests exercise the same host glue.

Gradients (the implicit-differentiation custom VJPs) are not ported yet:
everything here runs without autograd.
"""
from __future__ import annotations

import dataclasses

import torch

from ..scene.flatten import FlatScene
from ..types import MarchResult, Rays, dot
from . import sdf

Tensor = torch.Tensor

BACKENDS = ("torch", "cuda")


@dataclasses.dataclass(frozen=True, eq=True)
class MarchConfig:
    """Static march configuration; every field and default of the JAX
    ``MarchConfig``.  Fields that only steer the culled kernel or the
    backward pass are accepted and unused until those land (ROADMAP)."""

    max_steps: int = 192
    bound_skip: bool = True
    min_denom: float = 0.05
    backend: str = "torch"
    # per-tile cone culling of the kernel path; the "cuda" path raises
    # NotImplementedError for cull=True until the culled kernels land
    cull: bool = True
    cull_m: int = 256
    cull_m_shadow: int = 512
    cull_threshold: int = 48
    # over-relaxed sphere tracing with the overstep revert ("cuda" path)
    relax_omega: float = 1.0
    cull_window_clamp: float = 0.125
    # normals + material argmin in one surface kernel after the march
    fuse_surface: bool = True
    tile_sub: int = 0
    shadow_tile_sub: int = 0
    cull_early_out: bool = False
    bwd_cull_m: int = 48
    bwd_point_tile: int = 256
    # off-by-default layout knobs of the TPU kernel; the "cuda" path
    # rejects them when set
    shadow_axial_sort: bool = False
    shadow_block_sort: bool = False
    shadow_block_compact: bool = False
    step_unroll: int = 1
    debug_window_stats: bool = False
    shadow_compact: bool = False


_CULL_ITEM = ("the culled march (per-tile candidate tables for K1-K3) is "
              "not ported yet: ROADMAP Queue 2, 'Culled K1-K3'; pass "
              "cull=False")


def check_config(cfg: MarchConfig) -> None:
    """Raise for a backend or option this port does not run."""
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown march backend {cfg.backend!r} "
                         f"(one of {BACKENDS})")
    if cfg.backend != "cuda":
        return
    if cfg.cull:
        raise NotImplementedError(_CULL_ITEM)
    knobs = {"shadow_axial_sort": cfg.shadow_axial_sort,
             "shadow_block_sort": cfg.shadow_block_sort,
             "shadow_block_compact": cfg.shadow_block_compact,
             "shadow_compact": cfg.shadow_compact,
             "debug_window_stats": cfg.debug_window_stats,
             "step_unroll": cfg.step_unroll != 1}
    bad = [k for k, on in knobs.items() if on]
    if bad:
        raise NotImplementedError(
            f"MarchConfig {bad}: TPU layout knobs the cuda path does not "
            "implement")


def flat_rays(rays: Rays) -> Rays:
    """``[..., 3]`` / ``[...]`` ray fields → flat ``[N, 3]`` / ``[N]``."""
    nb = len(rays.batch_shape)
    return rays.map(lambda x: x.reshape((-1,) + tuple(x.shape[nb:])))


# ---------------------------------------------------------------------------
# Chunked dense evaluation: bounds the [rows, K] distance matrices
# ---------------------------------------------------------------------------

def _chunk_elems(device: torch.device) -> int:
    return 1 << (24 if device.type == "cuda" else 22)


def chunked(fn, scene: FlatScene, p: Tensor) -> Tensor:
    """``fn(scene, p)`` over row chunks of a flat ``p [n, 3]`` so the dense
    ``[rows, K]`` intermediates stay bounded; results concatenated."""
    n = p.shape[0]
    rows = max(1, _chunk_elems(p.device) // max(scene.num_prims, 1))
    if n <= rows:
        return fn(scene, p)
    return torch.cat([fn(scene, p[i:i + rows]) for i in range(0, n, rows)])


# ---------------------------------------------------------------------------
# Root-bound skip and the plain stepping loop
# ---------------------------------------------------------------------------

def bound_skip_start(scene: FlatScene, rays: Rays, sign: Tensor | None = None):
    """Fast-forward rays to the scene's root bounding sphere.

    Returns ``(t0, miss0, t_exit)``: the (epsilon backed-off) start offset,
    the lanes that provably miss the bound, and the ray parameter where
    each ray leaves the bound (callers clamp the budget to it).
    Inside-marching lanes (sign < 0) are left untouched."""
    bound = sdf.root_bound(scene)
    oc = rays.origin - bound[0:3]
    b = dot(oc, rays.direction)
    c = dot(oc, oc) - bound[3] * bound[3]
    disc = b * b - c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    outside = c > 0.0
    no_hit = outside & ((disc < 0.0) | (b > 0.0))
    enter = torch.clamp_min(-b - sq - rays.epsilon, 0.0)
    # exit + slack: keep a 4-epsilon shell inside the budget
    t_exit = torch.where(no_hit, 0.0, -b + sq + 4.0 * rays.epsilon)
    if sign is not None:
        outward = sign > 0.0
        outside = outside & outward
        no_hit = no_hit & outward
        t_exit = torch.where(outward, t_exit, rays.length)
    t0 = torch.where(outside & ~no_hit, enter, 0.0)
    return t0, no_hit, t_exit


@torch.no_grad()
def sphere_trace(scene: FlatScene, origin: Tensor, direction: Tensor,
                 length: Tensor, epsilon: Tensor, t0: Tensor, max_steps: int,
                 omega: float = 1.0, sign: Tensor | None = None):
    """The plain masked march over flat ``[N]`` lanes.

    Lanes start at ``t0`` and are active while ``length > 0`` and
    ``t < length``.  Each iteration evaluates ``scene_distance`` once for
    every active lane (only those lanes are evaluated), so a lane evaluates
    at most ``max_steps`` times.  ``omega > 1`` steps by ``omega·d`` with
    the overstep revert and budget-crossing rule of the TPU kernel
    (march_kernel.py:1684-1722).

    Returns ``(t, hit, d, steps, iterations)``: per-lane final t, hit mask,
    last distance, evaluation count (int32), and the iteration count."""
    n = origin.shape[0]
    dev = origin.device
    t = t0.clone()
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    d_out = torch.full((n,), sdf._BIG, dtype=torch.float32, device=dev)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    active = (length > 0.0) & (t0 < length)
    relaxed = omega > 1.0
    if relaxed:
        d_start = torch.full((n,), sdf._BIG, dtype=torch.float32, device=dev)
        step_taken = torch.zeros(n, dtype=torch.float32, device=dev)
    it = 0
    while it < max_steps:
        # host sync: the loop ends when no lane is active
        idx = torch.nonzero(active).squeeze(1)
        if idx.numel() == 0:
            break
        ti, li = t[idx], length[idx]
        p = origin[idx] + ti[:, None] * direction[idx]
        d = chunked(sdf.scene_distance, scene, p)
        if sign is not None:
            d = sign[idx] * d
        steps[idx] += 1
        if relaxed:
            ds, st = d_start[idx], step_taken[idx]
            # overstep: the relaxed step left the union of the two safety
            # spheres -> revert to the conservative landing point
            over = st > ds + d
            is_hit = ~over & (d < epsilon[idx])
            step_rel = omega * d
            # a relaxed step that would cross the budget falls back to d
            step_new = torch.where(ti + step_rel >= li, d, step_rel)
            adv = torch.where(over | is_hit, 0.0, step_new)
            t_new = torch.where(over, ti - st + ds, ti + adv)
            still = over | (~is_hit & (t_new < li))
            keep = (still & ~over) | is_hit
            d_start[idx] = torch.where(over, ds, d)
            step_taken[idx] = torch.where(over, ds, adv)
        else:
            is_hit = d < epsilon[idx]
            t_new = ti + torch.where(is_hit, 0.0, d)
            still = ~is_hit & (t_new < li)
            keep = still | is_hit
        t[idx] = t_new
        hit[idx] |= is_hit
        d_out[idx] = torch.where(keep, d, d_out[idx])
        active[idx] = still
        it += 1
    return t, hit, d_out, steps, it


def _march_raw(scene: FlatScene, rays: Rays, cfg: MarchConfig,
               sign: Tensor | None = None) -> MarchResult:
    """The "torch" backend: plain dense march (JAX ``_march_raw``);
    ``steps`` is the iteration count broadcast over the batch."""
    batch = rays.batch_shape
    flat = flat_rays(rays)
    sign_flat = None if sign is None else \
        torch.broadcast_to(sign, batch).reshape(-1)
    n = flat.origin.shape[0]
    t0 = torch.zeros(n, dtype=torch.float32, device=flat.origin.device)
    length = flat.length
    if cfg.bound_skip:
        t0, miss0, t_exit = bound_skip_start(scene, flat, sign_flat)
        length = torch.where(miss0, 0.0, torch.minimum(length, t_exit))
    t, hit, d, _steps, it = sphere_trace(
        scene, flat.origin, flat.direction, length, flat.epsilon, t0,
        cfg.max_steps, 1.0, sign_flat)
    steps = torch.full((n,), it, dtype=torch.int32, device=t.device)
    return MarchResult(hit=hit, t=t, distance=d, steps=steps).map(
        lambda x: x.reshape(batch))


def march(scene: FlatScene, rays: Rays, cfg: MarchConfig = MarchConfig(),
          sign: Tensor | None = None) -> MarchResult:
    """Sphere-trace ``rays`` against ``scene`` (forward only).  ``sign=-1``
    lanes march inside the solid ("torch" backend only)."""
    check_config(cfg)
    if cfg.backend == "cuda":
        from .cuda.march_kernel import cuda_march_raw
        _no_sign(sign)
        batch = rays.batch_shape
        res = cuda_march_raw(scene, flat_rays(rays), cfg)
        return res.map(lambda x: x.reshape(batch))
    return _march_raw(scene, rays, cfg, sign)


def _no_sign(sign):
    if sign is not None:
        raise NotImplementedError(
            "per-lane sign on the cuda path is not ported yet (ROADMAP "
            "Queue 2, K1)")


def march_occlusion(scene: FlatScene, rays: Rays,
                    cfg: MarchConfig = MarchConfig(),
                    sign: Tensor | None = None,
                    cone_apex: Tensor | None = None,
                    axial_key: Tensor | None = None) -> Tensor:
    """Any-hit occlusion test: the hit mask only, identical to
    ``march(...).hit`` (same stepping, same termination).  ``cone_apex``
    and ``axial_key`` only steer the culled kernel and are unused while
    ``cull=False``."""
    del cone_apex, axial_key
    check_config(cfg)
    if cfg.backend == "cuda":
        from .cuda.march_kernel import cuda_march_raw
        _no_sign(sign)
        batch = rays.batch_shape
        hit = cuda_march_raw(scene, flat_rays(rays), cfg, occlusion=True)
        return hit.reshape(batch)
    return _march_raw(scene, rays, cfg, sign).hit


def march_surface(scene: FlatScene, rays: Rays,
                  cfg: MarchConfig = MarchConfig(),
                  sign: Tensor | None = None):
    """March + shading-ready surface info.

    Returns ``(MarchResult, normal [..., 3], material_index [...])``: the
    unit normal at the epsilon backed-off hit point (the outward SDF
    gradient) and the CSG-aware winning material (-1 on miss).  On the
    "cuda" backend with ``fuse_surface`` this is the march kernel followed
    by the surface kernel; otherwise march + dense evaluation."""
    check_config(cfg)
    if cfg.backend == "cuda" and cfg.fuse_surface:
        from .cuda.march_kernel import cuda_march_raw
        _no_sign(sign)
        batch = rays.batch_shape
        res, normal, midx, _code = cuda_march_raw(
            scene, flat_rays(rays), cfg, want_surface=True)
        return (res.map(lambda x: x.reshape(batch)),
                normal.reshape(batch + (3,)), midx.reshape(batch))
    res = march(scene, rays, cfg, sign=sign)
    pos = rays.at(res.t - rays.epsilon).reshape(-1, 3)
    normal = chunked(sdf.scene_normal, scene, pos)
    midx = chunked(sdf.material_index_at, scene, pos)
    batch = rays.batch_shape
    return (res, normal.reshape(batch + (3,)),
            torch.where(res.hit, midx.reshape(batch), -1))
