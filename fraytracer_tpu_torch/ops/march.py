"""Sphere tracing (the hot loop) as a batched, masked march.

Counterpart of ``fraytracer_tpu.ops.march``.  Termination
semantics match the reference (``SdfForm.tryTrace``, SdfForm.fs:93-104):
miss when the travel budget is exhausted, hit when the scene distance drops
below ``epsilon``, otherwise step forward by the distance.

Backends (``MarchConfig.backend``):

* ``"cuda"`` (the default) — the hand-written CUDA kernels (``ops/cuda``),
  the counterpart of JAX ``"pallas"``: culled per-tile candidate tables by
  default (``cull=True``), every primitive each step with ``cull=False``.
  For CPU tensors the kernel wrappers run their plain versions, so CPU
  tests exercise the same host glue.
* ``"torch"`` — the plain dense march over every primitive, the
  counterpart of JAX ``"jnp"``; it ignores ``relax_omega`` and ``cull``
  like ``_march_raw`` does.

Differentiability: the march loop itself is never differentiated.  At a
converged hit ``x* = o + t*·d`` the surface condition ``f(x*, θ) = 0``
defines ``t*`` implicitly, so

    dt*/dθ = - (∂f/∂θ) / (∇ₓf · d)

and :func:`march` / :func:`march_surface` are ``torch.autograd.Function``s
whose forward runs the raw march without a graph and whose backward
evaluates that formula at the hit point (O(1) memory, no backprop through
iterations).  The backward is plain PyTorch on top of the forward
kernels, per lane: the winning leaf's distance for min/max plans (the leaf
code the surface kernel exports), per-tile candidate lists
(``ops/point_eval.py``) for plans with a smooth union, the dense scene
distance for ``sign`` lanes.  When no input requires grad the Functions
are bypassed and a call costs what the raw march costs.

Grazing-hit guard: the denominator ``∇ₓf·d`` → 0 at silhouettes, where
the exact sensitivity diverges.  It is clamped to ``sign(den)·max(|den|,
min_denom)`` (``den == 0`` → ``min_denom``), so the gradient saturates at
``1/min_denom`` there instead of overflowing.
"""
from __future__ import annotations

import dataclasses

import torch

from ..scene.flatten import FlatScene
from ..types import MarchResult, Rays, dot, normalize
from . import deferred, sdf

Tensor = torch.Tensor

BACKENDS = ("torch", "cuda")


@dataclasses.dataclass(frozen=True, eq=True)
class MarchConfig:
    """Static march configuration; every field of the JAX ``MarchConfig``
    with its default, except ``backend``: the kernels ("cuda") unless the
    caller asks for the plain dense march ("torch").  The ``cull_*``
    fields steer the "cuda" backend's culled kernels; ``min_denom`` guards
    the backward's denominator at grazing hits; ``bwd_cull_m`` /
    ``bwd_point_tile`` size the backward's per-tile candidate lists
    (``ops/point_eval.py``; exactness is certified per tile with a dense
    fallback, so they are pure performance knobs)."""

    max_steps: int = 192
    bound_skip: bool = True
    min_denom: float = 0.05
    backend: str = "cuda"
    # per-tile cone culling of the kernel path (ops/cuda/cull.py)
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


def check_config(cfg: MarchConfig) -> None:
    """Raise for a backend or option this port does not run."""
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown march backend {cfg.backend!r} "
                         f"(one of {BACKENDS})")
    if cfg.backend != "cuda":
        return
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
            "implement (ROADMAP, 'Not to port')")


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
                 omega: float = 1.0, sign: Tensor | None = None,
                 dist=None):
    """The plain masked march over flat ``[N]`` lanes.

    Lanes start at ``t0`` and are active while ``length > 0`` and
    ``t < length``.  Each iteration evaluates ``scene_distance`` once for
    every active lane (only those lanes are evaluated), so a lane evaluates
    at most ``max_steps`` times.  ``omega > 1`` steps by ``omega·d`` with
    the overstep revert and budget-crossing rule of the TPU kernel
    (march_kernel.py:1684-1722).  ``dist(idx, p, t)`` replaces the scene
    distance of the active lanes ``idx`` at points ``p`` / parameters ``t``
    (the culled plain march).

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
        d = chunked(sdf.scene_distance, scene, p) if dist is None \
            else dist(idx, p, ti)
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


def _flat_sign(sign: Tensor | None, batch) -> Tensor | None:
    """Per-lane ``sign`` broadcast over the ray batch, flat float32."""
    if sign is None:
        return None
    return torch.broadcast_to(sign, batch).reshape(-1).to(
        torch.float32).contiguous()


def _march_raw(scene: FlatScene, rays: Rays, cfg: MarchConfig,
               sign: Tensor | None = None) -> MarchResult:
    """The "torch" backend: plain dense march (JAX ``_march_raw``);
    ``steps`` is the iteration count broadcast over the batch."""
    batch = rays.batch_shape
    flat = flat_rays(rays)
    sign_flat = _flat_sign(sign, batch)
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


# ---------------------------------------------------------------------------
# Backward pass: implicit differentiation at the converged hit point
# ---------------------------------------------------------------------------
#
# A "scene distance" here is a pair ``(rows, at)``: ``at(lo, hi)`` gives the
# closure ``scene_d(params, x)`` for lanes ``[lo, hi)`` (``params``: kind →
# ``[K_t, P_t]``, ``x [hi-lo, 3]`` → ``[hi-lo]``, differentiable in both),
# and ``rows`` is how many lanes one chunk of the backward takes, so that
# the chunk's (second-order) graph bounds the peak memory.

def _lane_rows(device: torch.device) -> int:
    return 1 << (20 if device.type == "cuda" else 16)


def _dense_scene_d(scene: FlatScene, device: torch.device):
    """Every primitive at every lane (``sdf.scene_distance``)."""
    def scene_d(params, x):
        return sdf.scene_distance(
            dataclasses.replace(scene, prim_params=params), x)
    rows = max(1, _chunk_elems(device) // (8 * max(scene.num_prims, 1)))
    return rows, lambda lo, hi: scene_d


def _leaf_scene_d(scene: FlatScene, code: Tensor):
    """One primitive per lane: the winning leaf of the surface kernel's
    signed code (``sdf.leaf_distance``)."""
    return _lane_rows(code.device), lambda lo, hi: sdf.leaf_distance(
        scene.kind_counts, code[lo:hi])


def _culled_scene_d(scene: FlatScene, x0: Tensor, hit: Tensor,
                    cfg: MarchConfig):
    """Per-tile candidate lists around the hit points when culling is on
    (``ops/point_eval.py``), dense otherwise.  The exactness certificate
    picks the branch (``point_eval.culled_branch``), as JAX's ``lax.cond``
    on it does: the eager backward reads it on the host, and a batch with a
    tile that could rank the true argmin out of its candidates takes the
    dense evaluation; a deferred backward (``ops/deferred.py``) reads
    nothing, takes the candidate lists and raises its frame's flag where
    the certificate fails, so that the step runs again eagerly.  The
    gradient's fast path is never silently approximate."""
    if cfg.cull and cfg.backend == "cuda":
        from .point_eval import build_culled_eval, culled_branch
        built = build_culled_eval(scene, x0, hit, m=cfg.bwd_cull_m,
                                  threshold=cfg.cull_threshold,
                                  tile=cfg.bwd_point_tile,
                                  for_materials=False)
        if built is not None and culled_branch(built[4]):
            dist_fn = built[0]
            tile = cfg.bwd_point_tile

            def at(lo, hi):
                pad = (-(hi - lo)) % tile

                def scene_d(params, x):
                    if pad:
                        x = torch.cat([x, x[-1:].expand(pad, 3)])
                    d = dist_fn(params, x.reshape(-1, tile, 3), lo // tile)
                    return d.reshape(-1)[:hi - lo]
                return scene_d
            return dist_fn.g_chunk * tile, at
    return _dense_scene_d(scene, x0.device)


def hit_points(rays: Rays, t: Tensor, hit: Tensor) -> Tensor:
    """``rays.at(t)`` on hit lanes, the ray's origin on the others.  A lane
    that never enters the scene's bound carries ``t = 3e38``: a distance
    function overflows at such a point, and its non-finite derivative
    turns the zero cotangent of a masked-out lane into NaN."""
    return rays.at(torch.where(hit, t, 0.0))


def _implicit_t_denom(scene_d, params, x0: Tensor, direction: Tensor,
                      signv: Tensor | None, min_denom: float) -> Tensor:
    """``∇ₓf·d`` at the hit points with the grazing-hit guard (module
    docstring); carries no graph."""
    with torch.enable_grad():
        q = x0.detach().requires_grad_(True)
        f = scene_d({k: v.detach() for k, v in params.items()}, q)
        (gradx,) = torch.autograd.grad(f.sum(), q)
    if signv is not None:
        gradx = signv[:, None] * gradx
    den = dot(gradx, direction.detach())
    den = torch.sign(den) * torch.clamp_min(den.abs(), min_denom)
    return torch.where(den == 0.0, min_denom, den)


def implicit_vjp(scene: FlatScene, rays: Rays, t: Tensor, hit: Tensor,
                 scene_d, cfg: MarchConfig, ct_t: Tensor,
                 ct_n: Tensor | None = None, sign: Tensor | None = None,
                 need_rays: bool = True):
    """The backward of a march as a function of its residuals: cotangents
    of the hit distance ``ct_t [N]`` and (for the fused surface pass) of
    the unit normal ``ct_n [N, 3]`` → ``(params bar: kind → [K_t, P_t],
    origin bar [N, 3], direction bar [N, 3])`` (the ray bars ``None``
    without ``need_rays``).  ``rays`` is flat; ``t``/``hit`` are the raw
    march's outputs; ``scene_d`` a ``(rows, at)`` pair (see above).

    Per chunk of lanes this is one reverse sweep of

        L = Σ_hit f(θ, o + t·d)·(-ct_t / den)
            + Σ_hit ct_n · normalize(∇ₓf)(θ, o + (t(θ) - ε)·d)

    where ``den`` is the guarded ``∇ₓf·d`` and ``t(θ) = t - (f - sg f)/den``
    reattaches the hit distance by the implicit-function theorem, so the
    normal's gradient equals the unfused (march → normal) chain's without
    re-running a kernel.  ``f`` is the march-signed distance (``sign·f``);
    the normal is the outward gradient on ``sign = -1`` lanes too."""
    n = t.shape[0]
    rows, at = scene_d
    hit = hit.detach()
    # miss lanes are evaluated at their origin (see ``hit_points``)
    t = torch.where(hit, t.detach(), 0.0)
    bar_p = {k: torch.zeros_like(v) for k, v in scene.prim_params.items()}
    bar_o = torch.zeros_like(rays.origin) if need_rays else None
    bar_d = torch.zeros_like(rays.direction) if need_rays else None
    for lo in range(0, n, rows):
        hi = min(lo + rows, n)
        fn = at(lo, hi)
        tc, hc, eps = t[lo:hi], hit[lo:hi], rays.epsilon[lo:hi].detach()
        sg = None if sign is None else sign[lo:hi].detach()
        with torch.enable_grad():
            params = {k: v.detach().requires_grad_(True)
                      for k, v in scene.prim_params.items()}
            o = rays.origin[lo:hi].detach().requires_grad_(need_rays)
            d = rays.direction[lo:hi].detach().requires_grad_(need_rays)
            x = o + tc[:, None] * d
            den = _implicit_t_denom(fn, params, x, d, sg, cfg.min_denom)
            f0 = fn(params, x)
            if sg is not None:
                f0 = sg * f0
            # dt = -(df)/den on hit lanes
            loss = torch.sum(f0 * torch.where(hc, -ct_t[lo:hi] / den, 0.0))
            if ct_n is not None:
                t_diff = tc - (f0 - f0.detach()) / den
                p = o + (t_diff - eps)[:, None] * d
                (g,) = torch.autograd.grad(fn(params, p).sum(), p,
                                           create_graph=True)
                loss = loss + torch.sum(normalize(g) * torch.where(
                    hc[:, None], ct_n[lo:hi], 0.0))
            leaves = list(params.values()) + ([o, d] if need_rays else [])
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for k, gk in zip(params, grads):
            if gk is not None:
                bar_p[k] += gk
        if need_rays:
            for bar, gk in zip((bar_o, bar_d), grads[len(params):]):
                if gk is not None:
                    bar[lo:hi] = gk
    return bar_p, bar_o, bar_d


def _surface_scene_d(scene: FlatScene, rays: Rays, t: Tensor, hit: Tensor,
                     code: Tensor, cfg: MarchConfig, sign: Tensor | None):
    """The scene distance the fused-surface backward differentiates: the
    winning leaf for plans of min/max alone (slot mode), per-tile candidate
    lists for plans with a smooth union (code 0), the dense scene distance
    for ``sign`` lanes of such plans."""
    from .cuda.march_kernel import slot_surface_mode
    if slot_surface_mode(scene.plan):
        return _leaf_scene_d(scene, code)
    if sign is None:
        return _culled_scene_d(scene, rays.at(t).detach(), hit, cfg)
    return _dense_scene_d(scene, t.device)


class _MarchFn(torch.autograd.Function):
    """The raw march (and, with ``surface``, the fused surface pass) with
    the implicit-differentiation backward.  Tensor inputs: ``sign`` (or
    None), the flat rays' four fields, then one parameter matrix per kind.
    Outputs ``(t, hit, distance, steps)`` plus ``(normal, material, code)``
    with ``surface``; only ``t`` and ``normal`` carry gradient.

    The backward runs in the forward's deferred frame (``ops/deferred.py``),
    if any: autograd runs the backward of CUDA tensors on a thread of its
    own, where the context variable that names the frame is unset, so the
    forward hands the frame over in ``ctx``."""

    @staticmethod
    def forward(ctx, scene, cfg, surface, sign, origin, direction, length,
                epsilon, *params):
        rays = Rays(origin, direction, length, epsilon)
        ctx.scene, ctx.cfg, ctx.surface = scene, cfg, surface
        ctx.frame = deferred.current()
        ctx.has_sign = sign is not None
        if surface:
            from .cuda.march_kernel import cuda_march_raw
            res, normal, midx, code = cuda_march_raw(
                scene, rays, cfg, want_surface=True, sign=sign)
            out = (res.t, res.hit, res.distance, res.steps, normal, midx,
                   code)
            ctx.mark_non_differentiable(res.hit, res.distance, res.steps,
                                        midx, code)
            extra = (code,)
        else:
            res = _raw_flat(scene, rays, cfg, sign)
            out = (res.t, res.hit, res.distance, res.steps)
            ctx.mark_non_differentiable(res.hit, res.distance, res.steps)
            extra = ()
        ctx.save_for_backward(origin, direction, epsilon, res.t, res.hit,
                              *extra, *((sign,) if ctx.has_sign else ()),
                              *params)
        return out

    @staticmethod
    def backward(ctx, ct_t, _hit, _dist, _steps, ct_n=None, _m=None,
                 _code=None):
        if ctx.frame is None:
            return _MarchFn._backward(ctx, ct_t, ct_n)
        with deferred.deferring(ctx.frame):
            return _MarchFn._backward(ctx, ct_t, ct_n)

    @staticmethod
    def _backward(ctx, ct_t, ct_n):
        saved = list(ctx.saved_tensors)
        origin, direction, epsilon, t, hit = saved[:5]
        rest = saved[5:]
        code = rest.pop(0) if ctx.surface else None
        sign = rest.pop(0) if ctx.has_sign else None
        scene = dataclasses.replace(
            ctx.scene, prim_params=dict(zip(ctx.scene.prim_params, rest)))
        rays = Rays(origin, direction, torch.zeros_like(t), epsilon)
        cfg = ctx.cfg
        t = torch.where(hit, t, 0.0)      # see ``hit_points``
        if ctx.surface:
            scene_d = _surface_scene_d(scene, rays, t, hit, code, cfg, sign)
        elif sign is None:
            scene_d = _culled_scene_d(scene, rays.at(t), hit, cfg)
        else:
            scene_d = _dense_scene_d(scene, t.device)
        need_rays = ctx.needs_input_grad[4] or ctx.needs_input_grad[5]
        bar_p, bar_o, bar_d = implicit_vjp(
            scene, rays, t, hit, scene_d, cfg, ct_t,
            ct_n if ctx.surface else None, sign, need_rays)
        # scene, cfg, surface, sign; origin, direction, length, epsilon
        return (None, None, None, None, bar_o, bar_d, None, None,
                *bar_p.values())


def _raw_flat(scene: FlatScene, rays: Rays, cfg: MarchConfig,
              sign: Tensor | None) -> MarchResult:
    """The raw march of a flat ray batch on ``cfg.backend``."""
    if cfg.backend == "cuda":
        from .cuda.march_kernel import cuda_march_raw
        return cuda_march_raw(scene, rays, cfg, sign=sign)
    with torch.no_grad():
        return _march_raw(scene, rays, cfg, sign)


def _wants_grad(scene: FlatScene, rays: Rays) -> bool:
    """True when autograd must see the march: grad mode is on and a
    parameter matrix or a ray field the backward reaches requires grad."""
    return torch.is_grad_enabled() and (
        rays.origin.requires_grad or rays.direction.requires_grad
        or any(p.requires_grad for p in scene.prim_params.values()))


def march(scene: FlatScene, rays: Rays, cfg: MarchConfig = MarchConfig(),
          sign: Tensor | None = None) -> MarchResult:
    """Sphere-trace ``rays`` against ``scene``; ``t`` is differentiable at
    hits w.r.t. the scene's parameters and the rays' origin and direction
    (implicit differentiation, module docstring; nothing extra runs when
    no input requires grad).  ``sign`` (per-lane ±1) multiplies the scene
    distance: -1 lanes march inside the solid toward its exit surface."""
    check_config(cfg)
    batch = rays.batch_shape
    flat = flat_rays(rays)
    sign_flat = _flat_sign(sign, batch)
    if _wants_grad(scene, flat):
        t, hit, d, steps = _MarchFn.apply(
            scene, cfg, False, sign_flat, flat.origin, flat.direction,
            flat.length, flat.epsilon, *scene.prim_params.values())
        res = MarchResult(hit=hit, t=t, distance=d, steps=steps)
    else:
        res = _raw_flat(scene, flat, cfg, sign_flat)
    return res.map(lambda x: x.reshape(batch))


def march_occlusion(scene: FlatScene, rays: Rays,
                    cfg: MarchConfig = MarchConfig(),
                    sign: Tensor | None = None,
                    cone_apex: Tensor | None = None,
                    axial_key: Tensor | None = None) -> Tensor:
    """Any-hit occlusion test: the hit mask only, identical to
    ``march(...).hit`` (same stepping, same termination).  ``cone_apex
    [3]``: every ray ends at this point (point-light shadow rays); the
    culled kernel then selects candidates with the converging cone, which
    may flip grazing lanes.  ``axial_key`` only steers the TPU layout knob
    ``shadow_axial_sort``, which the port does not run.  The mask is
    boolean: the inputs are detached and autograd never sees this march
    (hard shadows are binary in the reference too)."""
    del axial_key
    check_config(cfg)
    rays = rays.map(torch.Tensor.detach)
    if cfg.backend == "cuda":
        from .cuda.march_kernel import cuda_march_raw
        batch = rays.batch_shape
        # the shadow-sized candidate table (march.py:636-638)
        cfg = dataclasses.replace(
            cfg, cull_m=max(cfg.cull_m, cfg.cull_m_shadow))
        hit = cuda_march_raw(scene, flat_rays(rays), cfg, occlusion=True,
                             cone_apex=cone_apex,
                             sign=_flat_sign(sign, batch))
        return hit.reshape(batch)
    with torch.no_grad():
        return _march_raw(scene, rays, cfg, sign).hit


def march_surface(scene: FlatScene, rays: Rays,
                  cfg: MarchConfig = MarchConfig(),
                  sign: Tensor | None = None):
    """March + shading-ready surface info.

    Returns ``(MarchResult, normal [..., 3], material_index [...])``: the
    unit normal at the epsilon backed-off hit point (the outward SDF
    gradient, on ``sign=-1`` lanes too) and the CSG-aware winning material
    (-1 on miss).  On the "cuda" backend with ``fuse_surface`` this is the
    march kernel followed by the surface kernel (slot mode, or AD mode for
    a plan with a smooth union); ``t`` and ``normal`` stay differentiable
    through the implicit-differentiation backward.  Otherwise march + dense
    evaluation."""
    check_config(cfg)
    batch = rays.batch_shape
    if cfg.backend == "cuda" and cfg.fuse_surface:
        flat = flat_rays(rays)
        sign_flat = _flat_sign(sign, batch)
        if _wants_grad(scene, flat):
            t, hit, d, steps, normal, midx, _code = _MarchFn.apply(
                scene, cfg, True, sign_flat, flat.origin, flat.direction,
                flat.length, flat.epsilon, *scene.prim_params.values())
            res = MarchResult(hit=hit, t=t, distance=d, steps=steps)
        else:
            from .cuda.march_kernel import cuda_march_raw
            res, normal, midx, _code = cuda_march_raw(
                scene, flat, cfg, want_surface=True, sign=sign_flat)
        return (res.map(lambda x: x.reshape(batch)),
                normal.reshape(batch + (3,)), midx.reshape(batch))
    res = march(scene, rays, cfg, sign=sign)
    pos = hit_points(rays, res.t - rays.epsilon, res.hit).reshape(-1, 3)
    normal = chunked(sdf.scene_normal, scene, pos)
    with torch.no_grad():
        midx = chunked(sdf.material_index_at, scene, pos)
    return (res, normal.reshape(batch + (3,)),
            torch.where(res.hit, midx.reshape(batch), -1))
