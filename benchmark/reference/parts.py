"""The plain frame of the machined-parts scene (``configs/parts1000.json``):
its distance, the relaxed march, the surface pass and the shading, written
from the published formulas in plain PyTorch, in the dtype of the tensors
handed in (float64 for the check).  It imports nothing of the port.

A part is ``max(max(box, sphere), −min(cone₀, cone₁, cone₂))``, the scene
``max(max(min over parts, clip), −cut)``.  The leaves are Inigo Quilez's
published distances (iquilezles.org, "distance functions"): the sphere,
``sdRoundBox`` and ``sdCappedCone``.  A box row holds its centre, its
half-extents inside the rounding and the rounding radius, so its
``sdRoundBox`` extents are the half-extents plus the radius.

The winning leaf, whose gradient is the normal, is the one the CSG tree
selects (the left operand on a tie; a subtract's right operand negated);
the material is that of the nearest leaf whose path from the root passes
no subtract's right operand: the boxes and part spheres (upstream
``SdfObject.fs`` 50-64).  The march, the bound and the shading are those
of ``render.py``: sphere tracing over-relaxed by ω with the overstep
revert, started where the ray enters the root bounding sphere, and
``albedo · (background + Σ unoccluded facing lights · I · cos) / π``.
Every leaf is evaluated at every step, in chunks of points.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference.render import (BIG, CHUNK_ELEMS, _norm, _unit,
                                        camera_rays, direct_light, light_terms)

SPHERE, BOX, CONE, CLIP, CUT = 0, 1, 2, 3, 4

__all__ = ["leaves_of", "camera_rays", "scene_eval", "root_bound", "march",
           "shade_rays"]


def leaves_of(arrays, device, dtype) -> dict:
    """The scene's floating tensors (``parts.PartArrays``)."""
    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device).clone()
    return {
        "sphere": t(arrays.sphere), "box": t(arrays.box),
        "cone": t(arrays.cones), "clip": t(arrays.clip), "cut": t(arrays.cut),
        "box_albedo": t(arrays.box_albedo),
        "sphere_albedo": t(arrays.sphere_albedo),
        "light_vec": t(arrays.light_vec),
        "light_color": t(arrays.light_color),
        "light_shadow_len": t(arrays.light_shadow_len),
        "background": t(arrays.background),
    }


# ---------------------------------------------------------------------------
# Leaves: coordinates ``x, y, z`` against rows, broadcast (``[m, 1]``
# against ``[K]``, or ``[m]`` against ``[m]``)
# ---------------------------------------------------------------------------

def _root(v):
    return torch.sqrt(torch.clamp_min(v, 0.0) + 1e-20)


def sd_sphere(s, x, y, z):
    dx, dy, dz = x - s[..., 0], y - s[..., 1], z - s[..., 2]
    return _root(dx * dx + dy * dy + dz * dz) - s[..., 3]


def sd_round_box(b, x, y, z):
    """``sdRoundBox(p − c, half + r, r)``."""
    r = b[..., 6]
    qx = torch.abs(x - b[..., 0]) - (b[..., 3] + r) + r
    qy = torch.abs(y - b[..., 1]) - (b[..., 4] + r) + r
    qz = torch.abs(z - b[..., 2]) - (b[..., 5] + r) + r
    ox, oy, oz = (torch.clamp_min(qx, 0.0), torch.clamp_min(qy, 0.0),
                  torch.clamp_min(qz, 0.0))
    inside = torch.clamp_max(torch.maximum(qx, torch.maximum(qy, qz)), 0.0)
    return _root(ox * ox + oy * oy + oz * oz) + inside - r


def sd_capped_cone(c, x, y, z):
    """``sdCappedCone(p, a, b, ra, rb)``: the cone between the disk of
    radius ``ra`` about ``a`` and that of ``rb`` about ``b``."""
    ra, rb = c[..., 6], c[..., 7]
    bax, bay, baz = c[..., 3] - c[..., 0], c[..., 4] - c[..., 1], \
        c[..., 5] - c[..., 2]
    pax, pay, paz = x - c[..., 0], y - c[..., 1], z - c[..., 2]
    rba = rb - ra
    baba = bax * bax + bay * bay + baz * baz
    papa = pax * pax + pay * pay + paz * paz
    paba = (pax * bax + pay * bay + paz * baz) / baba
    px = _root(papa - paba * paba * baba)
    cax = torch.clamp_min(px - torch.where(paba < 0.5, ra, rb), 0.0)
    cay = torch.abs(paba - 0.5) - 0.5
    k = rba * rba + baba
    f = torch.clamp((rba * (px - ra) + paba * baba) / k, 0.0, 1.0)
    cbx = px - ra - f * rba
    cby = paba - f
    s = torch.where((cbx < 0.0) & (cay < 0.0), -1.0, 1.0).to(px.dtype)
    return s * _root(torch.minimum(cax * cax + cay * cay * baba,
                                   cbx * cbx + cby * cby * baba))


# ---------------------------------------------------------------------------
# The scene
# ---------------------------------------------------------------------------

def _block(lv: dict, p):
    """At points ``p [m, 3]``: the distance, the winning leaf
    ``(kind, part, drill, sign)`` and the material's albedo."""
    x, y, z = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    k = lv["box"].shape[0]
    ds = sd_sphere(lv["sphere"], x, y, z)                       # [m, K]
    db = sd_round_box(lv["box"], x, y, z)
    dc = sd_capped_cone(lv["cone"].reshape(3 * k, 8), x, y, z) \
        .reshape(-1, k, 3)
    solid = torch.maximum(ds, db)
    box_wins = db > ds          # the box follows the sphere in slot order
    drill, dj = torch.min(dc, -1)
    part = torch.maximum(solid, -drill)
    cut_in = ~(solid > -drill)
    u, ui = torch.min(part, -1)
    rows = torch.arange(p.shape[0], device=p.device)
    kind = torch.where(box_wins[rows, ui], BOX, SPHERE)
    kind = torch.where(cut_in[rows, ui], CONE, kind)
    dj = dj[rows, ui]
    clip = sd_sphere(lv["clip"], p[:, 0], p[:, 1], p[:, 2])
    cut = sd_sphere(lv["cut"], p[:, 0], p[:, 1], p[:, 2])
    inter = torch.maximum(u, clip)
    kind = torch.where(u >= clip, kind, CLIP)
    d = torch.maximum(inter, -cut)
    kind = torch.where(inter > -cut, kind, CUT)
    # a drill wall and the cut sphere are right operands: negated
    sign = torch.where((kind == CONE) | (kind == CUT), -1.0, 1.0).to(p.dtype)
    vis = torch.cat([ds, db], -1)       # spheres, then boxes: slot order
    win = torch.argmin(vis, -1)
    albedo = torch.cat([lv["sphere_albedo"], lv["box_albedo"]])[win]
    return d, (kind, ui, dj, sign), albedo


@torch.no_grad()
def scene_eval(lv: dict, p):
    """``(distance, (kind, part, drill, sign), albedo)`` at ``p [m, 3]``,
    in chunks of points."""
    rows = max(1, CHUNK_ELEMS // (5 * lv["box"].shape[0]))
    outs = [_block(lv, p[i:i + rows]) for i in range(0, p.shape[0], rows)]
    if not outs:
        return _block(lv, p)
    return (torch.cat([o[0] for o in outs]),
            tuple(torch.cat([o[1][j] for o in outs]) for j in range(4)),
            torch.cat([o[2] for o in outs]))


def leaf_value(lv: dict, code, p):
    """The signed distance of each point's winning leaf at ``p``
    (differentiable in ``p``)."""
    kind, part, drill, sign = code
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    out = torch.zeros_like(x)
    fns = {SPHERE: lambda i: sd_sphere(lv["sphere"][part[i]], *q(i)),
           BOX: lambda i: sd_round_box(lv["box"][part[i]], *q(i)),
           CONE: lambda i: sd_capped_cone(lv["cone"][part[i], drill[i]],
                                          *q(i)),
           CLIP: lambda i: sd_sphere(lv["clip"], *q(i)),
           CUT: lambda i: sd_sphere(lv["cut"], *q(i))}

    def q(i):
        return x[i], y[i], z[i]
    for kd, fn in fns.items():
        i = torch.nonzero(kind == kd).squeeze(1)
        if i.numel():
            out = out.index_put((i,), fn(i))
    return sign * out


def leaf_normal(lv: dict, code, p):
    """Unit gradient of the winning leaf's signed distance at ``p``."""
    with torch.enable_grad():
        q = p.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(leaf_value(lv, code, q).sum(), q)
    return _unit(g)


@torch.no_grad()
def root_bound(lv: dict):
    """The scene's bounding sphere by the bound algebra of the CSG tree: a
    part's is the smaller of its box's (half-diagonal plus rounding) and
    its sphere's (the intersection; the drills take nothing away from a
    bound), the union's the enclosing sphere of the parts' (centre of the
    box around them, radius to the farthest), then the smaller of that and
    the clip sphere, which the cut leaves as it is."""
    box, sph = lv["box"], lv["sphere"]
    box_r = _norm(box[:, 3:6]) + box[:, 6]
    pb = torch.where((sph[:, 3] <= box_r)[:, None], sph,
                     torch.cat([box[:, 0:3], box_r[:, None]], 1))
    c, rad = pb[:, 0:3], pb[:, 3]
    lo = torch.amin(c - rad[:, None], 0)
    hi = torch.amax(c + rad[:, None], 0)
    centre = 0.5 * (lo + hi)
    ub = torch.cat([centre, torch.amax(_norm(c - centre) + rad)[None]])
    clip = lv["clip"]
    return ub if ub[3] <= clip[3] else clip


# ---------------------------------------------------------------------------
# March and shading
# ---------------------------------------------------------------------------

@torch.no_grad()
def march(lv: dict, o, d, length, eps: float, march_cfg: dict):
    """The relaxed sphere trace of rays ``o + t·d`` → ``(t, hit)``, as
    ``render.march``: the bound skip (enter less epsilon, leave plus 4
    epsilon, miss when the ray cannot enter), at most ``max_steps``
    evaluations a ray, a step of ω·d with the overstep revert, and d alone
    where the relaxed step would cross the budget."""
    n = o.shape[0]
    dt = o.dtype
    length = length.clone()
    t0 = torch.zeros(n, dtype=dt, device=o.device)
    if march_cfg["bound_skip"]:
        b4 = root_bound(lv).to(dt)
        oc = o - b4[0:3]
        b = torch.sum(oc * d, -1)
        c = torch.sum(oc * oc, -1) - b4[3] * b4[3]
        disc = b * b - c
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        outside = c > 0.0
        no_hit = outside & ((disc < 0.0) | (b > 0.0))
        enter = torch.clamp_min(-b - sq - eps, 0.0)
        t_exit = torch.where(no_hit, 0.0, -b + sq + 4.0 * eps)
        t0 = torch.where(outside & ~no_hit, enter, 0.0).to(dt)
        length = torch.where(no_hit, 0.0, torch.minimum(length, t_exit))
    t = t0.clone()
    hit = torch.zeros(n, dtype=torch.bool, device=o.device)
    active = (length > 0.0) & (t0 < length)
    omega = float(march_cfg["relax_omega"])
    d_start = torch.full((n,), BIG, dtype=dt, device=o.device)
    taken = torch.zeros(n, dtype=dt, device=o.device)
    for _ in range(int(march_cfg["max_steps"])):
        idx = torch.nonzero(active).squeeze(1)
        if idx.numel() == 0:
            break
        ti, li = t[idx], length[idx]
        dist = scene_eval(lv, o[idx] + ti[:, None] * d[idx])[0]
        if omega > 1.0:
            ds, st = d_start[idx], taken[idx]
            over = st > ds + dist
            is_hit = ~over & (dist < eps)
            rel = omega * dist
            step = torch.where(ti + rel >= li, dist, rel)
            adv = torch.where(over | is_hit, 0.0, step)
            t_new = torch.where(over, ti - st + ds, ti + adv)
            still = over | (~is_hit & (t_new < li))
            d_start[idx] = torch.where(over, ds, dist)
            taken[idx] = torch.where(over, ds, adv)
        else:
            is_hit = dist < eps
            t_new = ti + torch.where(is_hit, 0.0, dist)
            still = ~is_hit & (t_new < li)
        t[idx] = t_new
        hit[idx] |= is_hit
        active[idx] = still
    return t, hit


@torch.no_grad()
def occlusion(lv, kinds, pos, normal, eps: float, march_cfg: dict):
    """Per light: ``(facing, occluded)`` of the points ``pos`` with unit
    ``normal``; only facing points march their shadow ray."""
    out = []
    for i in range(len(kinds)):
        ldir, budget, _s = light_terms(lv, kinds, i, pos)
        facing = torch.sum(normal * ldir, -1) > 0.0
        occ = torch.zeros_like(facing)
        idx = torch.nonzero(facing).squeeze(1)
        if idx.numel():
            occ[idx] = march(lv, pos[idx], ldir[idx].contiguous(),
                             budget[idx].contiguous(), eps, march_cfg)[1]
        out.append((facing, occ))
    return out


@torch.no_grad()
def shade_rays(lv: dict, kinds, o, d, eps: float, length: float,
               march_cfg: dict):
    """Colours of primary rays: the background on a miss, else the
    shaded, epsilon backed-off hit point.  ``(colour [n, 3], hit [n])``."""
    n = o.shape[0]
    t, hit = march(lv, o, d, torch.full((n,), length, dtype=o.dtype,
                                        device=o.device), eps, march_cfg)
    col = lv["background"].expand(n, 3).clone()
    idx = torch.nonzero(hit).squeeze(1)
    if idx.numel():
        pos = o[idx] + (t[idx] - eps)[:, None] * d[idx]
        _d, code, albedo = scene_eval(lv, pos)
        normal = leaf_normal(lv, code, pos)
        shadows = occlusion(lv, kinds, pos, normal, eps, march_cfg)
        light = direct_light(lv, kinds, pos, normal, shadows)
        col[idx] = albedo * light / math.pi
    return col, hit
