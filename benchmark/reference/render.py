"""The plain frame: rays, the scene's distance, the relaxed march, the
surface pass and the Lambert shading with hard shadows.

The semantics are the configuration's, as the upstream program and the
port define them: sphere tracing that misses when the travel budget is
spent and hits where the distance drops below epsilon, started at the
root bounding sphere (``bound_skip``) and over-relaxed by ``relax_omega``
with the overstep revert; the hit point backed off by epsilon; the unit
normal of the winning leaf there; the material of the nearest torus;
``albedo · (background + Σ unoccluded facing lights · I · cos) / π``.

Every primitive is evaluated at every step (no culling), in the dtype of
the tensors handed in.  The union of tori is evaluated through two small
matrix products per chunk of points (``|q|²`` and ``q·n`` by expansion),
the rest elementwise.
"""
from __future__ import annotations

import math

import torch

BIG = 3.0e38
TORUS, CLIP, CUT = 0, 1, 2
# elements of one [points, tori] block of the dense evaluation
CHUNK_ELEMS = 1 << 24


def leaves_of(arrays, device, dtype) -> dict:
    """The scene's floating tensors, named as the port names its leaves
    (one material a torus here)."""
    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device).clone()
    return {
        "prim_params/sphere": t([list(arrays.clip), list(arrays.cut)]),
        "prim_params/torus": t(arrays.tori),
        "mat_albedo": t(arrays.albedo), "mat_emission": t(arrays.emission),
        "mat_reflectivity": t(arrays.reflectivity),
        "mat_ior": t(arrays.ior), "mat_tint": t(arrays.tint),
        "light_vec": t(arrays.light_vec),
        "light_color": t(arrays.light_color),
        "light_shadow_len": t(arrays.light_shadow_len),
        "background": t(arrays.background),
    }


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1) + 1e-20)


def _unit(v):
    return v / _norm(v)[..., None]


# ---------------------------------------------------------------------------
# Camera
# ---------------------------------------------------------------------------

def camera_rays(cam: dict, width: int, height: int, pixels, device, dtype):
    """Origins and unit directions of the pixels ``pixels`` (row-major
    indices, row 0 the top): the pinhole camera of the upstream program
    with the field of view in degrees and a half-size of tan(fov/2)."""
    f = dict(dtype=torch.float64, device=device)
    pos = torch.tensor(cam["position"], **f)
    fwd = _unit(torch.tensor(cam["target"], **f) - pos)
    right = _unit(torch.linalg.cross(torch.tensor(cam["up"], **f), fwd))
    up = torch.linalg.cross(fwd, right)
    half = math.tan(math.radians(cam["fov_degrees"]) * 0.5)
    pixels = torch.as_tensor(pixels, device=device)
    y, x = pixels // width, pixels % width
    m = float(max(width, height))
    u = (x.to(torch.float64) + 0.5) / m
    v = ((height - 1 - y).to(torch.float64) + 0.5) / m
    ndc_u = 2.0 * (u - 0.5 * width / m)
    ndc_v = 2.0 * (v - 0.5 * height / m)
    d = _unit(fwd + (ndc_u[:, None] * right + ndc_v[:, None] * up) * half)
    o = pos.expand(d.shape)
    return o.to(dtype).contiguous(), d.to(dtype).contiguous()


# ---------------------------------------------------------------------------
# Distance
# ---------------------------------------------------------------------------

def _tori_parts(tori):
    return tori[:, 0:3], _unit(tori[:, 3:6]), tori[:, 6], tori[:, 7]


def _union_block(p, c, n, cn, cc, R, r):
    """min over the tori at points ``p [m, 3]`` and the first argmin."""
    h = p @ n.T - cn
    q2 = torch.sum(p * p, -1, keepdim=True) - 2.0 * (p @ c.T) + cc
    radial = torch.sqrt(torch.clamp_min(q2 - h * h, 0.0)) - R
    d = torch.sqrt(h * h + radial * radial) - r
    return torch.min(d, dim=-1)


def _sphere_d(p, s):
    return _norm(p - s[0:3]) - s[3]


@torch.no_grad()
def scene_eval(lv: dict, p):
    """``(distance, winning leaf kind, nearest torus)`` at ``p [m, 3]``:
    ``max(max(min_tori, clip), -cut)``; the winner as the CSG tree picks
    it (the union on a tie with the clip sphere, the cut sphere only where
    it is strictly larger)."""
    c, n, R, r = _tori_parts(lv["prim_params/torus"])
    cn, cc = torch.sum(c * n, -1), torch.sum(c * c, -1)
    rows = max(1, CHUNK_ELEMS // c.shape[0])
    us, uis = [], []
    for i in range(0, p.shape[0], rows):
        u, ui = _union_block(p[i:i + rows], c, n, cn, cc, R, r)
        us.append(u)
        uis.append(ui)
    if not us:
        e = p.new_zeros(0)
        return e, e.long(), e.long()
    u, ui = torch.cat(us), torch.cat(uis)
    sph = lv["prim_params/sphere"]
    s1, s2 = _sphere_d(p, sph[0]), _sphere_d(p, sph[1])
    inter = torch.maximum(u, s1)
    kind = torch.where(u >= s1, TORUS, CLIP)
    kind = torch.where(inter > -s2, kind, CUT)
    return torch.maximum(inter, -s2), kind, ui


def leaf_distance(lv: dict, kind, ui, p):
    """The distance of each point's winning leaf (differentiable in the
    leaves and in ``p``): the torus ``ui``, the clip sphere, or the cut
    sphere negated."""
    tor = lv["prim_params/torus"].index_select(0, ui)
    c, n, R, r = _tori_parts(tor)
    q = p - c
    h = torch.sum(q * n, -1)
    radial = _norm(q - h[:, None] * n) - R
    dt = torch.sqrt(h * h + radial * radial + 1e-20) - r
    sph = lv["prim_params/sphere"]
    s1, s2 = _sphere_d(p, sph[0]), _sphere_d(p, sph[1])
    return torch.where(kind == TORUS, dt, torch.where(kind == CLIP, s1, -s2))


def leaf_normal(lv: dict, kind, ui, p, create_graph: bool = False):
    """Unit gradient of the winning leaf at ``p``."""
    with torch.enable_grad():
        q = p if p.requires_grad else p.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(leaf_distance(lv, kind, ui, q).sum(), q,
                                   create_graph=create_graph)
    return _unit(g)


@torch.no_grad()
def root_bound(lv: dict):
    """The scene's bounding sphere: the union's enclosing sphere (centre
    of the box around the tori's spheres of radius R + r, radius to the
    farthest of them), the smaller of it and the clip sphere for the
    intersection, and that for the subtraction."""
    tori = lv["prim_params/torus"]
    c, rad = tori[:, 0:3], tori[:, 6] + tori[:, 7]
    lo = torch.amin(c - rad[:, None], 0)
    hi = torch.amax(c + rad[:, None], 0)
    centre = 0.5 * (lo + hi)
    ub = torch.cat([centre, torch.amax(_norm(c - centre) + rad)[None]])
    clip = lv["prim_params/sphere"][0]
    return ub if ub[3] <= clip[3] else clip


# ---------------------------------------------------------------------------
# March
# ---------------------------------------------------------------------------

@torch.no_grad()
def march(lv: dict, o, d, length, eps: float, march_cfg: dict, sign=None):
    """The relaxed sphere trace of rays ``o + t·d`` → ``(t, hit)``.

    With ``bound_skip`` a ray starts where it enters the root bound (less
    epsilon), misses when it cannot enter, and its budget ends where it
    leaves (plus 4 epsilon); ``sign = -1`` lanes (inside glass) march
    ``-distance`` from ``t = 0``.  A lane evaluates the distance at most
    ``max_steps`` times.  With ``relax_omega`` ω > 1 a step is ω·d; when
    the new point's distance sphere and the last one's leave a gap (the
    step taken exceeds their radii's sum) the lane goes back to the last
    point's safe landing, and a relaxed step that would cross the budget
    is d alone."""
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
        if sign is not None:
            outward = sign > 0.0
            outside, no_hit = outside & outward, no_hit & outward
            t_exit = torch.where(outward, t_exit, length)
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
        if sign is not None:
            dist = sign[idx] * dist
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


# ---------------------------------------------------------------------------
# Shading
# ---------------------------------------------------------------------------

def light_terms(lv: dict, kinds, i: int, pos):
    """Unit direction toward light ``i``, its shadow budget and the
    intensity scale at ``pos``: a directional light shines along ``vec``
    with its shadow length; a point light at ``vec`` falls off as 1/dist²."""
    vec = lv["light_vec"][i]
    if kinds[i] == "directional":
        ldir = (-vec / _norm(vec)).expand(pos.shape)
        budget = lv["light_shadow_len"][i].expand(pos.shape[:-1])
        return ldir, budget, torch.ones_like(budget)
    diff = vec - pos
    dist2 = torch.clamp_min(torch.sum(diff * diff, -1), 1e-12)
    dist = torch.sqrt(dist2)
    return diff / dist[:, None], dist, 1.0 / dist2


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


def direct_light(lv, kinds, pos, normal, shadows):
    """``background + Σ_lights 1[facing ∧ ¬occluded] · I · scale · cos``."""
    acc = lv["background"].expand(pos.shape)
    for i, (facing, occ) in enumerate(shadows):
        ldir, _b, scale = light_terms(lv, kinds, i, pos)
        cos = torch.sum(normal * ldir, -1)
        contrib = lv["light_color"][i] * (scale * cos)[:, None]
        acc = acc + torch.where((facing & ~occ)[:, None], contrib, 0.0)
    return acc


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
        _f, kind, ui = scene_eval(lv, pos)
        normal = leaf_normal(lv, kind, ui, pos)
        shadows = occlusion(lv, kinds, pos, normal, eps, march_cfg)
        light = direct_light(lv, kinds, pos, normal, shadows)
        col[idx] = (lv["mat_albedo"][ui] * light / math.pi
                    + lv["mat_emission"][ui])
    return col, hit
