"""Batched SDF evaluation over flattened scenes.

Counterpart of ``fraytracer_tpu.ops.sdf`` (reference ``SdfForm.fs``): every
function is shape-polymorphic over a leading batch of query points
``p [..., 3]`` and vectorizes over all primitives of a kind at once.

The per-kind distance functions read their parameters as
``params[..., j]``, so ``params`` is either a kind's ``[K, P]`` matrix
(→ ``[..., K]`` distances to every primitive) or per-lane rows
``[n, 1, P]`` against ``p [n, 3]`` (→ ``[n, 1]``, one primitive per lane).

Key entry points: :func:`prim_distances`, :func:`scene_distance`,
:func:`scene_normal` (autograd), :func:`material_at`,
:func:`winning_leaf_code`, :func:`leaf_distance` / :func:`leaf_normal` (one
primitive per lane, for the backward pass), and the bounding spheres
:func:`prim_bounds` / :func:`root_bound`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..scene.flatten import FlatScene, Plan
from ..scene.nodes import MAT_PROCEDURAL
from ..types import cross, dot, norm, normalize
from . import deferred

Tensor = torch.Tensor

_BIG = 3.0e38  # effectively +inf in float32 without overflowing arithmetic


# ---------------------------------------------------------------------------
# Per-kind distance functions.  params: [..., P], p: [..., 3] -> [..., K]
# ---------------------------------------------------------------------------

def _d_sphere(params: Tensor, p: Tensor) -> Tensor:
    """|p - c| - r  (reference SdfForm.fs:125-135)."""
    c, r = params[..., 0:3], params[..., 3]
    return norm(p[..., None, :] - c) - r


def _d_capsule(params: Tensor, p: Tensor) -> Tensor:
    """Distance to segment [a,b] minus radius (reference SdfForm.fs:145-170)."""
    a, b, r = params[..., 0:3], params[..., 3:6], params[..., 6]
    pa = p[..., None, :] - a
    ba = b - a
    denom = torch.clamp_min(dot(ba, ba), 1e-20)
    h = torch.clamp(torch.sum(pa * ba, dim=-1) / denom, 0.0, 1.0)
    return norm(pa - h[..., None] * ba) - r


def _d_torus(params: Tensor, p: Tensor) -> Tensor:
    """Torus with centre c, axis n, radii (R, r):
    sqrt(h² + (|q - h·n| - R)²) - r (reference SdfForm.fs:181-203)."""
    c, n = params[..., 0:3], params[..., 3:6]
    R, r = params[..., 6], params[..., 7]
    n = normalize(n)
    q = p[..., None, :] - c
    h = torch.sum(q * n, dim=-1)
    radial = norm(q - h[..., None] * n) - R
    return torch.sqrt(h * h + radial * radial + 1e-20) - r


def _d_triangle(params: Tensor, p: Tensor) -> Tensor:
    """Rounded triangle, branch-free point-triangle distance (reference
    SdfForm.fs:214-250)."""
    v1, v2, v3 = params[..., 0:3], params[..., 3:6], params[..., 6:9]
    r = params[..., 9]
    v21, v32, v13 = v2 - v1, v3 - v2, v1 - v3
    nor = cross(v21, v13)

    p1 = p[..., None, :] - v1
    p2 = p[..., None, :] - v2
    p3 = p[..., None, :] - v3

    def edge_d2(e, q):
        denom = torch.clamp_min(dot(e, e), 1e-20)
        h = torch.clamp(torch.sum(q * e, dim=-1) / denom, 0.0, 1.0)
        diff = q - h[..., None] * e
        return torch.sum(diff * diff, dim=-1)

    d2_edges = torch.minimum(
        edge_d2(v21, p1),
        torch.minimum(edge_d2(v32, p2), edge_d2(v13, p3)))

    s1 = torch.sign(torch.sum(cross(v21, nor) * p1, dim=-1))
    s2 = torch.sign(torch.sum(cross(v32, nor) * p2, dim=-1))
    s3 = torch.sign(torch.sum(cross(v13, nor) * p3, dim=-1))
    inside = (s1 + s2 + s3) >= 2.0

    nor2 = torch.clamp_min(dot(nor, nor), 1e-20)
    h = torch.sum(nor * p1, dim=-1)
    d2_face = h * h / nor2
    return torch.sqrt(torch.where(inside, d2_face, d2_edges) + 1e-20) - r


def _d_box(params: Tensor, p: Tensor) -> Tensor:
    """Rounded axis-aligned box."""
    c, half, r = params[..., 0:3], params[..., 3:6], params[..., 6]
    q = torch.abs(p[..., None, :] - c) - half
    outside = norm(torch.clamp_min(q, 0.0))
    inside = torch.clamp_max(torch.amax(q, dim=-1), 0.0)
    return outside + inside - r


def _d_cone(params: Tensor, p: Tensor) -> Tensor:
    """Capped cone between disks (a, ra) and (b, rb), branch-free."""
    a, b = params[..., 0:3], params[..., 3:6]
    ra, rb = params[..., 6], params[..., 7]
    rba = rb - ra
    ba = b - a
    baba = torch.clamp_min(dot(ba, ba), 1e-20)
    pa = p[..., None, :] - a
    papa = dot(pa, pa)
    paba = torch.sum(pa * ba, dim=-1) / baba
    x = torch.sqrt(torch.clamp_min(papa - paba * paba * baba, 1e-20))
    cax = torch.clamp_min(x - torch.where(paba < 0.5, ra, rb), 0.0)
    cay = torch.abs(paba - 0.5) - 0.5
    k = rba * rba + baba
    f = torch.clamp((rba * (x - ra) + paba * baba) / k, 0.0, 1.0)
    cbx = x - ra - f * rba
    cby = paba - f
    s = torch.where((cbx < 0.0) & (cay < 0.0), -1.0, 1.0)
    return s * torch.sqrt(torch.minimum(cax * cax + cay * cay * baba,
                                        cbx * cbx + cby * cby * baba) + 1e-20)


def _d_plane(params: Tensor, p: Tensor) -> Tensor:
    """Half-space: dot(p, n) - offset."""
    n, off = params[..., 0:3], params[..., 3]
    return torch.sum(p[..., None, :] * n, dim=-1) - off


DIST_FNS = {
    "sphere": _d_sphere, "capsule": _d_capsule, "torus": _d_torus,
    "triangle": _d_triangle, "box": _d_box, "cone": _d_cone,
    "plane": _d_plane,
}


# ---------------------------------------------------------------------------
# The same distances over an accessor ``g(j)`` that yields the j-th
# parameter, broadcastable against the coordinates ``px, py, pz`` (no
# ``[..., 3]``-minor intermediates).  The backward pass and ``point_eval``
# use these: per lane (``g(j) [n]`` against ``px [n]``) or per tile
# candidate (``g(j) [G, 1, m]`` against ``px [G, T, 1]``).  The formulas are
# those of the JAX package's ``_GEN_FNS`` term by term, so gradients agree
# to float32 rounding.
# ---------------------------------------------------------------------------

def _g_sphere(g, px, py, pz):
    dx, dy, dz = px - g(0), py - g(1), pz - g(2)
    return torch.sqrt(dx * dx + dy * dy + dz * dz + 1e-20) - g(3)


def _g_capsule(g, px, py, pz):
    ax, ay, az = g(0), g(1), g(2)
    bax, bay, baz = g(3) - ax, g(4) - ay, g(5) - az
    pax, pay, paz = px - ax, py - ay, pz - az
    denom = torch.clamp_min(bax * bax + bay * bay + baz * baz, 1e-20)
    h = torch.clamp((pax * bax + pay * bay + paz * baz) / denom, 0.0, 1.0)
    ex, ey, ez = pax - h * bax, pay - h * bay, paz - h * baz
    return torch.sqrt(ex * ex + ey * ey + ez * ez + 1e-20) - g(6)


def _g_torus(g, px, py, pz):
    nx, ny, nz = g(3), g(4), g(5)
    ninv = torch.rsqrt(nx * nx + ny * ny + nz * nz + 1e-20)
    nx, ny, nz = nx * ninv, ny * ninv, nz * ninv
    qx, qy, qz = px - g(0), py - g(1), pz - g(2)
    h = qx * nx + qy * ny + qz * nz
    q2 = qx * qx + qy * qy + qz * qz
    radial = torch.sqrt(torch.clamp_min(q2 - h * h, 1e-20)) - g(6)
    return torch.sqrt(h * h + radial * radial + 1e-20) - g(7)


def _g_box(g, px, py, pz):
    qx = torch.abs(px - g(0)) - g(3)
    qy = torch.abs(py - g(1)) - g(4)
    qz = torch.abs(pz - g(2)) - g(5)
    ox, oy, oz = (torch.clamp_min(qx, 0.0), torch.clamp_min(qy, 0.0),
                  torch.clamp_min(qz, 0.0))
    outside = torch.sqrt(ox * ox + oy * oy + oz * oz + 1e-20)
    inside = torch.clamp_max(torch.maximum(qx, torch.maximum(qy, qz)), 0.0)
    return outside + inside - g(6)


def _g_plane(g, px, py, pz):
    return px * g(0) + py * g(1) + pz * g(2) - g(3)


def _g_cone(g, px, py, pz):
    ax, ay, az = g(0), g(1), g(2)
    ra, rb = g(6), g(7)
    rba = rb - ra
    bax, bay, baz = g(3) - ax, g(4) - ay, g(5) - az
    baba = torch.clamp_min(bax * bax + bay * bay + baz * baz, 1e-20)
    pax, pay, paz = px - ax, py - ay, pz - az
    papa = pax * pax + pay * pay + paz * paz
    paba = (pax * bax + pay * bay + paz * baz) / baba
    x = torch.sqrt(torch.clamp_min(papa - paba * paba * baba, 1e-20))
    cax = torch.clamp_min(x - torch.where(paba < 0.5, ra, rb), 0.0)
    cay = torch.abs(paba - 0.5) - 0.5
    k = rba * rba + baba
    f = torch.clamp((rba * (x - ra) + paba * baba) / k, 0.0, 1.0)
    cbx = x - ra - f * rba
    cby = paba - f
    s = torch.where((cbx < 0.0) & (cay < 0.0), -1.0, 1.0)
    return s * torch.sqrt(torch.minimum(cax * cax + cay * cay * baba,
                                        cbx * cbx + cby * cby * baba) + 1e-20)


def _g_triangle(g, px, py, pz):
    v1x, v1y, v1z = g(0), g(1), g(2)
    v2x, v2y, v2z = g(3), g(4), g(5)
    v3x, v3y, v3z = g(6), g(7), g(8)
    e1x, e1y, e1z = v2x - v1x, v2y - v1y, v2z - v1z   # v21
    e2x, e2y, e2z = v3x - v2x, v3y - v2y, v3z - v2z   # v32
    e3x, e3y, e3z = v1x - v3x, v1y - v3y, v1z - v3z   # v13
    # nor = cross(v21, v13)
    nx = e1y * e3z - e1z * e3y
    ny = e1z * e3x - e1x * e3z
    nz = e1x * e3y - e1y * e3x
    p1x, p1y, p1z = px - v1x, py - v1y, pz - v1z
    p2x, p2y, p2z = px - v2x, py - v2y, pz - v2z
    p3x, p3y, p3z = px - v3x, py - v3y, pz - v3z

    def seg_d2(ex, ey, ez, qx, qy, qz):
        denom = torch.clamp_min(ex * ex + ey * ey + ez * ez, 1e-20)
        h = torch.clamp((qx * ex + qy * ey + qz * ez) / denom, 0.0, 1.0)
        ux, uy, uz = qx - h * ex, qy - h * ey, qz - h * ez
        return ux * ux + uy * uy + uz * uz

    d2e = torch.minimum(
        seg_d2(e1x, e1y, e1z, p1x, p1y, p1z),
        torch.minimum(seg_d2(e2x, e2y, e2z, p2x, p2y, p2z),
                      seg_d2(e3x, e3y, e3z, p3x, p3y, p3z)))

    def half_sign(ex, ey, ez, qx, qy, qz):
        cx = ey * nz - ez * ny
        cy = ez * nx - ex * nz
        cz = ex * ny - ey * nx
        return torch.sign(cx * qx + cy * qy + cz * qz)

    s = (half_sign(e1x, e1y, e1z, p1x, p1y, p1z)
         + half_sign(e2x, e2y, e2z, p2x, p2y, p2z)
         + half_sign(e3x, e3y, e3z, p3x, p3y, p3z))
    n2 = torch.clamp_min(nx * nx + ny * ny + nz * nz, 1e-20)
    h = nx * p1x + ny * p1y + nz * p1z
    return torch.sqrt(torch.where(s >= 2.0, h * h / n2, d2e) + 1e-20) - g(9)


GEN_FNS = {
    "sphere": _g_sphere, "capsule": _g_capsule, "torus": _g_torus,
    "triangle": _g_triangle, "box": _g_box, "cone": _g_cone,
    "plane": _g_plane,
}


def leaf_distance(kind_counts, code: Tensor):
    """Leaf-local scene distance from the surface pass's signed winning-leaf
    code: ``f(x) = sign(code)·d_{|code|-1}(x)``.

    At a hit point of a min/max CSG scene the scene distance locally equals
    the winning leaf's (possibly negated) distance, so the backward pass
    differentiates that one primitive per lane.  Returns a closure
    ``scene_d(params, x)`` over ``params`` (kind → ``[K_t, P_t]``) and
    ``x [n, 3]``, differentiable in both; lanes with code 0 (a miss, or a
    blend's AD mode) give 0.  Each lane's row is read with
    ``index_select``, whose transpose is one ``index_add_``."""
    code = code.detach()
    slot = code.abs().long() - 1
    sgn = torch.sign(code)
    lane_id = torch.arange(code.shape[0], device=code.device)

    def scene_d(params, x: Tensor) -> Tensor:
        px, py, pz = x.unbind(-1)
        out = torch.zeros_like(px)
        off = 0
        for kind, cnt in kind_counts:
            in_kind = (slot >= off) & (slot < off + cnt)
            # lanes of another kind read any row (the ``where`` below drops
            # it), spread over the table so that the transpose's atomic
            # adds do not all land on one row
            row = torch.where(in_kind, slot - off, lane_id % cnt)
            # [P, n]: each parameter one contiguous row over the lanes
            lane = params[kind].t().index_select(1, row)
            d = GEN_FNS[kind](lambda j, lane=lane: lane[j], px, py, pz)
            out = torch.where(in_kind, d, out)
            off += cnt
        return sgn * out

    return scene_d


def leaf_normal(scene: FlatScene, code: Tensor, p: Tensor) -> Tensor:
    """Unit surface normal at ``p [n, 3]`` from a winning-leaf code
    (``sign·(global_slot + 1)``): the named primitive's (possibly negated)
    gradient.  Differentiable w.r.t. the scene's parameters and ``p`` when
    either requires grad (the leaf choice is held fixed); ``code == 0``
    lanes return (0, 0, 1)."""
    diff = torch.is_grad_enabled() and (
        p.requires_grad
        or any(v.requires_grad for v in scene.prim_params.values()))
    with torch.enable_grad():
        q = p if p.requires_grad else p.detach().requires_grad_(True)
        # the unsigned leaf distance: normalize first, orient after
        f = leaf_distance(scene.kind_counts, code.abs())(scene.prim_params, q)
        (g,) = torch.autograd.grad(f.sum(), q, create_graph=diff)
    n = normalize(g) * torch.where(code < 0, -1.0, 1.0)[..., None]
    up = torch.tensor([0.0, 0.0, 1.0], dtype=p.dtype, device=p.device)
    return torch.where((code != 0)[..., None], n, up)


# ---------------------------------------------------------------------------
# Scene evaluation
# ---------------------------------------------------------------------------

def prim_distances(scene: FlatScene, p: Tensor) -> Tensor:
    """Distances from ``p [..., 3]`` to every primitive → ``[..., K]`` in
    global slot order."""
    return torch.cat([DIST_FNS[kind](scene.prim_params[kind], p)
                      for kind, _cnt in scene.kind_counts], dim=-1)


@deferred.device_constant(maxsize=256)
def slots_on(slots: Tuple[int, ...], device: torch.device) -> Tensor:
    """A plan node's global slots as an int64 tensor on ``device``, copied
    there once (a captured frame keeps what it reads)."""
    return torch.as_tensor(np.asarray(slots, np.int64), device=device)


def combine(plan: Plan, d: Tensor) -> Tensor:
    """Apply the static CSG plan to ``d [..., K]`` → ``[...]``."""
    if plan.op == "prim":
        return d[..., plan.prim_slots[0]]
    if plan.op == "subtract":
        a = combine(plan.children[0], d)
        b = combine(plan.children[1], d)
        return torch.maximum(a, -b)  # SdfForm.fs:42-49

    vals = [combine(c, d) for c in plan.children]
    if plan.op in ("union", "intersect"):
        if plan.prim_slots:
            sub = d[..., slots_on(plan.prim_slots, d.device)]
            vals.append(torch.amin(sub, -1) if plan.op == "union"
                        else torch.amax(sub, -1))
        out = vals[0]
        f = torch.minimum if plan.op == "union" else torch.maximum
        for v in vals[1:]:
            out = f(out, v)
        return out
    if plan.op == "smooth_union":
        # -k * log(sum exp(-d/k))   (SdfForm.fs:69-91)
        k = float(plan.k)
        terms = []
        if plan.prim_slots:
            terms.append(d[..., slots_on(plan.prim_slots, d.device)])
        if vals:
            terms.append(torch.stack(vals, dim=-1))
        alld = torch.cat(terms, dim=-1)
        return -k * torch.logsumexp(-alld / k, dim=-1)
    raise ValueError(f"bad plan op {plan.op!r}")


def scene_distance(scene: FlatScene, p: Tensor) -> Tensor:
    """CSG-combined signed distance of the scene root at ``p [..., 3]``."""
    return combine(scene.plan, prim_distances(scene, p))


def scene_normal(scene: FlatScene, p: Tensor) -> Tensor:
    """Unit surface normal = normalized ∇_p scene_distance (autograd; the
    reference's 4-tap differences replaced by the exact gradient).  When
    ``p`` or a scene parameter requires grad the normal stays
    differentiable in both (a second-order graph); otherwise no graph is
    kept."""
    diff = torch.is_grad_enabled() and (
        p.requires_grad
        or any(v.requires_grad for v in scene.prim_params.values()))
    with torch.enable_grad():
        q = p if p.requires_grad else p.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(scene_distance(scene, q)), q,
                                   create_graph=diff)
    return normalize(g)


def take_rows(table: Tensor, idx: Tensor) -> Tensor:
    """``table[idx]`` over the leading axis through ``index_select``: its
    transpose is one ``index_add_`` (atomic adds), where advanced
    indexing's is a sort of all the lanes."""
    return table.index_select(0, idx.reshape(-1)).reshape(
        tuple(idx.shape) + tuple(table.shape[1:]))


@deferred.device_constant(maxsize=32)
def mat_kinds(mat_kind: Tuple[int, ...], device: torch.device) -> Tensor:
    """A scene's material kinds (``FlatScene.mat_kind``) as an int32 tensor
    on ``device``, copied there once per scene and device (a captured frame
    keeps what it reads)."""
    return torch.as_tensor(np.asarray(mat_kind, np.int32), device=device)


def albedo_of(scene: FlatScene, midx: Tensor, p: Tensor) -> Tensor:
    """Albedo of material ``midx [...]`` evaluated at ``p [..., 3]``.

    Procedural materials (MAT_PROCEDURAL) evaluate their fbm color blend at
    ``p`` — the position-dependent material closure of the reference design
    (``SdfMaterial`` takes Position → Color, Types.fs:46-49)."""
    midx = midx.long()
    albedo = take_rows(scene.mat_albedo, midx)
    if MAT_PROCEDURAL in scene.mat_kind:
        from ..utils.noise import fbm
        is_proc = mat_kinds(scene.mat_kind, midx.device)[midx] \
            == MAT_PROCEDURAL
        scale = take_rows(scene.mat_reflectivity, midx)
        blend = 0.5 * (fbm(p * scale[..., None], octaves=3) + 1.0)
        proc_albedo = (albedo * (1.0 - blend[..., None])
                       + take_rows(scene.mat_tint, midx) * blend[..., None])
        albedo = torch.where(is_proc[..., None], proc_albedo, albedo)
    return albedo


def winning_leaf_code(scene: FlatScene, p: Tensor) -> Tensor:
    """Dense winning-leaf code at ``p``: ``sign·(global_slot + 1)`` of the
    primitive selected by the CSG min/max tree (slot-mode plans only; ties
    break toward the earlier operand / first argmin).  float32 ``[...]``."""
    d = prim_distances(scene, p)
    shape = p.shape[:-1]

    def walk(plan) -> Tuple[Tensor, Tensor]:
        if plan.op == "prim":
            s = plan.prim_slots[0]
            return d[..., s], torch.full(shape, float(s + 1),
                                         dtype=torch.float32, device=p.device)
        if plan.op == "subtract":
            va, ca = walk(plan.children[0])
            vb, cb = walk(plan.children[1])
            sel = va > -vb
            return torch.maximum(va, -vb), torch.where(sel, ca, -cb)
        if plan.op in ("union", "intersect"):
            vals = [walk(c) for c in plan.children]
            if plan.prim_slots:
                slots = slots_on(plan.prim_slots, p.device)
                sub = d[..., slots]
                if plan.op == "union":
                    red, win = torch.amin(sub, -1), torch.argmin(sub, -1)
                else:
                    red, win = torch.amax(sub, -1), torch.argmax(sub, -1)
                vals.append((red, (slots[win] + 1).to(torch.float32)))
            out = vals[0]
            for v in vals[1:]:
                sel = (out[0] <= v[0]) if plan.op == "union" \
                    else (out[0] >= v[0])
                out = (torch.where(sel, out[0], v[0]),
                       torch.where(sel, out[1], v[1]))
            return out
        raise ValueError(f"winning_leaf_code: unsupported op {plan.op!r}")

    _v, code = walk(scene.plan)
    return code


def material_index_at(scene: FlatScene, p: Tensor) -> Tensor:
    """Winning material index at ``p`` (int32): argmin of distance over the
    CSG-visible material-bearing primitives, first minimum wins."""
    slots = scene.visible_material_slots()
    if slots.size == 0:
        return torch.zeros(p.shape[:-1], dtype=torch.int32, device=p.device)
    d = prim_distances(scene, p)[..., torch.as_tensor(slots).to(p.device)]
    win = torch.argmin(d, dim=-1)
    mat_of_slot = torch.as_tensor(
        np.asarray([scene.prim_material[s] for s in slots], np.int32),
        device=p.device)
    return mat_of_slot[win]


def material_at(scene: FlatScene, p: Tensor) -> Tuple[Tensor, Tensor]:
    """Winning material at ``p`` (reference ``SdfObject.fs:26-64``).
    Returns (material_index [...] int32, albedo [..., 3])."""
    midx = material_index_at(scene, p)
    return midx, albedo_of(scene, midx, p)


# ---------------------------------------------------------------------------
# Bounding spheres (reference SdfBoundary.fs algebra)
# ---------------------------------------------------------------------------

def _prim_bound_rows(kind: str, params: Tensor) -> Tensor:
    """Per-primitive bounding sphere [K, 4] = (center, radius)."""
    if kind == "sphere":
        return params
    if kind == "capsule":
        a, b, r = params[:, 0:3], params[:, 3:6], params[:, 6]
        rad = r + 0.5 * norm(b - a)
        return torch.cat([0.5 * (a + b), rad[:, None]], dim=-1)
    if kind == "torus":
        rad = params[:, 6] + params[:, 7]
        return torch.cat([params[:, 0:3], rad[:, None]], dim=-1)
    if kind == "triangle":
        v1, v2, v3 = params[:, 0:3], params[:, 3:6], params[:, 6:9]
        c = (v1 + v2 + v3) / 3.0
        rad = torch.maximum(norm(v1 - c), torch.maximum(
            norm(v2 - c), norm(v3 - c))) + params[:, 9]
        return torch.cat([c, rad[:, None]], dim=-1)
    if kind == "box":
        rad = norm(params[:, 3:6]) + params[:, 6]
        return torch.cat([params[:, 0:3], rad[:, None]], dim=-1)
    if kind == "cone":
        a, b = params[:, 0:3], params[:, 3:6]
        rad = 0.5 * norm(b - a) + torch.maximum(params[:, 6], params[:, 7])
        return torch.cat([0.5 * (a + b), rad[:, None]], dim=-1)
    if kind == "plane":
        k = params.shape[0]
        z = torch.zeros((k, 3), dtype=params.dtype, device=params.device)
        return torch.cat([z, torch.full((k, 1), _BIG, dtype=params.dtype,
                                        device=params.device)], -1)
    raise ValueError(kind)


def prim_bounds(scene: FlatScene) -> Tensor:
    """Bounding spheres of every primitive, [K, 4] in slot order."""
    return torch.cat([_prim_bound_rows(kind, scene.prim_params[kind])
                      for kind, _ in scene.kind_counts], dim=0)


def _bound_intersect2(a: Tensor, b: Tensor) -> Tensor:
    """Conservative bound of an intersection: the smaller input sphere."""
    return torch.where(a[3] <= b[3], a, b)


def _bound_union_many(rows: Tensor) -> Tensor:
    """Conservative enclosing sphere of ``rows [N, 4]``: centre = midpoint
    of the inputs' AABB, radius = max(|cᵢ - centre| + rᵢ)."""
    c, r = rows[:, 0:3], rows[:, 3]
    lo = torch.amin(c - r[:, None], dim=0)
    hi = torch.amax(c + r[:, None], dim=0)
    center = 0.5 * (lo + hi)
    radius = torch.amax(norm(c - center) + r)
    return torch.cat([center, radius[None]])


def plan_bound(scene: FlatScene, plan: Plan, pb: Tensor) -> Tensor:
    """Bounding sphere [4] of a plan node given primitive bounds ``pb``:
    union → enclosing sphere; intersect → smallest child; subtract → a."""
    if plan.op == "prim":
        return pb[plan.prim_slots[0]]
    if plan.op == "subtract":
        return plan_bound(scene, plan.children[0], pb)
    bounds = [plan_bound(scene, c, pb) for c in plan.children]
    slots = slots_on(plan.prim_slots, pb.device)
    if plan.op == "intersect":
        rows = list(bounds)
        if plan.prim_slots:
            # the smallest direct child, picked on the device (indexing by
            # a 0-d tensor would read it on the host)
            sub = pb.index_select(0, slots)
            rows.append(sub.index_select(
                0, torch.argmin(sub[:, 3]).reshape(1))[0])
        out = rows[0]
        for bnd in rows[1:]:
            out = _bound_intersect2(out, bnd)
        return out
    rows = [b[None, :] for b in bounds]
    if plan.prim_slots:
        rows.append(pb.index_select(0, slots))
    out = _bound_union_many(torch.cat(rows, dim=0))
    if plan.op == "smooth_union":
        # exp smooth-min can undershoot the true min by up to k*log(n)
        n = len(plan.children) + len(plan.prim_slots)
        out = out.clone()
        out[3] += np.float32(plan.k * np.log(max(n, 2)))
    return out


def root_bound(scene: FlatScene) -> Tensor:
    """Bounding sphere (center[3], radius) of the whole scene (detached)."""
    with torch.no_grad():
        return plan_bound(scene, scene.plan, prim_bounds(scene))


def bound_min_distance(bound: Tensor, p: Tensor) -> Tensor:
    """Lower bound on distance from ``p`` to anything inside ``bound``
    (reference SdfBoundary.getMinDistance)."""
    return norm(p - bound[0:3]) - bound[3]
