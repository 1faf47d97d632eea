"""Culled scene evaluation at point batches (normals, materials, VJPs).

Counterpart of ``fraytracer_tpu.ops.point_eval``.  The march kernels prune
primitives per ray tile; this module applies the same idea to the *point*
evaluations that surround the march — surface normals (the gradient of the
scene distance), material argmin resolution (reference
``SdfObject.fs:26-46``) and the implicit-differentiation VJP of the hit
distance — all plain PyTorch, as the JAX module is plain ``jnp``.

Mechanism: points are processed in tiles of ``tile``; for every large
homogeneous 'min' group (the same static ``_cull_pairs`` selection the
march kernels use) each tile gathers the ``m`` candidates whose *bounding
spheres* are nearest to the tile centroid.  Distances, gradients and
argmins are then computed over the ``[tile, m]`` candidate matrix instead
of ``[tile, K]``.  The selection indices carry no gradient; the gathered
parameters do (``index_select``, whose transpose is ``index_add_``).

Exactness is certified per tile: every excluded candidate's distance from
a query point q is ≥ ``B_m - |q - center|`` where ``B_m`` is the m-th kept
bound-distance from the centroid, so the selection is provably exact for a
tile when, at every (hit) query point,

    max(kept union min, kept material-argmin distance) + |q - center|
        <= B_m - cert_slack.

:func:`build_culled_eval` returns the certificate as a 0-dim bool tensor
``ok``.  Where JAX wraps the two routes in ``lax.cond``, callers here run
one route, picked by :func:`culled_branch`: an eager call reads ``ok`` on
the host once (``STATS["certificate_reads"]``) and takes the culled route,
or the tiled dense evaluation when any tile fails; a deferred call
(``ops/deferred.py``, the frame or step a CUDA graph captures) reads
nothing, takes the culled route and raises its frame's flag where ``ok``
is false, so that its caller runs it again eagerly.  Both routes
rematerialize per chunk of tiles (``torch.utils.checkpoint``, the
recomputation in the caller's deferred frame: ``deferred.in_current``)
when a graph is kept.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..scene.flatten import FlatScene
from ..types import norm, normalize
from . import deferred, sdf
from .cuda.cull import _build_groups, _cull_pairs

Tensor = torch.Tensor

POINT_TILE = 1024
CERT_SLACK = 0.05
_BIG = 3.0e38

# host reads of the certificate by eager calls, and which route each took
# (a deferred call reads nothing and counts nothing)
STATS = {"certificate_reads": 0, "culled": 0, "dense": 0}


def read_certificate(ok: Tensor) -> bool:
    """The eager call's one host read of ``ok`` (a sync on a CUDA tensor);
    counts the read and the route taken."""
    good = bool(ok)
    STATS["certificate_reads"] += 1
    STATS["culled" if good else "dense"] += 1
    return good


def culled_branch(ok: Tensor) -> bool:
    """True when a call takes the culled route.  Eagerly, the host reads
    the certificate (:func:`read_certificate`); in a deferred frame
    (``ops/deferred.py``) the call takes the culled route, reads nothing
    and ORs ``~ok`` into the frame's flag: a failing tile sends the whole
    frame to its eager re-run, which takes the dense route here."""
    frame = deferred.current()
    if frame is None:
        return read_certificate(ok)
    frame.raise_if(~ok)
    return True


def _chunk_elems(device: torch.device) -> int:
    """Elements of one ``[tiles, T, m]`` intermediate per chunk."""
    return 1 << (22 if device.type == "cuda" else 20)


def _params_of(sc):
    """``prim_params`` of a FlatScene, or ``sc`` itself when it already is
    the kind → parameter mapping (the backward pass hands those over)."""
    return sc.prim_params if isinstance(sc, FlatScene) else sc


def _wants_graph(sc, *tensors: Tensor) -> bool:
    return torch.is_grad_enabled() and (
        any(t.requires_grad for t in tensors)
        or any(v.requires_grad for v in _params_of(sc).values()))


def _static_layout(plan, kind_counts, threshold: int):
    """Static layout: cull pairs, groups/tree, per-slot group ids, kind
    offsets and the dense rows per kind (rows no culled pair covers).
    Reuses the march kernels' plan analysis."""
    pairs = _cull_pairs(kind_counts, plan, threshold)
    groups, tree = _build_groups(plan)

    culled_rows = {}
    for (_gid, kind, _ki, r0, r1) in pairs:
        culled_rows.setdefault(kind, []).append((r0, r1))

    offsets, off = {}, 0
    for k, c in kind_counts:
        offsets[k] = off
        off += c
    slot_gid = np.full(off, -1, np.int32)
    for g in groups:
        slot_gid[list(g.slots)] = g.gid

    dense = []  # (kind, row_idx np[int64], global_slot np[int64])
    for kind, cnt in kind_counts:
        mask = np.ones(cnt, bool)
        for lo, hi in culled_rows.get(kind, []):
            mask[lo:hi] = False
        rows = np.where(mask)[0].astype(np.int64)
        if rows.size:
            dense.append((kind, rows, offsets[kind] + rows))
    return pairs, groups, tree, slot_gid, offsets, dense


@deferred.device_constant(maxsize=32)
def _layout_on(plan, kind_counts, prim_material, threshold: int,
               device: torch.device):
    """The static layout's index tables on ``device``, copied there once
    (a captured frame keeps what it reads): per cull pair the CSG-visible
    material of each of its rows; the dense material slots ``(kind, rows,
    materials)``; the dense rows per kind with, per owning group, the
    columns of that group ``(kind, rows, [(gid, columns)])``."""
    from ..scene.flatten import visible_materials
    pairs, _g, _t, slot_gid, offsets, dense = _static_layout(
        plan, kind_counts, threshold)
    mat_vis = np.asarray(visible_materials(plan, prim_material), np.int64)
    pair_mats = [torch.as_tensor(
        mat_vis[offsets[kind] + lo:offsets[kind] + hi], device=device)
        for (_gid, kind, _ki, lo, hi) in pairs]
    dense_mat, dense_dev = [], []
    for kind, rows, gslots in dense:
        mats = mat_vis[gslots]
        keep = mats >= 0
        if keep.any():
            dense_mat.append((kind, torch.as_tensor(rows[keep],
                                                    device=device),
                              torch.as_tensor(mats[keep], device=device)))
        gids = slot_gid[gslots]
        split = [(int(gid), torch.as_tensor(np.where(gids == gid)[0],
                                            device=device))
                 for gid in np.unique(gids)]
        dense_dev.append((kind, torch.as_tensor(rows, device=device), split))
    return pair_mats, dense_mat, dense_dev


def _soa_eval(kind: str, params: Tensor, q: Tensor) -> Tensor:
    """Candidate distances: ``params [..., m, P]``, ``q [..., T, 3]`` →
    ``[..., T, m]``, without ``[..., T, m, 3]`` intermediates."""
    qx, qy, qz = (c[..., None] for c in q.unbind(-1))
    return sdf.GEN_FNS[kind](lambda j: params[..., j][..., None, :],
                             qx, qy, qz)


def _tile_centers(pos: Tensor, hit: Tensor | None) -> Tensor:
    """Per-tile centroid of (hit) points; pos [G, T, 3], hit [G, T] bool."""
    if hit is None:
        return pos.mean(1)
    w = hit.to(torch.float32)[..., None]
    n = torch.clamp_min(w.sum(1), 1.0)
    return (pos * w).sum(1) / n


def _candidates(bounds: Tensor, center: Tensor, m: int):
    """Indices ``[G, m]`` of the m candidates nearest the tile centers by
    bounding-sphere lower bound, plus ``B_m [G]`` — the m-th (largest kept)
    lower bound, the exclusion certificate radius.  Ties order as
    ``torch.topk`` orders them (not as ``lax.top_k``)."""
    bd = (norm(center[:, None, :] - bounds[None, :, 0:3])
          - bounds[None, :, 3])                       # [G, Kg]
    neg, idx = torch.topk(-bd, m, dim=1)
    return idx, -neg[:, -1]


def _gather_rows(params: Tensor, idx: Tensor) -> Tensor:
    """``params [K, P]``, ``idx [G, m]`` → ``[G, m, P]``."""
    return params.index_select(0, idx.reshape(-1)).reshape(
        idx.shape + (params.shape[-1],))


def build_culled_eval(scene: FlatScene, pos: Tensor,
                      hit: Tensor | None = None,
                      m: int = 128, threshold: int = 192,
                      tile: int = POINT_TILE,
                      for_materials: bool = True):
    """Build a culled scene evaluator around the point batch ``pos [N, 3]``.

    Returns ``None`` when the scene has no cull-eligible group (callers
    take the dense path), else ``(dist_fn, mat_fn, reshape, n, ok)``:

    * ``dist_fn(sc, q, g0=0)`` — scene distance at ``q [g, T, 3]`` (tiles
      ``g0 … g0+g`` of the batch) → ``[g, T]``, differentiable w.r.t. the
      parameters and ``q``; ``sc`` is a FlatScene or a kind → parameter
      mapping;
    * ``mat_fn(sc, q, g0=0)`` — winning material index ``[g, T]`` int32 over
      dense + candidate slots;
    * ``reshape(x)`` — ``[N, ...]`` → tiled ``[G, T, ...]`` (the last row
      repeated as padding);
    * ``n`` — the batch size; ``ok`` — the exactness certificate (0-dim
      bool tensor, see the module docstring).

    The candidate *selection* is fixed at build time from ``pos``
    (detached); the closures gather parameters from whatever ``sc`` they
    are called with.
    """
    n = pos.shape[0]
    dev = pos.device
    pairs, groups, tree, _slot_gid, offsets, _dense = _static_layout(
        scene.plan, scene.kind_counts, threshold)
    if not pairs:
        return None
    pair_mats, dense_mat, dense_dev = _layout_on(
        scene.plan, scene.kind_counts, scene.prim_material, threshold, dev)

    pad = (-n) % tile

    def reshape(x: Tensor) -> Tensor:
        if pad:
            x = torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
        return x.reshape(((n + pad) // tile, tile) + tuple(x.shape[1:]))

    mat_vis = np.asarray(scene.visible_material(), np.int64)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    pair_sel: List[Tuple] = []
    with torch.no_grad():
        pos_t = reshape(pos.detach())
        hit_t = reshape(hit) if hit is not None else None
        if hit_t is not None:
            # tiles look at their hit centroid; miss-lane positions must
            # not widen the candidate neighbourhood
            center = _tile_centers(pos_t, hit_t)
            pos_sel = torch.where(hit_t[..., None], pos_t,
                                  center[:, None, :])
            center = _tile_centers(pos_sel, None)
        else:
            pos_sel = pos_t
            center = _tile_centers(pos_t, None)

        for (gid, kind, _ki, row_lo, row_hi), mat_of_row in zip(pairs,
                                                                pair_mats):
            # 'max' (intersect) groups: every member can bind the max, so
            # the nearest-by-bound truncation (a union-min argument) is
            # unsound — keep the full group
            full = row_hi - row_lo
            mcap = full if groups[gid].op == "max" else min(m, full)
            rows_params = scene.prim_params[kind].detach()[row_lo:row_hi]
            bounds = sdf._prim_bound_rows(kind, rows_params)
            idx, b_m = _candidates(bounds, center, mcap)  # [G, mcap], [G]
            mats_np = mat_vis[offsets[kind] + row_lo:offsets[kind] + row_hi]
            pair_sel.append((gid, kind, row_lo, idx, mat_of_row))
            if mcap < full:
                # certificate: the kept union min (and, for materials, the
                # kept material-argmin distance) plus the point's centroid
                # radius must clear the m-th bound
                g_all = pos_sel.shape[0]
                step = max(1, _chunk_elems(dev) // (tile * mcap))
                for s in range(0, g_all, step):
                    q = pos_sel[s:s + step]
                    ix = idx[s:s + step]
                    d = _soa_eval(kind, _gather_rows(rows_params, ix), q)
                    need = d.amin(-1)
                    if for_materials and (mats_np >= 0).any():
                        # the material-argmin winner can be much farther
                        # than the union min (cutter surfaces)
                        cand_mats = mat_of_row[ix]            # [g, mcap]
                        dm = torch.where((cand_mats >= 0)[:, None, :], d,
                                         _BIG)
                        need = torch.maximum(need, dm.amin(-1))
                    rho = norm(q - center[s:s + step, None, :])
                    lane_ok = need + rho <= \
                        b_m[s:s + step, None] - CERT_SLACK
                    if hit_t is not None:
                        lane_ok = lane_ok | ~hit_t[s:s + step]
                    ok = ok & lane_ok.all()

    m_max = max(p[3].shape[1] for p in pair_sel)
    g_chunk = max(1, _chunk_elems(dev) // (tile * m_max))

    def _group_values(params, q: Tensor, g0: int):
        """q [g, T, 3] (tiles g0…) → per-group reduced values [g, T]."""
        shp = q.shape[:-1]
        accs = []
        for g in groups:
            fill = {"min": _BIG, "max": -_BIG, "sumexp": 0.0}[g.op]
            accs.append(torch.full(shp, fill, dtype=q.dtype,
                                   device=q.device))

        def fold(gi, d):
            g = groups[gi]
            if g.op == "min":
                accs[gi] = torch.minimum(accs[gi], d.amin(-1))
            elif g.op == "max":
                accs[gi] = torch.maximum(accs[gi], d.amax(-1))
            else:
                accs[gi] = accs[gi] + torch.exp(-d / g.k).sum(-1)

        # dense part: evaluate per kind, split by owning group (static)
        for kind, rows, split in dense_dev:
            d = _soa_eval(kind, params[kind].index_select(0, rows), q)
            for gid, sel in split:
                fold(gid, d.index_select(-1, sel))

        # culled part: per-tile gathered candidates
        for (gid, kind, row_lo, idx, _mats) in pair_sel:
            ix = row_lo + idx[g0:g0 + q.shape[0]]
            fold(gid, _soa_eval(kind, _gather_rows(params[kind], ix), q))

        return [-g.k * torch.log(torch.clamp_min(a, 1e-30))
                if g.op == "sumexp" else a for g, a in zip(groups, accs)]

    def _eval_tree(gvals, t):
        if t[0] == "g":
            return gvals[t[1]]
        op, k, kids = t
        vals = [_eval_tree(gvals, x) for x in kids]
        if op == "subtract":
            return torch.maximum(vals[0], -vals[1])
        if op in ("union", "intersect"):
            f = torch.minimum if op == "union" else torch.maximum
            out = vals[0]
            for v in vals[1:]:
                out = f(out, v)
            return out
        if op == "smooth_union":
            s = sum(torch.exp(-v / k) for v in vals)
            return -k * torch.log(torch.clamp_min(s, 1e-30))
        raise ValueError(op)

    def _chunked(fn, sc, q: Tensor, g0: int) -> Tensor:
        """``fn(params, q_chunk, g0_chunk)`` over chunks of tiles, each
        rematerialized in the backward when a graph is kept, so the
        ``[g, T, m]`` intermediates of one chunk bound the peak memory."""
        params = _params_of(sc)
        g = q.shape[0]
        if g <= g_chunk:
            return fn(params, q, g0)
        keep = _wants_graph(params, q)
        outs = []
        for s in range(0, g, g_chunk):
            args = (params, q[s:s + g_chunk], g0 + s)
            outs.append(checkpoint(deferred.in_current(fn), *args,
                                   use_reentrant=False)
                        if keep else fn(*args))
        return torch.cat(outs)

    def dist_fn(sc, q: Tensor, g0: int = 0) -> Tensor:
        return _chunked(
            lambda params, qq, gg: _eval_tree(_group_values(params, qq, gg),
                                              tree), sc, q, g0)

    def _mat_chunk(params, q: Tensor, g0: int) -> Tensor:
        """Winning material index at q [g, T, 3] → [g, T] int32 (argmin
        over material-bearing primitives, first minimum wins)."""
        shp = q.shape[:-1]
        best_d = torch.full(shp, _BIG, dtype=q.dtype, device=q.device)
        best_m = torch.zeros(shp, dtype=torch.int64, device=q.device)

        def consider(d, midx):
            nonlocal best_d, best_m
            better = d < best_d
            best_d = torch.where(better, d, best_d)
            best_m = torch.where(better, midx, best_m)

        for kind, rows, mats in dense_mat:
            d = _soa_eval(kind, params[kind].index_select(0, rows), q)
            consider(d.amin(-1), mats[d.argmin(-1)])

        for (_gid, kind, row_lo, idx, mat_of_row) in pair_sel:
            ix = idx[g0:g0 + q.shape[0]]
            d = _soa_eval(kind, _gather_rows(params[kind], row_lo + ix), q)
            cand_mats = mat_of_row[ix]                   # [g, mcap]
            d = torch.where((cand_mats >= 0)[:, None, :], d, _BIG)
            win = d.argmin(-1)                           # [g, T]
            consider(d.amin(-1), cand_mats.gather(1, win))
        return best_m.to(torch.int32)

    @torch.no_grad()
    def mat_fn(sc, q: Tensor, g0: int = 0) -> Tensor:
        return _chunked(_mat_chunk, sc, q.detach(), g0)

    dist_fn.g_chunk = g_chunk    # tiles a caller may hand over at once
    return dist_fn, mat_fn, reshape, n, ok


def _dense_rows(scene, device: torch.device) -> int:
    """Points per chunk of a dense ``[rows, K]`` evaluation with a graph."""
    k = sum(v.shape[0] for v in _params_of(scene).values())
    return max(1, _chunk_elems(device) // max(k, 1))


def dense_dist_tiled(scene: FlatScene, q: Tensor) -> Tensor:
    """Dense scene distance at ``q [G, T, 3]``, a chunk of points at a time
    (the certified fallback): the ``[rows, K]`` temporaries stay bounded,
    and each chunk is rematerialized in the backward when a graph is kept —
    without that a reverse-mode caller holds every chunk's ``[rows, K, 3]``
    intermediates at once."""
    flat = q.reshape(-1, 3)
    rows = _dense_rows(scene, q.device)
    if flat.shape[0] <= rows:
        return sdf.scene_distance(scene, flat).reshape(q.shape[:-1])
    keep = _wants_graph(scene, q)
    outs = []
    for s in range(0, flat.shape[0], rows):
        part = flat[s:s + rows]
        outs.append(checkpoint(deferred.in_current(sdf.scene_distance),
                               scene, part, use_reentrant=False)
                    if keep else sdf.scene_distance(scene, part))
    return torch.cat(outs).reshape(q.shape[:-1])


def _unit_gradient(fn, q: Tensor, keep: bool) -> Tensor:
    """``normalize(∇_q Σ fn(q))``; with ``keep`` the result stays
    differentiable (a second-order graph)."""
    with torch.enable_grad():
        qq = q if q.requires_grad else q.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(qq).sum(), qq, create_graph=keep)
    return normalize(g)


def _chunked_normals(fn, scene: FlatScene, q: Tensor, step: int) -> Tensor:
    """Unit gradients of ``fn(scene, q_chunk, start)`` over chunks of
    ``step`` leading rows of ``q``; each chunk (its inner gradient
    included) is rematerialized in the backward when a graph is kept."""
    keep = _wants_graph(scene, q)

    def one(sc, part, s):
        return _unit_gradient(lambda x: fn(sc, x, s), part, keep)

    outs = []
    for s in range(0, q.shape[0], step):
        part = q[s:s + step]
        if keep and q.shape[0] > step:
            outs.append(checkpoint(deferred.in_current(one), scene, part, s,
                                   use_reentrant=False))
        else:
            outs.append(one(scene, part, s))
    return torch.cat(outs)


def culled_surface_eval(scene: FlatScene, pos: Tensor,
                        hit: Tensor | None = None,
                        m: int = 128, threshold: int = 192):
    """Normal + material at hit points with per-tile candidate culling.

    ``pos [N, 3]`` → (normal [N, 3], material index [N] int32, albedo
    [N, 3]); ``None`` if the scene has no cull-eligible group.
    Differentiable w.r.t. the scene and ``pos``.  When any tile fails the
    exactness certificate the whole batch is evaluated densely instead
    (:func:`culled_branch` decides; never both)."""
    built = build_culled_eval(scene, pos, hit, m, threshold)
    if built is None:
        return None
    dist_fn, mat_fn, reshape, n, ok = built
    q = reshape(pos)
    if culled_branch(ok):
        normal = _chunked_normals(dist_fn, scene, q, dist_fn.g_chunk)
        midx = mat_fn(scene, q)
    else:
        flat = q.reshape(-1, 3)
        tiles = max(1, _dense_rows(scene, q.device) // q.shape[1])
        normal = _chunked_normals(
            lambda sc, x, _s: dense_dist_tiled(sc, x), scene, q, tiles)
        with torch.no_grad():
            midx = torch.cat([
                sdf.material_index_at(scene, flat[s:s + 16384].detach())
                for s in range(0, flat.shape[0], 16384)])
    normal = normal.reshape(-1, 3)[:n]
    midx = midx.reshape(-1)[:n]
    return normal, midx, sdf.albedo_of(scene, midx, pos)
