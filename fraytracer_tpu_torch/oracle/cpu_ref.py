"""Scalar NumPy oracle: an independent CPU re-implementation of the renderer.

This plays the role SURVEY.md §4 assigns to the "reference CPU
implementation": a slow, simple, float64, per-pixel scalar implementation of
exactly the same math as the kernel path, used as the ``allclose`` gate for
images and gradients (BASELINE.md correctness target).  It deliberately
mirrors the *semantics* of the F# reference (march loop SdfForm.fs:93-104,
integrator SdfScene.fs:7-28, lights SdfLight.fs, camera Camera.fs:33-54 with
the fov/degree fix) while sharing **no code** with the torch path — it walks
the builder tree directly with recursive closures, like the reference does.

The port's own copy of ``fraytracer_tpu.oracle.cpu_ref`` over the port's
``scene.nodes``: numpy only, no torch, so that a frame rendered on the card
can be held to it where JAX is not installed.  It equals the JAX package's
oracle bit for bit on the same scenes.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np

from ..scene import nodes as N

Vec = np.ndarray


def _norm(v: Vec) -> float:
    return float(math.sqrt(float(v @ v)))


def build_distance(node: N.SdfNode) -> Callable[[Vec], float]:
    """Compile a builder node into a scalar distance closure (the oracle's
    analog of the reference's closure tree, Types.fs:40-44)."""
    if isinstance(node, N.Prim):
        p = np.asarray(node.params, np.float64)
        k = node.kind
        if k == "sphere":
            c, r = p[0:3], p[3]
            return lambda q: _norm(q - c) - r
        if k == "capsule":
            a, b, r = p[0:3], p[3:6], p[6]
            ba = b - a
            denom = max(float(ba @ ba), 1e-300)

            def d_capsule(q, a=a, ba=ba, r=r, denom=denom):
                pa = q - a
                h = min(max(float(pa @ ba) / denom, 0.0), 1.0)
                return _norm(pa - h * ba) - r
            return d_capsule
        if k == "torus":
            c, n = p[0:3], p[3:6]
            n = n / _norm(n)
            R, r = p[6], p[7]

            def d_torus(q, c=c, n=n, R=R, r=r):
                qq = q - c
                h = float(qq @ n)
                radial = _norm(qq - h * n) - R
                return math.sqrt(h * h + radial * radial) - r
            return d_torus
        if k == "triangle":
            v1, v2, v3, r = p[0:3], p[3:6], p[6:9], p[9]
            v21, v32, v13 = v2 - v1, v3 - v2, v1 - v3
            nor = np.cross(v21, v13)

            def seg_d2(e, q):
                h = min(max(float(q @ e) / max(float(e @ e), 1e-300), 0.0), 1.0)
                diff = q - h * e
                return float(diff @ diff)

            def d_tri(q, v1=v1, v2=v2, v3=v3, r=r):
                p1, p2, p3 = q - v1, q - v2, q - v3
                s = (np.sign(float(np.cross(v21, nor) @ p1))
                     + np.sign(float(np.cross(v32, nor) @ p2))
                     + np.sign(float(np.cross(v13, nor) @ p3)))
                if s >= 2.0:
                    h = float(nor @ p1)
                    d2 = h * h / max(float(nor @ nor), 1e-300)
                else:
                    d2 = min(seg_d2(v21, p1), seg_d2(v32, p2), seg_d2(v13, p3))
                return math.sqrt(d2) - r
            return d_tri
        if k == "box":
            c, half, r = p[0:3], p[3:6], p[6]

            def d_box(p_, c=c, half=half, r=r):
                q = np.abs(p_ - c) - half
                outside = _norm(np.maximum(q, 0.0))
                inside = min(max(q[0], q[1], q[2]), 0.0)
                return outside + inside - r
            return d_box
        if k == "cone":
            a, b = p[0:3], p[3:6]
            ra, rb = p[6], p[7]
            ba = b - a
            baba = max(float(ba @ ba), 1e-300)
            rba = rb - ra

            def d_cone(q, a=a, ba=ba, baba=baba, ra=ra, rb=rb, rba=rba):
                pa = q - a
                papa = float(pa @ pa)
                paba = float(pa @ ba) / baba
                x = math.sqrt(max(papa - paba * paba * baba, 0.0))
                cax = max(0.0, x - (ra if paba < 0.5 else rb))
                cay = abs(paba - 0.5) - 0.5
                kk = rba * rba + baba
                f = min(max((rba * (x - ra) + paba * baba) / kk, 0.0), 1.0)
                cbx = x - ra - f * rba
                cby = paba - f
                s = -1.0 if (cbx < 0.0 and cay < 0.0) else 1.0
                return s * math.sqrt(min(cax * cax + cay * cay * baba,
                                         cbx * cbx + cby * cby * baba))
            return d_cone
        if k == "plane":
            n, off = p[0:3], p[3]
            return lambda q: float(q @ n) - off
        raise ValueError(k)
    if isinstance(node, N.Union):
        # vectorized fast path for large homogeneous prim groups (the
        # benchmark's 1000-torus union): one float64 NumPy evaluation over
        # a [K, P] parameter matrix instead of K scalar closures.  Same
        # math, still fully independent of the JAX path — this is what
        # makes the 64² end-to-end gate on the 1000-torus scene tractable.
        by_kind: dict = {}
        rest = []
        for c in node.children:
            if isinstance(c, N.Prim):
                by_kind.setdefault(c.kind, []).append(c)
            else:
                rest.append(c)
        fns = [build_distance(c) for c in rest]
        for kind, prims in by_kind.items():
            if len(prims) >= 32:
                fns.append(_vector_min_distance(kind, prims))
            else:
                fns.extend(build_distance(p) for p in prims)
        if len(fns) == 1:
            return fns[0]
        return lambda q: min(f(q) for f in fns)
    if isinstance(node, N.SmoothUnion):
        fns = [build_distance(c) for c in node.children]
        k = node.k

        def d_smooth(q, fns=fns, k=k):
            # -k * log(sum exp(-d/k)) (SdfForm.fs:69-91), stabilized
            ds = np.array([f(q) for f in fns])
            m = ds.min()
            return m - k * math.log(np.exp(-(ds - m) / k).sum())
        return d_smooth
    if isinstance(node, N.Intersect):
        fns = [build_distance(c) for c in node.children]
        return lambda q: max(f(q) for f in fns)
    if isinstance(node, N.Subtract):
        fa, fb = build_distance(node.a), build_distance(node.b)
        return lambda q: max(fa(q), -fb(q))
    raise TypeError(node)


def _vector_all_distances(kind: str, params: np.ndarray):
    """float64 NumPy distances of one point to ALL primitives of one kind:
    ``q [3] → d [K]``.  Used by the vectorized union fast path and the
    vectorized material argmin."""
    if kind == "sphere":
        c, r = params[:, 0:3], params[:, 3]
        return lambda q: np.sqrt(((q - c) ** 2).sum(-1)) - r
    if kind == "torus":
        c, n = params[:, 0:3], params[:, 3:6]
        n = n / np.sqrt((n * n).sum(-1, keepdims=True))
        R, r = params[:, 6], params[:, 7]

        def d_tori(q, c=c, n=n, R=R, r=r):
            qq = q[None, :] - c                      # [K, 3]
            h = (qq * n).sum(-1)                     # [K]
            radial = np.sqrt(np.maximum(
                (qq * qq).sum(-1) - h * h, 0.0)) - R
            return np.sqrt(h * h + radial * radial) - r
        return d_tori
    if kind == "capsule":
        a, b, r = params[:, 0:3], params[:, 3:6], params[:, 6]
        ba = b - a
        denom = np.maximum((ba * ba).sum(-1), 1e-300)

        def d_caps(q, a=a, ba=ba, r=r, denom=denom):
            pa = q[None, :] - a
            h = np.clip((pa * ba).sum(-1) / denom, 0.0, 1.0)
            e = pa - h[:, None] * ba
            return np.sqrt((e * e).sum(-1)) - r
        return d_caps
    if kind == "box":
        c, half, r = params[:, 0:3], params[:, 3:6], params[:, 6]

        def d_boxes(p_, c=c, half=half, r=r):
            q = np.abs(p_[None, :] - c) - half
            outside = np.sqrt((np.maximum(q, 0.0) ** 2).sum(-1))
            inside = np.minimum(q.max(-1), 0.0)
            return outside + inside - r
        return d_boxes
    # remaining kinds (triangle, cone, plane) fall back to scalar closures
    return None


def _vector_min_distance(kind: str, prims):
    """min-over-group distance closure, vectorized when the kind supports
    it, else a scalar loop."""
    params = np.stack([np.asarray(p.params, np.float64) for p in prims])
    vec = _vector_all_distances(kind, params)
    if vec is not None:
        return lambda q: float(vec(q).min())
    fns = [build_distance(p) for p in prims]
    return lambda q: min(f(q) for f in fns)


def collect_material_prims(node: N.SdfNode):
    """CSG-visible material-bearing primitives, in the same order the
    flattener assigns global slots (kind-major, encounter order within a
    kind).  Visibility matches the reference: materials on a subtract's
    *b* operand never win (``SdfObject.fs:50-64`` — subtract keeps the
    object's material; the subtrahend is a bare form)."""
    by_kind = {k: [] for k in
               ("sphere", "capsule", "torus", "triangle", "box", "cone",
                "plane")}

    def visit(n, visible):
        if isinstance(n, N.Prim):
            by_kind[n.kind].append((n, visible))
        elif isinstance(n, N.Subtract):
            visit(n.a, visible)
            visit(n.b, False)
        elif isinstance(n, (N.Union, N.SmoothUnion, N.Intersect)):
            for c in n.children:
                visit(c, visible)
    visit(node, True)
    ordered = [p for k in by_kind for p in by_kind[k]]
    return [(p, build_distance(p)) for (p, vis) in ordered
            if vis and p.material is not None]


class Oracle:
    """Scalar float64 renderer over a builder Scene."""

    def __init__(self, scene: N.Scene, grad_h: float = 1e-6):
        self.scene = scene
        self.distance = build_distance(scene.root)
        self.mat_prims = collect_material_prims(scene.root)
        self.grad_h = grad_h
        # vectorized material argmin (kind-major groups, first-min ties —
        # identical winner to the scalar loop below)
        self._mat_groups = []
        i = 0
        prims = [p for (p, _f) in self.mat_prims]
        while i < len(prims):
            j = i
            while j < len(prims) and prims[j].kind == prims[i].kind:
                j += 1
            group = prims[i:j]
            params = np.stack([np.asarray(p.params, np.float64)
                               for p in group])
            vec = _vector_all_distances(group[0].kind, params)
            albs = np.stack([np.asarray(p.material.albedo, np.float64)
                             for p in group])
            self._mat_groups.append(
                (vec, [f for (_p, f) in self.mat_prims[i:j]], albs))
            i = j

    # -- geometry ----------------------------------------------------------

    def normal(self, p: Vec) -> Vec:
        """Central-difference gradient in float64 (error O(h²) ≈ 1e-12) —
        numerically indistinguishable from the JAX analytic normal."""
        h = self.grad_h
        g = np.array([
            (self.distance(p + np.eye(3)[i] * h)
             - self.distance(p - np.eye(3)[i] * h)) / (2 * h)
            for i in range(3)
        ])
        n = _norm(g)
        return g / n if n > 0 else np.array([0.0, 0.0, 1.0])

    def march(self, origin: Vec, direction: Vec, epsilon: float,
              length: float, max_steps: int = 4096):
        """Reference march semantics (SdfForm.tryTrace, SdfForm.fs:93-104):
        miss when budget exhausted (checked first), hit when d < epsilon.
        Returns (hit, t)."""
        hit, t, _ = self.march_min(origin, direction, epsilon, length,
                                   max_steps)
        return hit, t

    def march_min(self, origin: Vec, direction: Vec, epsilon: float,
                  length: float, max_steps: int = 4096):
        """March + the minimum SDF value sampled along the way — the
        grazing-classification diagnostic for the f32-vs-f64 gate tests
        (a hit/miss flip between precisions is legitimate only when the
        ray passes within ~epsilon of a surface).  Returns
        (hit, t, min_d)."""
        t = 0.0
        min_d = math.inf
        for _ in range(max_steps):
            if t >= length:
                return False, t, min_d
            d = self.distance(origin + t * direction)
            min_d = min(min_d, d)
            if d < epsilon:
                return True, t, min_d
            t += d
        return False, t, min_d

    def material_albedo(self, p: Vec) -> Vec:
        """Argmin-over-material-prims albedo (SdfObject.fs:26-46)."""
        if not self.mat_prims:
            return np.ones(3)
        best, alb = math.inf, np.ones(3)
        for vec, fns, albs in self._mat_groups:
            if vec is not None:
                ds = vec(p)
            else:
                ds = np.array([f(p) for f in fns])
            w = int(np.argmin(ds))          # first minimum within the group
            if ds[w] < best:                # strict < keeps earlier groups
                best = float(ds[w])
                alb = albs[w]
        return alb

    # -- shading (SdfScene.fs:7-28, SdfLight.fs) ---------------------------

    def shade_ray(self, origin: Vec, direction: Vec, epsilon: float,
                  length: float, aux: dict | None = None) -> Vec:
        """Shade one ray; when ``aux`` is given, record per-ray diagnostics
        (hit, t, primary/shadow grazing min-distances, occlusion bits) for
        the decomposed f32-vs-f64 image gate."""
        bg = np.asarray(self.scene.background, np.float64)
        hit, t, min_d = self.march_min(origin, direction, epsilon, length)
        if aux is not None:
            aux.update(hit=hit, t=t, min_d=min_d, occluded=[],
                       shadow_min_d=[])
        if not hit:
            return bg
        pos = origin + (t - epsilon) * direction  # back off by epsilon
        n = self.normal(pos)
        albedo = self.material_albedo(pos)
        light_acc = bg.copy()
        for light in self.scene.lights:
            if light.kind == N.LIGHT_DIRECTIONAL:
                ldir = -np.asarray(light.vec, np.float64)
                ldir = ldir / _norm(ldir)
                budget = light.shadow_length
                scale = 1.0
            else:
                diff = np.asarray(light.vec, np.float64) - pos
                dist2 = max(float(diff @ diff), 1e-300)
                dist = math.sqrt(dist2)
                ldir = diff / dist
                budget = dist
                scale = 1.0 / dist2
            cos = float(n @ ldir)
            if cos <= 0.0:
                if aux is not None:
                    aux["occluded"].append(False)
                    aux["shadow_min_d"].append(math.inf)
                continue
            occluded, _st, smin = self.march_min(pos, ldir, epsilon, budget)
            if aux is not None:
                aux["occluded"].append(occluded)
                aux["shadow_min_d"].append(smin)
            if not occluded:
                light_acc += np.asarray(light.color, np.float64) * scale * cos
        return albedo * light_acc / math.pi

    # -- full frame --------------------------------------------------------

    def render(self, camera_pos, camera_target, up=(0.0, 1.0, 0.0),
               fov_degrees: float = 60.0, width: int = 64, height: int = 64,
               epsilon: float = 0.01, length: float = 30.0,
               ortho_scale: float = 0.0,
               return_aux: bool = False) -> np.ndarray:
        """Mirror of camera.py geometry in float64; returns [H, W, 3]
        (+ per-pixel aux dicts [H][W] when ``return_aux``)."""
        pos = np.asarray(camera_pos, np.float64)
        fwd = np.asarray(camera_target, np.float64) - pos
        fwd = fwd / _norm(fwd)
        upv = np.asarray(up, np.float64)
        right = np.cross(upv, fwd)
        right /= _norm(right)
        true_up = np.cross(fwd, right)
        half = 1.0 if ortho_scale > 0 else math.tan(
            math.radians(fov_degrees) * 0.5)
        m = float(max(width, height))
        img = np.zeros((height, width, 3))
        auxs = [[None] * width for _ in range(height)] if return_aux else None
        for yy in range(height):
            v = 2.0 * (((height - 1 - yy) + 0.5) / m - 0.5 * height / m)
            for xx in range(width):
                u = 2.0 * ((xx + 0.5) / m - 0.5 * width / m)
                offset = (u * right * half + v * true_up * half)
                if ortho_scale > 0:
                    o = pos + offset * ortho_scale
                    d = fwd
                else:
                    o = pos
                    d = fwd + offset
                    d = d / _norm(d)
                aux = {} if return_aux else None
                img[yy, xx] = self.shade_ray(o, d, epsilon, length, aux=aux)
                if return_aux:
                    auxs[yy][xx] = aux
        return (img, auxs) if return_aux else img
