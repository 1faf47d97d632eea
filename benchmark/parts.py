"""The machined-parts scene (``configs/parts1000.json``): the CSG scene of
the project's contract (a union, intersection and difference of spheres,
cones and boxes) as the textbook part, many times over, inside the
upstream console program's clip and cut spheres (FrayTracer
``Program.fs`` 67-83).

A part is ``(box ∩ sphere) − (three drills along the axes)``, each drill a
capped cone.  A scene is plain arrays (:class:`PartArrays`), handed alike
to the port (:func:`port_scene` builds its nodes) and to the plain
reference (``reference/parts.py``); every value is rounded to float32
first, as ``scenes.py`` rounds its tori.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from benchmark import program
from benchmark.scenes import _f32, _point_in_ball, rng_for

AXES = np.eye(3)


@dataclasses.dataclass
class PartArrays:
    """``subtract(intersect(union(parts), clip sphere), cut sphere)``: the
    rows of each part's leaves, the two materials a part carries, and the
    lights and background."""

    box: np.ndarray         # [K, 7]: centre, half-extents, rounding
    sphere: np.ndarray      # [K, 4]: centre, radius
    cones: np.ndarray       # [K, 3, 8]: end a, end b, radius at a, at b
    box_albedo: np.ndarray  # [K, 3]
    sphere_albedo: np.ndarray  # [K, 3]
    clip: np.ndarray        # [4]
    cut: np.ndarray         # [4]
    light_kind: tuple
    light_vec: np.ndarray   # [L, 3]: unit propagation direction or position
    light_color: np.ndarray  # [L, 3]
    light_shadow_len: np.ndarray  # [L]
    background: np.ndarray  # [3]

    @property
    def n_parts(self) -> int:
        return self.box.shape[0]


def draw(spec: dict, seed: int) -> PartArrays:
    """The parts of configuration ``spec["scene"]``, in the order ``seed``
    draws: every seed renders the same parts (the scene seed's), in
    another order, so every seed does the same work."""
    return _permuted(_canonical(spec), seed)


def _canonical(spec: dict) -> PartArrays:
    """One generator of the scene seed, part after part: a centre uniform
    in the ball, the half-size ``h`` uniform in its range, then the box's
    and the sphere's RGB albedo, each uniform (the upstream
    ``random_material``)."""
    s = spec["scene"]
    rng = np.random.default_rng(int(s["seed"]))
    k = int(s["n_parts"])
    centre, half = np.zeros((k, 3)), np.zeros(k)
    box_alb, sph_alb = np.zeros((k, 3)), np.zeros((k, 3))
    for i in range(k):
        centre[i] = _point_in_ball(rng, s["ball_radius"])
        half[i] = rng.uniform(*s["half_size"])
        box_alb[i] = rng.uniform(0.0, 1.0, size=3)
        sph_alb[i] = rng.uniform(0.0, 1.0, size=3)
    h = half[:, None]
    box = np.concatenate([centre, np.repeat(h, 3, 1),
                          s["box_rounding"] * h], 1)
    sphere = np.concatenate([centre, s["sphere_radius"] * h], 1)
    reach = s["drill_reach"] * h[:, :, None] * AXES[None]      # [K, 3, 3]
    cones = np.concatenate(
        [centre[:, None] - reach, centre[:, None] + reach,
         np.repeat((s["drill_radius"][0] * h)[:, None], 3, 1),
         np.repeat((s["drill_radius"][1] * h)[:, None], 3, 1)], 2)
    lights = s["lights"]
    vec = [np.asarray(l["vec"], np.float64) / (
        np.linalg.norm(l["vec"]) if l["kind"] == "directional" else 1.0)
        for l in lights]
    return PartArrays(
        box=_f32(box), sphere=_f32(sphere), cones=_f32(cones),
        box_albedo=_f32(box_alb), sphere_albedo=_f32(sph_alb),
        clip=_f32(s["clip_sphere"]), cut=_f32(s["cut_sphere"]),
        light_kind=tuple(l["kind"] for l in lights), light_vec=_f32(vec),
        light_color=_f32([l["color"] for l in lights]),
        light_shadow_len=_f32([l.get("shadow_length", 1000.0)
                               for l in lights]),
        background=_f32(s["background"]))


def _permuted(parts: PartArrays, seed: int) -> PartArrays:
    order = rng_for(seed, 0).permutation(parts.n_parts)
    per_part = ("box", "sphere", "cones", "box_albedo", "sphere_albedo")
    return dataclasses.replace(parts, **{f: getattr(parts, f)[order]
                                         for f in per_part})


def port_scene(arrays: PartArrays, device):
    """The port's flat scene of ``arrays``, built from its nodes: each part
    ``subtract(intersect(box, sphere), union(three cones))``, the drills
    without a material (a subtract's right operand is never seen)."""
    ft = program.port()
    parts = []
    for i in range(arrays.n_parts):
        b, s = arrays.box[i], arrays.sphere[i]
        solid = ft.intersect(
            ft.box(b[0:3], b[3:6], float(b[6]),
                   material=ft.solid(*arrays.box_albedo[i])),
            ft.sphere(s[0:3], float(s[3]),
                      material=ft.solid(*arrays.sphere_albedo[i])))
        drills = ft.union(*[ft.cone(c[0:3], c[3:6], float(c[6]), float(c[7]))
                            for c in arrays.cones[i]])
        parts.append(ft.subtract(solid, drills))
    root = ft.subtract(
        ft.intersect(ft.union(*parts),
                     ft.sphere(arrays.clip[0:3], float(arrays.clip[3]))),
        ft.sphere(arrays.cut[0:3], float(arrays.cut[3])))
    lights = []
    for kind, vec, col in zip(arrays.light_kind, arrays.light_vec,
                              arrays.light_color):
        make = ft.directional_light if kind == "directional" \
            else ft.point_light
        lights.append(make(tuple(vec), tuple(col)))
    return ft.flatten(ft.Scene(root=root, background=tuple(arrays.background),
                               lights=tuple(lights)), device=device)


def dense_counts() -> dict | None:
    """The port's dense-form counters (``ops.cuda.dense_counts()``), or
    ``None`` where the port keeps none."""
    try:
        from fraytracer_tpu_torch.ops import cuda
    except ImportError:
        return None
    read = getattr(cuda, "dense_counts", None)
    return None if read is None else read()
