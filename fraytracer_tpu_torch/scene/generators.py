"""Seeded random scene generators.

Replicates the *distributions* of the reference console program's scene
construction (``Program.fs:28-83``): random materials, spheres, capsules,
tori and triangles drawn in a ball of radius 4, assembled into the de-facto
benchmark scene ``subtract(intersect(union(1000 tori), sphere r=3.5),
sphere r=2.5)`` with one directional + one red point light.  RNG is NumPy
(not .NET ``System.Random``) so exact pixel parity with the F# binary is not
a goal — parity is against our scalar oracle (SURVEY.md §4).
"""
from __future__ import annotations

import numpy as np

from . import nodes as N

__all__ = [
    "random_material", "random_sphere", "random_capsule", "random_torus",
    "random_triangle", "torus_csg_scene", "benchmark_scene",
    "csg_demo_scene", "spectral_csg_scene",
]


def _point_in_ball(rng: np.random.Generator, radius: float) -> np.ndarray:
    """Rejection-sampled uniform point in a ball (Random.fs:27-32)."""
    while True:
        p = rng.uniform(-1.0, 1.0, size=3)
        if p @ p <= 1.0:
            return p * radius


def _point_on_sphere(rng: np.random.Generator, radius: float) -> np.ndarray:
    """Uniform point on a sphere via normalized ball sample
    (Random.fs:34-40)."""
    while True:
        p = rng.normal(size=3)
        n = np.linalg.norm(p)
        if n > 1e-9:
            return p / n * radius


def random_material(rng: np.random.Generator) -> N.Material:
    """Uniform random solid color (Program.fs:28-30)."""
    r, g, b = rng.uniform(0.0, 1.0, size=3)
    return N.solid(r, g, b)


def random_sphere(rng: np.random.Generator) -> N.Prim:
    """(Program.fs:32-37)"""
    return N.sphere(_point_in_ball(rng, 4.0), rng.uniform(0.3, 1.0),
                    material=random_material(rng))


def random_capsule(rng: np.random.Generator) -> N.Prim:
    """(Program.fs:39-46)"""
    center = _point_in_ball(rng, 4.0)
    return N.capsule(
        center, center + _point_on_sphere(rng, rng.uniform(0.5, 2.0)),
        rng.uniform(0.1, 0.3), material=random_material(rng))


def random_torus(rng: np.random.Generator) -> N.Prim:
    """(Program.fs:48-55)"""
    return N.torus(
        _point_in_ball(rng, 4.0), _point_on_sphere(rng, 1.0),
        rng.uniform(0.1, 0.4), rng.uniform(0.1, 0.3),
        material=random_material(rng))


def random_triangle(rng: np.random.Generator) -> N.Prim:
    """(Program.fs:57-65)"""
    v1 = _point_in_ball(rng, 4.0)
    return N.triangle(
        v1, v1 + _point_on_sphere(rng, rng.uniform(0.2, 0.6)),
        v1 + _point_on_sphere(rng, rng.uniform(0.2, 0.6)),
        rng.uniform(0.1, 0.3), material=random_material(rng))


def torus_csg_scene(seed: int = 19, n_tori: int = 1000) -> N.Scene:
    """The reference's de-facto benchmark scene (Program.fs:67-83):
    ``subtract(intersect(union(n random tori), sphere r=3.5),
    sphere(-0.5, 1, -2) r=2.5)``, 0.1-gray background, one directional +
    one red point light."""
    rng = np.random.default_rng(seed)
    tori = [random_torus(rng) for _ in range(n_tori)]
    root = N.subtract(
        N.intersect(N.union(*tori), N.sphere((0.0, 0.0, 0.0), 3.5)),
        N.sphere((-0.5, 1.0, -2.0), 2.5),
    )
    return N.Scene(
        root=root,
        background=(0.1, 0.1, 0.1),
        lights=(
            N.directional_light((-0.5, -1.0, 1.0), (0.5, 0.5, 0.5)),
            N.point_light((-0.5, 0.0, -2.0), (10.0, 0.0, 0.0)),
        ),
    )


# the canonical benchmark entry (BASELINE.md implied workload)
benchmark_scene = torus_csg_scene


def spectral_csg_scene(seed: int = 19, n_tori: int = 1000,
                       frac_dielectric: float = 0.25,
                       frac_mirror: float = 0.10) -> N.Scene:
    """The benchmark scene with a deterministic fraction of dispersive
    glass + mirror tori — the spectral-benchmark workload (BASELINE
    configs 3-4; the reference's intended optics, README.md:7 +
    Materials.fs glass constants).  Every 1/frac-th torus (by index) gets
    the specular material so the wavefront queue actually carries
    dispersive bounce rays instead of degenerating to the diffuse case."""
    rng = np.random.default_rng(seed)
    tori = []
    kd = max(int(round(1.0 / max(frac_dielectric, 1e-6))), 1)
    km = max(int(round(1.0 / max(frac_mirror, 1e-6))), 1)
    for i in range(n_tori):
        t = random_torus(rng)
        if i % kd == 0:
            t = N.torus(t.params[0:3], t.params[3:6], float(t.params[6]),
                        float(t.params[7]),
                        material=N.dielectric(1.5168, 0.00420,
                                              tint=(0.95, 0.97, 0.99)))
        elif i % km == 1:
            t = N.torus(t.params[0:3], t.params[3:6], float(t.params[6]),
                        float(t.params[7]),
                        material=N.mirror(0.85, albedo=(0.9, 0.9, 0.9)))
        tori.append(t)
    root = N.subtract(
        N.intersect(N.union(*tori), N.sphere((0.0, 0.0, 0.0), 3.5)),
        N.sphere((-0.5, 1.0, -2.0), 2.5),
    )
    return N.Scene(
        root=root,
        background=(0.1, 0.1, 0.1),
        lights=(
            N.directional_light((-0.5, -1.0, 1.0), (0.5, 0.5, 0.5)),
            N.point_light((-0.5, 0.0, -2.0), (10.0, 0.0, 0.0)),
        ),
    )


def csg_demo_scene(seed: int = 7) -> N.Scene:
    """BASELINE config 2: CSG of sphere + cone + box, perspective camera."""
    rng = np.random.default_rng(seed)
    root = N.subtract(
        N.union(
            N.sphere((0.0, 0.5, 0.0), 1.0, material=N.solid(0.9, 0.3, 0.2)),
            N.box((1.2, 0.0, 0.5), (0.6, 0.6, 0.6), 0.05,
                  material=N.solid(0.2, 0.5, 0.9)),
            N.cone((-1.3, -0.8, 0.0), (-1.3, 1.0, 0.0), 0.8, 0.05,
                   material=N.solid(0.3, 0.8, 0.3)),
            N.plane((0.0, 1.0, 0.0), -1.0, material=N.solid(0.6, 0.6, 0.6)),
        ),
        N.sphere((0.4, 1.0, -0.8), 0.7),
    )
    return N.Scene(
        root=root,
        background=(0.08, 0.08, 0.1),
        lights=(
            N.directional_light((-0.4, -1.0, 0.6), (0.7, 0.7, 0.65)),
            N.point_light((2.0, 2.5, -2.0), (6.0, 5.0, 4.0)),
        ),
    )
