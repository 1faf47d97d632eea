"""The configurations' scenes: a frozen NumPy copy of the distributions of the
upstream console program's scene construction (FrayTracer ``Program.fs``
28-83), as the port's ``scene/generators.py`` draws them, so that a later
edit of the port cannot move the yardstick.

A scene is plain arrays (:class:`SceneArrays`), handed alike to the port
(``program.py`` builds its nodes from them) and to the plain reference
(``reference/``).  Every value is rounded to float32 first, the precision
both sides hold it in, so both see the same numbers.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# material kinds, as the configuration files name them
SOLID, MIRROR, DIELECTRIC = "solid", "mirror", "dielectric"
KIND_CODE = {SOLID: 0, MIRROR: 1, DIELECTRIC: 2}


@dataclasses.dataclass
class SceneArrays:
    """``subtract(intersect(union(tori), clip sphere), cut sphere)`` with
    one material a torus, and its lights and background."""

    tori: np.ndarray        # [K, 8]: centre, unit axis, major R, minor r
    clip: np.ndarray        # [4]: centre, radius of the intersected sphere
    cut: np.ndarray         # [4]: centre, radius of the subtracted sphere
    mat_kind: np.ndarray    # [K] int: KIND_CODE of each torus's material
    albedo: np.ndarray      # [K, 3]
    emission: np.ndarray    # [K, 3]
    reflectivity: np.ndarray  # [K]
    ior: np.ndarray         # [K, 2] Cauchy A, B (B in µm²)
    tint: np.ndarray        # [K, 3]
    light_kind: tuple       # ("directional" | "point", ...)
    light_vec: np.ndarray   # [L, 3]: unit propagation direction or position
    light_color: np.ndarray  # [L, 3]
    light_shadow_len: np.ndarray  # [L]
    background: np.ndarray  # [3]


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float64).astype(np.float32).astype(np.float64)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The generator of one use of a run's seed (0: the order of the
    tori, 2: the sampled pixels, 3: the kept calls)."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def _point_in_ball(rng, radius):
    while True:
        p = rng.uniform(-1.0, 1.0, size=3)
        if p @ p <= 1.0:
            return p * radius


def _point_on_sphere(rng, radius):
    while True:
        p = rng.normal(size=3)
        n = np.linalg.norm(p)
        if n > 1e-9:
            return p / n * radius


def draw(spec: dict, seed: int) -> SceneArrays:
    """The scene of configuration ``spec["scene"]``, its tori in the order
    ``seed`` draws.

    The tori are the configuration's scene seed's (``scene["seed"]``), as
    ``random_torus`` draws them one after another from one generator: a
    centre uniform in the ball, a uniform unit axis, R and r uniform in
    their ranges, then a uniform RGB albedo.  With ``specular``, every
    ``dielectric_every``-th torus (index 0 mod it) takes the glass
    material and, of the others, each with index 1 mod ``mirror_every``
    the mirror, as ``spectral_csg_scene`` assigns them.  Then the run's
    seed shuffles the tori: every seed renders the same set of tori and
    so does the same work, in another order."""
    return _permuted(_canonical(spec), seed)


def _canonical(spec: dict) -> SceneArrays:
    s = spec["scene"]
    rng = np.random.default_rng(int(s["seed"]))
    k = int(s["n_tori"])
    tori = np.zeros((k, 8))
    albedo = np.zeros((k, 3))
    for i in range(k):
        tori[i, 0:3] = _point_in_ball(rng, s["ball_radius"])
        tori[i, 3:6] = _point_on_sphere(rng, 1.0)
        tori[i, 6] = rng.uniform(*s["major_radius"])
        tori[i, 7] = rng.uniform(*s["minor_radius"])
        albedo[i] = rng.uniform(0.0, 1.0, size=3)
    kind = np.zeros(k, np.int64)
    refl = np.zeros(k)
    ior = np.tile([1.5, 0.004], (k, 1))
    tint = np.ones((k, 3))
    spec_mats = s.get("specular")
    if spec_mats:
        glass, mirror = spec_mats["glass"], spec_mats["mirror"]
        for i in range(k):
            if i % spec_mats["dielectric_every"] == 0:
                kind[i] = KIND_CODE[DIELECTRIC]
                albedo[i] = 1.0
                ior[i] = (glass["ior"], glass["dispersion"])
                tint[i] = glass["tint"]
            elif i % spec_mats["mirror_every"] == 1:
                kind[i] = KIND_CODE[MIRROR]
                albedo[i] = mirror["albedo"]
                refl[i] = mirror["reflectivity"]
    lights = s["lights"]
    vec = []
    for light in lights:
        v = np.asarray(light["vec"], np.float64)
        vec.append(v / np.linalg.norm(v) if light["kind"] == "directional"
                   else v)
    return SceneArrays(
        tori=_f32(tori), clip=_f32(s["clip_sphere"]),
        cut=_f32(s["cut_sphere"]), mat_kind=kind, albedo=_f32(albedo),
        emission=np.zeros((k, 3)), reflectivity=_f32(refl), ior=_f32(ior),
        tint=_f32(tint), light_kind=tuple(l["kind"] for l in lights),
        light_vec=_f32(vec), light_color=_f32([l["color"] for l in lights]),
        light_shadow_len=_f32([l.get("shadow_length", 1000.0)
                               for l in lights]),
        background=_f32(s["background"]))


def _permuted(scene: SceneArrays, seed: int) -> SceneArrays:
    order = rng_for(seed, 0).permutation(scene.tori.shape[0])
    per_torus = ("tori", "mat_kind", "albedo", "emission", "reflectivity",
                 "ior", "tint")
    return dataclasses.replace(scene, **{f: getattr(scene, f)[order]
                                         for f in per_torus})


def perturbed(spec: dict, sigma: float, seed: int) -> tuple:
    """The fit's target scene and its start, its tori in the order
    ``seed`` draws: every geometry parameter (the tori's and the two
    spheres') plus ``sigma`` × N(0, 1) from the scene seed's own generator,
    so that every run seed starts from the same set of perturbed tori.
    Each axis is then made a unit vector again (the port's ``torus`` node
    normalises it, and the distance only sees its direction)."""
    scene = _canonical(spec)
    rng = np.random.default_rng([int(spec["scene"]["seed"]), 1])
    tori = scene.tori + sigma * rng.normal(size=scene.tori.shape)
    tori[:, 3:6] /= np.linalg.norm(tori[:, 3:6], axis=1, keepdims=True)
    clip = scene.clip + sigma * rng.normal(size=4)
    cut = scene.cut + sigma * rng.normal(size=4)
    start = dataclasses.replace(scene, tori=_f32(tori), clip=_f32(clip),
                                cut=_f32(cut))
    return _permuted(scene, seed), _permuted(start, seed)


def sample_pixels(width: int, height: int, n: int, seed: int) -> np.ndarray:
    """``n`` distinct pixel indices (row-major) drawn from the seed."""
    rng = rng_for(seed, 2)
    return np.sort(rng.choice(width * height, size=min(n, width * height),
                              replace=False))


def kept_calls(n: int, first: int, seed: int) -> list:
    """Which of the window's first ``first`` calls keep their output for
    the check (``n`` of them, drawn from the seed)."""
    rng = rng_for(seed, 3)
    return sorted(int(i) for i in rng.choice(first, size=min(n, first),
                                             replace=False))
