"""Scene-graph builder: immutable, composable SDF nodes.

This is the user-facing combinator API replacing the reference's closure-based
scene algebra (FrayTracer's ``src/FrayTracer/SdfForm.fs``,
``SdfObject.fs``).  Where the reference builds a tree of F# closures capturing
child closures (``Types.fs:40-44``), we build a lightweight *description* tree
of Python dataclasses; :mod:`fraytracer_tpu_torch.scene.flatten` lowers it to
flat tagged parameter tensors that the CUDA kernels consume.

Combinator parity with the reference:

* ``union``          — n-ary min           (``SdfForm.fs:14-40``)
* ``smooth_union``   — exp smooth-min      (``SdfForm.fs:69-91``)
* ``intersect``      — n-ary max           (``SdfForm.fs:51-67``)
* ``subtract``       — ``max(a, -b)``      (``SdfForm.fs:42-49``)

Primitive parity: sphere / capsule / torus / triangle
(``SdfForm.fs:117-268``) plus box / cone / plane, which the reference lacks
but its benchmark configs require (``BASELINE.json`` configs).

Operators: ``a | b`` = union, ``a & b`` = intersect, ``a - b`` = subtract.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Material", "solid", "mirror", "dielectric", "emissive", "procedural",
    "SdfNode", "Prim", "Union", "SmoothUnion", "Intersect", "Subtract",
    "sphere", "capsule", "torus", "triangle", "box", "cone", "plane",
    "union", "smooth_union", "intersect", "subtract",
    "Light", "directional_light", "point_light",
    "Scene",
    "MAT_SOLID", "MAT_MIRROR", "MAT_DIELECTRIC", "MAT_PROCEDURAL",
]

# ---------------------------------------------------------------------------
# Materials
# ---------------------------------------------------------------------------

MAT_SOLID = 0       # lambertian solid color (reference SdfMaterial.createSolid)
MAT_MIRROR = 1      # perfect/partial specular reflector (secondary rays)
MAT_DIELECTRIC = 2  # dispersive glass: Fresnel reflect+refract (Light.fs:28-59)
MAT_PROCEDURAL = 3  # fbm-noise blend of two colors ("wood, cloud",
                    # reference README.md:10 / Noise.fs)


@dataclasses.dataclass(frozen=True)
class Material:
    """Surface material description.

    The reference's live material system is a single constant-color closure
    (``SdfMaterial.fs:4-10``); its *intended* system (``README.md:10-12``,
    vestigial ``Light.fs``/``Materials.fs``) adds spectral Fresnel
    reflection/refraction.  We implement both: ``kind`` selects the shading
    path in the wavefront integrator.

    ``ior_a``/``ior_b`` are Cauchy coefficients: n(λ) = ior_a + ior_b/λ²
    with λ in micrometres — the standard dispersive-glass model backing the
    refraction indices catalogued in the reference's ``Materials.fs:6-60``.
    """

    albedo: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    kind: int = MAT_SOLID
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    reflectivity: float = 0.0          # mirror blend for MAT_MIRROR
    ior_a: float = 1.5                 # Cauchy A (dimensionless)
    ior_b: float = 0.004               # Cauchy B (µm²)
    tint: Tuple[float, float, float] = (1.0, 1.0, 1.0)  # transmission tint


def solid(r: float, g: float, b: float) -> Material:
    """Constant-color lambertian (reference ``SdfMaterial.createSolid``,
    SdfMaterial.fs:4-7)."""
    return Material(albedo=(float(r), float(g), float(b)), kind=MAT_SOLID)


def mirror(reflectivity: float = 1.0,
           albedo: Tuple[float, float, float] = (1.0, 1.0, 1.0)) -> Material:
    return Material(albedo=albedo, kind=MAT_MIRROR,
                    reflectivity=float(reflectivity))


def dielectric(ior: float = 1.5, dispersion: float = 0.004,
               tint: Tuple[float, float, float] = (1.0, 1.0, 1.0)) -> Material:
    """Dispersive glass (the reference's unrealised goal: ``README.md:7``,
    ``Light.fs:28-59``, ``Materials.fs``)."""
    return Material(kind=MAT_DIELECTRIC, ior_a=float(ior),
                    ior_b=float(dispersion), tint=tint)


def emissive(r: float, g: float, b: float) -> Material:
    return Material(albedo=(0.0, 0.0, 0.0), emission=(float(r), float(g), float(b)))


def procedural(color_a, color_b, scale: float = 2.0) -> Material:
    """Lambertian whose albedo blends ``color_a → color_b`` by fbm gradient
    noise of the hit position (``utils.noise``) — the reference's procedural
    material goal (README.md:10, Noise.fs).  ``scale`` is the noise spatial
    frequency (stored in ``reflectivity``; ``tint`` holds color_b)."""
    a = tuple(float(x) for x in color_a)
    b = tuple(float(x) for x in color_b)
    return Material(albedo=a, tint=b, kind=MAT_PROCEDURAL,
                    reflectivity=float(scale))


# ---------------------------------------------------------------------------
# SDF nodes
# ---------------------------------------------------------------------------


class SdfNode:
    """Base class for scene-graph nodes.  Immutable and composable —
    the design goals stated in the reference ``README.md:8``."""

    def __or__(self, other: "SdfNode") -> "SdfNode":
        return union(self, other)

    def __and__(self, other: "SdfNode") -> "SdfNode":
        return intersect(self, other)

    def __sub__(self, other: "SdfNode") -> "SdfNode":
        return subtract(self, other)


@dataclasses.dataclass(frozen=True)
class Prim(SdfNode):
    """A leaf primitive: a type tag + packed parameter row + optional material.

    ``params`` layout per kind (all float32):

    * ``sphere``:   [cx, cy, cz, r]                                  (SdfForm.fs:125-135)
    * ``capsule``:  [ax, ay, az, bx, by, bz, r]                      (SdfForm.fs:145-170)
    * ``torus``:    [cx, cy, cz, nx, ny, nz, R, r]                   (SdfForm.fs:181-203)
    * ``triangle``: [v1(3), v2(3), v3(3), r]  — rounded triangle     (SdfForm.fs:214-250)
    * ``box``:      [cx, cy, cz, hx, hy, hz, r] — rounded AA box     (new; BASELINE config 2)
    * ``cone``:     [ax, ay, az, bx, by, bz, ra, rb] — capped cone   (new; BASELINE config 2)
    * ``plane``:    [nx, ny, nz, offset]  — half-space               (new)
    """

    kind: str
    params: Tuple[float, ...]
    material: Optional[Material] = None

    def with_material(self, m: Material) -> "Prim":
        return dataclasses.replace(self, material=m)


@dataclasses.dataclass(frozen=True)
class Union(SdfNode):
    children: Tuple[SdfNode, ...]


@dataclasses.dataclass(frozen=True)
class SmoothUnion(SdfNode):
    children: Tuple[SdfNode, ...]
    k: float  # smoothing strength (reference `strength`, SdfForm.fs:69)


@dataclasses.dataclass(frozen=True)
class Intersect(SdfNode):
    children: Tuple[SdfNode, ...]


@dataclasses.dataclass(frozen=True)
class Subtract(SdfNode):
    a: SdfNode
    b: SdfNode


def _v3(x) -> Tuple[float, float, float]:
    a = np.asarray(x, dtype=np.float64).reshape(3)
    return (float(a[0]), float(a[1]), float(a[2]))


def sphere(center, radius: float, material: Optional[Material] = None) -> Prim:
    return Prim("sphere", _v3(center) + (float(radius),), material)


def capsule(a, b, radius: float, material: Optional[Material] = None) -> Prim:
    return Prim("capsule", _v3(a) + _v3(b) + (float(radius),), material)


def torus(center, normal, major_radius: float, minor_radius: float,
          material: Optional[Material] = None) -> Prim:
    n = np.asarray(normal, np.float64)
    n = n / np.linalg.norm(n)
    return Prim("torus", _v3(center) + _v3(n)
                + (float(major_radius), float(minor_radius)), material)


def triangle(v1, v2, v3, radius: float, material: Optional[Material] = None) -> Prim:
    return Prim("triangle", _v3(v1) + _v3(v2) + _v3(v3) + (float(radius),), material)


def box(center, half_extents, radius: float = 0.0,
        material: Optional[Material] = None) -> Prim:
    return Prim("box", _v3(center) + _v3(half_extents) + (float(radius),), material)


def cone(a, b, ra: float, rb: float = 0.0,
         material: Optional[Material] = None) -> Prim:
    """Capped cone from disk (a, ra) to disk (b, rb); rb=0 gives a true cone."""
    return Prim("cone", _v3(a) + _v3(b) + (float(ra), float(rb)), material)


def plane(normal, offset: float, material: Optional[Material] = None) -> Prim:
    n = np.asarray(normal, np.float64)
    n = n / np.linalg.norm(n)
    return Prim("plane", _v3(n) + (float(offset),), material)


def _flatten_children(op_cls, nodes: Sequence[SdfNode]) -> Tuple[SdfNode, ...]:
    out = []
    for n in nodes:
        if isinstance(n, op_cls):
            out.extend(n.children)
        else:
            out.append(n)
    return tuple(out)


def union(*nodes: SdfNode) -> SdfNode:
    """N-ary union (min).  Nested unions are flattened so sibling primitives
    land in one masked-min reduction — the TPU analog of the reference's
    spatial-lookup-pruned linear min (``SdfForm.fs:14-40``)."""
    nodes = _flatten_children(Union, nodes)
    if not nodes:
        raise ValueError("union of no nodes")
    if len(nodes) == 1:
        return nodes[0]
    return Union(nodes)


def smooth_union(k: float, *nodes: SdfNode) -> SdfNode:
    """Exponential smooth-min ``-k * log(sum(exp(-d_i / k)))``
    (reference ``SdfForm.unionSmooth``, SdfForm.fs:69-91)."""
    if not nodes:
        raise ValueError("smooth_union of no nodes")
    if len(nodes) == 1:
        return nodes[0]
    return SmoothUnion(tuple(nodes), float(k))


def intersect(*nodes: SdfNode) -> SdfNode:
    """N-ary intersection (max) (reference ``SdfForm.intersect``,
    SdfForm.fs:51-67)."""
    nodes = _flatten_children(Intersect, nodes)
    if not nodes:
        raise ValueError("intersect of no nodes")
    if len(nodes) == 1:
        return nodes[0]
    return Intersect(nodes)


def subtract(a: SdfNode, b: SdfNode) -> SdfNode:
    """``max(d_a, -d_b)`` (reference ``SdfForm.subtract``, SdfForm.fs:42-49)."""
    return Subtract(a, b)


# ---------------------------------------------------------------------------
# Lights
# ---------------------------------------------------------------------------

LIGHT_DIRECTIONAL = 0
LIGHT_POINT = 1


@dataclasses.dataclass(frozen=True)
class Light:
    """Light description (reference ``SdfLight.fs``).

    ``directional``: ``vec`` is the *propagation* direction of the light
    (shadow rays go along ``-vec``); intensity is ``color`` when unoccluded
    (``SdfLight.fs:6-21``, shadow-ray budget 1000 kept as ``shadow_length``).

    ``point``: ``vec`` is the light position; intensity falls off as
    ``color / dist²`` (``SdfLight.fs:23-42``).  The reference's
    shadow-direction normalization bug (``SdfLight.fs:30`` divides by dist²)
    is intentionally NOT replicated — our shadow rays use unit directions.
    """

    kind: int
    vec: Tuple[float, float, float]
    color: Tuple[float, float, float]
    shadow_length: float = 1000.0


def directional_light(direction, color) -> Light:
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    return Light(LIGHT_DIRECTIONAL, _v3(d), _v3(color))


def point_light(position, color) -> Light:
    return Light(LIGHT_POINT, _v3(position), _v3(color))


# ---------------------------------------------------------------------------
# Scene
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scene:
    """A complete scene: one root SDF object + background + lights
    (reference ``SdfScene``, Types.fs:74-79).  ``background`` doubles as the
    ambient term exactly as in the reference integrator (``SdfScene.fs:12``)."""

    root: SdfNode
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    lights: Tuple[Light, ...] = ()
