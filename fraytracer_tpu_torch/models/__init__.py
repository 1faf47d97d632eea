"""Preset scenes ("model zoo"): ready-made demonstrations of each
capability tier (counterpart of ``fraytracer_tpu.models``)."""
from __future__ import annotations

from ..scene import nodes as N
from ..scene.generators import csg_demo_scene, torus_csg_scene

__all__ = [
    "single_sphere_scene", "torus_csg_scene", "csg_demo_scene",
    "glass_demo_scene", "mirror_demo_scene",
]


def single_sphere_scene() -> N.Scene:
    """A single lambertian sphere under one directional light."""
    return N.Scene(
        root=N.sphere((0.0, 0.0, 0.0), 1.0, material=N.solid(0.9, 0.9, 0.9)),
        background=(0.0, 0.0, 0.0),
        lights=(N.directional_light((0.0, -0.3, 1.0), (1.0, 1.0, 1.0)),),
    )


def glass_demo_scene() -> N.Scene:
    """Dispersive glass sphere over a floor with an emissive bar (the
    forward frame shades it as Lambert + emission; refraction belongs to
    the spectral wavefront)."""
    return N.Scene(
        root=N.union(
            N.sphere((0.0, 0.2, 0.0), 1.0,
                     material=N.dielectric(ior=1.5, dispersion=0.02)),
            N.box((0.0, 0.5, 3.0), (0.2, 2.0, 0.05),
                  material=N.emissive(4.0, 4.0, 4.0)),
            N.plane((0.0, 1.0, 0.0), -1.0,
                    material=N.solid(0.5, 0.5, 0.55)),
        ),
        background=(0.02, 0.02, 0.03),
        lights=(N.directional_light((-0.3, -1.0, 0.4), (0.8, 0.8, 0.75)),),
    )


def mirror_demo_scene() -> N.Scene:
    """Secondary-ray reflections: mirrored floor under colored solids."""
    return N.Scene(
        root=N.union(
            N.sphere((-0.9, 0.6, 0.0), 0.6, material=N.solid(0.9, 0.2, 0.2)),
            N.box((0.9, 0.45, 0.3), (0.45, 0.45, 0.45), 0.05,
                  material=N.solid(0.2, 0.4, 0.9)),
            N.plane((0.0, 1.0, 0.0), 0.0, material=N.mirror(0.85)),
        ),
        background=(0.05, 0.05, 0.06),
        lights=(
            N.directional_light((0.3, -1.0, 0.5), (0.9, 0.9, 0.85)),
            N.point_light((0.0, 3.0, -2.0), (4.0, 4.0, 4.0)),
        ),
    )
