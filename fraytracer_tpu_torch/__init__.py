"""fraytracer_tpu_torch — the PyTorch + CUDA port of ``fraytracer_tpu``.

The SDF/CSG sphere tracer of the JAX package, forward frame first: scenes
flatten to parameter tensors, rays march through hand-written CUDA kernels
(``csrc/``) on an NVIDIA GPU, or through the kernels' plain PyTorch
versions on the CPU.  Importing the package builds nothing and needs no
GPU.

Quick start::

    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.scene.generators import torus_csg_scene

    scene = ft.flatten(torus_csg_scene(19, 1000), device="cuda")
    camera = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60, device="cuda")
    cfg = ft.RenderConfig(march=ft.MarchConfig(backend="cuda", cull=False,
                                               relax_omega=1.4))
    img = ft.render(scene, camera, cfg)
"""

from .camera import Camera, camera_rays, look_at
from .ops.march import MarchConfig, march
from .ops.sdf import (material_at, prim_bounds, prim_distances, root_bound,
                      scene_distance, scene_normal)
from .ops.shade import surface_hit, trace
from .ops.tonemap import tonemap
from .render import (RenderConfig, render, render_image, render_rays,
                     render_scene, render_with_stats)
from .scene.flatten import FlatScene, flatten
from .scene.nodes import (Light, Material, Scene, SdfNode, box, capsule, cone,
                          dielectric, directional_light, emissive, intersect,
                          mirror, plane, point_light, procedural,
                          smooth_union, solid, sphere, subtract, torus,
                          triangle, union)
from .types import MarchResult, Rays, SurfaceHit, make_rays

__version__ = "0.1.0"

__all__ = [
    "Camera", "camera_rays", "look_at",
    "MarchConfig", "march",
    "material_at", "prim_bounds", "prim_distances", "root_bound",
    "scene_distance", "scene_normal",
    "surface_hit", "trace", "tonemap",
    "RenderConfig", "render", "render_image", "render_rays", "render_scene",
    "render_with_stats",
    "FlatScene", "flatten",
    "Light", "Material", "Scene", "SdfNode", "box", "capsule", "cone",
    "dielectric", "directional_light", "emissive", "intersect", "mirror",
    "plane", "point_light", "procedural", "smooth_union", "solid",
    "sphere", "subtract",
    "torus", "triangle", "union",
    "MarchResult", "Rays", "SurfaceHit", "make_rays",
]
