"""fraytracer_tpu_torch — the PyTorch + CUDA port of ``fraytracer_tpu``.

The SDF/CSG sphere tracer of the JAX package: scenes flatten to parameter
tensors, rays march through hand-written CUDA kernels (``csrc/``) on an
NVIDIA GPU — culled per-tile candidate tables by default, every primitive
each step with ``cull=False`` — or through the kernels' plain PyTorch
versions on the CPU.  A frame is differentiable w.r.t. every scene tensor
that requires grad (implicit differentiation at the hit points,
``ops/march.py``).  The entry points default to the GPU and the kernels;
name ``device="cpu"`` to run the plain versions.  On the card a frame
that autograd need not see replays one captured CUDA graph per scene
structure, shapes and config (``ops/graph.py``; ``render_grid`` is the
eager frame), and so does a step of ``render_value_and_grad`` (forward
and backward).  Importing the package builds nothing and needs no GPU.

Quick start::

    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.scene.generators import torus_csg_scene

    scene = ft.flatten(torus_csg_scene(19, 1000))
    camera = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60)
    cfg = ft.RenderConfig(march=ft.MarchConfig(relax_omega=1.4))
    img = ft.render(scene, camera, cfg)

    scene.requires_grad_(True)              # inverse rendering
    (ft.render(scene, camera, cfg) ** 2).sum().backward()
    loss, grads = ft.render_value_and_grad(  # the step as one CUDA graph
        lambda img: (img ** 2).sum(), scene, camera, cfg)

    from fraytracer_tpu_torch.scene.generators import spectral_csg_scene
    glass = ft.flatten(spectral_csg_scene(19, 1000))   # spectral wavefront
    img = ft.render_spectral(glass, camera, 512, 512,
                             ft.WavefrontConfig(march=cfg.march))
"""

from .camera import Camera, camera_rays, look_at
from .ops.march import MarchConfig, march
from .ops.sdf import (material_at, prim_bounds, prim_distances, root_bound,
                      scene_distance, scene_normal)
from .ops.shade import surface_hit, trace
from .ops import spectral
from .ops.tonemap import tonemap
from .ops.wavefront import (WavefrontConfig, render_spectral,
                            render_spectral_with_stats)
from .render import (RenderConfig, render, render_grid, render_image,
                     render_rays, render_scene, render_value_and_grad,
                     render_with_stats)
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
    "spectral", "WavefrontConfig", "render_spectral",
    "render_spectral_with_stats",
    "RenderConfig", "render", "render_grid", "render_image", "render_rays",
    "render_scene", "render_value_and_grad", "render_with_stats",
    "FlatScene", "flatten",
    "Light", "Material", "Scene", "SdfNode", "box", "capsule", "cone",
    "dielectric", "directional_light", "emissive", "intersect", "mirror",
    "plane", "point_light", "procedural", "smooth_union", "solid",
    "sphere", "subtract",
    "torus", "triangle", "union",
    "MarchResult", "Rays", "SurfaceHit", "make_rays",
]
