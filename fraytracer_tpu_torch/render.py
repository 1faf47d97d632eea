"""Top-level render API (counterpart of ``fraytracer_tpu.render``).

The pixel grid → camera rays → masked march → shading, as one call over the
whole image (reference ``Image.render`` + ``SdfScene.trace``).  On the
"cuda" backend rays are put in the screen-block order of
``camera.to_blocks`` before marching, as the JAX kernel path does.

The JAX package wraps ``render``, ``render_with_stats`` and
``render_image`` in ``jax.jit``; here a frame of the kernels on a CUDA
device that autograd need not see is one captured CUDA graph a key
(``ops/graph.py``, whose rule every entry point shares), and
:func:`render_grid` is the eager frame of a ray grid.  The JAX package's
``cli fit`` and bench jit ``jax.value_and_grad`` of a loss of the frame;
:func:`render_value_and_grad` is its counterpart, a step (forward and
backward) captured as one CUDA graph a key by the same rule, the
backward's host read (the certificate of ``point_eval``'s candidate
lists) deferred to the graph's flag too.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import checkpoint

from . import camera as cam
from .ops import deferred, graph, shade, tonemap
from .ops.march import MarchConfig, check_config
from .scene.flatten import FlatScene, flatten
from .scene.nodes import Scene
from .types import Rays
from .utils.profiling import span

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True, eq=True)
class RenderConfig:
    """Static render configuration (same fields and defaults as JAX)."""

    width: int = 1024
    height: int = 1024
    epsilon: float = 0.01       # hit threshold (Program.fs:85)
    length: float = 30.0        # ray travel budget (Program.fs:93)
    gamma: float = 2.2          # tone-map gamma (Program.fs:99)
    march: MarchConfig = MarchConfig()
    # rays per tile for the "torch" backend, whose march builds [tile, K]
    # distance matrices; 0 → the whole image in one batch
    tile_rays: int = 65536
    # rays per tile for the kernel backend; 0 → untiled
    tile_rays_pallas: int = 0


def _pad_rays(rays: Rays, pad: int) -> Rays:
    """Append ``pad`` zero-budget (inactive) lanes."""
    padded = rays.map(lambda x: torch.nn.functional.pad(
        x, (0, 0) * (x.ndim - 1) + (0, pad)))
    padded.length[-pad:] = 0.0
    return padded


def _trace(scene: FlatScene, rays: Rays, march_cfg: MarchConfig,
           tile_rays: int):
    """Trace a flat ray batch, in tiles of ``tile_rays`` when > 0 (bounds
    the "torch" backend's memory; with a graph each tile is rematerialized
    in the backward, so one tile's intermediates bound the peak).  Returns
    (colors [N, 3], n_rays)."""
    n = rays.origin.shape[0]
    if tile_rays <= 0 or n <= tile_rays:
        return shade.trace_with_stats(scene, rays, march_cfg)
    pad = (-n) % tile_rays
    if pad:
        rays = _pad_rays(rays, pad)
    keep = torch.is_grad_enabled() and any(
        x.requires_grad for x in scene.tensors().values())

    def tile(i):
        part = rays.map(lambda x: x[i:i + tile_rays])
        if keep:
            return checkpoint(deferred.in_current(shade.trace_with_stats),
                              scene, part, march_cfg, use_reentrant=False)
        return shade.trace_with_stats(scene, part, march_cfg)

    colors, n_rays = [], 0
    for i in range(0, n + pad, tile_rays):
        c, k = tile(i)
        colors.append(c)
        n_rays = n_rays + k
    # padded lanes each contribute exactly 1 to the primary count
    return torch.cat(colors)[:n], n_rays - pad


def _frame(scene: FlatScene, camera: cam.Camera, cfg: RenderConfig):
    """The frame: camera rays, then :func:`render_grid`."""
    rays = cam.camera_rays(camera, cfg.width, cfg.height,
                           cfg.epsilon, cfg.length)
    return render_grid(scene, rays, cfg)


def _step(loss_fn, scene: FlatScene, camera: cam.Camera, cfg: RenderConfig,
          *args) -> tuple:
    """The step on the scene's own leaves, which require grad: ``(loss,
    *grads)``, the gradients in ``scene.tensors()`` order, zeros for a leaf
    autograd did not reach (as ``jax.value_and_grad`` gives them)."""
    leaves = list(scene.tensors().values())
    with torch.enable_grad():
        image = _frame(scene, camera, cfg)[0]
        with span("loss"):
            loss = loss_fn(image, *args)
        del image       # what the backward needs autograd keeps
        if loss.ndim != 0:
            raise ValueError(f"loss_fn returned shape {tuple(loss.shape)}, "
                             "want a scalar")
        with span("vjp"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return (loss.detach(),) + tuple(
        torch.zeros_like(x) if g is None else g
        for x, g in zip(leaves, grads))


def frame_graph(scene: FlatScene, camera: cam.Camera,
                cfg: RenderConfig = RenderConfig()):
    """What the first call of this call's key made, if any
    (``ops/graph.py::find``): its ``capture_s``, and its ``graph`` (``None``
    for a key run eagerly)."""
    return graph.find("frame", scene, camera, cfg)


def render_with_stats(scene: FlatScene, camera: cam.Camera,
                      cfg: RenderConfig = RenderConfig()):
    """``render`` + the number of rays marched (primary + shadow per facing
    hit, an int64 scalar tensor).  Returns ``(image [H, W, 3], n_rays)``.
    The image is differentiable w.r.t. every scene tensor that requires
    grad; when none does, no graph is built.  On the kernels of a CUDA
    device a frame autograd need not see replays a captured CUDA graph
    (``ops/graph.py``); its outputs are the caller's own."""
    with span("frame"):
        check_config(cfg.march)
        return graph.run(_frame, scene, camera, cfg, name="frame")


def step_graph(loss_fn, scene: FlatScene, camera: cam.Camera,
               cfg: RenderConfig, *args):
    """:func:`frame_graph` of the step of :func:`render_value_and_grad`."""
    return graph.find("step", scene, camera, cfg, args, (loss_fn,))


def render_value_and_grad(loss_fn, scene: FlatScene, camera: cam.Camera,
                          cfg: RenderConfig = RenderConfig(), *args):
    """``jax.value_and_grad`` of a loss of the frame, as the JAX package
    jits it: ``loss_fn(image [H, W, 3], *args)`` returns a scalar; the
    result is ``(loss, grads)``, ``grads`` keyed as ``scene.tensors()``
    keys the leaves (the JAX gradient pytree's naming), every floating
    leaf, zeros where the loss does not reach it.  ``args`` are tensors
    (a target image, weights); the camera is held fixed.  ``loss_fn`` is
    part of the key: pass the same function object every step.

    On the kernels of a CUDA device the step is one captured CUDA graph a
    key, forward and backward, with no host read in either
    (``ops/graph.py``'s rule; the backward's certificate is the frame's
    flag, ``ops/point_eval.py::culled_branch``): a later call
    copies the scene's, the camera's and ``args``' tensors into the graph's
    inputs, replays it, reads the flag once and returns clones of the loss
    and the gradients; a flagged call runs the eager step again.  Steps
    count as frames in ``ops.cuda.graph_counts()``.  On the CPU, or on the
    "torch" backend, the step runs eagerly.  The scene's tensors are not
    changed and gain no ``.grad``."""
    with span("step"):
        check_config(cfg.march)
        out = graph.run(functools.partial(_step, loss_fn), scene, camera,
                        cfg, args, name="step", extra=(loss_fn,), grad=True)
        return out[0], dict(zip(scene.tensors(), out[1:]))


def render_grid(scene: FlatScene, rays: Rays, cfg: RenderConfig):
    """Trace a ``[h, w]`` grid of camera rays — a whole frame or a band of
    its rows (``parallel/mesh.py``) — and shade it.  Returns ``(image [h,
    w, 3], n_rays)``.  On the "cuda" backend, when 32 divides both sides,
    the rays are traced in 32×32 block order, so a band of whole block
    rows gets the tiles, tables and windows of the full frame."""
    h, w = rays.origin.shape[:2]
    kernel = cfg.march.backend == "cuda"
    blocked = kernel and h % 32 == 0 and w % 32 == 0
    if blocked:
        b = cam.auto_block(h, w)
        flat = rays.map(lambda x: cam.to_blocks(x, h, w, b))
    else:
        flat = rays.map(lambda x: x.reshape((w * h,) + tuple(x.shape[2:])))
    tile = cfg.tile_rays_pallas if kernel else cfg.tile_rays
    colors, n_rays = _trace(scene, flat, cfg.march, tile)
    if blocked:
        return cam.from_blocks(colors, h, w, b), n_rays
    return colors.reshape(h, w, 3), n_rays


def render(scene: FlatScene, camera: cam.Camera,
           cfg: RenderConfig = RenderConfig()) -> Tensor:
    """Render the full image → linear RGB float32 [H, W, 3] (row 0 = top)."""
    return render_with_stats(scene, camera, cfg)[0]


def render_rays(scene: FlatScene, rays: Rays,
                march_cfg: MarchConfig = MarchConfig()) -> Tensor:
    """Trace an arbitrary ray batch → linear RGB [..., 3]."""
    return shade.trace(scene, rays, march_cfg)


def render_image(scene: FlatScene, camera: cam.Camera,
                 generator: torch.Generator | None = None,
                 cfg: RenderConfig = RenderConfig()) -> Tensor:
    """Render + tone map → dithered uint8 [H, W, 3] (Image.fs:37-50)."""
    return tonemap.tonemap(render(scene, camera, cfg), generator, cfg.gamma)


def render_scene(scene: Scene, camera: cam.Camera,
                 cfg: RenderConfig = RenderConfig()) -> Tensor:
    """Convenience: flatten a builder Scene and render linear RGB."""
    return render(flatten(scene, device=camera.position.device), camera, cfg)
