"""Top-level render API (counterpart of ``fraytracer_tpu.render``).

The pixel grid → camera rays → masked march → shading, as one call over the
whole image (reference ``Image.render`` + ``SdfScene.trace``).  On the
"cuda" backend rays are put in 32×32 screen-block order before marching, as
the JAX kernel path does; dense marching does not need it, the culled
kernels will.
"""
from __future__ import annotations

import dataclasses

import torch

from . import camera as cam
from .ops import shade, tonemap
from .ops.march import MarchConfig, check_config
from .scene.flatten import FlatScene, flatten
from .scene.nodes import Scene
from .types import Rays

Tensor = torch.Tensor

BLOCK_EDGE = 32   # screen-block edge: one 1024-ray tile per block


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


def _auto_block(height: int, width: int) -> int:
    """Screen-block edge: 32 (the non-TPU ray tile of 1024 rays), halved
    until it divides both image sides."""
    b = BLOCK_EDGE
    while height % b or width % b:
        b //= 2
    return max(b, 1)


def _to_blocks(x: Tensor, height: int, width: int, b: int) -> Tensor:
    """[H, W, ...] → flat [H·W, ...] in b×b-block order."""
    t = x.reshape((height // b, b, width // b, b) + tuple(x.shape[2:]))
    order = (0, 2, 1, 3) + tuple(range(4, t.ndim))
    return t.permute(order).reshape((height * width,) + tuple(x.shape[2:]))


def _from_blocks(x: Tensor, height: int, width: int, b: int) -> Tensor:
    """flat [H·W, ...] in block order → [H, W, ...]."""
    t = x.reshape((height // b, width // b, b, b) + tuple(x.shape[1:]))
    order = (0, 2, 1, 3) + tuple(range(4, t.ndim))
    return t.permute(order).reshape((height, width) + tuple(x.shape[1:]))


def _pad_rays(rays: Rays, pad: int) -> Rays:
    """Append ``pad`` zero-budget (inactive) lanes."""
    padded = rays.map(lambda x: torch.nn.functional.pad(
        x, (0, 0) * (x.ndim - 1) + (0, pad)))
    padded.length[-pad:] = 0.0
    return padded


def _trace(scene: FlatScene, rays: Rays, march_cfg: MarchConfig,
           tile_rays: int):
    """Trace a flat ray batch, in tiles of ``tile_rays`` when > 0 (bounds
    the "torch" backend's memory).  Returns (colors [N, 3], n_rays)."""
    n = rays.origin.shape[0]
    if tile_rays <= 0 or n <= tile_rays:
        return shade.trace_with_stats(scene, rays, march_cfg)
    pad = (-n) % tile_rays
    if pad:
        rays = _pad_rays(rays, pad)
    colors, n_rays = [], 0
    for i in range(0, n + pad, tile_rays):
        c, k = shade.trace_with_stats(
            scene, rays.map(lambda x: x[i:i + tile_rays]), march_cfg)
        colors.append(c)
        n_rays = n_rays + k
    # padded lanes each contribute exactly 1 to the primary count
    return torch.cat(colors)[:n], n_rays - pad


@torch.no_grad()
def render_with_stats(scene: FlatScene, camera: cam.Camera,
                      cfg: RenderConfig = RenderConfig()):
    """``render`` + the number of rays marched (primary + shadow per facing
    hit, an int64 scalar tensor).  Returns ``(image [H, W, 3], n_rays)``."""
    check_config(cfg.march)
    rays = cam.camera_rays(camera, cfg.width, cfg.height,
                           cfg.epsilon, cfg.length)
    kernel = cfg.march.backend == "cuda"
    blocked = kernel and cfg.height % 32 == 0 and cfg.width % 32 == 0
    if blocked:
        b = _auto_block(cfg.height, cfg.width)
        flat = rays.map(lambda x: _to_blocks(x, cfg.height, cfg.width, b))
    else:
        flat = rays.map(lambda x: x.reshape(
            (cfg.width * cfg.height,) + tuple(x.shape[2:])))
    tile = cfg.tile_rays_pallas if kernel else cfg.tile_rays
    colors, n_rays = _trace(scene, flat, cfg.march, tile)
    if blocked:
        return _from_blocks(colors, cfg.height, cfg.width, b), n_rays
    return colors.reshape(cfg.height, cfg.width, 3), n_rays


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
