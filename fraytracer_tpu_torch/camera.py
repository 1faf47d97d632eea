"""Pinhole camera: orthonormal frame + batched pixel→ray generation.

Counterpart of ``fraytracer_tpu.camera`` (reference ``Camera.fs``), with the
same two deliberate fixes: field-of-view in degrees, and a near-plane
half-size of ``tan(fov/2)``.  Also provides the orthographic projection.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .types import Rays, cross, normalize


@dataclasses.dataclass
class Camera:
    """Pinhole camera frame (reference ``Camera`` record): position +
    forward + up/right scaled by the near-plane half-size.
    ``ortho_scale > 0`` switches to an orthographic projection."""

    position: torch.Tensor       # [3]
    forward: torch.Tensor        # [3] unit
    up_scaled: torch.Tensor      # [3] up * near_plane_half_size
    right_scaled: torch.Tensor   # [3] right * near_plane_half_size
    ortho_scale: float = 0.0


def look_at(position, target, up=(0.0, 1.0, 0.0), fov_degrees: float = 60.0,
            ortho_scale: float = 0.0, device="cpu") -> Camera:
    """Build a camera frame (reference ``Camera.lookAt``).  Left-handed like
    the reference: right = up × forward."""
    f32 = dict(dtype=torch.float32, device=device)
    position = torch.as_tensor(position, **f32)
    target = torch.as_tensor(target, **f32)
    up = torch.as_tensor(up, **f32)
    forward = normalize(target - position)
    right = normalize(cross(up, forward))
    true_up = cross(forward, right)
    half = 1.0 if ortho_scale > 0.0 else math.tan(
        math.radians(float(fov_degrees)) * 0.5)
    half_t = torch.tensor(half, **f32)
    return Camera(position=position, forward=forward,
                  up_scaled=true_up * half_t, right_scaled=right * half_t,
                  ortho_scale=float(ortho_scale))


def pixel_grid_uv(width: int, height: int, device="cpu"):
    """Uniform pixel-centre coordinates, row 0 = top; (u, v) each [H, W]
    with v increasing upward (reference ``ImageSize.getUniformPixelPos``)."""
    m = float(max(width, height))
    x = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / m
    y = (torch.arange(height, dtype=torch.float32, device=device)
         .flip(0) + 0.5) / m
    u = x[None, :].expand(height, width)
    v = y[:, None].expand(height, width)
    return u, v


def camera_rays(camera: Camera, width: int, height: int,
                epsilon, length) -> Rays:
    """The full [H, W] primary-ray batch (reference
    ``Camera.uniformPixelToRay``, vectorized)."""
    device = camera.position.device
    u, v = pixel_grid_uv(width, height, device)
    ndc_u = 2.0 * (u - 0.5 * width / max(width, height))
    ndc_v = 2.0 * (v - 0.5 * height / max(width, height))
    offset = (ndc_u[..., None] * camera.right_scaled
              + ndc_v[..., None] * camera.up_scaled)
    if camera.ortho_scale > 0.0:
        origin = camera.position + offset * camera.ortho_scale
        direction = camera.forward.expand(height, width, 3)
    else:
        origin = camera.position.expand(height, width, 3)
        direction = normalize(camera.forward + offset)
    f32 = dict(dtype=torch.float32, device=device)
    return Rays(origin=origin.contiguous(),
                direction=direction.contiguous(),
                length=torch.full((height, width), float(length), **f32),
                epsilon=torch.full((height, width), float(epsilon), **f32))
