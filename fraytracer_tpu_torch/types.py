"""Core value types of the PyTorch port (counterpart of ``fraytracer_tpu.types``).

Everything is a **batch**: ``Rays`` holds a structure-of-arrays bundle of
many rays; trace results are batched and masked (a ``hit`` bool tensor
replaces the reference's ``voption``).  Containers are plain dataclasses of
tensors; ``map`` applies a function to every tensor field (the port's
stand-in for ``jax.tree.map``).
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


def _map_fields(obj, fn):
    return dataclasses.replace(obj, **{
        f.name: fn(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


@dataclasses.dataclass
class Rays:
    """A batch of rays (structure-of-arrays), reference ``Ray``
    (``Types.fs:10-17``): ``origin``/``direction`` are ``[..., 3]``;
    ``length`` (remaining travel budget) and ``epsilon`` (hit threshold) are
    ``[...]``."""

    origin: Tensor      # [..., 3] float32
    direction: Tensor   # [..., 3] float32, unit norm
    length: Tensor      # [...]    float32
    epsilon: Tensor     # [...]    float32

    @property
    def batch_shape(self):
        return tuple(self.origin.shape[:-1])

    def at(self, t: Tensor) -> Tensor:
        """Point ``origin + t * direction`` (reference ``Ray.get``)."""
        return self.origin + t[..., None] * self.direction

    def map(self, fn) -> "Rays":
        return _map_fields(self, fn)


def _f32(x, device) -> Tensor:
    if isinstance(x, Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(x, dtype=torch.float32, device=device)


def make_rays(origin, direction, length, epsilon, device=None) -> Rays:
    """Broadcast the four fields into one ray batch on ``device``; without
    one, on the device of the first field that is a tensor, or on the GPU
    when none is."""
    if device is None:
        device = next((x.device for x in (origin, direction, length, epsilon)
                       if isinstance(x, Tensor)), "cuda")
    origin = _f32(origin, device)
    direction = _f32(direction, device)
    batch = torch.broadcast_shapes(origin.shape[:-1], direction.shape[:-1])
    return Rays(
        origin=origin.expand(batch + (3,)).contiguous(),
        direction=direction.expand(batch + (3,)).contiguous(),
        length=_f32(length, device).expand(batch).contiguous(),
        epsilon=_f32(epsilon, device).expand(batch).contiguous(),
    )


@dataclasses.dataclass
class MarchResult:
    """Result of sphere-tracing a batch of rays (reference
    ``SdfFormTraceResult``): ``hit`` mask, travel ``t`` (finite on misses),
    final SDF ``distance`` and per-lane ``steps`` (march evaluations)."""

    hit: Tensor        # [...] bool
    t: Tensor          # [...] float32
    distance: Tensor   # [...] float32
    steps: Tensor      # [...] int32

    def map(self, fn) -> "MarchResult":
        return _map_fields(self, fn)


@dataclasses.dataclass
class SurfaceHit:
    """Shading-ready hit info (reference ``SdfObjectTraceResult``):
    backed-off position, unit normal, albedo, winning material (-1 on miss)."""

    hit: Tensor        # [...] bool
    position: Tensor   # [..., 3]
    normal: Tensor     # [..., 3]
    color: Tensor      # [..., 3]
    material: Tensor   # [...] int32
    t: Tensor          # [...] float32


def dot(a: Tensor, b: Tensor) -> Tensor:
    """Batched 3-vector dot product over the trailing axis."""
    return torch.sum(a * b, dim=-1)


def norm(v: Tensor, eps: float = 1e-20) -> Tensor:
    """Safe Euclidean norm over the trailing axis (grad-safe at 0)."""
    return torch.sqrt(torch.sum(v * v, dim=-1) + eps)


def normalize(v: Tensor, eps: float = 1e-20) -> Tensor:
    """Unit vector over the trailing axis (grad-safe at 0)."""
    return v / norm(v, eps)[..., None]


def cross(a: Tensor, b: Tensor) -> Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)
