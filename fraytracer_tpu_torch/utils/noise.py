"""Procedural noise: Catmull-Rom splines, value noise, gradient noise, fbm.

Counterpart of ``fraytracer_tpu.utils.noise`` (reference ``Spline.fs:13-30``
Catmull-Rom interpolation; ``Noise.fs:7-113`` permutation-table
value/gradient noise): the backing of the procedural materials
(``ops.sdf.albedo_of``).  All functions are shape-polymorphic
over ``p [..., 3]``, run on ``p``'s device and are differentiable.
"""
from __future__ import annotations


import numpy as np
import torch

from ..ops import deferred

Tensor = torch.Tensor

_TABLE_SIZE = 256


def _permutation(seed: int) -> np.ndarray:
    """Doubled permutation table (reference Noise.fs:7-26)."""
    rng = np.random.default_rng(seed)
    p = rng.permutation(_TABLE_SIZE)
    return np.concatenate([p, p]).astype(np.int64)


_PERM = _permutation(19)

# 12 edge-gradient directions
_DIRS = np.array([
    [1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0],
    [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
    [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1],
], np.float32)


def catmull_rom(p0: Tensor, p1: Tensor, p2: Tensor, p3: Tensor,
                t: Tensor) -> Tensor:
    """Catmull-Rom cubic interpolation (reference Spline.catmulRom1D,
    Spline.fs:13-30): interpolates between p1 (t=0) and p2 (t=1)."""
    t2 = t * t
    t3 = t2 * t
    return 0.5 * ((2.0 * p1)
                  + (-p0 + p2) * t
                  + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * t2
                  + (-p0 + 3.0 * p1 - 3.0 * p2 + p3) * t3)


def catmull_rom_1d(knots, t, device=None) -> Tensor:
    """Spline through a knot array sampled at t ∈ [0, n-1] (clamped; the
    knot indices clamp at both ends), on ``device``; without one, on the
    device of ``t`` when it is a tensor, else of ``knots`` when it is one,
    else on the GPU."""
    if device is None:
        device = next((x.device for x in (t, knots)
                       if isinstance(x, Tensor)), "cuda")
    knots = torch.as_tensor(knots, dtype=torch.float32, device=device)
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    n = knots.shape[0]
    t = torch.clamp(t, 0.0, n - 1.0)
    i = torch.clamp(torch.floor(t).to(torch.int64), 0, n - 2)
    f = t - i

    def at(j):
        return knots[torch.clamp(j, 0, n - 1)]

    return catmull_rom(at(i - 1), at(i), at(i + 1), at(i + 2), f)


@deferred.device_constant(maxsize=8)
def _tables(device: str):
    """The permutation table and gradient directions on ``device`` (a
    captured frame keeps what it reads)."""
    return (torch.as_tensor(_PERM, device=device),
            torch.as_tensor(_DIRS, device=device))


def _hash3(ix: Tensor, iy: Tensor, iz: Tensor) -> Tensor:
    """Lattice hash via the permutation table (Noise.fs lattice lookup)."""
    perm, _dirs = _tables(str(ix.device))
    m = _TABLE_SIZE - 1
    return perm[perm[perm[ix & m] + (iy & m)] + (iz & m)]


def _smoothstep(t: Tensor) -> Tensor:
    """Quintic fade (C2-continuous)."""
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _lattice(p: Tensor):
    """Integer cell (ix, iy, iz), in-cell offset ``pf`` and fade weights."""
    pi = torch.floor(p)
    pf = p - pi
    cell = pi.detach().to(torch.int64)
    return cell[..., 0], cell[..., 1], cell[..., 2], pf, _smoothstep(pf)


def _lerp(a, b, t):
    return a + (b - a) * t


def _trilerp(corner, w: Tensor) -> Tensor:
    """Blend the eight ``corner(dx, dy, dz)`` values by the weights ``w``."""
    x00 = _lerp(corner(0, 0, 0), corner(1, 0, 0), w[..., 0])
    x10 = _lerp(corner(0, 1, 0), corner(1, 1, 0), w[..., 0])
    x01 = _lerp(corner(0, 0, 1), corner(1, 0, 1), w[..., 0])
    x11 = _lerp(corner(0, 1, 1), corner(1, 1, 1), w[..., 0])
    y0 = _lerp(x00, x10, w[..., 1])
    y1 = _lerp(x01, x11, w[..., 1])
    return _lerp(y0, y1, w[..., 2])


def value_noise(p: Tensor) -> Tensor:
    """Lattice value noise in [-1, 1] (reference Noise.fs:38-53, with
    smooth interpolation instead of its Catmull-Rom column scheme)."""
    ix, iy, iz, _pf, w = _lattice(p)

    def corner(dx, dy, dz):
        h = _hash3(ix + dx, iy + dy, iz + dz)
        return h.to(torch.float32) / (_TABLE_SIZE - 1) * 2.0 - 1.0

    return _trilerp(corner, w)


def gradient_noise(p: Tensor) -> Tensor:
    """Perlin-style gradient noise in ~[-1, 1] (reference Noise.fs:72-110)."""
    ix, iy, iz, pf, w = _lattice(p)
    _perm, dirs = _tables(str(p.device))

    def corner(dx, dy, dz):
        g = dirs[_hash3(ix + dx, iy + dy, iz + dz) % 12]
        off = torch.stack((pf[..., 0] - dx, pf[..., 1] - dy,
                           pf[..., 2] - dz), -1)
        return torch.sum(g * off, dim=-1)

    return _trilerp(corner, w)


def fbm(p: Tensor, octaves: int = 4, lacunarity: float = 2.0,
        gain: float = 0.5, noise=gradient_noise) -> Tensor:
    """Fractional Brownian motion over any base noise."""
    total = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    amp, freq, norm = 1.0, 1.0, 0.0
    for _ in range(octaves):
        total = total + amp * noise(p * freq)
        norm += amp
        amp *= gain
        freq *= lacunarity
    return total / norm
