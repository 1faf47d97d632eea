"""Spectral ray optics: wavelength bins, dispersive IOR, Fresnel equations
(counterpart of ``fraytracer_tpu.ops.spectral``).

The reference's stated spectral capability (``README.md:7``: a ray test
carries a wavelength and produces an intensity, e.g. optical dispersion;
the Fresnel equations and visible bands of ``Light.fs:12-59``, the
refraction-index catalogue ``Materials.fs:6-60``): 8 wavelength bins with
dispersive glass.  Everything is batched over rays; a ray carries its
wavelength as an int bin index into the static tables below.

The tables are numpy, computed as the JAX package computes them, so they
match it bit for bit; a function takes them on its inputs' device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..types import dot
from . import deferred

Tensor = torch.Tensor

# 8 visible-spectrum bins, centers in micrometres, violet → red (the
# reference's THz bands, Light.fs:19-26: 380 nm … 750 nm)
NUM_BINS = 8
WAVELENGTHS_UM = np.linspace(0.40, 0.70, NUM_BINS).astype(np.float32)


def _bin_rgb_table() -> np.ndarray:
    """Per-bin linear-RGB response, a coarse CIE-style fit: each row is the
    RGB color of monochromatic light at that bin center, the columns
    scaled to sum to 1 — an equal-energy spectrum reconstructs white."""
    lam = WAVELENGTHS_UM * 1000.0  # nm

    def g(x, mu, s1, s2):
        s = np.where(x < mu, s1, s2)
        return np.exp(-0.5 * ((x - mu) / s) ** 2)

    # Gaussian-lobe fit of CIE-1931-like RGB primaries
    r = 1.056 * g(lam, 599.8, 37.9, 31.0) + 0.362 * g(lam, 442.0, 16.0, 26.7) \
        - 0.065 * g(lam, 501.1, 20.4, 26.2)
    gch = 0.821 * g(lam, 568.8, 46.9, 40.5) + 0.286 * g(lam, 530.9, 16.3, 31.1)
    b = 1.217 * g(lam, 437.0, 11.8, 36.0) + 0.681 * g(lam, 459.0, 26.0, 13.8)
    rgb = np.stack([r, gch, b], axis=-1)
    rgb = np.maximum(rgb, 0.0)
    rgb /= np.maximum(rgb.sum(axis=0, keepdims=True), 1e-6)  # columns sum→1
    return rgb.astype(np.float32)


BIN_RGB = _bin_rgb_table()  # [NUM_BINS, 3]

_TABLES = {"bin_rgb": BIN_RGB, "wavelengths_um": WAVELENGTHS_UM,
           # the summed bin weights of the wavefront's shared primary round
           "bin_rgb_sum": BIN_RGB.sum(axis=0)}


@deferred.device_constant(maxsize=8)
def table(name: str, device: torch.device) -> Tensor:
    """The numpy table ``name`` on ``device``, copied there once per device:
    a copy from host memory waits for the device's queue to drain (and a
    captured frame reads it by address: ``deferred.device_constant``)."""
    return torch.from_numpy(_TABLES[name]).to(device)


def bin_rgb(wl: Tensor) -> Tensor:
    """RGB filter of wavelength-bin indices ``wl [...]`` → ``[..., 3]``."""
    return table("bin_rgb", wl.device)[wl.long()]


def cauchy_ior(ior_ab: Tensor, wl: Tensor) -> Tensor:
    """Dispersive refractive index n(λ) = A + B/λ² (λ in µm):
    ``ior_ab [..., 2]`` per-material Cauchy coefficients, ``wl [...]`` bin
    indices."""
    lam = table("wavelengths_um", wl.device)[wl.long()]
    return ior_ab[..., 0] + ior_ab[..., 1] / (lam * lam)


def fresnel(direction: Tensor, normal: Tensor, n1: Tensor, n2: Tensor):
    """Fresnel reflectance + reflected/refracted directions (batched): the
    s/p-polarized reflectance averaged, mirror reflection ``d - 2(d·n)n``,
    Snell refraction, total internal reflection handled (reflectance 1,
    refracted direction unused) — ``Light.fresnel``, Light.fs:28-59.

    ``direction [..., 3]`` unit incident (pointing into the surface),
    ``normal [..., 3]`` unit, oriented against the ray (``d·n < 0``),
    ``n1`` / ``n2 [...]`` the incident / transmit media indices.  Returns
    ``(R [...], reflect_dir [..., 3], refract_dir [..., 3], tir [...])``."""
    cosi = torch.clamp(-dot(direction, normal), 1e-6, 1.0)
    eta = n1 / n2
    sin2t = eta * eta * torch.clamp_min(1.0 - cosi * cosi, 0.0)
    tir = sin2t > 1.0
    cost = torch.sqrt(torch.clamp_min(1.0 - sin2t, 0.0))

    rs = ((n1 * cosi - n2 * cost) / (n1 * cosi + n2 * cost + 1e-12)) ** 2
    rp = ((n2 * cosi - n1 * cost) / (n2 * cosi + n1 * cost + 1e-12)) ** 2
    R = torch.where(tir, 1.0, 0.5 * (rs + rp))

    reflect_dir = direction + 2.0 * cosi[..., None] * normal
    refract_dir = (eta[..., None] * direction
                   + (eta * cosi - cost)[..., None] * normal)
    return R, reflect_dir, refract_dir, tir


def schlick(direction: Tensor, normal: Tensor, n1: Tensor,
            n2: Tensor) -> Tensor:
    """Schlick's approximation of the Fresnel reflectance (the reference's
    own TODO, Light.fs:61-62)."""
    cosi = torch.clamp(-dot(direction, normal), 0.0, 1.0)
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cosi) ** 5
