"""Tone mapping: auto-exposure → gamma → dithered 8-bit quantization.

Counterpart of ``fraytracer_tpu.ops.tonemap`` (reference ``Image.toColors``,
Image.fs:37-50, and ``FColor.fs:43-55``).  The dither is uniform noise in
[0, 1) from a ``torch.Generator``, or an explicit ``dither`` tensor so that
tests can feed the JAX and PyTorch versions the same noise.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def auto_exposure_scale(image: Tensor) -> Tensor:
    """Global max channel clamped ≥ 0.01 (Image.fs:40-43)."""
    return torch.clamp_min(torch.amax(image), 0.01)


def tone_curve(image: Tensor, gamma: float = 2.2,
               max_value: Tensor | None = None) -> Tensor:
    """Exposure + gamma, before quantization: ``(image / max)^(1/γ)``."""
    if max_value is None:
        max_value = auto_exposure_scale(image)
    normalized = image / max_value
    return torch.pow(torch.clamp_min(normalized, 0.0),
                     torch.tensor(1.0 / gamma, dtype=torch.float32))


def tonemap(image: Tensor, generator: torch.Generator | None = None,
            gamma: float = 2.2, max_value: Tensor | None = None,
            dither: Tensor | None = None) -> Tensor:
    """Linear RGB ``[..., 3]`` → dithered uint8 ``[..., 3]``.

    ``max_value`` lets a caller pass a global max (multi-device renders);
    defaults to this image's own max.  ``dither`` (same shape as ``image``,
    values in [0, 1)) overrides the generator's noise."""
    mapped = tone_curve(image, gamma, max_value)
    if dither is None:
        dither = torch.rand(image.shape, generator=generator,
                            dtype=torch.float32, device=image.device)
    q = torch.floor(mapped * 254.5 + dither + 0.5)
    return torch.clamp(q, 0, 255).to(torch.uint8)
