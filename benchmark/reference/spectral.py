"""The plain spectral frame: the wavefront integrator of the configuration,
followed ray by ray for a sample of pixels.

Round 0 marches one primary ray a pixel, shared by the wavelength bins,
and adds the diffuse or background term with the summed bin weight.
Every mirror or glass hit then spawns one path a bin (throughput 1/B)
whose Fresnel children (reflection along the facing normal, refraction
through it, each from the true surface point offset by 3 epsilon) march
in rounds 1 … depth − 1; lanes inside glass march the negated distance.
A lane adds ``throughput · bin RGB · B`` times the background on a miss,
or times the Lambert term and the diffuse weight (solid 1, mirror 1 − ρ,
glass 0) on a hit; the last round spawns nothing.  Children under
``min_throughput`` die.  Paths are kept whole: nothing is dropped for
want of room, so a program that drops energy reads as different.

The bins' RGB response and wavelengths are a frozen copy of the port's
tables (a Gaussian-lobe fit of CIE-like primaries, columns summing to 1).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import render as R

MIRROR, DIELECTRIC, SOLID = 1, 2, 0


def bin_tables(num_bins: int):
    """``(bin RGB [B, 3], wavelengths µm [B])``, float32 as the port's."""
    wl = np.linspace(0.40, 0.70, num_bins).astype(np.float32)
    lam = wl * 1000.0

    def g(x, mu, s1, s2):
        s = np.where(x < mu, s1, s2)
        return np.exp(-0.5 * ((x - mu) / s) ** 2)

    r = 1.056 * g(lam, 599.8, 37.9, 31.0) + 0.362 * g(lam, 442.0, 16.0, 26.7) \
        - 0.065 * g(lam, 501.1, 20.4, 26.2)
    gc = 0.821 * g(lam, 568.8, 46.9, 40.5) + 0.286 * g(lam, 530.9, 16.3, 31.1)
    b = 1.217 * g(lam, 437.0, 11.8, 36.0) + 0.681 * g(lam, 459.0, 26.0, 13.8)
    rgb = np.maximum(np.stack([r, gc, b], axis=-1), 0.0)
    rgb /= np.maximum(rgb.sum(axis=0, keepdims=True), 1e-6)
    return rgb.astype(np.float32), wl


def _dot(a, b):
    return torch.sum(a * b, -1)


def fresnel(d, n, n1, n2):
    """Averaged s/p reflectance, mirror and Snell directions, total
    internal reflection (reflectance 1)."""
    cosi = torch.clamp(-_dot(d, n), 1e-6, 1.0)
    eta = n1 / n2
    sin2t = eta * eta * torch.clamp_min(1.0 - cosi * cosi, 0.0)
    tir = sin2t > 1.0
    cost = torch.sqrt(torch.clamp_min(1.0 - sin2t, 0.0))
    rs = ((n1 * cosi - n2 * cost) / (n1 * cosi + n2 * cost + 1e-12)) ** 2
    rp = ((n2 * cosi - n1 * cost) / (n2 * cosi + n1 * cost + 1e-12)) ** 2
    refl = torch.where(tir, 1.0, 0.5 * (rs + rp))
    return (refl, d + 2.0 * cosi[:, None] * n,
            eta[:, None] * d + (eta * cosi - cost)[:, None] * n, tir)


class _Lanes:
    """Paths in flight: origin, direction, sampled-pixel slot, bin,
    throughput, remaining budget, inside glass."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def take(self, idx):
        return _Lanes(**{k: v[idx] for k, v in self.__dict__.items()})

    @staticmethod
    def cat(a, b):
        return _Lanes(**{k: torch.cat([v, getattr(b, k)])
                         for k, v in a.__dict__.items()})


@torch.no_grad()
def _hits(lv, kinds, mat, lanes, eps, march_cfg, sign=None):
    """March ``lanes`` and work out, at each hit, the surface terms:
    ``(t, hit, normal, nearest torus, Lambert term)``; the Lambert term
    (with its shadow marches) only where the material has a diffuse
    weight."""
    t, hit = R.march(lv, lanes.o, lanes.d, lanes.length, eps, march_cfg,
                     sign=sign)
    n = t.shape[0]
    dt = lanes.o.dtype
    normal = torch.zeros((n, 3), dtype=dt, device=t.device)
    ui = torch.zeros(n, dtype=torch.long, device=t.device)
    lam = torch.zeros((n, 3), dtype=dt, device=t.device)
    idx = torch.nonzero(hit).squeeze(1)
    if idx.numel():
        pos = lanes.o[idx] + (t[idx] - eps)[:, None] * lanes.d[idx]
        _f, kind, u = R.scene_eval(lv, pos)
        nrm = R.leaf_normal(lv, kind, u, pos)
        normal[idx], ui[idx] = nrm, u
        diffuse = mat["kind"][u] != DIELECTRIC
        j = torch.nonzero(diffuse).squeeze(1)
        if j.numel():
            shadows = R.occlusion(lv, kinds, pos[j], nrm[j], eps, march_cfg)
            light = R.direct_light(lv, kinds, pos[j], nrm[j], shadows)
            lam[idx[j]] = (lv["mat_albedo"][u[j]] * light / math.pi
                           + lv["mat_emission"][u[j]])
    return t, hit, normal, ui, lam


def _diffuse_w(mat, ui):
    k = mat["kind"][ui]
    return torch.where(k == SOLID, 1.0, torch.where(
        k == MIRROR, 1.0 - mat["reflectivity"][ui], 0.0))


def _children(mat, lanes, t, hit, normal, ui, bins, eps, min_t):
    """The Fresnel children of the mirror and glass hits of ``lanes``
    (only the live ones)."""
    rgb, wl_um = bins
    d = lanes.d
    face = torch.where((_dot(normal, d) > 0.0)[:, None], -normal, normal)
    kind = mat["kind"][ui]
    is_m, is_g = kind == MIRROR, kind == DIELECTRIC
    lam = wl_um[lanes.wl]
    ior = mat["ior"][ui, 0] + mat["ior"][ui, 1] / (lam * lam)
    n1 = torch.where(lanes.inside, ior, 1.0)
    n2 = torch.where(lanes.inside, 1.0, ior)
    refl, rdir, tdir, tir = fresnel(d, face, n1, n2)
    surf = lanes.o + t[:, None] * d
    rem = torch.clamp_min(lanes.length - t, 0.0)
    a_t = lanes.T * torch.where(is_m, mat["reflectivity"][ui],
                                torch.where(is_g, refl, 0.0))
    filt = rgb[lanes.wl]
    tint = torch.sum(filt * mat["tint"][ui], -1) / torch.clamp_min(
        torch.sum(filt, -1), 1e-6)
    b_t = lanes.T * torch.where(is_g, (1.0 - refl) * tint, 0.0)
    a_live = hit & (is_m | is_g) & (a_t > min_t)
    b_live = hit & is_g & ~tir & (b_t > min_t)
    a = _Lanes(o=surf + 3.0 * eps * face, d=rdir, pix=lanes.pix, wl=lanes.wl,
               T=a_t, length=rem, inside=lanes.inside)
    b = _Lanes(o=surf - 3.0 * eps * face, d=R._unit(tdir), pix=lanes.pix,
               wl=lanes.wl, T=b_t, length=rem, inside=~lanes.inside)
    return _Lanes.cat(a.take(torch.nonzero(a_live).squeeze(1)),
                      b.take(torch.nonzero(b_live).squeeze(1)))


@torch.no_grad()
def spectral_pixels(arrays, cam: dict, width: int, height: int, pixels,
                    wcfg: dict, march_cfg: dict, device, dtype):
    """Linear RGB ``[len(pixels), 3]`` of the spectral frame at
    ``pixels`` (row-major indices), in ``dtype``, and where the primary
    ray hit."""
    lv = R.leaves_of(arrays, device, dtype)
    kinds = arrays.light_kind
    mat = {"kind": torch.as_tensor(arrays.mat_kind, device=device),
           "reflectivity": lv["mat_reflectivity"], "ior": lv["mat_ior"],
           "tint": lv["mat_tint"]}
    nb = int(wcfg["num_bins"])
    rgb_np, wl_np = bin_tables(nb)
    bins = (torch.as_tensor(rgb_np, dtype=dtype, device=device),
            torch.as_tensor(wl_np, dtype=dtype, device=device))
    eps, length = float(wcfg["epsilon"]), float(wcfg["length"])
    min_t = float(wcfg["min_throughput"])
    o, d = R.camera_rays(cam, width, height, pixels, device, dtype)
    n = o.shape[0]
    slot = torch.arange(n, device=device)
    lanes = _Lanes(o=o, d=d, pix=slot, wl=torch.zeros_like(slot),
                   T=torch.ones(n, dtype=dtype, device=device),
                   length=torch.full((n,), length, dtype=dtype,
                                     device=device),
                   inside=torch.zeros(n, dtype=torch.bool, device=device))
    t, hit, normal, ui, lam = _hits(lv, kinds, mat, lanes, eps, march_cfg)
    w0 = bins[0].sum(0)
    bg = lv["background"]
    image = torch.where(hit[:, None], w0 * lam * _diffuse_w(mat, ui)[:, None],
                        w0 * bg)
    primary = hit
    if int(wcfg["depth"]) <= 1 or not bool(
            (mat["kind"] != SOLID).any()):
        return image, primary
    # one path a bin of each specular hit
    rep = torch.arange(n, device=device).repeat_interleave(nb)
    per_bin = lanes.take(rep)
    per_bin.wl = torch.arange(nb, device=device).repeat(n)
    per_bin.T = torch.full((n * nb,), 1.0 / nb, dtype=dtype, device=device)
    q = _children(mat, per_bin, t[rep], hit[rep], normal[rep], ui[rep], bins,
                  eps, min_t)
    for rnd in range(1, int(wcfg["depth"])):
        if q.o.shape[0] == 0:
            break
        sign = torch.where(q.inside, -1.0, 1.0).to(dtype)
        t, hit, normal, ui, lam = _hits(lv, kinds, mat, q, eps, march_cfg,
                                        sign=sign)
        w = q.T[:, None] * bins[0][q.wl] * float(nb)
        contrib = torch.where(hit[:, None],
                              w * lam * _diffuse_w(mat, ui)[:, None], w * bg)
        image.index_add_(0, q.pix, contrib)
        if rnd == int(wcfg["depth"]) - 1:
            break
        q = _children(mat, q, t, hit, normal, ui, bins, eps, min_t)
    return image, primary
