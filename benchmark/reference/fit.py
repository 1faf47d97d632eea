"""The plain fit: the full frame, its mean squared error against a target,
the gradient of every floating leaf, and SGD.

The gradient is the configuration's: the march is not differentiated; at
a hit ``x0 = o + t·d`` the hit distance follows the surface by implicit
differentiation, ``t(θ) = t − (f(x0; θ) − f(x0))/den`` with ``den = ∇ₓf·d``
held off zero at ``min_denom`` (its sign kept), ``f`` the winning leaf at
the backed-off point; the shading point ``o + (t(θ) − ε)·d``, its unit
normal (a second-order term), the point light's direction and falloff,
the albedo, the emission, the lights and the background carry the rest.
Shadows are hard: a boolean that carries no gradient.
"""
from __future__ import annotations

import math

import torch

from . import render as R

# hit lanes a differentiable chunk takes
LANES = 1 << 18


@torch.no_grad()
def frame(lv: dict, kinds, cam: dict, cfg: dict, march_cfg: dict):
    """The full frame, row-major: ``(colour [H·W, 3], residuals)``; the
    residuals (rays, hits, winners, shadows) feed :func:`loss_and_grads`."""
    w, h = int(cfg["width"]), int(cfg["height"])
    dev, dt = lv["background"].device, lv["background"].dtype
    eps, length = float(cfg["epsilon"]), float(cfg["length"])
    o, d = R.camera_rays(cam, w, h, torch.arange(w * h, device=dev), dev, dt)
    t, hit = R.march(lv, o, d, torch.full((w * h,), length, dtype=dt,
                                          device=dev), eps, march_cfg)
    col = lv["background"].expand(w * h, 3).clone()
    idx = torch.nonzero(hit).squeeze(1)
    res = dict(o=o, d=d, t=t, idx=idx)
    if idx.numel():
        pos = o[idx] + (t[idx] - eps)[:, None] * d[idx]
        _f, kind, ui = R.scene_eval(lv, pos)
        normal = R.leaf_normal(lv, kind, ui, pos)
        shadows = R.occlusion(lv, kinds, pos, normal, eps, march_cfg)
        light = R.direct_light(lv, kinds, pos, normal, shadows)
        col[idx] = (lv["mat_albedo"][ui] * light / math.pi
                    + lv["mat_emission"][ui])
        res.update(kind=kind, ui=ui, shadows=shadows)
    return col, res


def _guarded(den, min_denom):
    den = torch.sign(den) * torch.clamp_min(den.abs(), min_denom)
    return torch.where(den == 0.0, min_denom, den)


def loss_and_grads(lv: dict, kinds, cam: dict, cfg: dict, march_cfg: dict,
                   target):
    """``(loss, grads)``: the mean over pixels and channels of
    ``(frame − target)²`` and its gradient for every leaf of ``lv``
    (zeros where the loss does not reach)."""
    col, res = frame(lv, kinds, cam, cfg, march_cfg)
    eps = float(cfg["epsilon"])
    scale = 1.0 / target.numel()
    leaves = {k: v.detach().requires_grad_(True) for k, v in lv.items()}
    grads = {k: torch.zeros_like(v) for k, v in lv.items()}

    def add(part):
        gs = torch.autograd.grad(part, list(leaves.values()),
                                 allow_unused=True)
        for k, g in zip(leaves, gs):
            if g is not None:
                grads[k] += g

    idx = res["idx"]
    miss = torch.ones(col.shape[0], dtype=torch.bool, device=col.device)
    miss[idx] = False
    with torch.enable_grad():
        add(scale * torch.sum((leaves["background"] - target[miss]) ** 2))
        for lo in range(0, idx.numel(), LANES):
            j = idx[lo:lo + LANES]
            sl = slice(lo, lo + LANES)
            o, d, t = res["o"][j], res["d"][j], res["t"][j]
            kind, ui = res["kind"][sl], res["ui"][sl]
            x0 = o + t[:, None] * d
            f0 = R.leaf_distance(leaves, kind, ui, x0)
            q = x0.detach().requires_grad_(True)
            (gx,) = torch.autograd.grad(R.leaf_distance(
                {k: v.detach() for k, v in leaves.items()}, kind, ui,
                q).sum(), q)
            den = _guarded(torch.sum(gx * d, -1),
                           float(march_cfg["min_denom"]))
            t_th = t - (f0 - f0.detach()) / den
            pos = o + (t_th - eps)[:, None] * d
            normal = R.leaf_normal(leaves, kind, ui, pos, create_graph=True)
            shadows = [(f[sl], oc[sl]) for f, oc in res["shadows"]]
            light = R.direct_light(leaves, kinds, pos, normal, shadows)
            c = (leaves["mat_albedo"][ui] * light / math.pi
                 + leaves["mat_emission"][ui])
            add(scale * torch.sum((c - target[j]) ** 2))
    loss = torch.mean((col - target) ** 2)
    return loss, grads


def fit(lv: dict, kinds, cam: dict, cfg: dict, march_cfg: dict, target,
        lr: float, steps: int):
    """``steps`` SGD steps on every leaf from ``lv``: the losses, the first
    gradients, and the leaves after each step (``states[0]`` is ``lv``)."""
    states, losses, first = [dict(lv)], [], None
    for _ in range(steps):
        loss, g = loss_and_grads(states[-1], kinds, cam, cfg, march_cfg,
                                 target)
        losses.append(float(loss))
        first = g if first is None else first
        states.append({k: v - lr * g[k] for k, v in states[-1].items()})
    return losses, first, states
