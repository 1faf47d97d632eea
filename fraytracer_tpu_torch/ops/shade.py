"""Lambert + hard-shadow integrator over batched hits.

Counterpart of ``fraytracer_tpu.ops.shade`` (reference ``SdfScene.trace``,
SdfScene.fs:7-28, and ``SdfLight.fs``):

* miss → background color,
* hit  → ``albedo · (background + Σ_lights 1[facing ∧ unoccluded] · I · cosθ)
  / π`` — background doubles as the ambient term,
* directional light: unoccluded intensity = color, shadow budget
  ``shadow_length``; point light: color / dist², budget = distance.

Each light costs one occlusion march over the whole batch.  The JAX
``lax.cond`` tiers of :func:`resolve_material` are Python branches on a
count read from the device; each such read is a host sync.
"""
from __future__ import annotations

import math

import torch

from ..scene.flatten import FlatScene
from ..scene.nodes import LIGHT_DIRECTIONAL, LIGHT_POINT
from ..types import Rays, SurfaceHit, dot
from . import sdf
from .march import (MarchConfig, check_config, chunked, march_occlusion,
                    march_surface)

Tensor = torch.Tensor

BCAP_MAX = 16     # bad (8, 128) blocks repaired by the block tier
CAP_MAX = 4096    # bad lanes repaired by the lane tier


@torch.no_grad()
def resolve_material(scene: FlatScene, pos: Tensor, hit: Tensor,
                     midx: Tensor, backend: str = "torch") -> Tensor:
    """Repair ``midx == -1`` on *hit* lanes of the fused surface pass with
    the global argmin over visible material primitives (reference
    ``SdfObject.fs:26-46``).

    Tiers: none (free); on the "cuda" backend, bad lanes in ≤ 16 blocks of
    1024 lanes → gather those blocks with the K4 block gather and
    dense-evaluate them; then ≤ 4096 bad lanes → lane gather; else the full
    dense sweep."""
    from .cuda.gather import BLOCK, flat_block_gather
    bad = hit & (midx < 0)
    flatpos = pos.detach().reshape(-1, 3)
    flatbad = bad.reshape(-1)
    flatm = midx.reshape(-1)
    n = flatpos.shape[0]
    cap = min(CAP_MAX, n)

    def lane_tiers() -> Tensor:
        nbad = int(flatbad.sum())                      # host sync
        if nbad == 0:
            return flatm
        if nbad <= cap:
            _v, idx = torch.topk(flatbad.to(torch.int32), cap)
            m = chunked(sdf.material_index_at, scene, flatpos[idx])
            out = flatm.clone()
            out[idx] = torch.where(flatbad[idx], m, flatm[idx])
            return out
        m = chunked(sdf.material_index_at, scene, flatpos)
        return torch.where(flatbad, m, flatm)

    if backend == "cuda" and n % BLOCK == 0 and n // BLOCK > 1:
        nb = n // BLOCK
        bcap = min(BCAP_MAX, nb)
        anyb = torch.any(flatbad.reshape(nb, BLOCK), dim=1)
        nbb = int(anyb.sum())                          # host sync
        if nbb == 0:
            out = flatm
        elif nbb <= bcap:
            _v, bidx = torch.topk(anyb.to(torch.int32), bcap)
            bidx = bidx.to(torch.int32)
            pts = flat_block_gather(flatpos.contiguous(), bidx, bcap)
            m = chunked(sdf.material_index_at, scene, pts).reshape(bcap,
                                                                  BLOCK)
            cur = flatm.reshape(nb, BLOCK)
            rows = bidx.long()
            new = torch.where(flatbad.reshape(nb, BLOCK)[rows], m, cur[rows])
            out = cur.clone()
            out[rows] = new
            out = out.reshape(-1)
        else:
            out = lane_tiers()
    else:
        out = lane_tiers()
    return out.reshape(midx.shape)


def surface_hit(scene: FlatScene, rays: Rays,
                cfg: MarchConfig = MarchConfig()) -> SurfaceHit:
    """March + shading-ready hit info (reference ``SdfObject.tryTrace``):
    position backed off by epsilon, unit normal there, and the winning
    material's albedo."""
    check_config(cfg)
    res, normal, midx = march_surface(scene, rays, cfg)
    pos = rays.at(res.t - rays.epsilon)
    if cfg.backend == "cuda" and cfg.fuse_surface:
        midx = resolve_material(scene, pos, res.hit, midx,
                                backend=cfg.backend)
    albedo = sdf.albedo_of(scene, torch.clamp_min(midx, 0), pos)
    return SurfaceHit(hit=res.hit, position=pos, normal=normal,
                      color=albedo, material=midx, t=res.t)


def light_dir_and_dist(scene: FlatScene, i: int, pos: Tensor):
    """Unit direction from ``pos`` toward light ``i`` and the shadow budget.
    Returns (dir [..., 3], budget [...], intensity_scale [...])."""
    kind = scene.light_kind[i]
    vec = scene.light_vec[i]
    if kind == LIGHT_DIRECTIONAL:
        d = -vec / torch.sqrt(torch.clamp_min(torch.sum(vec * vec), 1e-20))
        ldir = d.expand(pos.shape).contiguous()
        budget = scene.light_shadow_len[i].expand(pos.shape[:-1]).contiguous()
        scale = torch.ones(pos.shape[:-1], dtype=torch.float32,
                           device=pos.device)
        return ldir, budget, scale
    if kind == LIGHT_POINT:
        diff = vec - pos
        dist2 = torch.clamp_min(dot(diff, diff), 1e-12)
        dist = torch.sqrt(dist2)
        return diff / dist[..., None], dist, 1.0 / dist2
    raise ValueError(f"bad light kind {kind}")


def shade_with_stats(scene: FlatScene, rays: Rays, hit: SurfaceHit,
                     cfg: MarchConfig = MarchConfig()):
    """Shade surface hits → ``(linear RGB [..., 3], n_shadow)``, where
    ``n_shadow`` (int64 scalar tensor) counts the shadow rays marched
    (facing lanes per light)."""
    light_acc = scene.background.expand(hit.position.shape)
    n_shadow = torch.zeros((), dtype=torch.int64, device=hit.position.device)
    for i in range(scene.num_lights):
        ldir, budget, scale = light_dir_and_dist(scene, i, hit.position)
        cos = dot(hit.normal, ldir)
        facing = hit.hit & (cos > 0.0)
        shadow_rays = Rays(origin=hit.position, direction=ldir,
                           # zero budget de-activates non-facing lanes
                           length=torch.where(facing, budget, 0.0),
                           epsilon=rays.epsilon)
        # the point light's apex and the axial key only steer the culled
        # kernel (not ported yet); they are passed for the same call shape
        if scene.light_kind[i] == LIGHT_POINT:
            apex, akey = scene.light_vec[i].detach(), budget
        else:
            apex, akey = None, dot(hit.position, ldir)
        occluded = march_occlusion(scene, shadow_rays, cfg, cone_apex=apex,
                                   axial_key=akey)
        n_shadow = n_shadow + facing.sum()
        contrib = scene.light_color[i] * scale[..., None] * cos[..., None]
        light_acc = light_acc + torch.where(
            (facing & ~occluded)[..., None], contrib, 0.0)

    lit = hit.color * light_acc * (1.0 / math.pi)
    # emission (zero for plain solids)
    emission = torch.where(hit.material[..., None] >= 0,
                           scene.mat_emission[torch.clamp_min(
                               hit.material, 0).long()], 0.0)
    shaded = lit + emission
    return torch.where(hit.hit[..., None], shaded, scene.background), n_shadow


def shade(scene: FlatScene, rays: Rays, hit: SurfaceHit,
          cfg: MarchConfig = MarchConfig()) -> Tensor:
    """Shade a batch of surface hits → linear RGB ``[..., 3]``."""
    return shade_with_stats(scene, rays, hit, cfg)[0]


@torch.no_grad()
def trace(scene: FlatScene, rays: Rays,
          cfg: MarchConfig = MarchConfig()) -> Tensor:
    """Full primary trace: march → surface info → shade (reference
    ``SdfScene.trace``)."""
    hit = surface_hit(scene, rays, cfg)
    return shade(scene, rays, hit, cfg)


@torch.no_grad()
def trace_with_stats(scene: FlatScene, rays: Rays,
                     cfg: MarchConfig = MarchConfig()):
    """``trace`` + the total rays marched (primary + shadow) as an int64
    scalar tensor.  Returns ``(color [..., 3], n_rays)``."""
    hit = surface_hit(scene, rays, cfg)
    color, n_shadow = shade_with_stats(scene, rays, hit, cfg)
    return color, n_shadow + hit.hit.numel()
