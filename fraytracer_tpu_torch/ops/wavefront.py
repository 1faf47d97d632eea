"""Wavefront spectral path integrator: secondary rays as an iterative queue
(counterpart of ``fraytracer_tpu.ops.wavefront``).

The reference's "materials may create subsequent rays" design goal
(``README.md:10-12``; its only realized instance is the shadow-ray
recursion of ``SdfLight.fs:10-21``) as an iterative wavefront:

* a fixed-capacity flat ray buffer (structure of tensors) replaces
  recursion;
* each bounce round marches all queued rays in one masked march — the
  culled CUDA kernels on the "cuda" backend, inside-glass lanes with
  ``sign = -1`` — shades diffuse hits with next-event light sampling, and
  spawns Fresnel reflection / refraction children at mirror and dielectric
  hits;
* the children (up to 2 a ray) land in a double-width buffer that is
  compacted by throughput back to capacity with static shapes: whole
  1024-lane blocks gathered by the K4 block gather on the "cuda" backend,
  single lanes by a stable sort otherwise;
* per-ray wavelength bins drive dispersive refraction; contributions
  accumulate into the RGB image through the bins' response filters.

Host syncs of the eager frame: none beyond those of ``resolve_material``'s
tiers and of the culled marches' overflow check; the frame a CUDA graph
captures (``render_spectral_with_stats`` on the card) defers both to one
device flag.  Every round marches (and launches its kernels) even when its
queue is empty, and whether a scene has specular materials is read from
``scene.mat_kind``, not from the device.  The
integrator is forward only (it runs without autograd): the block gather
has no backward, as the JAX package's Pallas gather has none.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..camera import auto_block, camera_rays, from_blocks, to_blocks
from ..scene.flatten import FlatScene
from ..scene.nodes import LIGHT_POINT, MAT_DIELECTRIC, MAT_MIRROR, MAT_SOLID
from ..types import Rays, _map_fields, dot, normalize
from ..utils.profiling import span
from . import graph, sdf, spectral
from .cuda import gather
from .march import MarchConfig, march_occlusion, march_surface
from .shade import light_dir_and_dist, resolve_material

Tensor = torch.Tensor


@dataclasses.dataclass
class RayQueue:
    """Fixed-capacity wavefront ray buffer.  ``pixel`` indexes the flat
    image, ``wl`` is the wavelength bin, ``throughput`` the path weight for
    that bin, ``inside`` the medium (inside a dielectric); inactive lanes
    have ``active`` False and zero throughput and budget."""

    origin: Tensor      # [C, 3] float32
    direction: Tensor   # [C, 3] float32
    pixel: Tensor       # [C] int32
    wl: Tensor          # [C] int32 wavelength bin
    throughput: Tensor  # [C] float32
    length: Tensor      # [C] float32 remaining budget
    inside: Tensor      # [C] bool
    active: Tensor      # [C] bool

    def map(self, fn) -> "RayQueue":
        return _map_fields(self, fn)


@dataclasses.dataclass(frozen=True, eq=True)
class WavefrontConfig:
    """Static wavefront parameters (the JAX fields and defaults)."""

    depth: int = 4                  # bounce rounds
    num_bins: int = spectral.NUM_BINS
    epsilon: float = 0.01
    length: float = 30.0
    march: MarchConfig = MarchConfig()
    min_throughput: float = 1e-3    # kill paths below this weight
    # children below this weight are the first dropped when the queue
    # overflows (they still render when capacity allows)
    overflow_drop_threshold: float = 0.05
    # candidate-table rows of the bounce rounds' marches and of their
    # shadow marches: secondary rays diverge until a tile's cone becomes a
    # bounding ball and its candidate count approaches the group size, so
    # these tables are sized not to overflow (an overflow re-runs the call
    # with full tables)
    bounce_cull_m: int = 1024


def block_compact_key(klass: Tensor, block: int) -> Tensor:
    """Per-block sort key of block-granular compaction: ``klass [2C]`` in
    {0: active and meaningful, 1: active and low throughput, 2: dead};
    key = −Σ(2 − klass) over the block — the blocks carrying the most
    energy first, fully dead blocks last (a density key: ranking by the
    best lane would keep a block of one live lane ahead of a full one)."""
    w = 2 - klass.reshape(-1, block)
    return -torch.sum(w, dim=1)


def _compact(both: RayQueue, cap: int, cfg: WavefrontConfig) -> RayQueue:
    """``2·cap`` children → ``cap``: a stable three-class partition — active
    children with meaningful throughput in their original (pixel) order,
    so the queue stays spatially coherent for the culled tiles; then those
    below ``overflow_drop_threshold``; then the dead.  On overflow the
    lowest-energy tail is dropped.

    On the "cuda" backend with ``cap`` a whole number of 1024-lane blocks,
    the partition is taken over blocks (:func:`block_compact_key`) and each
    field is moved by the K4 block gather; a kept block may carry dead
    lanes, which march as no-ops.  Otherwise lanes are sorted."""
    low = both.active & (both.throughput < cfg.overflow_drop_threshold)
    klass = (~both.active).to(torch.int32) * 2 + low.to(torch.int32)
    if cfg.march.backend == "cuda" and cap % gather.BLOCK == 0:
        nb = cap // gather.BLOCK
        keep = torch.argsort(block_compact_key(klass, gather.BLOCK),
                             stable=True)[:nb].to(torch.int32)

        def move(x):
            if x.dtype == torch.bool:
                return gather.flat_block_gather(x.to(torch.int32), keep,
                                                nb).to(torch.bool)
            return gather.flat_block_gather(x, keep, nb)
        return both.map(move)
    keep = torch.argsort(klass, stable=True)[:cap]
    return both.map(lambda x: x[keep])


def _concat(a: RayQueue, b: RayQueue) -> RayQueue:
    return RayQueue(**{f.name: torch.cat([getattr(a, f.name),
                                          getattr(b, f.name)])
                       for f in dataclasses.fields(RayQueue)})


def _repeat(x: Tensor, b: int) -> Tensor:
    """Each row ``b`` times in a row (``jnp.repeat(x, b, axis=0)``): a
    broadcast and a reshape, no gather and no host sync."""
    return x.unsqueeze(1).expand((x.shape[0], b) + tuple(x.shape[1:])) \
        .reshape((x.shape[0] * b,) + tuple(x.shape[1:]))


@span("shade")
def _shade_local(scene: FlatScene, pos: Tensor, normal: Tensor,
                 eps: Tensor, cfg: WavefrontConfig):
    """Direct lighting at points (Lambert + hard shadows), RGB ``[..., 3]``,
    and the shadow rays marched (an int64 scalar tensor).  The math of
    ``ops.shade`` (SdfScene.fs:7-28) on any batch of points; as in the JAX
    package, a lane is marched and counted wherever its normal faces the
    light."""
    light_acc = scene.background.expand(pos.shape)
    n_shadow = torch.zeros((), dtype=torch.int64, device=pos.device)
    for i in range(scene.num_lights):
        ldir, budget, scale = light_dir_and_dist(scene, i, pos)
        cos = dot(normal, ldir)
        facing = cos > 0.0
        shadow = Rays(origin=pos, direction=ldir,
                      length=torch.where(facing, budget, 0.0), epsilon=eps)
        if scene.light_kind[i] == LIGHT_POINT:
            apex, akey = scene.light_vec[i].detach(), budget
        else:
            apex, akey = None, dot(pos, ldir)
        occluded = march_occlusion(scene, shadow, cfg.march, cone_apex=apex,
                                   axial_key=akey)
        n_shadow = n_shadow + facing.sum()
        contrib = scene.light_color[i] * scale[..., None] * cos[..., None]
        light_acc = light_acc + torch.where((facing & ~occluded)[..., None],
                                            contrib, 0.0)
    return light_acc, n_shadow


@span("wavefront")
def _surface_terms(scene: FlatScene, rays: Rays, res, nrm: Tensor,
                   midx: Tensor, hit: Tensor, cfg: WavefrontConfig):
    """The shading inputs at a march's hits: the backed-off point, the
    repaired material (``resolve_material``; misses → 0), its kind, the
    diffuse weight (solids 1, mirrors 1 − ρ, dielectrics 0), the Lambert
    + emission term and the shadow rays marched."""
    with span("surface"):
        pos = rays.at(res.t - rays.epsilon)
        midx = torch.clamp_min(resolve_material(
            scene, pos, hit, midx, backend=cfg.march.backend), 0)
        rows = midx.long()
        albedo = sdf.albedo_of(scene, midx, pos)
    kind = sdf.mat_kinds(scene.mat_kind, midx.device)[rows]
    refl = sdf.take_rows(scene.mat_reflectivity, rows)
    light_rgb, n_shadow = _shade_local(scene, pos, nrm, rays.epsilon, cfg)
    lambert = albedo * light_rgb * (1.0 / math.pi) \
        + sdf.take_rows(scene.mat_emission, rows)
    is_mirror = kind == MAT_MIRROR
    diffuse_w = torch.where(kind == MAT_SOLID, 1.0,
                            torch.where(is_mirror, 1.0 - refl, 0.0))
    return dict(rows=rows, refl=refl, is_mirror=is_mirror,
                is_diel=kind == MAT_DIELECTRIC, lambert=lambert,
                diffuse_w=diffuse_w, n_shadow=n_shadow)


def _children(parent_t, direction, n_face, surf, eps, remaining, refl, ior,
              tint_rgb, is_mirror, is_diel, hit, inside, pixel, wl,
              cfg: WavefrontConfig):
    """The Fresnel children of specular hits, concatenated: A (reflection:
    mirror ρ, dielectric R) leaves along the face normal, B (refraction,
    dielectric without TIR, tinted at the ray's bin) through it, each from
    the true surface point offset by 3ε (less could leave a child inside
    the ε shell of the surface it just left).  ``parent_t`` is the parent's
    throughput, ``inside`` its medium."""
    n1 = torch.where(inside, ior, 1.0)
    n2 = torch.where(inside, 1.0, ior)
    R, refl_dir, refr_dir, tir = spectral.fresnel(direction, n_face, n1, n2)
    refl_T = parent_t * torch.where(is_mirror, refl,
                                    torch.where(is_diel, R, 0.0))
    a_active = hit & (is_mirror | is_diel) & (refl_T > cfg.min_throughput)
    a_origin = surf + 3.0 * eps[..., None] * n_face
    bfilt = spectral.bin_rgb(wl)
    tint = (torch.sum(bfilt * tint_rgb, dim=-1)
            / torch.clamp_min(torch.sum(bfilt, dim=-1), 1e-6))
    refr_T = parent_t * torch.where(is_diel, (1.0 - R) * tint, 0.0)
    b_active = hit & is_diel & ~tir & (refr_T > cfg.min_throughput)
    b_origin = surf - 3.0 * eps[..., None] * n_face

    def child(origin, d, T, active, medium):
        return RayQueue(origin=origin, direction=d, pixel=pixel, wl=wl,
                        throughput=torch.where(active, T, 0.0),
                        length=torch.where(active, remaining, 0.0),
                        inside=medium, active=active)
    return _concat(child(a_origin, refl_dir, refl_T, a_active, inside),
                   child(b_origin, normalize(refr_dir), refr_T, b_active,
                         ~inside))


def _face(nrm: Tensor, direction: Tensor) -> Tensor:
    """The shading normal oriented against the incident ray."""
    return torch.where(dot(nrm, direction)[..., None] > 0.0, -nrm, nrm)


@span("wavefront")
def _bounce(scene: FlatScene, q: RayQueue, image: Tensor,
            cfg: WavefrontConfig, is_last: bool):
    """One wavefront round: march → shade and accumulate → spawn children
    → compact.  Returns ``(queue, image, rays marched)``."""
    C = q.origin.shape[0]
    eps = torch.full((C,), cfg.epsilon, dtype=torch.float32,
                     device=q.origin.device)
    rays = Rays(origin=q.origin, direction=q.direction,
                length=torch.where(q.active, q.length, 0.0), epsilon=eps)
    # rays inside a dielectric march the negated distance toward the exit
    # surface (transmission)
    sign = torch.where(q.inside, -1.0, 1.0)
    # bounce rays diverge off curved geometry: the bounce-sized tables for
    # the march and for its shadow marches
    mcfg = dataclasses.replace(
        cfg.march, cull_m=max(cfg.march.cull_m, cfg.bounce_cull_m),
        cull_m_shadow=max(cfg.march.cull_m_shadow, cfg.bounce_cull_m))
    bcfg = dataclasses.replace(cfg, march=mcfg)
    res, nrm, midx = march_surface(scene, rays, mcfg, sign=sign)
    hit = res.hit & q.active
    missed = q.active & ~res.hit
    s = _surface_terms(scene, rays, res, nrm, midx, hit, bcfg)
    n_marched = q.active.sum() + s["n_shadow"]

    w = q.throughput[..., None] * (spectral.bin_rgb(q.wl)
                                   * float(cfg.num_bins))
    bg_contrib = torch.where(missed[..., None], w * scene.background, 0.0)
    hit_contrib = torch.where(hit[..., None],
                              w * s["lambert"] * s["diffuse_w"][..., None],
                              0.0)
    image.index_add_(0, q.pixel.long(), bg_contrib + hit_contrib)
    if is_last:
        # the terminal round drops unfinished specular energy (a bounded
        # bias, like any fixed-depth path truncation)
        return q, image, n_marched

    rows = s["rows"]
    both = _children(
        q.throughput, q.direction, _face(nrm, q.direction), rays.at(res.t),
        eps, torch.clamp_min(q.length - res.t, 0.0), s["refl"],
        spectral.cauchy_ior(sdf.take_rows(scene.mat_ior, rows), q.wl),
        sdf.take_rows(scene.mat_tint, rows), s["is_mirror"], s["is_diel"],
        hit, q.inside, q.pixel, q.wl, cfg)
    return _compact(both, C, cfg), image, n_marched


def spectral_graph(scene: FlatScene, camera, width: int, height: int,
                   cfg: WavefrontConfig):
    """What the first call of this key of
    :func:`render_spectral_with_stats` made, if any
    (``ops/graph.py::find``): its ``capture_s``, its ``graph`` and its
    ``frame.promoted``, the sites that build full-group tables."""
    return graph.find("spectral", scene, camera, cfg, extra=(width, height))


@torch.no_grad()
def render_spectral_with_stats(scene: FlatScene, camera, width: int,
                               height: int,
                               cfg: WavefrontConfig = WavefrontConfig()):
    """Spectral wavefront render → ``(linear RGB [H, W, 3], rays marched)``
    (an int64 scalar tensor: primary, bounce and facing shadow lanes); the
    frame is :func:`_spectral_frame`.

    The JAX package jits this function (static ``width``, ``height`` and
    ``cfg``): its culled marches' overflow fallbacks are ``lax.cond``s on
    the device.  On the kernels of a CUDA device the frame is one captured
    CUDA graph a key, by the rule every entry point shares
    (``ops/graph.py``): the key's first call runs the frame with its host
    reads deferred; where culled march calls overflowed their tables there,
    those sites are promoted to full-group tables and the frame runs once
    more, deferred, and is captured unless that run raises the flag too.  A
    replay reads one device flag, set where another site overflows or a
    material repair is needed, and on it runs the eager frame again.  Spectral frames count as frames in
    ``ops.cuda.graph_counts()`` (no keys of their own).  On the CPU, or on
    the "torch" backend, the frame runs eagerly.  The outputs are the
    caller's own."""
    def body(s, c, w):
        return _spectral_frame(s, c, width, height, w)
    with span("spectral"):
        return graph.run(body, scene, camera, cfg, name="spectral",
                         extra=(width, height))


@torch.no_grad()
def _spectral_frame(scene: FlatScene, camera, width: int, height: int,
                    cfg: WavefrontConfig):
    """The eager spectral frame (what :func:`render_spectral_with_stats`
    captures, and runs again where a replay raises its flag).

    **Shared primary round**: camera rays are the same for every bin
    (dispersion starts at the first specular surface), so round 0 marches
    one ray a pixel and accumulates the diffuse / miss terms with the
    summed bin weight — the per-bin result at 1/B of the march cost.
    Specular hits then spawn per-bin Fresnel children into the queue,
    pixel-major (lane = pixel·B + bin: a 1024-lane tile holds 128
    neighbouring parents, so its cone stays narrow), and rounds
    1 … depth−1 run the queue.  A scene without mirror or dielectric
    materials skips the queue."""
    base = camera_rays(camera, width, height, cfg.epsilon, cfg.length)
    dev = base.origin.device
    npix = width * height
    B = cfg.num_bins
    # screen-block order: the culled tiles need spatially coherent rays
    blocked = (cfg.march.backend == "cuda" and height % 32 == 0
               and width % 32 == 0)
    if blocked:
        bsz = auto_block(height, width)
        o0 = to_blocks(base.origin, height, width, bsz)
        d0 = to_blocks(base.direction, height, width, bsz)
    else:
        o0 = base.origin.reshape(npix, 3)
        d0 = base.direction.reshape(npix, 3)
    rays0 = Rays(origin=o0, direction=d0,
                 length=torch.full((npix,), cfg.length, dtype=torch.float32,
                                   device=dev),
                 epsilon=torch.full((npix,), cfg.epsilon, dtype=torch.float32,
                                    device=dev))

    # ---- round 0: one march shared by all bins ----------------------------
    res, nrm, midx = march_surface(scene, rays0, cfg.march)
    hit = res.hit
    s = _surface_terms(scene, rays0, res, nrm, midx, hit, cfg)
    n_rays = s["n_shadow"] + npix
    # summed per-bin weight: Σ_b (1/B)·(bin_rgb·B) = Σ_b bin_rgb ≈ (1,1,1)
    w0 = spectral.table("bin_rgb_sum", dev)
    image = torch.where(~hit[..., None], w0 * scene.background,
                        w0 * s["lambert"] * s["diffuse_w"][..., None])

    def finish(img):
        # the image lives in the rays' (block) order; children carry
        # block-order pixel ids
        if blocked:
            return from_blocks(img, height, width, bsz)
        return img.reshape(height, width, 3)

    has_specular = any(k in (MAT_MIRROR, MAT_DIELECTRIC)
                       for k in scene.mat_kind)
    if not has_specular or cfg.depth <= 1:
        return finish(image), n_rays

    # ---- per-bin children of the shared hits, pixel-major -----------------
    def rep(x):
        return _repeat(x, B)

    rows = s["rows"]
    with span("wavefront"):
        wl = torch.arange(B, dtype=torch.int32, device=dev).repeat(npix)
        pixel = rep(torch.arange(npix, dtype=torch.int32, device=dev))
        both = _children(
            torch.full((B * npix,), 1.0 / B, dtype=torch.float32,
                       device=dev),
            rep(d0), rep(_face(nrm, d0)), rep(rays0.at(res.t)),
            rep(rays0.epsilon),
            rep(torch.clamp_min(rays0.length - res.t, 0.0)), rep(s["refl"]),
            spectral.cauchy_ior(rep(sdf.take_rows(scene.mat_ior, rows)), wl),
            rep(sdf.take_rows(scene.mat_tint, rows)), rep(s["is_mirror"]),
            rep(s["is_diel"]), rep(hit),
            torch.zeros((B * npix,), dtype=torch.bool, device=dev), pixel,
            wl, cfg)
        q = _compact(both, B * npix, cfg)

    for bounce in range(1, cfg.depth):
        q, image, n_m = _bounce(scene, q, image, cfg,
                                is_last=(bounce == cfg.depth - 1))
        n_rays = n_rays + n_m
    return finish(image), n_rays


def render_spectral(scene: FlatScene, camera, width: int, height: int,
                    cfg: WavefrontConfig = WavefrontConfig()) -> Tensor:
    """Spectral wavefront render → linear RGB ``[H, W, 3]`` (see
    :func:`render_spectral_with_stats`).  A purely diffuse scene reproduces
    the plain render (the bin filters sum to 1); mirror and dielectric
    materials add reflection, dispersive refraction and TIR — the
    reference's end-goal optics (README.md:7, Light.fs)."""
    return render_spectral_with_stats(scene, camera, width, height, cfg)[0]
