"""Multi-process execution: image rows sharded over the ranks of a process
group (counterpart of ``fraytracer_tpu.parallel.mesh``).

One rank is one process with one device.  The scene and the camera are
replicated; rank ``k`` of ``n`` traces rows ``[k·H/n, (k+1)·H/n)`` and keeps
them.  The only communication is explicit ``torch.distributed`` calls on
the mesh's group:

* one ``all_reduce(MAX)`` for the auto-exposure maximum;
* in the training step, one ``all_reduce(SUM)`` of each chunk's gradients,
  issued asynchronously so that it runs during the next chunk's backward,
  and one of the chunk losses;
* in the rebalanced spectral frame, an ``all_gather`` of the active counts
  and an ``all_to_all_single`` of ray lanes a round, one ``all_reduce(SUM)``
  of the frame and an ``all_gather`` of the counts;
* on a card, one ``all_reduce(MAX)`` of the graph's flag a call
  (**Compiled**, below).

The gloo backend takes all of these on CUDA tensors as well as on CPU
tensors (torch 2.11, two ranks on one H100), so no collective is staged
through host memory here.  Multi-host runs call
``parallel.multihost.initialize`` first; these functions then see every
rank of every host.

**Compiled.**  The JAX package jits each sharded function as one device
program a rank, collectives inside (``jax.jit(shard_map(...))``).  Here, on
the kernels of a CUDA device, each is one captured CUDA graph a key and
rank (``render.py::_FrameGraph``), its host reads deferred to one device
flag as in the one-process graphs; the flag is ORed over the mesh's group
(``deferred.Frame.agree``) before any decision is taken on it, so that the
ranks capture, run again after a promotion, or re-run eagerly all alike
and always issue the same collectives.

* On NCCL every collective of the body is captured with it: the frame's
  flag reduction; the step's async gradient ``all_reduce`` of each chunk
  (each still overlapping the next chunk's backward: the graph keeps the
  fork onto NCCL's stream and the join at the wait), the losses', then the
  SGD update and the flag's reduction; the spectral frame's ``all_gather`` and
  ``all_to_all_single`` of every rebalanced round, its ``all_reduce`` of
  the frame, the counts' ``all_gather`` and the flag's.
* gloo's collectives run on host threads and cannot be captured, so on
  gloo a graph holds the rank's local work and the collectives follow the
  replay, eagerly: the frame's flag reduction; for the step, the graph
  sums the chunks' gradients and stacks the chunk losses into one buffer,
  then come the flag's ``all_reduce(MAX)``, the buffer's ``all_reduce``
  (one, not one a chunk: gloo loses the overlap) and the update; for the
  spectral frame without rebalancing, the flag's reduction and the counts'
  ``all_gather``.  The rebalanced spectral frame has a collective inside
  every round and runs eagerly on gloo, counted as an eager frame.

On the CPU, on the "torch" backend, and for a frame autograd must see, the
functions run eagerly, as the one-process frame does.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from .. import camera as cam
from ..ops import cuda as ops_cuda
from ..render import (BLOCK_EDGE, RenderConfig, _FrameGraph, _from_blocks,
                      _graph_frame, _graph_step, _run_graph, _to_blocks,
                      frame_key, render_grid, spectral_key)
from ..ops.march import check_config
from ..scene.flatten import FlatScene

Tensor = torch.Tensor

AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ranks along the axis ``"rays"``: the process group,
    this process's rank in it, the group's size and this rank's device."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = AXIS

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def local_rank() -> int:
    """This process's card on its host: torchrun's ``LOCAL_RANK``, else the
    global rank modulo the host's cards (ranks spawned on one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() % max(torch.cuda.device_count(), 1)


def make_mesh(n_devices: Optional[int] = None,
              devices: Union[None, str, torch.device] = None
              ) -> Optional[Mesh]:
    """A mesh over the first ``n_devices`` ranks of the initialized process
    group (all of them by default).  Every rank must call it: a mesh
    smaller than the world is a new group, whose creation is collective;
    a rank outside it gets ``None``.

    ``devices``: ``None`` puts this rank on ``cuda:<local rank>``; a device
    (e.g. ``"cpu"``) puts every rank there."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "parallel.multihost.initialize() first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        return None
    device = torch.device("cuda", local_rank()) if devices is None \
        else torch.device(devices)
    return Mesh(group=group, rank=rank, size=n, device=device)


def _shard_rows(mesh: Mesh, height: int) -> int:
    """Rows a rank holds; raises when ``height`` does not divide."""
    if height % mesh.size != 0:
        raise ValueError(
            f"image height {height} must divide by mesh size {mesh.size}")
    return height // mesh.size


def _band(x: Tensor, mesh: Mesh, rows: int) -> Tensor:
    return x[mesh.rank * rows:(mesh.rank + 1) * rows]


def all_gather(x: Tensor, mesh: Mesh) -> Tensor:
    """``[n, *x.shape]``: every rank's ``x`` (at least 1-D), stacked in
    rank order (gathered in the concatenated form, which gloo takes)."""
    out = torch.empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
    return out.reshape((mesh.size,) + tuple(x.shape))


def _band_frame(mesh: Mesh, scene: FlatScene, camera: cam.Camera,
                cfg: RenderConfig):
    """The band's frame: this rank's rows of the camera's rays through
    ``render_grid``; ``(image, n_rays)``.  No collective."""
    rows = _shard_rows(mesh, cfg.height)
    rays = cam.camera_rays(camera, cfg.width, cfg.height, cfg.epsilon,
                           cfg.length)
    return render_grid(scene, rays.map(lambda x: _band(x, mesh, rows)), cfg)


def render_sharded(scene: FlatScene, camera: cam.Camera, cfg: RenderConfig,
                   mesh: Mesh) -> Tensor:
    """This rank's rows of the full frame, linear RGB ``[H/n, W, 3]`` (no
    tone map).  Each rank traces its band of the camera's rays on its own,
    in the 32×32 block order of ``render.render_with_stats`` when 32 divides
    the band's sides: a band of whole block rows then gets the tiles,
    candidate tables and windows of the one-process frame, and its pixels
    are that frame's bit for bit.  A band that is not blocked is traced in
    row order; on the culled path its tiles differ, and so may its hits
    inside the ε shell.

    On the kernels of a CUDA device a frame autograd need not see replays
    one captured CUDA graph a ``("sharded", frame key, rank, size)`` (the
    band's rows are baked into it), with the graph frame's rule and its
    flag agreed over the mesh (module docstring)."""
    check_config(cfg.march)
    _shard_rows(mesh, cfg.height)
    body = functools.partial(_band_frame, mesh)
    if not _graph_frame(scene, camera, cfg):
        return body(scene, camera, cfg)[0]
    return _run_graph(
        ("sharded", frame_key(scene, camera, cfg), mesh.rank, mesh.size),
        lambda: _FrameGraph(body, scene, camera, cfg, group=mesh.group),
        lambda: body(scene, camera, cfg), (scene, camera))[0]


def exposure_max_sharded(image: Tensor, mesh: Mesh) -> Tensor:
    """The frame's maximum from every rank's rows: one ``all_reduce(MAX)``
    (the auto-exposure of ``Image.fs:40-43`` across ranks)."""
    m = image.detach().amax().reshape(1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.group)
    return m[0]


# ---------------------------------------------------------------------------
# Spectral wavefront with rows sharded, optionally rebalanced
# ---------------------------------------------------------------------------

_LANE_WIDTH = 12    # 4-byte columns of a packed queue lane


def _pack(q) -> Tensor:
    """A queue as ``[C, 12]`` float32 rows: origin, direction, then pixel,
    wavelength bin, throughput, budget, inside and active, the integers
    and flags bit-cast (one collective moves a lane whole)."""
    def bits(x):
        return x.to(torch.int32).view(torch.float32)[:, None]
    return torch.cat([q.origin, q.direction, bits(q.pixel), bits(q.wl),
                      q.throughput[:, None], q.length[:, None],
                      bits(q.inside), bits(q.active)], 1)


def _unpack(rows: Tensor):
    from ..ops.wavefront import RayQueue

    def bits(j):
        return rows[:, j].contiguous().view(torch.int32)
    return RayQueue(origin=rows[:, 0:3].contiguous(),
                    direction=rows[:, 3:6].contiguous(), pixel=bits(6),
                    wl=bits(7), throughput=rows[:, 8].contiguous(),
                    length=rows[:, 9].contiguous(), inside=bits(10) != 0,
                    active=bits(11) != 0)


def _rebalance_exchange(q, k: int, n_dev: int, C: int, tmin: float,
                        mesh: Mesh):
    """Fixed-size all-to-all ray redistribution (JAX ``mesh.py:88``); each
    rank keeps O(C) memory whatever the mesh size:

    1. local stable compaction (active lanes first, in their order);
    2. ``all_gather`` of the active counts only (``[n]`` integers);
    3. a live lane's global rank gives its destination
       ``dst = rank·n // A``, an exactly balanced contiguous partition, so
       each (source, destination) pair exchanges one contiguous block;
    4. lanes ship by ``all_to_all_single`` over an ``[n, S]`` buffer with
       ``S = C // n``; lanes past a pair's ``S`` slots stay with their
       donor;
    5. received and kept lanes merge and compact back to ``C`` by a
       lane-granular stable sort of the class (live, live below ``tmin``,
       dead), as JAX does at :147."""
    from ..ops.wavefront import _concat
    order = torch.argsort((~q.active).to(torch.int32), stable=True)
    q = q.map(lambda x: x[order])
    dev = q.active.device
    lane = torch.arange(C, dtype=torch.int64, device=dev)
    counts = all_gather(q.active.sum().reshape(1), mesh)[:, 0]
    A = counts.sum()
    start_k = (torch.cumsum(counts, 0) - counts)[k]
    S = max(C // n_dev, 1)
    rank = start_k + lane
    dst = torch.clamp_max(rank * n_dev // torch.clamp_min(A, 1), n_dev - 1)
    r0_dst = (dst * A + n_dev - 1) // n_dev          # ceil(dst·A/n)
    pair_idx = rank - torch.maximum(start_k, r0_dst)
    ship = q.active & (dst != k) & (pair_idx >= 0) & (pair_idx < S)
    keep = q.active & ~ship
    # lanes that stay write a spare last row, which is not sent
    slot = torch.where(ship, dst * S + pair_idx, n_dev * S)
    send = torch.zeros((n_dev * S + 1, _LANE_WIDTH), dtype=torch.float32,
                       device=dev)
    send[slot] = _pack(dataclasses.replace(q, active=ship))
    recv = torch.empty((n_dev * S, _LANE_WIDTH), dtype=torch.float32,
                       device=dev)
    dist.all_to_all_single(recv, send[:-1], group=mesh.group)
    both = _concat(dataclasses.replace(q, active=keep), _unpack(recv))
    low = both.active & (both.throughput < tmin)
    klass = (~both.active).to(torch.int32) * 2 + low.to(torch.int32)
    take = torch.argsort(klass, stable=True)[:C]
    return both.map(lambda x: x[take])


def _spectral_rounds(mesh: Mesh, width: int, height: int, rebalance: bool,
                     scene: FlatScene, camera: cam.Camera, wcfg):
    """This rank's rounds of :func:`render_spectral_sharded` (with
    ``rebalance`` the exchanges and the frame's ``all_reduce``): ``(rows,
    live lanes entering each round [depth])``."""
    from ..ops.wavefront import RayQueue, _bounce, _repeat
    rows = _shard_rows(mesh, height)
    n, k = mesh.size, mesh.rank
    base = cam.camera_rays(camera, width, height, wcfg.epsilon, wcfg.length)
    band = base.map(lambda x: _band(x, mesh, rows))
    blocked = (wcfg.march.backend == "cuda" and rows % BLOCK_EDGE == 0
               and width % BLOCK_EDGE == 0)
    if blocked:
        o = _to_blocks(band.origin, rows, width, BLOCK_EDGE)
        d = _to_blocks(band.direction, rows, width, BLOCK_EDGE)
    else:
        o = band.origin.reshape(-1, 3)
        d = band.direction.reshape(-1, 3)
    dev = o.device
    npix = rows * width
    B = wcfg.num_bins
    C = npix * B
    pix0 = k * npix if rebalance else 0
    f32 = dict(dtype=torch.float32, device=dev)
    q = RayQueue(
        origin=_repeat(o, B), direction=_repeat(d, B),
        pixel=pix0 + _repeat(torch.arange(npix, dtype=torch.int32,
                                          device=dev), B),
        wl=torch.arange(B, dtype=torch.int32, device=dev).repeat(npix),
        throughput=torch.full((C,), 1.0 / B, **f32),
        length=torch.full((C,), wcfg.length, **f32),
        inside=torch.zeros((C,), dtype=torch.bool, device=dev),
        active=torch.ones((C,), dtype=torch.bool, device=dev))
    image = torch.zeros((npix * n if rebalance else npix, 3), **f32)
    counts = []
    for bounce in range(wcfg.depth):
        if rebalance and bounce > 0:
            q = _rebalance_exchange(q, k, n, C, wcfg.min_throughput, mesh)
        counts.append(q.active.sum())
        q, image, _n = _bounce(scene, q, image, wcfg,
                               is_last=(bounce == wcfg.depth - 1))
    if rebalance:
        dist.all_reduce(image, group=mesh.group)
        image = image[k * npix:(k + 1) * npix]
    image = _from_blocks(image, rows, width, BLOCK_EDGE) if blocked \
        else image.reshape(rows, width, 3)
    return image, torch.stack(counts)


def _gathered_counts(mesh: Mesh, _scene, out):
    """``(rows, every rank's counts [n, depth])`` from a rank's rounds."""
    image, counts = out
    return image, all_gather(counts, mesh)


def _spectral_band(mesh: Mesh, width: int, height: int, rebalance: bool,
                   scene: FlatScene, camera: cam.Camera, wcfg):
    """The sharded spectral frame: this rank's rounds, then the counts'
    ``all_gather``."""
    return _gathered_counts(mesh, scene, _spectral_rounds(
        mesh, width, height, rebalance, scene, camera, wcfg))


@torch.no_grad()
def render_spectral_sharded(scene: FlatScene, camera: cam.Camera, width: int,
                            height: int, wcfg, mesh: Mesh,
                            rebalance: bool = False):
    """Spectral wavefront frame with image rows sharded over the mesh.

    Each rank runs its band's queue — ``B`` lanes a pixel, pixel-major, in
    the band's 32×32 block order on the "cuda" backend — through every
    round of ``ops/wavefront.py::_bounce`` (the JAX sharded frame has no
    shared primary round either).  ``rebalance=False``: queues stay with
    their rank.  ``rebalance=True``: before each round after the first,
    live lanes are spread evenly over the ranks (:func:`_rebalance_exchange`);
    lanes carry global pixel ids, every rank accumulates into a full-frame
    buffer, and one ``all_reduce(SUM)`` assembles the frame, of which each
    rank keeps its band.

    Returns ``(rows [H/n, W, 3], counts [n, depth])``: this rank's linear
    RGB rows, and the live lanes entering each round on every rank (after
    the exchange), gathered to every rank.

    On the kernels of a CUDA device the frame is one captured CUDA graph a
    ``("sharded", spectral key, rank, size, rebalance)``, with the
    one-process spectral graph's rule (the sites that overflow in the
    key's first run promoted) and its flag agreed over the mesh: on NCCL
    every collective inside; on gloo the graph holds the rank's rounds and
    the counts' ``all_gather`` follows the replay, and a rebalanced frame
    (a collective in every round) runs eagerly, counted as an eager frame
    (module docstring)."""
    from ..ops.wavefront import _graph_spectral
    _shard_rows(mesh, height)
    full = functools.partial(_spectral_band, mesh, width, height, rebalance)

    def eager():
        return full(scene, camera, wcfg)
    if not _graph_spectral(scene, camera, wcfg):
        return eager()
    if mesh.backend == "nccl":
        def make():
            return _FrameGraph(full, scene, camera, wcfg, promote=True,
                               group=mesh.group, name="spectral")
    elif rebalance:
        ops_cuda.GRAPH["eager_frames"] += 1
        return eager()
    else:
        def make():
            return _FrameGraph(
                functools.partial(_spectral_rounds, mesh, width, height,
                                  False),
                scene, camera, wcfg, promote=True, group=mesh.group,
                finish=functools.partial(_gathered_counts, mesh),
                name="spectral")
    return _run_graph(
        ("sharded", spectral_key(scene, camera, width, height, wcfg),
         mesh.rank, mesh.size, rebalance), make, eager, (scene, camera))


# ---------------------------------------------------------------------------
# The sharded training step
# ---------------------------------------------------------------------------

def _chunk_grads(mesh: Mesh, grad_chunks: int, scene: FlatScene,
                 camera: cam.Camera, cfg: RenderConfig, target: Tensor,
                 issue=None):
    """Each chunk of this rank's rows (``grad_chunks`` of them, one when
    the rows do not divide): its forward, its L2 loss against the target's
    rows and the loss's gradients w.r.t. the scene's tensors (which require
    grad), flattened into one buffer (zeros for a leaf the loss does not
    reach); ``issue(buffer)`` as soon as a chunk's exists.  Returns
    ``(buffers, losses [chunks], what issue returned)``."""
    rows = _shard_rows(mesh, cfg.height)
    rays = cam.camera_rays(camera, cfg.width, cfg.height, cfg.epsilon,
                           cfg.length).map(lambda x: _band(x, mesh, rows))
    tgt = _band(target, mesh, rows)
    nc = grad_chunks if grad_chunks > 0 and rows % grad_chunks == 0 else 1
    hc = rows // nc
    params = list(scene.tensors().values())
    flats, losses, issued = [], [], []
    with torch.enable_grad():
        for i in range(nc):
            chunk = rays.map(lambda x: x[i * hc:(i + 1) * hc])
            img, _n = render_grid(scene, chunk, cfg)
            loss = torch.sum((img - tgt[i * hc:(i + 1) * hc]) ** 2)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            flat = torch.cat([
                (torch.zeros_like(p) if g is None else g).reshape(-1)
                for g, p in zip(grads, params)])
            flats.append(flat)
            if issue is not None:
                issued.append(issue(flat))
            losses.append(loss.detach())
    return flats, torch.stack(losses), issued


def _summed(flats: list) -> Tensor:
    """The chunks' gradient buffers summed in chunk order."""
    total = flats[0]
    for flat in flats[1:]:
        total = total + flat
    return total


@torch.no_grad()
def _sgd(scene: FlatScene, total: Tensor, lr: float) -> tuple:
    """Every leaf of the scene moved by ``-lr`` times its stretch of the
    flattened gradient ``total``: new tensors, which need no grad."""
    new, at = [], 0
    for p in scene.tensors().values():
        new.append(p.detach() - lr * total[at:at + p.numel()].view_as(p))
        at += p.numel()
    return tuple(new)


def _step_overlapped(mesh: Mesh, lr: float, grad_chunks: int,
                     scene: FlatScene, camera: cam.Camera,
                     cfg: RenderConfig, target: Tensor) -> tuple:
    """The step, ``(loss, *new leaves)``: each chunk's gradients
    all-reduced asynchronously as soon as they exist, so that the
    reduction runs during the next chunk's backward; the chunk losses'
    ``all_reduce``; the waits; the update.  The eager step, and the body
    captured on NCCL."""
    flats, losses, handles = _chunk_grads(
        mesh, grad_chunks, scene, camera, cfg, target,
        issue=lambda flat: dist.all_reduce(flat, group=mesh.group,
                                           async_op=True))
    dist.all_reduce(losses, group=mesh.group)
    for handle in handles:
        handle.wait()
    return (losses.sum(),) + _sgd(scene, _summed(flats), lr)


def _step_local(mesh: Mesh, grad_chunks: int, scene: FlatScene,
                camera: cam.Camera, cfg: RenderConfig,
                target: Tensor) -> tuple:
    """The rank's part of the step, the body captured on gloo:
    ``(buffer,)``, the gradients summed over the chunks, then the chunk
    losses."""
    flats, losses, _none = _chunk_grads(mesh, grad_chunks, scene, camera,
                                        cfg, target)
    return (torch.cat([_summed(flats), losses]),)


def _step_reduced(mesh: Mesh, lr: float, scene: FlatScene, out) -> tuple:
    """What follows a gloo replay whose flag is clear: the buffer's
    ``all_reduce``, then the update; ``(loss, *new leaves)``."""
    buf, = out
    dist.all_reduce(buf, group=mesh.group)
    n = sum(p.numel() for p in scene.tensors().values())
    return (buf[n:].sum(),) + _sgd(scene, buf[:n], lr)


def make_train_step(cfg: RenderConfig, mesh: Mesh, lr: float = 1e-2,
                    grad_chunks: int = 4):
    """The sharded inverse-rendering step ``step(scene, camera, target) ->
    (scene', loss)``: each rank renders its rows of the current scene, takes
    the L2 loss against its rows of ``target [H, W, 3]``, and the
    gradients of every floating leaf are summed over the ranks (not
    averaged, as JAX's ``psum``); then one SGD step on the replicated
    scene.  ``loss`` is the frame's summed loss; ``scene'`` holds new
    tensors, which need no grad (the caller's scene is left as it was).

    **Overlap of the all-reduce with the backward**: the rank's rows are
    split into ``grad_chunks`` chunks (one when the rows do not divide);
    for each chunk the forward, its backward (``torch.autograd.grad``) and
    an ``all_reduce(SUM, async_op=True)`` of its gradients, flattened into
    one buffer — which runs while the next chunk computes.  The handles
    are waited on before the update.  The sum over chunks and ranks equals
    the monolithic step's up to float32 reassociation.

    **Compiled** (the counterpart of ``@jax.jit`` on JAX's step): on the
    kernels of a CUDA device the step replays one captured CUDA graph a
    frame key, target shape and dtype, rank and size, kept by ``step``
    (``step.graphs``; ``lr`` and ``grad_chunks`` are the closure's), with
    the graph frame's rule and its flag agreed over the mesh.  On NCCL the
    graph is the whole step above, collectives, waits and update inside.
    On gloo it is the rank's chunks, their gradients summed over the
    chunks before the sum over the ranks (within float32 reassociation of
    the eager step), and one ``all_reduce`` of them with the losses
    follows the replay, then the update: gloo's collectives cannot be
    captured, and the overlap is lost.  A flagged replay runs the eager
    step on every rank."""
    graphs = {}

    def step(scene: FlatScene, camera: cam.Camera, target: Tensor):
        check_config(cfg.march)
        _shard_rows(mesh, cfg.height)
        full = functools.partial(_step_overlapped, mesh, lr, grad_chunks)

        def eager():
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in scene.tensors().items()}
            return full(scene.with_tensors(leaves), camera, cfg, target)
        if not _graph_step(scene, camera, cfg, (target,)):
            out = eager()
        else:
            if mesh.backend == "nccl":
                def make():
                    return _FrameGraph(full, scene, camera, cfg, (target,),
                                       grad=True, group=mesh.group,
                                       name="step")
            else:
                def make():
                    return _FrameGraph(
                        functools.partial(_step_local, mesh, grad_chunks),
                        scene, camera, cfg, (target,), grad=True,
                        group=mesh.group,
                        finish=functools.partial(_step_reduced, mesh, lr),
                        name="step")
            key = ("sharded_step", frame_key(scene, camera, cfg),
                   (tuple(target.shape), target.dtype, target.device),
                   mesh.rank, mesh.size)
            out = _run_graph(key, make, eager, (scene, camera, (target,)),
                             graphs)
        return scene.with_tensors(dict(zip(scene.tensors(), out[1:]))), \
            out[0]

    step.graphs = graphs
    return step
