"""Top-level render API (counterpart of ``fraytracer_tpu.render``).

The pixel grid → camera rays → masked march → shading, as one call over the
whole image (reference ``Image.render`` + ``SdfScene.trace``).  On the
"cuda" backend rays are put in 32×32 screen-block order before marching, as
the JAX kernel path does: each block is one 1024-ray tile of the culled
kernels' candidate tables (``ops/cuda/cull.py``), so a tile's rays are
coherent and its cone is tight.

The JAX package wraps ``render``, ``render_with_stats`` and
``render_image`` in ``jax.jit``: a frame is one device program per scene
structure, shapes and config, and its data-dependent branches are
``lax.cond``s on the device.  Here a frame of the kernels on a CUDA device
is one captured CUDA graph per :func:`frame_key` (:class:`_FrameGraph`):
the first call runs the frame eagerly with its host reads deferred
(``ops/deferred.py``) and captures it; a later call copies the scene's and
the camera's tensors into the graph's inputs, replays it and reads one
device flag, set where an overflowing candidate table or a material repair
needs the eager frame, which then runs again (exact, and counted).  A key
whose first run raises the flag is not captured: its frames run eagerly.
Every graph is captured into one memory pool a device, so the graphs of
many keys hold about one frame's peak together.  A frame
that autograd must see (a scene or camera tensor requires grad while grad
is enabled), a frame on the CPU and a frame on the "torch" backend (whose
plain march ends its loop on a host read) run eagerly; :func:`render_grid`
is the eager frame of a ray grid.

The JAX package's ``cli fit`` and bench jit ``jax.value_and_grad`` of a
loss of the frame; :func:`render_value_and_grad` is its counterpart, a
step (forward and backward) captured as one CUDA graph a
:func:`step_key` by the same rule, the backward's host read (the
certificate of ``point_eval``'s candidate lists) deferred to the flag too.

The spectral frame (``ops/wavefront.py::render_spectral_with_stats``) is
captured a :func:`spectral_key` by one more rule, for its culled marches'
overflow fallbacks: where the key's first run raised the flag and its
culled march calls (sites, numbered in their fixed order) overflowed, those
sites are promoted to full-group tables, the frame runs once more deferred
and, unless that run raises the flag too, is captured.  Frame and step keys
keep the rule above.

The sharded frame, step and spectral frame (``parallel/mesh.py``) are
graphs of the same kind a key and rank, whose ranks run their bodies
together: each decision on the flag (capture or not, promote and run
again, replay or re-run eagerly) is taken on the flag ORed over the mesh's
group (``deferred.Frame.agree``), so that every rank issues the same
collectives.
"""
from __future__ import annotations

import dataclasses
import functools
import time

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from . import camera as cam
from .ops import cuda as ops_cuda, deferred, shade, tonemap
from .ops.cuda.build import on_device
from .ops.march import MarchConfig, check_config
from .scene.flatten import FlatScene, flatten
from .scene.nodes import Scene
from .types import Rays

Tensor = torch.Tensor

BLOCK_EDGE = 32   # screen-block edge: one 1024-ray tile per block


@dataclasses.dataclass(frozen=True, eq=True)
class RenderConfig:
    """Static render configuration (same fields and defaults as JAX)."""

    width: int = 1024
    height: int = 1024
    epsilon: float = 0.01       # hit threshold (Program.fs:85)
    length: float = 30.0        # ray travel budget (Program.fs:93)
    gamma: float = 2.2          # tone-map gamma (Program.fs:99)
    march: MarchConfig = MarchConfig()
    # rays per tile for the "torch" backend, whose march builds [tile, K]
    # distance matrices; 0 → the whole image in one batch
    tile_rays: int = 65536
    # rays per tile for the kernel backend; 0 → untiled
    tile_rays_pallas: int = 0


def _auto_block(height: int, width: int) -> int:
    """Screen-block edge: 32 (the non-TPU ray tile of 1024 rays), halved
    until it divides both image sides."""
    b = BLOCK_EDGE
    while height % b or width % b:
        b //= 2
    return max(b, 1)


def _to_blocks(x: Tensor, height: int, width: int, b: int) -> Tensor:
    """[H, W, ...] → flat [H·W, ...] in b×b-block order."""
    t = x.reshape((height // b, b, width // b, b) + tuple(x.shape[2:]))
    order = (0, 2, 1, 3) + tuple(range(4, t.ndim))
    return t.permute(order).reshape((height * width,) + tuple(x.shape[2:]))


def _from_blocks(x: Tensor, height: int, width: int, b: int) -> Tensor:
    """flat [H·W, ...] in block order → [H, W, ...]."""
    t = x.reshape((height // b, width // b, b, b) + tuple(x.shape[1:]))
    order = (0, 2, 1, 3) + tuple(range(4, t.ndim))
    return t.permute(order).reshape((height, width) + tuple(x.shape[1:]))


def _pad_rays(rays: Rays, pad: int) -> Rays:
    """Append ``pad`` zero-budget (inactive) lanes."""
    padded = rays.map(lambda x: torch.nn.functional.pad(
        x, (0, 0) * (x.ndim - 1) + (0, pad)))
    padded.length[-pad:] = 0.0
    return padded


def _trace(scene: FlatScene, rays: Rays, march_cfg: MarchConfig,
           tile_rays: int):
    """Trace a flat ray batch, in tiles of ``tile_rays`` when > 0 (bounds
    the "torch" backend's memory; with a graph each tile is rematerialized
    in the backward, so one tile's intermediates bound the peak).  Returns
    (colors [N, 3], n_rays)."""
    n = rays.origin.shape[0]
    if tile_rays <= 0 or n <= tile_rays:
        return shade.trace_with_stats(scene, rays, march_cfg)
    pad = (-n) % tile_rays
    if pad:
        rays = _pad_rays(rays, pad)
    keep = torch.is_grad_enabled() and any(
        x.requires_grad for x in scene.tensors().values())

    def tile(i):
        part = rays.map(lambda x: x[i:i + tile_rays])
        if keep:
            return checkpoint(deferred.in_current(shade.trace_with_stats),
                              scene, part, march_cfg, use_reentrant=False)
        return shade.trace_with_stats(scene, part, march_cfg)

    colors, n_rays = [], 0
    for i in range(0, n + pad, tile_rays):
        c, k = tile(i)
        colors.append(c)
        n_rays = n_rays + k
    # padded lanes each contribute exactly 1 to the primary count
    return torch.cat(colors)[:n], n_rays - pad


def _frame(scene: FlatScene, camera: cam.Camera, cfg: RenderConfig):
    """The frame: camera rays, then :func:`render_grid`."""
    rays = cam.camera_rays(camera, cfg.width, cfg.height,
                           cfg.epsilon, cfg.length)
    return render_grid(scene, rays, cfg)


def _inputs(scene: FlatScene, camera: cam.Camera) -> list:
    """A frame's tensors: the scene's leaves, then the camera's."""
    return list(scene.tensors().values()) + [
        camera.position, camera.forward, camera.up_scaled,
        camera.right_scaled]


def frame_key(scene: FlatScene, camera: cam.Camera, cfg: RenderConfig):
    """What a captured frame is kept under, as ``jax.jit`` keys the frame:
    the scene's static fields, the camera's ``ortho_scale``, each tensor's
    shape, dtype and device, and the config — never the scene object nor a
    parameter's value."""
    leaves = tuple((tuple(x.shape), x.dtype, x.device)
                   for x in _inputs(scene, camera))
    return (scene.plan, scene.kind_counts, scene.prim_material,
            scene.mat_kind, scene.light_kind, camera.ortho_scale,
            tuple(scene.prim_params), leaves, cfg)


def spectral_key(scene: FlatScene, camera: cam.Camera, width: int,
                 height: int, cfg):
    """What a captured spectral frame (``ops/wavefront.py``) is kept under,
    as ``jax.jit`` keys it (static ``width``, ``height`` and ``cfg``): the
    frame's key over the ``WavefrontConfig`` and the image size."""
    return ("spectral", frame_key(scene, camera, (width, height, cfg)))


def _graph_frame(scene: FlatScene, camera: cam.Camera,
                 cfg: RenderConfig) -> bool:
    """True when the frame runs as a captured graph: the kernels, every
    tensor on a CUDA device, and none that autograd must see."""
    xs = _inputs(scene, camera)
    return (cfg.march.backend == "cuda" and all(x.is_cuda for x in xs)
            and not (torch.is_grad_enabled()
                     and any(x.requires_grad for x in xs)))


def _graph_step(scene: FlatScene, camera: cam.Camera, cfg: RenderConfig,
                args) -> bool:
    """True when the step runs as a captured graph: the kernels, and every
    tensor of the scene, the camera and ``args`` on a CUDA device."""
    return cfg.march.backend == "cuda" and all(
        x.is_cuda for x in _inputs(scene, camera) + list(args))


def _step(loss_fn, scene: FlatScene, camera: cam.Camera, cfg: RenderConfig,
          *args) -> tuple:
    """The step on the scene's own leaves, which require grad: ``(loss,
    *grads)``, the gradients in ``scene.tensors()`` order, zeros for a leaf
    autograd did not reach (as ``jax.value_and_grad`` gives them)."""
    leaves = list(scene.tensors().values())
    with torch.enable_grad():
        loss = loss_fn(_frame(scene, camera, cfg)[0], *args)
        if loss.ndim != 0:
            raise ValueError(f"loss_fn returned shape {tuple(loss.shape)}, "
                             "want a scalar")
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return (loss.detach(),) + tuple(
        torch.zeros_like(x) if g is None else g
        for x, g in zip(leaves, grads))


def _eager_step(loss_fn, scene: FlatScene, camera: cam.Camera,
                cfg: RenderConfig, *args) -> tuple:
    """:func:`_step` on leaves made from the scene's tensors."""
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in scene.tensors().items()}
    return _step(loss_fn, scene.with_tensors(leaves), camera, cfg, *args)


class _FrameGraph:
    """A frame, or a step (a frame, a loss and its gradient), captured in a
    CUDA graph: the counterpart of a ``jax.jit`` executable.  It holds
    copies of the scene's, the camera's and ``args``' tensors as the
    graph's inputs (the scene's requiring grad in a step: the leaves its
    ``autograd.grad`` differentiates), the body's outputs and the flag of
    its deferred frame in the graph's memory, and the kernel launches
    recorded at its capture, which each replay adds to the counts (the
    Python wrappers do not run on a replay).  Its deferred frame also keeps
    the device constants the graph reads (``deferred.device_constant``).

    ``body(scene, camera, cfg, *args)`` returns a tuple of tensors:
    :func:`_frame` (``grad`` false), :func:`_step` over a loss function
    (``grad`` true) or the spectral frame.  Made by the first call of a
    key: the body runs eagerly once, its host reads deferred (``first``:
    its outputs, or ``None`` when it raised the flag); that run also makes
    the device constants, whose copies from host data cannot be captured,
    and sets up autograd's worker thread for a step.  With ``promote``,
    a first run that raised the flag and saw sites overflow (its stacked
    overflow bools read once) promotes those sites and runs once more,
    deferred: the counterpart of JAX's ``lax.cond`` fallback taken per
    call site.  Then, unless the last run raised the flag, the body is
    captured (``graph``, else ``None``: the key runs eagerly;
    ``capture_s``: the runs and the capture together, the counterpart of
    JAX's compile time).  A failure in any raises.

    ``group``: the process group whose ranks make and replay this key's
    graph together (``parallel/mesh.py``).  Every run of the body ends with
    the flag ORed over the group, so that every rank takes each decision
    alike: with a flag set anywhere no rank captures; a promoting first run
    is run again on every rank (each promoting its own overflowed sites:
    promotion changes a rank's tables, not its collectives); a replay's
    outputs stand on every rank or none.  On NCCL that reduction is the
    captured body's last collective; gloo's collectives run on host
    threads and cannot be captured, so on gloo it runs after the replay.
    The deferred first run issues the body's collectives eagerly, so no
    collective is the first of its communicator inside a capture.
    ``finish(scene, outputs)``: the work that follows a replay whose flag
    is clear, and the first run (a gloo body's collectives, eagerly); the
    call's result is what it returns."""

    def __init__(self, body, scene: FlatScene, camera: cam.Camera,
                 cfg, args=(), grad: bool = False, promote: bool = False,
                 group=None, finish=None):
        t0 = time.perf_counter()
        self.device = scene.device
        self.inputs = [x.detach().clone()
                       for x in _inputs(scene, camera) + list(args)]
        names = list(scene.tensors())
        for x in self.inputs[:len(names) if grad else 0]:
            x.requires_grad_(True)
        graph_scene = scene.with_tensors(dict(zip(names, self.inputs)))
        position, forward, up, right = self.inputs[len(names):len(names) + 4]
        graph_camera = dataclasses.replace(
            camera, position=position, forward=forward, up_scaled=up,
            right_scaled=right)
        graph_args = self.inputs[len(names) + 4:]
        self.body = lambda: body(graph_scene, graph_camera, cfg, *graph_args)
        self.frame = deferred.Frame(self.device, group)
        self.agree_in_graph = (group is not None
                               and dist.get_backend(group) == "nccl")
        self.finish = finish
        self.graph, self.launches = None, {}
        with torch.no_grad(), on_device(self.device):
            out = self._run(agree=True)
            flagged = bool(self.frame.flag)
            if flagged and promote:
                sites = self.frame.overflowed_sites()
                # with a group the flag was set on some rank: every rank
                # runs again, as the collectives of the run need
                if sites or group is not None:
                    self.frame.promoted = sites
                    out = self._run(agree=True)
                    flagged = bool(self.frame.flag)
            self.first = None if flagged else out
            if self.first is not None:
                if finish is not None:
                    self.first = finish(scene, out)
                self._capture()
        self.capture_s = time.perf_counter() - t0

    def _run(self, agree: bool):
        """The body with its host reads deferred to the frame, its sites
        numbered from 0, the flag cleared first and, with ``agree``, ORed
        over the group last: what the capture records."""
        self.frame.overflows.clear()
        with deferred.deferring(self.frame):
            self.frame.flag.zero_()
            out = self.body()
        if agree:
            self.frame.agree()
        return out

    def _capture(self) -> None:
        """Capture the body into the device's graph memory pool."""
        graph = torch.cuda.CUDAGraph()
        self.frame.programs.clear()
        index = self.device.index if self.device.index is not None \
            else torch.cuda.current_device()
        if index not in _pools:
            _pools[index] = torch.cuda.graph_pool_handle()
        before = ops_cuda.launch_counts()
        # a group's NCCL watchdog thread may query the events of earlier
        # eager collectives while the capture runs; in the global mode
        # such a call from another thread would invalidate the capture
        mode = "global" if self.frame.group is None else "thread_local"
        try:
            with torch.no_grad(), on_device(self.device), \
                    torch.cuda.graph(graph, pool=_pools[index],
                                     capture_error_mode=mode):
                self.outputs = self._run(agree=self.agree_in_graph)
        except BaseException:
            # a capture that fails leaves its pool bound to it: the
            # device's next capture takes a new pool
            del _pools[index]
            raise
        after = ops_cuda.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        # captured, not launched: the replays count them
        ops_cuda.add_launch_counts({k: -v for k, v in self.launches.items()})
        self.graph = graph
        ops_cuda.GRAPH["captures"] += 1

    def replay(self, scene: FlatScene, camera: cam.Camera, args=()):
        """The body on ``scene``, ``camera`` and ``args`` (this graph's
        key): clones of the outputs, or ``None`` when the replay raised the
        flag."""
        with torch.no_grad(), on_device(self.device):
            for dst, src in zip(self.inputs,
                                _inputs(scene, camera) + list(args)):
                dst.copy_(src)
            self.graph.replay()
            if not self.agree_in_graph:
                self.frame.agree()
            out = tuple(x.clone() for x in self.outputs)
            flagged = bool(self.frame.flag)      # the body's one host read
            if not flagged and self.finish is not None:
                out = self.finish(scene, out)
        ops_cuda.add_launch_counts(self.launches)
        ops_cuda.GRAPH["replays"] += 1
        return None if flagged else out


# A graph's memory is its pool's, and every graph of a device shares one
# (device index → pool, made at the device's first capture): a replay
# writes each of its pool's tensors before it reads it, and the tensors a
# graph keeps (its outputs, its lowered programs) are live and so never
# handed to another capture.
_pools: dict = {}
_graphs: "dict[tuple, _FrameGraph]" = {}


def _run_graph(key, make, eager, replay_args, graphs=None):
    """A call of ``key`` through its graph (module docstring): made by the
    key's first call (``make()``), else replayed on ``replay_args``; the
    eager body ``eager()`` where the key runs eagerly or the flag is set,
    counted.  ``graphs``: where the key's graph is kept (this module's
    ``_graphs`` by default)."""
    graphs = _graphs if graphs is None else graphs
    fg = graphs.get(key)
    if fg is None:
        fg = graphs[key] = make()
        out, fg.first = fg.first, None
    elif fg.graph is None:
        # the key's first run raised the flag: its calls run eagerly, as
        # a replay that raised it would pay the graph, then the eager body
        ops_cuda.GRAPH["eager_frames"] += 1
        return eager()
    else:
        out = fg.replay(*replay_args)
    if out is None:
        # an overflowing table, a material repair or a failing certificate
        ops_cuda.GRAPH["eager_reruns"] += 1
        out = eager()
    return out


def frame_graph(scene: FlatScene, camera: cam.Camera,
                cfg: RenderConfig = RenderConfig()) -> _FrameGraph | None:
    """What the first call of this call's key made, if any: its
    ``capture_s``, and its ``graph`` (``None`` for a key run eagerly)."""
    return _graphs.get(frame_key(scene, camera, cfg))


def render_with_stats(scene: FlatScene, camera: cam.Camera,
                      cfg: RenderConfig = RenderConfig()):
    """``render`` + the number of rays marched (primary + shadow per facing
    hit, an int64 scalar tensor).  Returns ``(image [H, W, 3], n_rays)``.
    The image is differentiable w.r.t. every scene tensor that requires
    grad; when none does, no graph is built.  On the kernels of a CUDA
    device a frame autograd need not see replays a captured CUDA graph (the
    module docstring); its outputs are the caller's own."""
    check_config(cfg.march)
    if not _graph_frame(scene, camera, cfg):
        return _frame(scene, camera, cfg)
    return _run_graph(
        frame_key(scene, camera, cfg),
        lambda: _FrameGraph(_frame, scene, camera, cfg),
        lambda: _frame(scene, camera, cfg), (scene, camera))


def spectral_graph(scene: FlatScene, camera: cam.Camera, width: int,
                   height: int, cfg) -> _FrameGraph | None:
    """:func:`frame_graph` of the spectral frame
    (``ops/wavefront.py::render_spectral_with_stats``): also its
    ``frame.promoted``, the sites that build full-group tables."""
    return _graphs.get(spectral_key(scene, camera, width, height, cfg))


def step_key(loss_fn, scene: FlatScene, camera: cam.Camera,
             cfg: RenderConfig, *args):
    """What a captured step is kept under: the frame's key, ``loss_fn``
    and each tensor of ``args`` by shape, dtype and device."""
    return ("step", frame_key(scene, camera, cfg), loss_fn,
            tuple((tuple(x.shape), x.dtype, x.device) for x in args))


def step_graph(loss_fn, scene: FlatScene, camera: cam.Camera,
               cfg: RenderConfig, *args) -> _FrameGraph | None:
    """:func:`frame_graph` of the step of :func:`render_value_and_grad`."""
    return _graphs.get(step_key(loss_fn, scene, camera, cfg, *args))


def render_value_and_grad(loss_fn, scene: FlatScene, camera: cam.Camera,
                          cfg: RenderConfig = RenderConfig(), *args):
    """``jax.value_and_grad`` of a loss of the frame, as the JAX package
    jits it: ``loss_fn(image [H, W, 3], *args)`` returns a scalar; the
    result is ``(loss, grads)``, ``grads`` keyed as ``scene.tensors()``
    keys the leaves (the JAX gradient pytree's naming), every floating
    leaf, zeros where the loss does not reach it.  ``args`` are tensors
    (a target image, weights); the camera is held fixed.  ``loss_fn`` is
    part of the key: pass the same function object every step.

    On the kernels of a CUDA device the step is one captured CUDA graph a
    :func:`step_key`, forward and backward, with no host read in either
    (the module docstring's rule; the backward's certificate is the
    frame's flag, ``ops/point_eval.py::culled_branch``): a later call
    copies the scene's, the camera's and ``args``' tensors into the graph's
    inputs, replays it, reads the flag once and returns clones of the loss
    and the gradients; a flagged call runs the eager step again.  Steps
    count as frames in ``ops.cuda.graph_counts()``.  On the CPU, or on the
    "torch" backend, the step runs eagerly.  The scene's tensors are not
    changed and gain no ``.grad``."""
    check_config(cfg.march)
    names = list(scene.tensors())

    def eager():
        return _eager_step(loss_fn, scene, camera, cfg, *args)
    if _graph_step(scene, camera, cfg, args):
        out = _run_graph(
            step_key(loss_fn, scene, camera, cfg, *args),
            lambda: _FrameGraph(functools.partial(_step, loss_fn), scene,
                                camera, cfg, args, grad=True),
            eager, (scene, camera, args))
    else:
        out = eager()
    return out[0], dict(zip(names, out[1:]))


def render_grid(scene: FlatScene, rays: Rays, cfg: RenderConfig):
    """Trace a ``[h, w]`` grid of camera rays — a whole frame or a band of
    its rows (``parallel/mesh.py``) — and shade it.  Returns ``(image [h,
    w, 3], n_rays)``.  On the "cuda" backend, when 32 divides both sides,
    the rays are traced in 32×32 block order, so a band of whole block
    rows gets the tiles, tables and windows of the full frame."""
    h, w = rays.origin.shape[:2]
    kernel = cfg.march.backend == "cuda"
    blocked = kernel and h % 32 == 0 and w % 32 == 0
    if blocked:
        b = _auto_block(h, w)
        flat = rays.map(lambda x: _to_blocks(x, h, w, b))
    else:
        flat = rays.map(lambda x: x.reshape((w * h,) + tuple(x.shape[2:])))
    tile = cfg.tile_rays_pallas if kernel else cfg.tile_rays
    colors, n_rays = _trace(scene, flat, cfg.march, tile)
    if blocked:
        return _from_blocks(colors, h, w, b), n_rays
    return colors.reshape(h, w, 3), n_rays


def render(scene: FlatScene, camera: cam.Camera,
           cfg: RenderConfig = RenderConfig()) -> Tensor:
    """Render the full image → linear RGB float32 [H, W, 3] (row 0 = top)."""
    return render_with_stats(scene, camera, cfg)[0]


def render_rays(scene: FlatScene, rays: Rays,
                march_cfg: MarchConfig = MarchConfig()) -> Tensor:
    """Trace an arbitrary ray batch → linear RGB [..., 3]."""
    return shade.trace(scene, rays, march_cfg)


def render_image(scene: FlatScene, camera: cam.Camera,
                 generator: torch.Generator | None = None,
                 cfg: RenderConfig = RenderConfig()) -> Tensor:
    """Render + tone map → dithered uint8 [H, W, 3] (Image.fs:37-50)."""
    return tonemap.tonemap(render(scene, camera, cfg), generator, cfg.gamma)


def render_scene(scene: Scene, camera: cam.Camera,
                 cfg: RenderConfig = RenderConfig()) -> Tensor:
    """Convenience: flatten a builder Scene and render linear RGB."""
    return render(flatten(scene, device=camera.position.device), camera, cfg)
