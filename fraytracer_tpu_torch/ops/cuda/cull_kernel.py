"""The table build as kernels: host side of ``csrc/cull.cu``.

:func:`build_tables` is what ``cull.build_pair_tables`` runs for CUDA
tensors: the same :class:`~.cull.CullTables` as the plain build
(``cull.build_pair_tables_plain``, which CPU tensors take), from two
launches a culled march site whatever its number of pairs:

* ``cull_cones_kernel`` — the cone statistics of every tile and of its
  :data:`~.cull.SUBF` sub-tiles, and each lane's ``oa`` / ``ca``;
* ``cull_select_kernel`` — one block a (tile, pair): the candidacy test
  against the sub-cones, the candidates in stable axial order, the
  table, its chunk keys, suffix minima, misc, count and the overflow flag.

A select block keeps its candidates in shared memory
(:func:`select_words` from the group and ``m``); a group too large for that
takes the same code over a slice of device memory allocated here (the
large path).  ``LAUNCHES`` counts the cones launches, the select launches
and the select launches that took the large path, apart.  Nothing is read
back to the host: the overflow flag stays on the device.
"""
from __future__ import annotations

import ctypes

import torch

from ...scene.flatten import KINDS, PARAM_WIDTH, FlatScene
from ...utils.profiling import anchor
from .build import check, library, on_device
from .cull import (CAND_UNROLL, MAX_PAIRS, SMEM_LIMIT, SUBF, TABLE_W, TILE,
                   CullTables, PairTable, TileCones, _grouped, _pair_m,
                   _row_ids, kind_offset)

Tensor = torch.Tensor

LAUNCHES = {"cull_cones": 0, "cull_select": 0, "cull_select_large": 0}

CONES = 1 + SUBF         # cones a tile: its own, then its sub-tiles'
CONE_W = 20              # floats of one cone's statistics (FT_CONE_W)
SELECT_STATIC = 1024     # a select block's own shared memory, at most
# a group past this is refused: row counts and the table's float32 slot
# column are exact below 2**24
MAX_GROUP = 1 << 24


class FtBuildPair(ctypes.Structure):
    """Mirror of ``struct FtBuildPair`` (csrc/ft_sdf.cuh)."""
    _fields_ = [
        ("params", ctypes.c_void_p), ("ids", ctypes.c_void_p),
        ("idx", ctypes.c_void_p), ("count", ctypes.c_void_p),
        ("table", ctypes.c_void_p), ("keys", ctypes.c_void_p),
        ("misc", ctypes.c_void_p), ("hsuf", ctypes.c_void_p),
        ("scratch", ctypes.c_void_p),
        ("kind", ctypes.c_int), ("width", ctypes.c_int),
        ("g", ctypes.c_int), ("m", ctypes.c_int),
        ("reach", ctypes.c_float), ("scratch_words", ctypes.c_int),
    ]


class FtBuild(ctypes.Structure):
    """Mirror of ``struct FtBuild`` (csrc/ft_sdf.cuh)."""
    _fields_ = [
        ("cones", ctypes.c_void_p), ("overflow", ctypes.c_void_p),
        ("window_clamp", ctypes.c_float), ("converging", ctypes.c_int),
        ("n_pairs", ctypes.c_int), ("pad_", ctypes.c_int),
        ("pairs", FtBuildPair * MAX_PAIRS),
    ]


def select_words(g: int, m: int) -> int:
    """4-byte words of a select block's buffers for a group of ``g`` and a
    table of ``m`` rows: keys and rows of the sort (the next power of two
    of ``g`` each), the ballot words and their prefix, the chunks' near
    edges."""
    cap = 1 << max(g - 1, 0).bit_length()
    words = -(-g // 32)
    return 2 * cap + 2 * words + m // CAND_UNROLL


def select_path(g: int, m: int) -> str:
    """Where a select block of this pair keeps its buffers: ``"shared"``
    memory when they fit next to its own, else ``"large"`` (device
    memory); a group beyond both raises ``NotImplementedError``."""
    if g >= MAX_GROUP:
        raise NotImplementedError(
            f"a culled group of {g} members (the table build takes fewer "
            f"than {MAX_GROUP})")
    if 4 * select_words(g, m) + SELECT_STATIC <= SMEM_LIMIT:
        return "shared"
    return "large"


def _check(name: str, x: Tensor, shape: tuple) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, want {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(origin, direction, t0, length, epsilon, cone_apex):
    """The lanes as the kernels take them: float32, contiguous, ``[n, 3]``
    and ``[n]``, on one CUDA device; returns ``n``."""
    n = origin.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"{n} lanes: the table build takes < 2**31")
    for name, x, shape in (("origin", origin, (n, 3)),
                           ("direction", direction, (n, 3)),
                           ("t0", t0, (n,)), ("length", length, (n,)),
                           ("epsilon", epsilon, (n,))) + (
            () if cone_apex is None else (("cone_apex", cone_apex, (3,)),)):
        _check(name, x, shape)
    for name, x in (("origin", origin), ("direction", direction),
                    ("t0", t0), ("length", length), ("epsilon", epsilon)) + (
            () if cone_apex is None else (("cone_apex", cone_apex),)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} is on {x.device}, not a CUDA device")
        if x.device != origin.device:
            raise ValueError(f"{name} is on {x.device}, expected "
                             f"{origin.device}")
    return n


def _launch_cones(origin, direction, t0, length, epsilon, cone_apex,
                  overflow=None):
    """The cones launch: ``(cones [G, CONES, CONE_W], oa [n], ca [n])``."""
    n = origin.shape[0]
    grid = -(-n // TILE)
    dev = origin.device
    cones = torch.empty((grid, CONES, CONE_W), dtype=torch.float32,
                        device=dev)
    oa = torch.empty(n, dtype=torch.float32, device=dev)
    ca = torch.empty(n, dtype=torch.float32, device=dev)
    with on_device(dev):
        err = library().ft_cull_cones(
            origin.data_ptr(), direction.data_ptr(), t0.data_ptr(),
            length.data_ptr(), epsilon.data_ptr(), n,
            None if cone_apex is None else cone_apex.data_ptr(),
            cones.data_ptr(), oa.data_ptr(), ca.data_ptr(),
            None if overflow is None else overflow.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "ft_cull_cones")
    if grid:
        anchor("cull_cones_kernel")
        LAUNCHES["cull_cones"] += 1
    return cones, oa, ca


def cones_of(buf: Tensor) -> tuple:
    """The cones buffer as ``(tile cones [G], sub-tile cones [G·SUBF])``,
    each a :class:`~.cull.TileCones` (sub-tiles in lane order)."""
    def one(c):
        return TileCones(c[:, 0:3], c[:, 3:6],
                         *(c[:, k] for k in range(6, 11)), c[:, 11] > 0.0,
                         *(c[:, k] for k in range(12, 19)))
    return one(buf[:, 0]), one(buf[:, 1:].reshape(-1, CONE_W))


@torch.no_grad()
def tile_cones(origin: Tensor, direction: Tensor, t0: Tensor, length: Tensor,
               epsilon: Tensor, cone_apex: Tensor | None = None):
    """The cones launch alone: ``(tile cones, sub-tile cones, oa, ca)``
    as :func:`build_tables` computes them (``length`` 0: a lane that never
    marches)."""
    _check_inputs(origin, direction, t0, length, epsilon, cone_apex)
    buf, oa, ca = _launch_cones(origin, direction, t0, length, epsilon,
                                cone_apex)
    return cones_of(buf) + (oa, ca)


@torch.no_grad()
def build_tables(scene: FlatScene, origin: Tensor, direction: Tensor,
                 t0: Tensor, length: Tensor, epsilon: Tensor, pairs,
                 cull_m: int, window_clamp: float,
                 cone_apex: Tensor | None = None,
                 early_out: bool = False) -> CullTables:
    """``cull.build_pair_tables`` on CUDA tensors: the same arguments and
    the same :class:`CullTables`, from the cones launch and one select
    launch.  Refuses what the kernels do not take (more than
    ``MAX_PAIRS`` pairs, a group beyond :func:`select_path`, lanes that
    are not float32, contiguous and on one CUDA device) before any
    launch."""
    if len(pairs) > MAX_PAIRS:
        raise NotImplementedError(
            f"{len(pairs)} culled pairs > {MAX_PAIRS} (csrc/ft_sdf.cuh "
            "FT_MAX_PAIRS)")
    dev = origin.device
    plan = []
    for (gid, kind, _ki, row_lo, row_hi) in pairs:
        g = row_hi - row_lo
        m = _pair_m(cull_m, g)
        path = select_path(g, m)
        params = scene.prim_params[kind]
        _check(f"prim_params[{kind!r}]", params,
               (params.shape[0], PARAM_WIDTH[kind]))
        if params.device != dev:
            raise ValueError(f"prim_params[{kind!r}] is on {params.device}, "
                             f"expected {dev}")
        plan.append((gid, kind, row_lo, row_hi, g, m, path, params))
    if cone_apex is not None:
        cone_apex = cone_apex.to(origin).contiguous()
    n = _check_inputs(origin, direction, t0, length, epsilon, cone_apex)
    grid = -(-n // TILE)
    groups, _tree, reach = _grouped(scene.plan)
    overflow = None
    if any(m < g for *_p, g, m, _path, _params in plan):
        overflow = torch.empty((), dtype=torch.bool, device=dev)
    cones, oa, ca = _launch_cones(origin, direction, t0, length, epsilon,
                                  cone_apex, overflow)

    job = FtBuild(cones=cones.data_ptr(),
                  overflow=None if overflow is None else overflow.data_ptr(),
                  window_clamp=float(window_clamp),
                  converging=int(cone_apex is not None), n_pairs=len(pairs))
    tables, scratch, smem = [], [], 0
    f32 = dict(dtype=torch.float32, device=dev)
    for q, (gid, kind, row_lo, row_hi, g, m, path, params) in \
            enumerate(plan):
        chunks = m // CAND_UNROLL
        ids = _row_ids(scene.plan, scene.prim_material,
                       kind_offset(scene, kind), row_lo, row_hi, dev)
        t = PairTable(
            gid=gid, op=groups[gid].op, kind=kind, row_lo=row_lo,
            row_hi=row_hi, m=m,
            idx=torch.empty((grid, m), dtype=torch.int64, device=dev),
            count=torch.empty(grid, dtype=torch.int32, device=dev),
            table=torch.empty((grid, m, TABLE_W), **f32),
            keys=torch.empty((grid, 2, chunks), **f32),
            misc=torch.empty((grid, 4), **f32),
            hsuf=torch.empty((grid, chunks), **f32))
        words = select_words(g, m)
        p = job.pairs[q]
        p.scratch = None
        if path == "large":
            # kept until the launch; freed after it, later work on the
            # stream (or later nodes of a captured graph) runs after it
            scratch.append(torch.empty(grid * words, **f32))
            p.scratch = scratch[-1].data_ptr()
        else:
            smem = max(smem, 4 * words)
        p.params = params.data_ptr() + row_lo * PARAM_WIDTH[kind] * 4
        p.ids = ids.data_ptr()
        p.idx, p.count = t.idx.data_ptr(), t.count.data_ptr()
        p.table, p.keys = t.table.data_ptr(), t.keys.data_ptr()
        p.misc, p.hsuf = t.misc.data_ptr(), t.hsuf.data_ptr()
        p.kind, p.width = KINDS.index(kind), PARAM_WIDTH[kind]
        p.g, p.m = g, m
        p.reach = float(reach[gid])
        p.scratch_words = words
        tables.append(t)
    if grid and pairs:
        with on_device(dev):
            err = library().ft_cull_select(
                ctypes.byref(job), grid, -(-smem // 16) * 16,
                torch.cuda.current_stream(dev).cuda_stream)
        check(err, "ft_cull_select")
        anchor("cull_select_kernel")
        LAUNCHES["cull_select_large" if scratch else "cull_select"] += 1
    return CullTables(pairs=tuple(pairs), tables=tables, oa=oa, ca=ca,
                      overflow=overflow, early_out=bool(early_out))
