"""K1/K2/K3 host side: the counterpart of ``pallas_march_raw``
(``fraytracer_tpu/ops/pallas/march_kernel.py`` :1785), dense and culled.

The CSG plan is lowered to a small program (:func:`lower_program`) that the
kernels in ``csrc/march.cu`` interpret per ray: groups of primitives with a
min/max/sumexp reduction (``cull._build_groups``, the TPU kernel's
grouping) and the tree over them in postfix.  Parameters stay runtime
tensors, so a scene edit rebuilds nothing.  With culling (``cull=True``)
the rows of each culled (group, kind) pair leave their group's dense entry
range; the kernels read them from the per-tile candidate tables of
``cull.build_pair_tables`` instead, through a windowed scan.

Each kernel has a wrapper and a plain PyTorch version beside it:

* :func:`march_kernel` / :func:`march_plain` — K1 (march) and K2
  (occlusion, hit mask only), dense or culled;
* :func:`surface_kernel` / :func:`surface_plain` — K3, the surface pass,
  dense or culled: slot mode for plans of min/max alone (winning leaf
  code, its gradient as the normal, material argmin), AD mode
  (:func:`surface_ad_plain`) for plans with a smooth union (value and
  gradient folded through the tree, material argmin, code 0).

A culled K1/K2/K3 block stages its tile's candidate tables, the program
and the few dense entries in shared memory; the wrapper sizes that from
shapes alone (``cull.stage_plan``, no device read).  The dense form has
kernels of its own: the lowering also emits each group's entries as runs
of one kind and packs their rows at their kind's width (``packed``), which
a dense block stages with one bulk copy where it fits
(``cull.dense_stage_plan``); dense K1/K2 run a persistent grid whose lanes
take the next ray from a counter when theirs ends.  :func:`march_sections`
launches the culled kernel's instrumented twin (per-section clock counts,
a diagnostic of ``chip_smoke.py`` with a launch counter of its own).

A wrapper launches the kernel for CUDA tensors and counts the launch in
``LAUNCHES`` (``march``/``occlusion``/``surface``/``surface_ad`` for the
dense form, ``*_culled`` for the culled one); for CPU tensors it runs the
plain version (the CPU tests go through the same host glue); any other
device raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ...scene.flatten import FlatScene, Plan, PARAM_WIDTH, KINDS, \
    visible_materials
from ...types import MarchResult, Rays, normalize
from ...utils.profiling import anchor, span
from .. import deferred, sdf
from ..march import (MarchConfig, bound_skip_start, check_config, chunked,
                     _chunk_elems, sphere_trace)
from .build import check, library, on_device
from .cull import (CAND_UNROLL, MAX_PAIRS, PSTRIDE, STAGE_MEMBER_BYTES,
                   STAGE_OP_BYTES, STAGE_RUN_BYTES, SURF_LIST_BYTES, TABLE_W,
                   TILE, WINDOW_LANES, CullTables, DenseStagePlan, PairTable,
                   StagePlan, _build_groups, _cull_pairs, build_pair_tables,
                   dense_march_threads, dense_stage_plan, kind_offset,
                   stage_plan)

Tensor = torch.Tensor

LAUNCHES = {"march": 0, "occlusion": 0, "surface": 0, "surface_ad": 0,
            "march_culled": 0, "occlusion_culled": 0, "surface_culled": 0,
            "surface_ad_culled": 0}

MAX_STACK = 16    # CSG value-stack depth (FT_MAX_STACK)

# The dense form's program as its last K1/K2 and K3 launches lowered it:
# its ops, kind runs and value-stack depth, and the bytes of it a block
# keeps in shared memory against those it reads from device memory; the
# last K1/K2 launch's threads a block and blocks an SM
# (``ops.cuda.dense_counts()``)
DENSE = {"ops": 0, "kind_runs": 0, "stack": 0, "march_staged_bytes": 0,
         "march_device_bytes": 0, "surface_staged_bytes": 0,
         "surface_device_bytes": 0, "march_threads": 0,
         "march_blocks_per_sm": 0}
# per device, int64 [1]: the scene evaluations the dense K1/K2 made, counted
# by the kernel (the plain version adds its lanes' steps), summed over
# launches and graph replays
LANE_STEPS: dict = {}
_BIG = 3.0e38

_OPCODE = {"union": 1, "intersect": 2, "subtract": 3, "smooth_union": 4}
_GROUP_OP = {"min": 0, "max": 1, "sumexp": 2}


@functools.lru_cache(maxsize=32)
def slot_surface_mode(plan: Plan) -> bool:
    """True when the surface kernel's slot mode applies: no smooth union
    anywhere in the plan, so CSG min/max names one winning leaf; False
    selects AD mode.  (The JAX predicate looks only for sumexp groups and
    so misses a smooth union whose operands are all sub-plans — ROADMAP,
    Queue 3.)"""
    return plan.op != "smooth_union" and all(
        slot_surface_mode(c) for c in plan.children)


# ---------------------------------------------------------------------------
# Plan → device program
# ---------------------------------------------------------------------------

class FtProgram(ctypes.Structure):
    """Mirror of ``struct FtProgram`` in csrc/ft_sdf.cuh (same order)."""
    _fields_ = [
        ("ops", ctypes.c_void_p), ("op_k", ctypes.c_void_p),
        ("n_ops", ctypes.c_int),
        ("groups", ctypes.c_void_p), ("group_k", ctypes.c_void_p),
        ("n_groups", ctypes.c_int),
        ("ent_kind", ctypes.c_void_p), ("ent_slot", ctypes.c_void_p),
        ("ent_mat", ctypes.c_void_p), ("ent_params", ctypes.c_void_p),
        ("n_ent", ctypes.c_int),
        ("group_pairs", ctypes.c_void_p),
        ("runs", ctypes.c_void_p), ("n_runs", ctypes.c_int),
        ("group_runs", ctypes.c_void_p), ("packed", ctypes.c_void_p),
        ("ent_ms", ctypes.c_void_p),
    ]


class FtPair(ctypes.Structure):
    """Mirror of ``struct FtPair`` (csrc/ft_sdf.cuh)."""
    _fields_ = [
        ("table", ctypes.c_void_p), ("keys", ctypes.c_void_p),
        ("misc", ctypes.c_void_p), ("hsuf", ctypes.c_void_p),
        ("m", ctypes.c_int), ("kind", ctypes.c_int),
        ("group_size", ctypes.c_int), ("pad_", ctypes.c_int),
    ]


class FtCull(ctypes.Structure):
    """Mirror of ``struct FtCull`` (csrc/ft_sdf.cuh)."""
    _fields_ = [
        ("oa", ctypes.c_void_p), ("ca", ctypes.c_void_p),
        ("n_pairs", ctypes.c_int), ("early_out", ctypes.c_int),
        ("pairs", FtPair * MAX_PAIRS),
    ]


class FtStage(ctypes.Structure):
    """Mirror of ``struct FtStage`` (csrc/ft_sdf.cuh): a
    :class:`cull.StagePlan` as the kernel takes it."""
    _fields_ = [
        ("bytes", ctypes.c_int), ("bulk_bytes", ctypes.c_int),
        ("ents", ctypes.c_int),
        ("ops_off", ctypes.c_int), ("ents_off", ctypes.c_int),
        ("bulk_keys", ctypes.c_int), ("bulk_hsuf", ctypes.c_int),
        ("pair_off", ctypes.c_int * MAX_PAIRS),
    ]


class FtDenseStage(ctypes.Structure):
    """Mirror of ``struct FtDenseStage`` (csrc/ft_sdf.cuh): a
    :class:`cull.DenseStagePlan` as the dense-form kernels take it."""
    _fields_ = [
        ("bytes", ctypes.c_int), ("ops_off", ctypes.c_int),
        ("runs_off", ctypes.c_int), ("ms_off", ctypes.c_int),
        ("rows_off", ctypes.c_int), ("rows_bytes", ctypes.c_int),
    ]


@functools.lru_cache(maxsize=256)
def _dense_stage_struct(plan: DenseStagePlan) -> FtDenseStage:
    return FtDenseStage(plan.bytes, plan.ops_off, plan.runs_off, plan.ms_off,
                        plan.rows_off, plan.rows_bytes)


@functools.lru_cache(maxsize=256)
def _stage_struct(plan: StagePlan) -> FtStage:
    pad = (-1,) * (MAX_PAIRS - len(plan.pair_off))
    return FtStage(plan.bytes, plan.bulk_bytes, plan.ents,
                   plan.ops_off, plan.ents_off, plan.bulk_keys, plan.bulk_hsuf,
                   (ctypes.c_int * MAX_PAIRS)(*plan.pair_off, *pad))


def _cull_struct(cull: CullTables) -> FtCull:
    """A culled launch's ``FtCull``, kept on the tables until their
    ``early_out`` changes."""
    memo = cull.__dict__.get("_struct")
    if memo is not None and memo[0] == cull.early_out:
        return memo[1]
    for q in cull.tables:
        # the kernel reads table rows and misc as 16-byte words
        if q.table.data_ptr() % 16 or q.misc.data_ptr() % 16 \
                or q.keys.data_ptr() % 16 or q.hsuf.data_ptr() % 16:
            raise ValueError("candidate tables must be 16-byte aligned")
    s = FtCull()
    s.oa, s.ca = cull.oa.data_ptr(), cull.ca.data_ptr()
    s.n_pairs, s.early_out = len(cull.tables), int(cull.early_out)
    for i, q in enumerate(cull.tables):
        s.pairs[i] = FtPair(q.table.data_ptr(), q.keys.data_ptr(),
                            q.misc.data_ptr(), q.hsuf.data_ptr(), q.m,
                            KINDS.index(q.kind), q.row_hi - q.row_lo, 0)
    cull.__dict__["_struct"] = (cull.early_out, s)
    return s


@dataclasses.dataclass
class Program:
    """The lowered scene on one device (tensors the kernels read)."""
    ops: Tensor          # int32 [L, 2] (opcode, group id | operand count)
    op_k: Tensor         # float32 [L]
    groups: Tensor       # int32 [G, 3] (entry start, entry end, op)
    group_k: Tensor      # float32 [G]
    ent_kind: Tensor     # int32 [E]
    ent_slot: Tensor     # int32 [E]
    ent_mat: Tensor      # int32 [E]
    ent_params: Tensor   # float32 [E, PSTRIDE]
    group_pairs: Tensor  # int32 [G, 2] the group's culled pairs [start, end)
    runs: Tensor         # int32 [R, 4] the dense entries as runs of one
    #                      kind: (first entry, end, kind, first 16-byte
    #                      word of the run in ``packed``)
    group_runs: Tensor   # int32 [G, 2] the group's runs [start, end)
    packed: Tensor       # float32 [words * 4] the dense entries' rows, each
    #                      at its kind's width rounded up to 16 bytes
    ent_ms: Tensor       # int32 [E, 2] (material, slot) of each entry
    n_dense: int = 0     # entries inside the groups' ranges (not culled)
    stack: int = 0       # the value stack's largest depth

    def struct(self) -> FtProgram:
        """The program as the kernels take it (its tensors never change:
        built once)."""
        s = self.__dict__.get("_struct")
        if s is None:
            s = self.__dict__["_struct"] = self._make_struct()
        return s

    def _make_struct(self) -> FtProgram:
        return FtProgram(
            self.ops.data_ptr(), self.op_k.data_ptr(), self.ops.shape[0],
            self.groups.data_ptr(), self.group_k.data_ptr(),
            self.groups.shape[0],
            self.ent_kind.data_ptr(), self.ent_slot.data_ptr(),
            self.ent_mat.data_ptr(), self.ent_params.data_ptr(),
            self.ent_kind.shape[0],
            self.group_pairs.data_ptr(), self.runs.data_ptr(),
            self.runs.shape[0], self.group_runs.data_ptr(),
            self.packed.data_ptr(), self.ent_ms.data_ptr())


def _culled_slots(kind_counts, pairs) -> set:
    """Global slots read from the candidate tables instead of entries."""
    offsets, off = {}, 0
    for k, c in kind_counts:
        offsets[k] = off
        off += c
    return {offsets[kind] + r for (_g, kind, _ki, r0, r1) in pairs
            for r in range(r0, r1)}


def row_words(kind: int) -> int:
    """16-byte words of a packed row of primitive kind ``kind`` (its
    PARAM_WIDTH floats rounded up; ``ft_kind_width`` in csrc/ft_sdf.cuh)."""
    return -(-PARAM_WIDTH[KINDS[kind]] // 4)


def _kind_runs(rows, entries, kind_of_slot):
    """The dense entries of each group as runs of one kind: a group's
    members are in ascending slot and slots are kind-major, so its range
    is already at most one run per kind, and no entry moves.  Returns the
    runs ``(first entry, end, kind, first 16-byte word of the run in the
    packed rows)``, each group's run range ``[start, end)`` and the index
    of every packed float into the entries' parameters padded to
    TABLE_W columns."""
    runs, group_runs, pack, word = [], [], [], 0
    for e0, e1, _op in rows:
        start = len(runs)
        e = e0
        while e < e1:
            kind = int(kind_of_slot[entries[e]])
            f = e
            while f < e1 and kind_of_slot[entries[f]] == kind:
                f += 1
            w = row_words(kind)
            runs.append((e, f, kind, word))
            pack.append((np.arange(e, f)[:, None] * TABLE_W
                         + np.arange(4 * w)[None, :]).ravel())
            word += (f - e) * w
            e = f
        group_runs.append((start, len(runs)))
    return runs, group_runs, \
        np.concatenate(pack) if pack else np.zeros(0, np.int64)


def _tree_depth(node) -> int:
    """Combinators on the longest path from the root of a group tree
    (``cull._build_groups``) to a group."""
    if node[0] == "g":
        return 0
    return 1 + max(_tree_depth(kid) for kid in node[2])


@functools.lru_cache(maxsize=32)
def _lower_static(plan: Plan, kind_counts, prim_material, pairs=()):
    """The static part of the program as numpy arrays (cached per scene
    structure and cull pairs): postfix ops, groups, entry order,
    per-entry tables and the dense entries' kind runs.  A culled pair's
    rows sit after every group's range (read through the tables; K3 still
    finds the winning leaf's entry)."""
    groups, tree = _build_groups(plan)
    culled = _culled_slots(kind_counts, pairs)
    entries, rows, gpairs = [], [], []
    for g in groups:
        # ascending slot: the first extremum wins
        members = sorted(s for s in g.slots if s not in culled)
        rows.append((len(entries), len(entries) + len(members),
                     _GROUP_OP[g.op]))
        entries += members
        mine = [i for i, p in enumerate(pairs) if p[0] == g.gid]
        gpairs.append((mine[0], mine[-1] + 1) if mine else (0, 0))
    n_dense = len(entries)
    entries += sorted(culled)

    ops, op_k = [], []
    depth = max_depth = 0

    def push(op, arg, k=0.0):
        nonlocal depth, max_depth
        ops.append((op, arg))
        op_k.append(float(k))
        depth += 1 - (arg if op else 0)
        max_depth = max(max_depth, depth)

    def emit(node):
        if node[0] == "g":
            push(0, node[1])
            return
        op, k, kids = node
        if op == "smooth_union":
            # n-ary: refolding smooth_fold would change its rounding
            for kid in kids:
                emit(kid)
            push(_OPCODE[op], len(kids), k)
            return
        # union / intersect / subtract fold left, two operands a combine:
        # the kernels' csg_pick folds an n-ary combine left to right, so
        # values and ties are the same, and a union of subtrees keeps the
        # stack at its widest operand's depth plus one
        emit(kids[0])
        for kid in kids[1:]:
            emit(kid)
            push(_OPCODE[op], 2, k)

    emit(tree)
    if max_depth > MAX_STACK:
        raise NotImplementedError(
            f"CSG plan needs a value stack of {max_depth} > {MAX_STACK} "
            f"(csrc/ft_sdf.cuh FT_MAX_STACK): its tree is "
            f"{_tree_depth(tree)} combinators deep")

    kind_of_slot = np.concatenate(
        [np.full(c, KINDS.index(k), np.int32) for k, c in kind_counts])
    mat_vis = np.asarray(visible_materials(plan, prim_material), np.int32)
    ent = np.asarray(entries, np.int64)
    runs, group_runs, pack_idx = _kind_runs(rows, entries, kind_of_slot)
    return dict(
        ops=np.asarray(ops, np.int32).reshape(-1, 2),
        op_k=np.asarray(op_k, np.float32),
        groups=np.asarray(rows, np.int32).reshape(-1, 3),
        group_k=np.asarray([g.k for g in groups], np.float32),
        ent_kind=kind_of_slot[ent],
        ent_slot=ent.astype(np.int32),
        ent_mat=mat_vis[ent],
        ent_ms=np.stack([mat_vis[ent], ent.astype(np.int32)], 1)
        .astype(np.int32),
        entries=ent,
        group_pairs=np.asarray(gpairs, np.int32).reshape(-1, 2),
        runs=np.asarray(runs, np.int32).reshape(-1, 4),
        group_runs=np.asarray(group_runs, np.int32).reshape(-1, 2),
        pack_idx=pack_idx.astype(np.int64),
        n_dense=n_dense,
        stack=max_depth,
    )


@deferred.device_constant(maxsize=32)
def _static_on(plan: Plan, kind_counts, prim_material, pairs, device: str):
    """The static part on ``device``, copied there once (a captured frame
    keeps what it reads: ``deferred.device_constant``)."""
    st = _lower_static(plan, kind_counts, prim_material, pairs)
    return {k: torch.as_tensor(v, device=device)
            if isinstance(v, np.ndarray) else v for k, v in st.items()}


def slot_param_rows(scene: FlatScene) -> Tensor:
    """Every primitive's parameters as ``[K, PSTRIDE]`` rows in slot order;
    torus axes are normalized with the plain version's formula."""
    rows = []
    for kind, _cnt in scene.kind_counts:
        p = scene.prim_params[kind].detach().to(torch.float32)
        if kind == "torus":
            p = torch.cat([p[:, 0:3], normalize(p[:, 3:6]), p[:, 6:]], -1)
        rows.append(torch.nn.functional.pad(
            p, (0, PSTRIDE - PARAM_WIDTH[kind])))
    return torch.cat(rows, 0).contiguous()


def _lower_values(scene: FlatScene, st: dict) -> Program:
    """The value part of the lowering on the static part ``st``: the
    parameters in slot order, each entry's row (``ent_params``) and the
    packed rows of the dense entries — fresh tensors, computed on the
    device from the scene's parameter tensors."""
    dev = st["entries"].device
    params = slot_param_rows(scene).to(dev)
    ent_params = params.index_select(0, st["entries"]).contiguous()
    # the packed rows: one gather from the entries' rows padded to TABLE_W
    padded = torch.nn.functional.pad(ent_params[:st["n_dense"]],
                                     (0, TABLE_W - PSTRIDE))
    return Program(ops=st["ops"], op_k=st["op_k"], groups=st["groups"],
                   group_k=st["group_k"], ent_kind=st["ent_kind"],
                   ent_slot=st["ent_slot"], ent_mat=st["ent_mat"],
                   ent_params=ent_params, group_pairs=st["group_pairs"],
                   runs=st["runs"], group_runs=st["group_runs"],
                   packed=padded.reshape(-1).index_select(0, st["pack_idx"])
                   .contiguous(),
                   ent_ms=st["ent_ms"], n_dense=st["n_dense"],
                   stack=st["stack"])


def lower_program(scene: FlatScene, device, pairs=()) -> Program:
    """Lower ``scene`` to the kernels' program on ``device`` (``pairs``:
    the culled pairs of the launch, none for the dense form).  The static
    part is memoized per scene structure; the value part
    (:func:`_lower_values`) is kept, with the plan, the parameter tensors
    and their in-place versions it was made from, and reused by every
    launch until one of them changes (an edit through ``.data`` bumps no
    version and is not seen), so a frame lowers its scene once.  The
    eager frame keeps it on the scene object; a deferred frame
    (``ops/deferred.py``) keeps its own, so that a captured frame lowers
    the values inside the capture and every replay lowers them again into
    the buffers whose addresses its launches hold."""
    key = (str(torch.device(device)), tuple(pairs))
    frame = deferred.current()
    memo = frame.programs if frame is not None \
        else scene.__dict__.setdefault("_lowered", {})
    cur = tuple(scene.prim_params.values())
    seen = memo.get(key)
    if seen is not None:
        plan, params, versions, prog = seen
        if (plan is scene.plan and len(params) == len(cur)
                and all(a is b for a, b in zip(params, cur))
                and versions == tuple(p._version for p in cur)):
            return prog
    st = _static_on(scene.plan, scene.kind_counts, scene.prim_material,
                    key[1], key[0])
    prog = _lower_values(scene, st)
    memo[key] = (scene.plan, cur, tuple(p._version for p in cur), prog)
    return prog


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_lanes(n: int, **tensors) -> None:
    """Kernel inputs: float32/int32/bool contiguous CUDA tensors, [n] or
    [n, 3], all on one device."""
    dev = None
    for name, x in tensors.items():
        if not x.is_cuda:
            raise ValueError(f"{name} is on {x.device}, not a CUDA device")
        if dev is None:
            dev = x.device
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.shape[0] != n or x.ndim > 2 or (x.ndim == 2
                                             and x.shape[1] != 3):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, want "
                             f"[{n}] or [{n}, 3]")
    if n >= 2 ** 31:
        raise ValueError("too many rays for one launch")


def _route(x: Tensor) -> bool:
    """True → launch the kernel (CUDA tensor); False → plain version (CPU
    tensor); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}")


def _f32(name, x):
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    return x


# ---------------------------------------------------------------------------
# plain versions of the culled passes
# ---------------------------------------------------------------------------

def _warp_window(q: PairTable, lane: Tensor, p_ax: Tensor):
    """The kernel's per-step window of pair ``q`` (``_pair_window``
    :641-697), computed per WINDOW_LANES group over the active lanes
    ``lane`` (ascending; whole groups only).  Returns the per-lane
    ``cap`` and ``skip_lb`` and the per-group ``(inv, tile, phi, w_lo,
    w_hi)``: each lane's group, the group's tile, its largest axial
    coordinate and its window ``[w_lo, w_hi)`` in chunks."""
    warp = lane // WINDOW_LANES
    uw, inv = torch.unique_consecutive(warp, return_inverse=True)
    nw, dev = uw.shape[0], p_ax.device
    plo = torch.full((nw,), _BIG, device=dev).scatter_reduce(
        0, inv, p_ax, "amin")
    phi = torch.full((nw,), -_BIG, device=dev).scatter_reduce(
        0, inv, p_ax, "amax")
    tile = uw * WINDOW_LANES // TILE
    lo_c, hi_c = q.keys[tile, 0], q.keys[tile, 1]          # [nw, C]
    clamp = q.misc[tile, 2]
    behind = lo_c < (plo - clamp)[:, None]
    ahead = hi_c > (phi + clamp)[:, None]
    rel = ~behind & ~ahead
    chunks = lo_c.shape[1]
    ci = torch.arange(chunks, device=dev)
    w_lo = torch.where(rel, ci, chunks).amin(1)
    w_hi = torch.where(rel, ci + 1, 0).amax(1)
    bh = torch.where(behind, lo_c, -_BIG).amax(1)[inv]
    ah = torch.where(ahead, hi_c, _BIG).amin(1)[inv]
    bh_min = torch.where(behind, lo_c, _BIG).amin(1)[inv]
    ah_max = torch.where(ahead, hi_c, -_BIG).amax(1)[inv]
    cap = torch.minimum(ah - p_ax, p_ax - bh)
    skip_lb = torch.maximum(
        torch.where(behind.any(1)[inv], p_ax - bh_min, -_BIG),
        torch.where(ahead.any(1)[inv], ah_max - p_ax, -_BIG))
    return cap, skip_lb, (inv, tile, phi, w_lo, w_hi)


def _early_out_end(q: PairTable, dch: Tensor, warp) -> Tensor:
    """Per-group end of the window scan with the running-min early-out
    (:884-959): the scan stops before chunk ``c`` once the largest running
    min over the group's active lanes, plus ``phi``, is at most the
    suffix-min ``hsuf[c]`` — no later candidate can lower any lane's min."""
    inv, tile, phi, w_lo, w_hi = warp
    n, chunks = dch.shape
    ci = torch.arange(chunks, device=dch.device)
    started = ci >= w_lo[inv][:, None]
    run = torch.cummin(torch.where(started, dch, _BIG), 1).values
    before = torch.cat([torch.full((n, 1), _BIG, device=dch.device),
                        run[:, :-1]], 1)              # acc before chunk c
    amax = torch.full((w_lo.shape[0], chunks), -_BIG,
                      device=dch.device).scatter_reduce(
        0, inv[:, None].expand(n, chunks), before, "amax")
    stop = ~(amax + phi[:, None] > q.hsuf[tile]) & (ci >= w_lo[:, None])
    return torch.minimum(w_hi, torch.where(stop, ci, chunks).amin(1))


def _culled_distance(scene: FlatScene, cull: CullTables, lane: Tensor,
                     p: Tensor, t: Tensor, eps: Tensor) -> Tensor:
    """Plain version of the culled scene distance of K1/K2 for the active
    lanes ``lane`` (whole WINDOW_LANES groups) at ray parameter ``t``.

    Every primitive is evaluated; each pair's rows then take the pair's
    windowed value — ``min(window min, cap)`` for a min group,
    ``max(window max, skip_lb, excl)`` for a max group (:960-973) — and the
    plan combines as usual (the pair's rows all belong to its group, so
    the group reduces to the same value the kernel folds in)."""
    d = sdf.prim_distances(scene, p)
    oa, ca = cull.oa[lane], cull.ca[lane]
    p_ax = oa + t * ca
    for q in cull.tables:
        mn = q.op == "min"
        off = kind_offset(scene, q.kind) + q.row_lo
        g = q.row_hi - q.row_lo
        cap, skip_lb, warp = _warp_window(q, lane, p_ax)
        inv, _tile, _phi, w_lo, w_hi = warp
        cols = off + q.idx[lane // TILE]                   # [n, m]
        rows = d.gather(1, cols).reshape(-1, q.m // CAND_UNROLL,
                                         CAND_UNROLL)
        dch = rows.amin(-1) if mn else rows.amax(-1)       # [n, C]
        if mn and cull.early_out:
            w_hi = _early_out_end(q, dch, warp)
        ci = torch.arange(dch.shape[1], device=d.device)
        inwin = (ci >= w_lo[inv][:, None]) & (ci < w_hi[inv][:, None])
        if mn:
            win = torch.where(inwin, dch, _BIG).amin(1)
            val = torch.minimum(win, cap)
        else:
            win = torch.where(inwin, dch, -_BIG).amax(1)
            excl = torch.where(q.count[lane // TILE] < g, 2.0 * eps, -_BIG)
            val = torch.maximum(torch.maximum(win, skip_lb), excl)
        d[:, off:off + g] = val[:, None]
    return sdf.combine(scene.plan, d)


def _lane_chunks(lane: Tensor, rows: int):
    """Split the ascending active lanes into pieces of about ``rows``
    that never cut a WINDOW_LANES group (one host sync)."""
    n = lane.shape[0]
    rows = max(rows, WINDOW_LANES)
    if n <= rows:
        return [(0, n)]
    at = torch.arange(rows, n, rows, device=lane.device)
    start = lane[at] // WINDOW_LANES * WINDOW_LANES
    cuts = torch.searchsorted(lane, start).tolist()
    bounds = sorted({0, n, *cuts})
    return list(zip(bounds[:-1], bounds[1:]))


def _culled_march_dist(scene: FlatScene, cull: CullTables, epsilon: Tensor):
    """``sphere_trace``'s distance hook for the culled plain march."""
    rows = _chunk_elems(epsilon.device) // max(scene.num_prims, 1)

    def dist(idx, p, t):
        out = torch.empty_like(t)
        for s, e in _lane_chunks(idx, rows):
            out[s:e] = _culled_distance(scene, cull, idx[s:e], p[s:e],
                                        t[s:e], epsilon[idx[s:e]])
        return out
    return dist


def _walk_codes(scene: FlatScene, d: Tensor, pair_vals, culled) -> Tensor:
    """Signed winning-leaf code of slot mode on the distances ``d [n, K]``,
    group by group as K3 folds them: each group's pair results first
    (``pair_vals[gid]``, strict), then its dense members (lowest slot
    first, strict), then the CSG tree (earlier operand wins ties)."""
    groups, tree = _build_groups(scene.plan)
    n, dev = d.shape[0], d.device
    vals = []
    for g in groups:
        mn = g.op == "min"
        v = torch.full((n,), _BIG if mn else -_BIG, device=dev)
        c = torch.zeros(n, device=dev)
        for pv, pc in pair_vals.get(g.gid, ()):
            better = pv < v if mn else pv > v
            v, c = torch.where(better, pv, v), torch.where(better, pc, c)
        dense = sorted(s for s in g.slots if s not in culled)
        if dense:
            sub = d[:, dense]
            win = sub.argmin(1) if mn else sub.argmax(1)
            red = sub.gather(1, win[:, None])[:, 0]
            code = torch.as_tensor(dense, device=dev)[win].float() + 1.0
            better = red < v if mn else red > v
            v, c = torch.where(better, red, v), torch.where(better, code, c)
        vals.append((v, c))

    def walk(node):
        if node[0] == "g":
            return vals[node[1]]
        op, _k, kids = node
        parts = [walk(k) for k in kids]
        if op == "subtract":
            (va, ca), (vb, cb) = parts
            sel = va > -vb
            return torch.maximum(va, -vb), torch.where(sel, ca, -cb)
        out = parts[0]
        for v in parts[1:]:
            sel = out[0] <= v[0] if op == "union" else out[0] >= v[0]
            out = (torch.where(sel, out[0], v[0]),
                   torch.where(sel, out[1], v[1]))
        return out

    return walk(tree)[1]


def _scan_pairs(scene: FlatScene, cull: CullTables, lane: Tensor,
                d: Tensor, eps: Tensor):
    """K3's scan of every culled pair on the distances ``d [n, K]`` of
    lanes ``lane``: each pair reads its tile's first
    ``ceil8(min(count, m))`` table rows (``culled_sp`` :1051-1144; ties to
    the lowest slot); a max group's extremum is floored at 2·eps, owned by
    no leaf, when the cone excluded members (:1122-1138).  Returns
    ``(scans, evaluated)``: ``scans[gid]`` lists ``(value, slot, owned)``
    per pair of the group (``slot`` the winning global slot, ``owned``
    False where the value is the floor or no row was scanned), and
    ``evaluated [n, K]`` marks the primitives the lane's pass saw."""
    n, dev = d.shape[0], d.device
    tile = lane // TILE
    evaluated = torch.ones_like(d, dtype=torch.bool)
    scans = {}
    for q in cull.tables:
        mn = q.op == "min"
        off = kind_offset(scene, q.kind) + q.row_lo
        g = q.row_hi - q.row_lo
        count = q.count[tile]
        n_rows = (torch.clamp_max(count, q.m) + CAND_UNROLL - 1) \
            // CAND_UNROLL * CAND_UNROLL
        scanned = torch.arange(q.m, device=dev)[None, :] < n_rows[:, None]
        cols = off + q.idx[tile]
        rows = d.gather(1, cols)
        bd = torch.where(scanned, rows, _BIG if mn else -_BIG)
        bd = bd.amin(1) if mn else bd.amax(1)
        wins = scanned & (rows == bd[:, None])
        slot = torch.where(wins, cols, 2 ** 62).amin(1)
        owned = wins.any(1)
        if not mn:
            low = (count < g) & (bd < 2.0 * eps)
            bd = torch.where(low, 2.0 * eps, bd)
            owned = owned & ~low
        scans.setdefault(q.gid, []).append(
            (bd, torch.where(owned, slot, 0), owned))
        seen = torch.zeros((n, g), device=dev).scatter_add_(
            1, q.idx[tile], scanned.float())
        evaluated[:, off:off + g] = seen > 0
    return scans, evaluated


def _material_argmin(scene: FlatScene, d: Tensor, evaluated: Tensor):
    """K3's material: argmin of the leaf distance over the CSG-visible
    primitives the pass evaluated (first minimum wins; -1 when none)."""
    n, dev = d.shape[0], d.device
    vis = torch.as_tensor(scene.visible_material_slots(), device=dev)
    if not vis.numel():
        return torch.full((n,), -1, dtype=torch.int32, device=dev)
    ok = evaluated[:, vis]
    win = torch.where(ok, d[:, vis], _BIG).argmin(1)
    mat = torch.as_tensor(np.asarray(scene.visible_material(), np.int32),
                          device=dev)[vis]
    return torch.where(ok.any(1), mat[win], -1)


def _culled_surface(scene: FlatScene, cull: CullTables, lane: Tensor,
                    p: Tensor, eps: Tensor):
    """Plain version of culled K3, slot mode, at hit points ``p`` of lanes
    ``lane``: the pairs' scans (:func:`_scan_pairs`), the winning-leaf code
    folded as the kernel folds it, and the material argmin over the dense
    entries plus the scanned rows.  Returns ``(code, material)``."""
    d = sdf.prim_distances(scene, p)
    scans, evaluated = _scan_pairs(scene, cull, lane, d, eps)
    pair_vals = {gid: [(bd, torch.where(owned, slot + 1, 0).float())
                       for bd, slot, owned in rows]
                 for gid, rows in scans.items()}
    culled = _culled_slots(scene.kind_counts, cull.pairs)
    code = _walk_codes(scene, d, pair_vals, culled)
    return code, _material_argmin(scene, d, evaluated)


def _surface_ad(scene: FlatScene, cull: CullTables | None, lane: Tensor,
                p: Tensor, eps: Tensor):
    """Plain version of K3's AD mode at hit points ``p`` of lanes ``lane``:
    the scene value folded as the kernel folds it — per group the first
    extremum (culled pairs first, each by its scan, then the dense members
    in ascending slot, strict compares) or ``-k·log(max(Σe, 1e-30))``,
    through the tree with subtract's ``max(a, -b)`` and the smooth union —
    and its gradient by autograd.  Every selection is a ``where``, so the
    gradient is the selected operand's; a value no leaf owns (an empty
    group, a floored max group) carries the gradient (0, 0, 1) as in
    ``surface_eval`` (:1317-1321, :1430-1432).  Returns ``(gradient
    [n, 3], material)``."""
    groups, tree = _build_groups(scene.plan)
    with torch.enable_grad():
        q = p.detach().requires_grad_(True)
        d = sdf.prim_distances(scene, q)
        dv = d.detach()
        if cull is None:
            scans, evaluated = {}, torch.ones_like(dv, dtype=torch.bool)
            culled = set()
        else:
            scans, evaluated = _scan_pairs(scene, cull, lane, dv, eps)
            culled = _culled_slots(scene.kind_counts, cull.pairs)
        unowned = q[:, 2] - q[:, 2].detach()    # value 0, gradient (0, 0, 1)
        vals = []
        for g in groups:
            if g.op == "sumexp":
                e = torch.exp(-d[:, sorted(g.slots)] / g.k).sum(1)
                vals.append(-g.k * torch.log(torch.clamp_min(e, 1e-30)))
                continue
            mn = g.op == "min"
            v = unowned + (_BIG if mn else -_BIG)
            for bd, slot, owned in scans.get(g.gid, ()):
                pv = torch.where(owned, d.gather(1, slot[:, None])[:, 0],
                                 unowned + bd)
                v = torch.where(bd < v if mn else bd > v, pv, v)
            dense = sorted(s for s in g.slots if s not in culled)
            if dense:
                sub = dv[:, dense]
                win = sub.argmin(1) if mn else sub.argmax(1)
                red = d[:, dense].gather(1, win[:, None])[:, 0]
                v = torch.where(red < v if mn else red > v, red, v)
            vals.append(v)

        def walk(node):
            if node[0] == "g":
                return vals[node[1]]
            op, k, kids = node
            parts = [walk(x) for x in kids]
            if op == "subtract":
                a, b = parts
                return torch.where(a > -b, a, -b)
            if op == "smooth_union":
                e = sum(torch.exp(-v / k) for v in parts)
                return -k * torch.log(torch.clamp_min(e, 1e-30))
            out = parts[0]
            for v in parts[1:]:
                out = torch.where(out <= v if op == "union" else out >= v,
                                  out, v)
            return out

        (grad,) = torch.autograd.grad(walk(tree).sum(), q)
    return grad, _material_argmin(scene, dv, evaluated)


def march_plain(scene: FlatScene, origin: Tensor, direction: Tensor,
                length: Tensor, epsilon: Tensor, t0: Tensor, *,
                max_steps: int, omega: float, occlusion: bool = False,
                cull: CullTables | None = None, sign: Tensor | None = None):
    """Plain version of K1/K2: the kernel's stepping (per-lane
    ``max_steps`` cap, ω-relaxation with the overstep revert) on tensors,
    over ``sdf.scene_distance`` — or, with ``cull``, over the windowed
    culled distance at the kernel's WINDOW_LANES granularity — times the
    per-lane ``sign [N]`` when given.  Returns ``(t, hit, d, steps)``, or
    ``(hit, steps)`` for occlusion."""
    dist = None if cull is None else \
        _culled_march_dist(scene, cull, epsilon)
    t, hit, d, steps, _it = sphere_trace(scene, origin, direction, length,
                                         epsilon, t0, max_steps, omega,
                                         sign=sign, dist=dist)
    return (hit, steps) if occlusion else (t, hit, d, steps)


def march_stage_plan(prog: Program, cull: CullTables | None,
                     reserve: int = 0, members: bool = False):
    """The shared-memory plan of a K1/K2 launch of ``prog`` on ``cull``
    (``reserve``: bytes of the kernel's own at the end): a
    :class:`cull.StagePlan` for the culled form, a
    :class:`cull.DenseStagePlan` for the dense form (``members``: with
    each entry's material and slot, as K3 reads them)."""
    if cull is None:
        return dense_stage_plan(prog.ops.shape[0], prog.runs.shape[0],
                                4 * prog.packed.numel(),
                                prog.ent_ms.shape[0] if members else 0,
                                reserve)
    return stage_plan(tuple(q.m for q in cull.tables), prog.ops.shape[0],
                      prog.n_dense, reserve)


def surface_stage_plan(prog: Program, cull: CullTables | None):
    """The shared-memory plan of a K3 launch: K1/K2's (the dense form's
    with each entry's material and slot), then the block's hit-lane
    list."""
    return march_stage_plan(prog, cull, SURF_LIST_BYTES, members=True)


def _note_dense(prog: Program, plan: DenseStagePlan, launch: str) -> None:
    """Record in :data:`DENSE` the program of a dense ``launch``
    (``march`` for K1/K2, ``surface`` for K3) and where its block finds
    it: the ops and runs always staged, the packed rows and (K3) each
    entry's material and slot where ``plan`` stages them."""
    staged = (STAGE_OP_BYTES * prog.ops.shape[0]
              + STAGE_RUN_BYTES * prog.runs.shape[0])
    parts = [(plan.rows_off, plan.rows_bytes)]
    if launch == "surface":
        parts.append((plan.ms_off, STAGE_MEMBER_BYTES * prog.ent_ms.shape[0]))
    device = 0
    for off, n in parts:
        if off >= 0:
            staged += n
        else:
            device += n
    DENSE.update({"ops": prog.ops.shape[0], "kind_runs": prog.runs.shape[0],
                  "stack": prog.stack, f"{launch}_staged_bytes": staged,
                  f"{launch}_device_bytes": device})


def _lane_steps(dev: torch.device) -> Tensor | None:
    """The lane-step counter of ``dev`` (:data:`LANE_STEPS`), made at the
    first dense launch outside a graph capture: one made inside would be
    zeroed again by each replay.  ``None`` while capturing without one."""
    key = str(dev)
    c = LANE_STEPS.get(key)
    if c is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            return None
        c = LANE_STEPS[key] = torch.zeros(1, dtype=torch.int64, device=dev)
    return c


def _launch_march(entry: str, scene: FlatScene, origin: Tensor,
                  direction: Tensor, length: Tensor, epsilon: Tensor,
                  t0: Tensor, max_steps: int, omega: float, occlusion: bool,
                  cull: CullTables | None, sign: Tensor | None, extra=()):
    """Check the lanes, allocate the outputs and call the C entry point
    ``entry``: ``ft_march`` (the culled form) or its instrumented twin,
    which take the tables and the plan, or ``ft_march_dense`` (the dense
    form), which takes the plan and its block's width
    (:func:`cull.dense_march_threads`) and reports the blocks an SM;
    ``extra`` goes before the stream (the twin's sections buffer; the
    dense form's ray counter, issue count and lane-step counter).
    Returns ``(t, hit int32, d, steps)`` with ``t`` and ``d`` None for
    occlusion."""
    n = origin.shape[0]
    _check_lanes(n, origin=_f32("origin", origin),
                 direction=_f32("direction", direction),
                 length=_f32("length", length),
                 epsilon=_f32("epsilon", epsilon), t0=_f32("t0", t0))
    if sign is not None:
        _check_lanes(n, sign=_f32("sign", sign))
    if cull is not None:
        _check_lanes(n, oa=_f32("oa", cull.oa), ca=_f32("ca", cull.ca))
    lib = library()
    dev = origin.device
    prog = lower_program(scene, dev, () if cull is None else cull.pairs)
    f32 = dict(dtype=torch.float32, device=dev)
    hit = torch.empty(n, dtype=torch.int32, device=dev)
    steps = torch.empty(n, dtype=torch.int32, device=dev)
    t = None if occlusion else torch.empty(n, **f32)
    d = None if occlusion else torch.empty(n, **f32)
    s = prog.struct()
    # what the blocks stage in shared memory: sized from shapes alone
    plan = march_stage_plan(prog, cull)
    width = ()
    if cull is None:
        _note_dense(prog, plan, "march")
        # the block's width from the plan's size; the blocks an SM come back
        width, per_sm = (dense_march_threads(plan.bytes),), ctypes.c_int(0)
        extra = (*extra, ctypes.byref(per_sm))
    tables = () if cull is None else (ctypes.byref(_cull_struct(cull)),)
    stage = _dense_stage_struct(plan) if cull is None \
        else _stage_struct(plan)
    with on_device(dev):
        err = getattr(lib, entry)(
            origin.data_ptr(), direction.data_ptr(), length.data_ptr(),
            epsilon.data_ptr(), t0.data_ptr(),
            None if sign is None else sign.data_ptr(), n, ctypes.byref(s),
            *tables, ctypes.byref(stage), *width, int(max_steps),
            float(omega), int(occlusion),
            None if occlusion else t.data_ptr(), hit.data_ptr(),
            None if occlusion else d.data_ptr(), steps.data_ptr(), *extra,
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, entry)
    if width and n:
        DENSE.update(march_threads=width[0],
                     march_blocks_per_sm=per_sm.value)
    if n:
        anchor("march_kernel" if cull is not None else "march_dense_kernel")
    return t, hit, d, steps


def march_kernel(scene: FlatScene, origin: Tensor, direction: Tensor,
                 length: Tensor, epsilon: Tensor, t0: Tensor, *,
                 max_steps: int, omega: float, occlusion: bool = False,
                 cull: CullTables | None = None, sign: Tensor | None = None,
                 issued: Tensor | None = None):
    """K1 (``occlusion=False``) / K2 (``occlusion=True``) over flat lanes:
    ``origin``/``direction [N, 3]``, ``length``/``epsilon``/``t0 [N]``
    (lanes with ``length <= 0`` or ``t0 >= length`` never step); ``cull``
    selects the culled form; ``sign [N]`` (±1) multiplies the scene
    distance per lane, -1 marching inside the solid.  ``issued``: an int64
    ``[1]`` CUDA tensor to which the dense form adds its warps' march
    iterations (32 issued evaluations each: the denominator of its lane
    efficiency; a diagnostic).  The dense form runs in the span
    ``march.dense`` and adds its lane-steps to :data:`LANE_STEPS`.
    Returns ``(t, hit, d, steps)``, or ``(hit, steps)`` for occlusion."""
    with span("march.dense") if cull is None else contextlib.nullcontext():
        return _march(scene, origin, direction, length, epsilon, t0,
                      max_steps, omega, occlusion, cull, sign, issued)


def _march(scene, origin, direction, length, epsilon, t0, max_steps, omega,
           occlusion, cull, sign, issued):
    if not _route(origin):
        out = march_plain(scene, origin, direction, length, epsilon, t0,
                          max_steps=max_steps, omega=omega,
                          occlusion=occlusion, cull=cull, sign=sign)
        if cull is None:
            _lane_steps(origin.device).add_(out[-1].sum())
        return out
    extra = ()
    if cull is None:
        if issued is not None and (issued.dtype != torch.int64
                                   or issued.device != origin.device):
            raise TypeError("issued must be an int64 tensor on the rays' "
                            "device")
        # the persistent grid's ray counter, zeroed on the launch's stream;
        # its last refills overshoot the ray count by up to 32 a warp
        if origin.shape[0] > 2 ** 31 - 2 ** 20:
            raise ValueError("too many rays for one dense launch")
        nxt = torch.empty(1, dtype=torch.int32, device=origin.device)
        evals = _lane_steps(origin.device)
        extra = (nxt.data_ptr(),
                 None if issued is None else issued.data_ptr(),
                 None if evals is None else evals.data_ptr())
    t, hit, d, steps = _launch_march(
        "ft_march" if cull is not None else "ft_march_dense", scene, origin,
        direction, length, epsilon, t0, max_steps, omega, occlusion, cull,
        sign, extra)
    name = "occlusion" if occlusion else "march"
    LAUNCHES[name if cull is None else name + "_culled"] += 1
    if occlusion:
        return hit.bool(), steps
    return t, hit.bool(), d, steps


# sections and counts of the instrumented twin, in the order of the enums
# SEC_* and CNT_* of csrc/ft_sdf.cuh
SECTIONS = ("ray_load", "window_stats", "candidate_rows", "early_out",
            "dense_and_tree", "stepping", "store")
SECTION_COUNTS = ("warp_steps", "chunks_scanned", "chunks_cut")
SECTION_LAUNCHES = {"march_sections": 0}


def march_sections(scene: FlatScene, origin: Tensor, direction: Tensor,
                   length: Tensor, epsilon: Tensor, t0: Tensor, *,
                   max_steps: int, omega: float, occlusion: bool = False,
                   cull: CullTables | None = None,
                   sign: Tensor | None = None):
    """The instrumented twin of K1/K2 (CUDA tensors only): the same kernel
    built with per-warp ``clock64()`` deltas around its sections.  Returns
    ``(outputs, clocks, counts)``: the kernel's outputs as
    :func:`march_kernel` gives them, the clock cycles summed over warps per
    name of :data:`SECTIONS` and the counts per name of
    :data:`SECTION_COUNTS` (warp iterations, window chunks scanned and
    cut by the early-out).  A diagnostic for ``chip_smoke.py``: slower than
    the kernel, on no path of the renderer, counted apart in
    :data:`SECTION_LAUNCHES`."""
    if origin.device.type != "cuda":
        raise ValueError("march_sections needs CUDA tensors")
    if cull is None:
        raise ValueError("march_sections instruments the culled form")
    buf = torch.zeros(len(SECTIONS) + len(SECTION_COUNTS),
                      dtype=torch.int64, device=origin.device)
    t, hit, d, steps = _launch_march(
        "ft_march_sections", scene, origin, direction, length, epsilon, t0,
        max_steps, omega, occlusion, cull, sign, extra=(buf.data_ptr(),))
    SECTION_LAUNCHES["march_sections"] += 1
    vals = buf.tolist()
    out = (hit.bool(), steps) if occlusion else (t, hit.bool(), d, steps)
    return out, dict(zip(SECTIONS, vals)), \
        dict(zip(SECTION_COUNTS, vals[len(SECTIONS):]))


def leaf_gradient(scene: FlatScene, p: Tensor, code: Tensor) -> Tensor:
    """∇_p of the signed winning leaf ``sign(code)·d_{|code|-1}(p)`` by
    autograd, one primitive per lane (zero where ``code == 0``)."""
    slot = code.abs().long() - 1
    g = torch.zeros_like(p)
    off = 0
    for kind, cnt in scene.kind_counts:
        sel = torch.nonzero((slot >= off) & (slot < off + cnt)).squeeze(1)
        if sel.numel():
            rows = scene.prim_params[kind].detach()[slot[sel] - off]
            with torch.enable_grad():
                q = p[sel].detach().requires_grad_(True)
                dist = sdf.DIST_FNS[kind](rows[:, None, :], q)[:, 0]
                (gk,) = torch.autograd.grad(dist.sum(), q)
            g[sel] = gk
        off += cnt
    return g * torch.sign(code)[:, None]


def surface_plain(scene: FlatScene, origin: Tensor, direction: Tensor,
                  t: Tensor, epsilon: Tensor, hit: Tensor,
                  cull: CullTables | None = None):
    """Plain version of K3 at ``p = o + (t - ε)·d`` on hit lanes.  Slot
    mode: ``winning_leaf_code`` + the leaf gradient by autograd (unit
    normal via ``g·rsqrt(g·g + 1e-20)``) + the material argmin; with
    ``cull``, culled groups see only their tile's scanned candidates
    (:func:`_culled_surface`).  A plan with a smooth union takes
    :func:`surface_ad_plain`.  Miss lanes: normal (0, 0, 1), material -1,
    code 0.  Returns ``(normal, midx, code)``."""
    if not slot_surface_mode(scene.plan):
        return surface_ad_plain(scene, origin, direction, t, epsilon, hit,
                                cull=cull)
    n = origin.shape[0]
    dev = origin.device
    normal = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    normal[:, 2] = 1.0
    midx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    code = torch.zeros(n, dtype=torch.float32, device=dev)
    idx = torch.nonzero(hit).squeeze(1)
    if idx.numel():
        p = origin[idx] + (t[idx] - epsilon[idx])[:, None] * direction[idx]
        if cull is None:
            c = chunked(sdf.winning_leaf_code, scene, p)
            midx[idx] = chunked(sdf.material_index_at, scene, p)
        else:
            rows = max(1, _chunk_elems(dev) // max(scene.num_prims, 1))
            parts = [_culled_surface(scene, cull, idx[s:s + rows],
                                     p[s:s + rows], epsilon[idx[s:s + rows]])
                     for s in range(0, idx.numel(), rows)]
            c = torch.cat([a for a, _ in parts])
            midx[idx] = torch.cat([b for _, b in parts]).to(torch.int32)
        g = leaf_gradient(scene, p, c)
        normal[idx] = g * torch.rsqrt(torch.sum(g * g, -1) + 1e-20)[:, None]
        code[idx] = c
    return normal, midx, code


def surface_ad_plain(scene: FlatScene, origin: Tensor, direction: Tensor,
                     t: Tensor, epsilon: Tensor, hit: Tensor,
                     cull: CullTables | None = None):
    """Plain version of K3's AD mode at ``p = o + (t - ε)·d`` on hit lanes:
    the gradient of the scene value as the kernel folds it
    (:func:`_surface_ad`; with ``cull`` the culled groups see their tile's
    scanned candidates) as the unit normal ``g·rsqrt(g·g + 1e-20)``, and
    the material argmin.  Miss lanes: normal (0, 0, 1), material -1; code
    0 on every lane (a blend has no winning leaf).  Returns
    ``(normal, midx, code)``."""
    n = origin.shape[0]
    dev = origin.device
    normal = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    normal[:, 2] = 1.0
    midx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    idx = torch.nonzero(hit).squeeze(1)
    p = origin[idx] + (t[idx] - epsilon[idx])[:, None] * direction[idx]
    # autograd keeps the [rows, K] intermediates of every distance function
    rows = max(1, _chunk_elems(dev) // (4 * max(scene.num_prims, 1)))
    for s in range(0, idx.numel(), rows):
        part = idx[s:s + rows]
        g, m = _surface_ad(scene, cull, part, p[s:s + rows], epsilon[part])
        normal[part] = g * torch.rsqrt(torch.sum(g * g, -1) + 1e-20)[:, None]
        midx[part] = m.to(torch.int32)
    return normal, midx, torch.zeros(n, dtype=torch.float32, device=dev)


def surface_kernel(scene: FlatScene, origin: Tensor, direction: Tensor,
                   t: Tensor, epsilon: Tensor, hit: Tensor,
                   cull: CullTables | None = None):
    """K3: ``(normal [N, 3], material [N] int32, code [N])`` at the epsilon
    backed-off hit points of the lanes where ``hit [N]`` (bool) is set —
    slot mode for plans of min/max alone, AD mode for plans with a smooth
    union (see :func:`surface_plain`, :func:`surface_ad_plain`).  The
    dense form runs in the span ``surface.dense``."""
    with span("surface.dense") if cull is None else contextlib.nullcontext():
        return _surface(scene, origin, direction, t, epsilon, hit, cull)


def _surface(scene, origin, direction, t, epsilon, hit, cull):
    ad = not slot_surface_mode(scene.plan)
    if not _route(origin):
        return surface_plain(scene, origin, direction, t, epsilon, hit,
                             cull=cull)
    n = origin.shape[0]
    if hit.dtype != torch.bool:
        raise TypeError(f"hit must be bool, got {hit.dtype}")
    _check_lanes(n, origin=_f32("origin", origin),
                 direction=_f32("direction", direction), t=_f32("t", t),
                 epsilon=_f32("epsilon", epsilon), hit=hit)
    lib = library()
    dev = origin.device
    prog = lower_program(scene, dev, () if cull is None else cull.pairs)
    normal = torch.empty((n, 3), dtype=torch.float32, device=dev)
    midx = torch.empty(n, dtype=torch.int32, device=dev)
    code = torch.empty(n, dtype=torch.float32, device=dev)
    s = prog.struct()
    # the staged program and tables (or packed rows), then the hit-lane
    # list: from shapes
    plan = surface_stage_plan(prog, cull)
    if cull is None:
        _note_dense(prog, plan, "surface")
        tables, stage = (), _dense_stage_struct(plan)
    else:
        tables = (ctypes.byref(_cull_struct(cull)),)
        stage = _stage_struct(plan)
    entry = ("ft_surface_ad" if ad else "ft_surface") \
        + ("_dense" if cull is None else "")
    with on_device(dev):
        err = getattr(lib, entry)(
            origin.data_ptr(), direction.data_ptr(), t.data_ptr(),
            epsilon.data_ptr(), hit.data_ptr(), n, ctypes.byref(s),
            *tables, ctypes.byref(stage), normal.data_ptr(),
            midx.data_ptr(), code.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, entry)
    if n:
        anchor(entry[len("ft_"):] + "_kernel")
    name = "surface_ad" if ad else "surface"
    LAUNCHES[name if cull is None else name + "_culled"] += 1
    return normal, midx, code


# ---------------------------------------------------------------------------
# host glue (pallas_march_raw)
# ---------------------------------------------------------------------------

def cull_pairs_for(scene: FlatScene, cfg: MarchConfig):
    """The culled pairs a march with ``cfg`` uses (none when ``cull`` is
    off or no group reaches ``cull_threshold``)."""
    if not cfg.cull:
        return ()
    return _cull_pairs(scene.kind_counts, scene.plan, cfg.cull_threshold)


def _overflow_on_host(cull: CullTables | None):
    """Start copying the overflow flag to the host; returns a callable
    that waits for the copy only (not for kernels queued after it)."""
    if cull is None or cull.overflow is None:
        return lambda: False
    if not cull.overflow.is_cuda:
        return lambda: bool(cull.overflow)
    flag = torch.empty((), dtype=torch.bool, pin_memory=True)
    flag.copy_(cull.overflow, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def read():
        done.synchronize()
        return bool(flag)
    return read


@torch.no_grad()
def march_tables(scene: FlatScene, rays: Rays, cfg: MarchConfig,
                 cone_apex: Tensor | None = None, sign: Tensor | None = None):
    """A flat batch's march range and tables as K1/K2/K3 read them:
    ``(t0, miss0, length, cull)`` — the root-bound skip's start, the lanes
    that miss the bound, the budget clamped to the bound's exit (0 on those
    lanes), and the culled pairs' candidate tables (``None`` without
    culled pairs)."""
    n = rays.origin.shape[0]
    dev = rays.origin.device
    t0 = torch.zeros(n, dtype=torch.float32, device=dev)
    miss0 = torch.zeros(n, dtype=torch.bool, device=dev)
    length = rays.length
    if cfg.bound_skip:
        t0, miss0, t_exit = bound_skip_start(scene, rays, sign)
        length = torch.minimum(length, t_exit)
    length = torch.where(miss0, 0.0, length).contiguous()
    t0 = t0.contiguous()
    pairs = cull_pairs_for(scene, cfg)
    cull = None
    if pairs:
        cull = build_pair_tables(scene, rays.origin.contiguous(),
                                 rays.direction.contiguous(), t0, length,
                                 rays.epsilon.contiguous(), pairs,
                                 cfg.cull_m, cfg.cull_window_clamp,
                                 cone_apex, cfg.cull_early_out)
    return t0, miss0, length, cull


@span("march")
@torch.no_grad()
def cuda_march_raw(scene: FlatScene, rays: Rays, cfg: MarchConfig,
                   want_surface: bool = False, occlusion: bool = False,
                   cone_apex: Tensor | None = None,
                   sign: Tensor | None = None):
    """March a flat ray batch ``[N]`` through K1 (or K2), then K3.

    Applies the root-bound skip and clamps the budget to the bound's exit
    (march_kernel.py:1809-1818); lanes that miss the bound get a zero
    budget.  With ``cfg.cull`` and culled pairs the launches read per-tile
    candidate tables (``cull.build_pair_tables``; ``cone_apex`` selects the
    converging cone of point-light shadow rays).  ``sign [N]`` (±1)
    multiplies the marched distance per lane: -1 lanes march inside the
    solid and skip the bound skip; the surface pass never takes it, its
    normal stays the outward gradient (march_kernel.py:2059-2062).
    ``occlusion=True`` returns the hit mask ``[N] bool`` only;
    ``want_surface=True`` returns ``(MarchResult, normal [N, 3],
    material [N], code [N])`` with ``material = -1`` off hit lanes."""
    check_config(cfg)
    origin = rays.origin.contiguous()
    direction = rays.direction.contiguous()
    epsilon = rays.epsilon.contiguous()
    frame = deferred.current()
    # a deferred frame's culled call is a site; a promoted site builds the
    # full-group tables at once (ops/deferred.py)
    site = frame is not None and bool(cull_pairs_for(scene, cfg))
    if site and frame.next_site_promoted():
        cfg = _full_tables(cfg, cull_pairs_for(scene, cfg))
    t0, miss0, length, cull = march_tables(scene, rays, cfg, cone_apex,
                                           sign)
    pairs = cull.pairs if cull is not None else ()
    overflowed = _overflow_on_host(cull) if frame is None else None
    kw = dict(max_steps=cfg.max_steps, omega=cfg.relax_omega, cull=cull,
              sign=sign)
    if occlusion:
        hit, _steps = march_kernel(scene, origin, direction, length, epsilon,
                                   t0, occlusion=True, **kw)
        out = hit & ~miss0
    else:
        t, hit_k, d, steps = march_kernel(scene, origin, direction, length,
                                          epsilon, t0, **kw)
        hit = hit_k & ~miss0
        out = MarchResult(hit=hit, t=t, distance=d, steps=steps)
        if want_surface:
            normal, midx, code = surface_kernel(scene, origin, direction, t,
                                                epsilon, hit_k, cull=cull)
            out = (out, normal, torch.where(hit, midx, -1), code)
    # a tile's candidate count exceeded its table, so its windows were
    # unsound.  A deferred frame (ops/deferred.py) records the site's
    # overflow, raises its flag on it and is run again eagerly (or, for a
    # site it then promotes, again deferred); the eager call reads the
    # flag on the host (its one host sync) and runs the same path again
    # with full-group tables (m >= every group: cannot overflow,
    # march_kernel.py:2018-2043, :2092-2096); the re-run's launches count
    # too
    if frame is not None:
        if site:
            frame.add_site(cull.overflow)
        return out
    if overflowed():
        return cuda_march_raw(scene, rays, _full_tables(cfg, pairs),
                              want_surface, occlusion, cone_apex, sign)
    return out


def _full_tables(cfg: MarchConfig, pairs) -> MarchConfig:
    """``cfg`` with candidate tables of the largest culled group: no
    tile's count can exceed them."""
    big = max(r1 - r0 for (_g, _k, _ki, r0, r1) in pairs)
    return dataclasses.replace(cfg, cull_m=big, cull_m_shadow=big)
