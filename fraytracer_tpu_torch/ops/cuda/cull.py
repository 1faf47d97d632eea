"""Host prep of the culled kernels: per-tile cones and axially sorted
candidate tables, and the shared-memory plans of the kernels that read
them.

Counterpart of the jnp host prep in
``fraytracer_tpu/ops/pallas/march_kernel.py``; the JAX names are kept:

* :func:`_build_groups` — the plan's group-reduced form (:302);
* :func:`_cull_pairs` — the static (group, kind) pairs worth culling (:343);
* :class:`TileCones` / :func:`_tile_cones` — per-tile bounding cones (:415);
* :class:`CandSelect`, :func:`_cand_mask`, :func:`_cone_candidates` — the
  conservative candidacy test and the axially sorted selection (:539, :588);
* :func:`_pair_m` — table rows per pair in whole chunks (:700);
* :func:`build_pair_tables` — the per-pair tables ``pallas_march_raw``
  builds before its ``pallas_call`` (:1857-1977): on CUDA tensors two
  kernel launches a site (``cull_kernel.py``, ``csrc/cull.cu``), on CPU
  tensors :func:`build_pair_tables_plain`, the plain version in PyTorch
  ops;
* :func:`stage_plan` — where a K1/K2/K3 block keeps a tile's slices of
  those tables in shared memory, :func:`dense_stage_plan` where a
  dense-form block keeps the program's packed rows (no JAX counterpart:
  the TPU kernel's BlockSpecs did this), and :func:`dense_march_threads`
  how wide a dense K1/K2 block is for that plan.

A tile is :data:`TILE` consecutive lanes of the flat ray batch: one 32×32
screen block in ``camera.to_blocks``' order, and the JAX kernel's
interpret-mode ``RAY_TILE``.  Lanes past the batch end are padded inactive,
as :1822-1838 do.  The kernels (``csrc/march.cu``) read one table per tile
and compute each march step's candidate window over :data:`WINDOW_LANES`
lanes (a warp); the plain versions in ``march_kernel.py`` use the same
granularity.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...scene.flatten import FlatScene, Plan, visible_materials
from ...types import normalize
from ...utils.profiling import span
from .. import deferred
from ..sdf import _prim_bound_rows

Tensor = torch.Tensor

TILE = 1024         # rays per candidate table (csrc/ft_sdf.cuh FT_TILE)
SUBF = 4            # sub-tiles whose candidacy masks are OR-ed per tile
CAND_UNROLL = 8     # candidates per window chunk (FT_CAND_UNROLL)
WINDOW_LANES = 32   # lanes sharing one per-step window: a warp
PSTRIDE = 10        # parameter floats per row (FT_PSTRIDE); a table row
#                     adds material and global slot (FT_TABLE_W = 12)
MAX_PAIRS = 8       # culled pairs one launch takes (FT_MAX_PAIRS)
TABLE_W = PSTRIDE + 2   # floats of a table row (FT_TABLE_W)
_BIG = 3.0e38

# What a K1/K2/K3 block stages in shared memory (csrc/ft_sdf.cuh FtStage)
SMEM_LIMIT = 232448      # bytes a block may use on the H100 (227 KB)
STAGE_HEADER = 16 + MAX_PAIRS * 48   # the copy barrier + the pair records
STAGE_OP_BYTES = 32      # one staged op of the program (struct SOp)
STAGE_ENTS_MAX = 128     # a culled launch's dense entries staged at most,
#                          TABLE_W floats each
SURF_LIST_BYTES = 144    # K3's hit-lane list at the plan's end: a count a
#                          warp, a byte a lane (FT_SURF_LIST_BYTES)
# What a dense-form block stages (csrc/ft_sdf.cuh FtDenseStage)
DENSE_HEADER = 16        # the copy barrier
STAGE_RUN_BYTES = 16     # one run of the program's dense entries (int4)
STAGE_MEMBER_BYTES = 8   # K3: an entry's (material, slot) (int2)
# How wide a dense K1/K2 block is (dense_march_threads)
BLOCK = 128              # threads of a K1/K2/K3 block (FT_BLOCK)
DENSE_THREADS = 768      # the dense K1/K2's threads an SM, as its register
#                          budget allows them (FT_DENSE_THREADS)
SMEM_BLOCK_RESERVED = 1024   # shared memory the system keeps a block
SMEM_PER_SM = SMEM_LIMIT + SMEM_BLOCK_RESERVED   # an H100 SM's (228 KB)


# ---------------------------------------------------------------------------
# Plan → group-reduced form (march_kernel.py:_build_groups :302)
# ---------------------------------------------------------------------------

class _Group:
    """A plan node's primitive set with its reduction op
    ('min', 'max' or 'sumexp'; k is the smooth strength)."""

    __slots__ = ("op", "slots", "k", "gid")

    def __init__(self, op, slots, k, gid):
        self.op, self.slots, self.k, self.gid = op, tuple(slots), k, gid


def _build_groups(plan: Plan):
    """One _Group per plan node that reduces primitives, and the eval tree
    over group ids: tree := ('g', gid) | (op, k, [tree...])."""
    groups: List[_Group] = []

    def visit(p: Plan):
        if p.op == "prim":
            g = _Group("min", p.prim_slots, 0.0, len(groups))
            groups.append(g)
            return ("g", g.gid)
        if p.op == "subtract":
            return ("subtract", 0.0, [visit(p.children[0]),
                                      visit(p.children[1])])
        kids = [visit(c) for c in p.children]
        if p.op in ("union", "intersect"):
            if p.prim_slots:
                op = "min" if p.op == "union" else "max"
                g = _Group(op, p.prim_slots, 0.0, len(groups))
                groups.append(g)
                kids.append(("g", g.gid))
            if len(kids) == 1:
                return kids[0]
            return (p.op, 0.0, kids)
        if p.op == "smooth_union":
            if p.prim_slots:
                g = _Group("sumexp", p.prim_slots, p.k, len(groups))
                groups.append(g)
                kids.append(("g", g.gid))
            return ("smooth_union", p.k, kids)
        raise ValueError(p.op)

    tree = visit(plan)
    return groups, tree


def _blend_reach(tree) -> dict:
    """Per group id, the largest ``k`` of the smooth unions between the
    group and the root (0 when none blends it)."""
    reach = {}

    def visit(node, k_above):
        if node[0] == "g":
            reach[node[1]] = k_above
            return
        op, k, kids = node
        for kid in kids:
            visit(kid, max(k_above, k) if op == "smooth_union" else k_above)

    visit(tree, 0.0)
    return reach


@functools.lru_cache(maxsize=32)
def _grouped(plan: Plan):
    """``_build_groups(plan)`` with the groups' blend reach, kept per plan:
    every march call of a frame asks for the same three."""
    groups, tree = _build_groups(plan)
    return groups, tree, _blend_reach(tree)


# ---------------------------------------------------------------------------
# Static cull-pair selection (:343-382)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _cull_pairs(kind_counts: Tuple[Tuple[str, int], ...], plan: Plan,
                threshold: int):
    """(group, kind) pairs worth cone-culling: 'min' or 'max' groups whose
    slots of one kind form a contiguous, group-uniform row range of
    ≥ ``threshold`` primitives.  Returns tuples
    ``(gid, kind, kind_index, row_lo, row_hi)`` in group order."""
    groups, _tree = _build_groups(plan)
    kind_index = {k: i for i, (k, _) in enumerate(kind_counts)}
    offsets, off = {}, 0
    for k, c in kind_counts:
        offsets[k] = off
        off += c
    slot_gid = np.full(off, -1, np.int32)
    for g in groups:
        slot_gid[list(g.slots)] = g.gid

    pairs = []
    for g in groups:
        if g.op == "sumexp":
            continue
        slots = np.sort(np.asarray(g.slots))
        for kind, cnt in kind_counts:
            lo = offsets[kind]
            in_kind = slots[(slots >= lo) & (slots < lo + cnt)]
            if len(in_kind) < threshold:
                continue
            r0, r1 = int(in_kind.min()) - lo, int(in_kind.max()) + 1 - lo
            if len(in_kind) != r1 - r0:
                continue
            if not (slot_gid[lo + r0:lo + r1] == g.gid).all():
                continue
            pairs.append((g.gid, kind, kind_index[kind], r0, r1))
    return tuple(pairs)


def _pair_m(cull_m: int, group: int) -> int:
    """Candidate-table rows for one pair (:700): ``min(cull_m, group)``
    rounded up to whole CAND_UNROLL chunks, never below one chunk — so
    ``cull_m >= group`` gives ``m >= group`` and cannot overflow."""
    m_arm = min(cull_m, group)
    return max(CAND_UNROLL, -(-m_arm // CAND_UNROLL) * CAND_UNROLL)


# ---------------------------------------------------------------------------
# Shared-memory plan of a K1/K2/K3 launch
# ---------------------------------------------------------------------------

def _round16(b: int) -> int:
    return (b + 15) // 16 * 16


def pair_slice_bytes(m: int) -> dict:
    """Bytes of one tile's slices of a pair with ``m`` table rows, as
    :func:`build_pair_tables` lays them out (each contiguous per tile)."""
    chunks = m // CAND_UNROLL
    return {"table": m * TABLE_W * 4, "keys": 2 * chunks * 4,
            "hsuf": chunks * 4, "misc": 16}


def pair_stage_bytes(m: int) -> int:
    """Shared memory a staged pair takes: table, keys and hsuf of the
    block's tile, each starting at a multiple of 16 bytes."""
    b = pair_slice_bytes(m)
    return b["table"] + _round16(b["keys"]) + _round16(b["hsuf"])


def bulk_slices(m: int) -> Tuple[str, ...]:
    """The slices of a staged pair that one bulk asynchronous copy brings
    in: those whose tile stride — hence every tile's start and size — is a
    multiple of 16 bytes.  The table always is (``m`` is a multiple of 8,
    rows are 48 bytes); keys (``m`` bytes) when 16 divides ``m``, hsuf
    (``m / 2`` bytes) when 32 does.  The block's threads copy the others
    with plain loads."""
    b = pair_slice_bytes(m)
    return tuple(k for k in ("table", "keys", "hsuf") if b[k] % 16 == 0)


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """Where a K1/K2/K3 block keeps what it stages (byte offsets into its
    dynamic shared memory; mirrored by ``struct FtStage``)."""
    bytes: int               # dynamic shared memory of a block
    bulk_bytes: int          # bytes brought in by bulk copies
    ents: int                # dense entries staged (0: read from device)
    ops_off: int             # the program: one 32-byte record an op
    ents_off: int
    pair_off: Tuple[int, ...]   # per pair, -1: read from device memory
    bulk_keys: int           # bit q: pair q's keys go by bulk copy
    bulk_hsuf: int           # bit q: pair q's hsuf go by bulk copy

    @property
    def staged(self) -> Tuple[bool, ...]:
        return tuple(o >= 0 for o in self.pair_off)


@functools.lru_cache(maxsize=256)
def stage_plan(ms: Tuple[int, ...], n_ops: int, n_dense: int,
               reserve: int = 0) -> StagePlan:
    """The shared-memory plan of a K1/K2/K3 launch, from sizes alone:
    ``ms`` the table rows of its culled pairs in program order (none for
    the dense form), the program's op count and its dense entries;
    ``reserve`` bytes (a multiple of 16) at the end are the kernel's own
    (K3: SURF_LIST_BYTES).

    After the header come the program, one record of STAGE_OP_BYTES an op
    (always: a plan whose program does not fit a block's shared memory is
    refused, as one deeper than the value stack is), and the dense entries
    as rows of TABLE_W floats (when there are at most STAGE_ENTS_MAX; more
    are read from device memory).  Then the pairs
    in program order: a pair is staged while the block stays within
    SMEM_LIMIT; one that does not fit is read from device memory, and so is
    every pair after it."""
    if len(ms) > MAX_PAIRS:
        raise NotImplementedError(f"{len(ms)} culled pairs > {MAX_PAIRS}")
    limit = SMEM_LIMIT - reserve
    ops_off = STAGE_HEADER
    at = ops_off + STAGE_OP_BYTES * n_ops
    ents = n_dense if 0 < n_dense <= STAGE_ENTS_MAX else 0
    if at + ents * TABLE_W * 4 > limit:
        raise NotImplementedError(
            f"a CSG program of {n_ops} ops does not fit a block's shared "
            f"memory ({at + ents * TABLE_W * 4 + reserve} > {SMEM_LIMIT} "
            "bytes)")
    offs = {"ops_off": ops_off, "ents_off": at if ents else 0}
    at += ents * TABLE_W * 4
    pair_off, bulk_bytes, bulk_keys, bulk_hsuf = [], 0, 0, 0
    fits = True
    for q, m in enumerate(ms):
        need = pair_stage_bytes(m)
        fits = fits and at + need <= limit
        if not fits:
            pair_off.append(-1)
            continue
        pair_off.append(at)
        at += need
        b = pair_slice_bytes(m)
        bulk = bulk_slices(m)
        bulk_bytes += sum(b[k] for k in bulk)
        bulk_keys |= ("keys" in bulk) << q
        bulk_hsuf |= ("hsuf" in bulk) << q
    return StagePlan(bytes=at + reserve, bulk_bytes=bulk_bytes, ents=ents,
                     pair_off=tuple(pair_off), bulk_keys=bulk_keys,
                     bulk_hsuf=bulk_hsuf, **offs)


@dataclasses.dataclass(frozen=True)
class DenseStagePlan:
    """Where a dense-form block (K1/K2 ``march_dense_kernel``, dense K3)
    keeps what it stages (byte offsets into its dynamic shared memory;
    mirrored by ``struct FtDenseStage``)."""
    bytes: int        # dynamic shared memory of a block
    ops_off: int      # the program: one STAGE_OP_BYTES record an op
    runs_off: int     # the kind runs: one STAGE_RUN_BYTES record a run
    ms_off: int       # K3: (material, slot) of each entry; -1: device
    rows_off: int     # the packed rows; -1: read from device memory
    rows_bytes: int   # bytes of the packed rows (one bulk copy if staged)

    @property
    def staged(self) -> bool:
        return self.rows_off >= 0


@functools.lru_cache(maxsize=256)
def dense_stage_plan(n_ops: int, n_runs: int, rows_bytes: int,
                     members: int = 0, reserve: int = 0) -> DenseStagePlan:
    """The shared-memory plan of a dense-form launch, from sizes alone: the
    program's op count, its kind runs, the bytes of its packed rows (each
    entry at its kind's width rounded up to 16 bytes), ``members`` entries
    whose (material, slot) K3 stages (0 for K1/K2) and ``reserve`` bytes
    at the end (K3: SURF_LIST_BYTES).

    After the barrier come the program and the runs (always: a program
    that does not fit a block is refused), then the members while they
    fit, then the packed rows while they fit (one bulk copy).  What does
    not fit is read from device memory through the same code."""
    limit = SMEM_LIMIT - reserve
    ops_off = DENSE_HEADER
    runs_off = ops_off + STAGE_OP_BYTES * n_ops
    at = runs_off + STAGE_RUN_BYTES * n_runs
    if at > limit:
        raise NotImplementedError(
            f"a CSG program of {n_ops} ops and {n_runs} kind runs does not "
            f"fit a block's shared memory ({at + reserve} > {SMEM_LIMIT} "
            "bytes)")
    ms_off = -1
    ms_bytes = _round16(STAGE_MEMBER_BYTES * members)
    if members and at + ms_bytes <= limit:
        ms_off, at = at, at + ms_bytes
    rows_off = -1
    if rows_bytes and at + rows_bytes <= limit:
        rows_off, at = at, at + rows_bytes
    return DenseStagePlan(bytes=at + reserve, ops_off=ops_off,
                          runs_off=runs_off, ms_off=ms_off,
                          rows_off=rows_off, rows_bytes=rows_bytes)


def dense_march_threads(stage_bytes: int) -> int:
    """The width of a dense K1/K2 block whose plan takes ``stage_bytes``
    of shared memory: the smallest multiple of BLOCK at which the blocks
    an SM holds by shared memory reach DENSE_THREADS threads, and no more
    than DENSE_THREADS.  A stage six blocks fit gets BLOCK (six warps a
    scheduler as six blocks); one that fits only one block an SM gets one
    block of DENSE_THREADS, where BLOCK would leave a warp a scheduler to
    wait out its dependent loads alone."""
    blocks = max(SMEM_PER_SM // (stage_bytes + SMEM_BLOCK_RESERVED), 1)
    per_block = -(-DENSE_THREADS // blocks)
    return min(-(-per_block // BLOCK) * BLOCK, DENSE_THREADS)


# ---------------------------------------------------------------------------
# Per-tile cones (:389-527)
# ---------------------------------------------------------------------------

class TileCones(NamedTuple):
    """Per-ray-tile bounding cone statistics (all [G] or [G, 3])."""

    apex: Tensor        # [G, 3] mean active origin (or the converging apex)
    axis: Tensor        # [G, 3] unit mean direction
    cos_half: Tensor    # [G] cone half-angle cosine, clipped ≥ 1e-3
    cos_lo: Tensor      # [G] min direction·axis, unclipped below 0
    t_min: Tensor       # [G] smallest march-entry t over active lanes
    max_len: Tensor     # [G] largest march-exit t over active lanes
    margin: Tensor      # [G] lateral slack: origin spread + 2·eps
    any_active: Tensor  # [G] bool
    o_off_lo: Tensor    # [G] min over active lanes of (origin-apex)·axis
    o_off_hi: Tensor    # [G] max of the same
    eps_max: Tensor     # [G] largest epsilon over active lanes
    ax_lo: Tensor       # [G] exact min reachable axial coordinate
    ax_hi: Tensor       # [G] exact max reachable axial coordinate
    tan_conv: Tensor    # [G] converging-cone tangent (apex mode; else -1)
    tan_neg: Tensor     # [G] tangent of lanes past the apex (else 0)


def _tile_cones(origin: Tensor, direction: Tensor, t_lo: Tensor,
                t_hi: Tensor, epsilon: Tensor, grid: int, tile: int = TILE,
                conv_apex: Optional[Tensor] = None) -> TileCones:
    """Per-ray-tile bounding cones (:415-527) from the *pre-bound-skip*
    origins and the march range ``[t_lo, t_hi]``; lanes with
    ``t_hi <= t_lo`` (provable miss, padding) are masked out of every
    statistic.  ``conv_apex [3]``: every ray ends at this point (point-light
    shadow rays); the cone is anchored there with the two-sided converging
    tangents of :505-524."""
    o = origin.reshape(grid, tile, 3)
    d = direction.reshape(grid, tile, 3)
    actf = (t_hi > t_lo).reshape(grid, tile).to(o.dtype)
    safe_n = torch.clamp_min(actf.sum(1), 1.0)
    if conv_apex is None:
        apex = (o * actf[..., None]).sum(1) / safe_n[:, None]
    else:
        apex = conv_apex.to(o).reshape(1, 3).expand(grid, 3)
    axis = (d * actf[..., None]).sum(1)
    if conv_apex is not None:
        axis = -axis            # from the light back toward the origins
    nrm = torch.linalg.norm(axis, dim=-1, keepdim=True)
    # (0, 0, 1) where no lane is active, made on the device
    axis = torch.where(nrm > 1e-12, axis / torch.clamp_min(nrm, 1e-12),
                       torch.nn.functional.pad(torch.ones_like(nrm), (2, 0)))
    return _cones_in_frame(origin, direction, t_lo, t_hi, epsilon, grid,
                           tile, apex, axis, conv_apex is not None)


def _cones_in_frame(origin: Tensor, direction: Tensor, t_lo: Tensor,
                    t_hi: Tensor, epsilon: Tensor, grid: int, tile: int,
                    apex: Tensor, axis: Tensor,
                    converging: bool) -> TileCones:
    """The statistics of :func:`_tile_cones` in a given frame: each tile's
    ``apex`` and unit ``axis [G, 3]`` (the lanes' sums, the cones'
    first pass), then every lane projected on them."""
    o = origin.reshape(grid, tile, 3)
    d = direction.reshape(grid, tile, 3)
    lo = t_lo.reshape(grid, tile)
    hi = t_hi.reshape(grid, tile)
    ep = epsilon.reshape(grid, tile)
    act = hi > lo
    actf = act.to(o.dtype)
    any_active = actf.sum(1) > 0.0
    o_rel = o - apex[:, None, :]
    o_par = (o_rel * axis[:, None, :]).sum(-1)
    rho2 = torch.clamp_min((o_rel * o_rel).sum(-1) - o_par * o_par, 0.0)
    rho = torch.sqrt(torch.where(act, rho2, 0.0).amax(1))
    cosd = (d * axis[:, None, :]).sum(-1)
    cos_min = torch.where(act, cosd, 1.0).amin(1)
    # cone-width cosine clipped away from 0; the axial-projection cosine
    # stays unclipped below 0 (backward-pointing lanes, :472-480)
    cos_half = torch.clamp(cos_min, 1e-3, 1.0)
    cos_lo = torch.clamp_max(cos_min, 1.0)
    o_off_lo = torch.where(any_active,
                           torch.where(act, o_par, _BIG).amin(1), 0.0)
    o_off_hi = torch.where(any_active,
                           torch.where(act, o_par, -_BIG).amax(1), 0.0)
    t_min = torch.where(any_active,
                        torch.where(act, lo, float("inf")).amin(1), 0.0)
    max_len = torch.where(act, hi, 0.0).amax(1)
    eps_max = (ep * actf).amax(1)
    # exact axial reach: oa + t·cosd is monotone in t
    ax0 = o_par + lo * cosd
    ax1 = o_par + hi * cosd
    ax_lo = torch.where(any_active, torch.where(
        act, torch.minimum(ax0, ax1), _BIG).amin(1), 0.0)
    ax_hi = torch.where(any_active, torch.where(
        act, torch.maximum(ax0, ax1), -_BIG).amax(1), 0.0)
    if not converging:
        margin = rho + 2.0 * eps_max + 1e-3
        tan_conv = torch.full_like(margin, -1.0)
        tan_neg = torch.zeros_like(margin)
    else:
        # two-sided envelope: lanes with o_par ≥ 0 reach α·tan_conv, lanes
        # past the apex (o_par < 0) reach |α|·tan_neg
        lam = torch.sqrt(rho2)
        pos_side = o_par >= 0.0
        tan_p = lam / torch.clamp_min(o_par, 1e-6)
        tan_n = lam / torch.clamp_min(-o_par, 1e-6)
        margin = 2.0 * eps_max + 1e-3
        tan_conv = torch.where(act & pos_side, tan_p, 0.0).amax(1)
        tan_neg = torch.where(act & ~pos_side, tan_n, 0.0).amax(1)
    return TileCones(apex, axis, cos_half, cos_lo, t_min, max_len, margin,
                     any_active, o_off_lo, o_off_hi, eps_max, ax_lo, ax_hi,
                     tan_conv, tan_neg)


# ---------------------------------------------------------------------------
# Candidate selection (:530-634)
# ---------------------------------------------------------------------------

class CandSelect(NamedTuple):
    """Axially sorted per-tile candidate selection."""

    idx: Tensor      # [G, M] int64 candidate rows, ascending axial position
    count: Tensor    # [G] int32 true candidate count (may exceed M)
    lo_key: Tensor   # [G, M] axial far edge  a + r + 1e-3
    hi_key: Tensor   # [G, M] axial near edge a - r - 1e-3


def _cand_mask(bounds: Tensor, cones: TileCones,
               converging: bool = False) -> Tensor:
    """Conservative per-tile candidacy mask ``[G, Kg]`` (:539-585): the
    lateral wedge test (or the two-sided converging envelope) plus the
    exact axial reach ``[ax_lo, ax_hi]``."""
    c = bounds[None, :, 0:3]
    r = bounds[None, :, 3] + cones.margin[:, None]
    v = c - cones.apex[:, None, :]
    a = (v * cones.axis[:, None, :]).sum(-1)
    v2 = (v * v).sum(-1)
    p = torch.sqrt(torch.clamp_min(v2 - a * a, 0.0))
    near = v2 <= r * r
    sin_half = torch.sqrt(torch.clamp_min(1.0 - cones.cos_half ** 2, 0.0))
    ml = cones.max_len[:, None]
    t_reach = torch.where(
        cones.cos_lo[:, None] > 0.0,
        torch.minimum(torch.clamp_min(
            (a + r - cones.o_off_lo[:, None])
            / torch.clamp_min(cones.cos_lo, 1e-6)[:, None], 0.0), ml),
        ml)
    if converging:
        reach = torch.maximum(
            torch.clamp_min(a + r, 0.0) * cones.tan_conv[:, None],
            torch.clamp_min(r - a, 0.0) * cones.tan_neg[:, None])
        lateral_ok = near | (p <= r + reach)
    else:
        lateral_ok = near | (p <= r + sin_half[:, None] * t_reach)
    return lateral_ok \
        & (a + r >= cones.ax_lo[:, None]) \
        & (a - r <= cones.ax_hi[:, None]) \
        & cones.any_active[:, None]


def _cone_candidates(bounds: Tensor, cones: TileCones, m_slots: int,
                     converging: bool = False,
                     cand: Optional[Tensor] = None) -> CandSelect:
    """Candidates sorted by axial position along the tile cone (:588-634).
    ``cand`` overrides the membership mask (the sub-tile OR); keys are
    always in this cone's frame.  Non-candidates sort to the end with keys
    ≈ +BIG.  The sort is stable, so equal keys keep the lower row, as
    ``lax.top_k`` does."""
    c = bounds[None, :, 0:3]
    v = c - cones.apex[:, None, :]
    a = (v * cones.axis[:, None, :]).sum(-1)          # [G, Kg]
    if cand is None:
        cand = _cand_mask(bounds, cones, converging)
    count = cand.sum(-1, dtype=torch.int32)
    m = min(m_slots, bounds.shape[0])
    key = torch.where(cand, a, _BIG)
    a_sorted, idx = torch.sort(key, dim=-1, stable=True)
    a_g, idx = a_sorted[:, :m], idx[:, :m]
    r_g = bounds[:, 3][idx]
    return CandSelect(idx, count, a_g + r_g + 1e-3, a_g - r_g - 1e-3)


# ---------------------------------------------------------------------------
# Per-pair tables (pallas_march_raw :1857-1977)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PairTable:
    """One culled pair's per-tile tables, as the kernels read them."""
    gid: int             # group of the pair
    op: str              # the group's reduction, 'min' or 'max'
    kind: str            # primitive kind
    row_lo: int          # the pair's rows [row_lo, row_hi) of its kind
    row_hi: int
    m: int               # table rows per tile (whole chunks)
    idx: Tensor          # int64 [G, m] candidate rows relative to row_lo
    count: Tensor        # int32 [G] candidate count (overflow if > m)
    table: Tensor        # float32 [G, m, PSTRIDE + 2] params, mat, slot
    keys: Tensor         # float32 [G, 2, m/CAND_UNROLL] chunk lo_c, hi_c
    misc: Tensor         # float32 [G, 4] count, cos_lo, clamp, margin
    hsuf: Tensor         # float32 [G, m/CAND_UNROLL] suffix-min of hi_key


@dataclasses.dataclass
class CullTables:
    """Everything the culled kernels read besides the rays and program."""
    pairs: Tuple          # the static _cull_pairs tuples
    tables: List[PairTable]
    oa: Tensor            # float32 [n] (origin - apex)·axis of the lane's tile
    ca: Tensor            # float32 [n] direction·axis
    overflow: Optional[Tensor]   # bool scalar, None when impossible
    early_out: bool = False      # MarchConfig.cull_early_out


@deferred.device_constant(maxsize=256)
def _row_ids(plan: Plan, prim_material, off: int, row_lo: int, row_hi: int,
             device: torch.device) -> Tensor:
    """The CSG-visible material and the global slot of a pair's rows
    (``off``: its kind's first slot) as float32 ``[g, 2]`` on ``device``,
    copied there once (a captured frame keeps what it reads)."""
    vis = visible_materials(plan, prim_material)
    mats = np.asarray([vis[off + r] for r in range(row_lo, row_hi)],
                      np.float32)
    slots = np.arange(off + row_lo, off + row_hi, dtype=np.float32)
    return torch.as_tensor(np.stack([mats, slots], 1), device=device)


def _table_rows(scene: FlatScene, kind: str, row_lo: int,
                row_hi: int) -> Tensor:
    """The pair's rows ``[g, PSTRIDE + 2]``: parameters padded to PSTRIDE
    (torus axes normalized as ``_prep_rows`` :277 does), the CSG-visible
    material and the global slot."""
    p = scene.prim_params[kind][row_lo:row_hi].detach().to(torch.float32)
    if kind == "torus":
        p = torch.cat([p[:, 0:3], normalize(p[:, 3:6]), p[:, 6:]], -1)
    p = torch.nn.functional.pad(p, (0, PSTRIDE - p.shape[1]))
    extra = _row_ids(scene.plan, scene.prim_material,
                     kind_offset(scene, kind), row_lo, row_hi, p.device)
    return torch.cat([p, extra], 1)


def kind_offset(scene: FlatScene, kind: str) -> int:
    """Global slot of the first primitive of ``kind``."""
    off = 0
    for k, c in scene.kind_counts:
        if k == kind:
            return off
        off += c
    raise KeyError(kind)


def padded_lanes(origin: Tensor, direction: Tensor, t0: Tensor,
                 length: Tensor, epsilon: Tensor) -> tuple:
    """A flat batch ``[n]`` padded to whole tiles as the cones take it:
    ``(origin, direction, t_lo, t_hi, epsilon)``, the march range ``[t0,
    length]`` (``length`` 0: a lane that never marches, as the padding)."""
    pad = (-origin.shape[0]) % TILE
    f = torch.nn.functional.pad
    return (f(origin, (0, 0, 0, pad)), f(direction, (0, 0, 0, pad)),
            f(t0, (0, pad)), f(torch.where(length > 0.0, length, t0),
                               (0, pad)), f(epsilon, (0, pad)))


def lane_cones(origin: Tensor, direction: Tensor, t0: Tensor,
               length: Tensor, epsilon: Tensor,
               cone_apex: Optional[Tensor] = None):
    """The cones of a flat batch ``[n]`` as the table build takes them
    (:func:`padded_lanes`).  Returns ``(tile cones, sub-tile cones, padded
    origins, padded directions)``."""
    lanes = padded_lanes(origin, direction, t0, length, epsilon)
    grid = lanes[0].shape[0] // TILE
    cones = _tile_cones(*lanes, grid, TILE, cone_apex)
    cones_f = _tile_cones(*lanes, grid * SUBF, TILE // SUBF, cone_apex)
    return cones, cones_f, lanes[0], lanes[1]


@span("cull")
@torch.no_grad()
def build_pair_tables(scene: FlatScene, origin: Tensor, direction: Tensor,
                      t0: Tensor, length: Tensor, epsilon: Tensor,
                      pairs, cull_m: int, window_clamp: float,
                      cone_apex: Optional[Tensor] = None,
                      early_out: bool = False) -> CullTables:
    """The culled kernels' inputs for a flat batch ``[n]``
    (:func:`build_pair_tables_plain` says what they are): CUDA tensors
    launch the table build's kernels (``cull_kernel.build_tables``, which
    raises on what they do not take), CPU tensors take the plain build;
    any other device raises."""
    args = (scene, origin, direction, t0, length, epsilon, pairs, cull_m,
            window_clamp, cone_apex, early_out)
    if origin.device.type == "cuda":
        from .cull_kernel import build_tables
        return build_tables(*args)
    if origin.device.type != "cpu":
        raise ValueError(f"build_pair_tables: unsupported device "
                         f"{origin.device}")
    return build_pair_tables_plain(*args)


@torch.no_grad()
def build_pair_tables_plain(scene: FlatScene, origin: Tensor,
                            direction: Tensor, t0: Tensor, length: Tensor,
                            epsilon: Tensor, pairs, cull_m: int,
                            window_clamp: float,
                            cone_apex: Optional[Tensor] = None,
                            early_out: bool = False) -> CullTables:
    """Plain version of the table build, PyTorch ops on any device: one
    :class:`PairTable` per pair, the per-lane axial coordinates ``oa``/``ca``
    and the overflow flag.

    ``t0``/``length`` are the march range after the root-bound skip
    (``length`` 0 on lanes that never march).  Cones use
    ``[t0, length]``, sub-tile candidacy masks are OR-ed per tile
    (SUBF = 4, :1872-1883, :1906-1910), and the window clamp is
    ``max(window_clamp, 8·eps_max)`` (:1898).

    A pair whose group lies under a smooth union of strength ``k`` gets
    the clamp ``k·log(8k / eps_max)`` where that is larger.  A window
    replaces the skipped members by a bound at least the clamp away; a
    hard min/max never lets such a value decide a hit, but a blend lowers
    the scene value by up to ``k·exp(-clamp / k)`` for it, which this
    clamp holds to an eighth of the hit shell.  (The JAX package clamps
    blended groups like any other; its windows span a tile of 1024 lanes
    and are rarely that narrow, a warp's are.)"""
    if len(pairs) > MAX_PAIRS:
        raise NotImplementedError(
            f"{len(pairs)} culled pairs > {MAX_PAIRS} (csrc/ft_sdf.cuh "
            "FT_MAX_PAIRS)")
    n = origin.shape[0]
    cones, cones_f, origin_p, dir_p = lane_cones(origin, direction, t0,
                                                 length, epsilon, cone_apex)
    grid = origin_p.shape[0] // TILE
    # per-lane exact axial coordinate p_ax = oa + t·ca (:1884-1896)
    oa = ((origin_p.reshape(grid, TILE, 3) - cones.apex[:, None, :])
          * cones.axis[:, None, :]).sum(-1).reshape(-1)[:n].contiguous()
    ca = (dir_p.reshape(grid, TILE, 3) * cones.axis[:, None, :]) \
        .sum(-1).reshape(-1)[:n].contiguous()
    clamp_eff = torch.clamp_min(8.0 * cones.eps_max, float(window_clamp))
    converging = cone_apex is not None
    groups, _tree, reach = _grouped(scene.plan)
    tables, overflow = [], None
    for (gid, kind, _ki, row_lo, row_hi) in pairs:
        g = row_hi - row_lo
        clamp = clamp_eff
        if reach[gid] > 0.0:
            k = reach[gid]
            clamp = torch.maximum(clamp_eff, k * torch.log(torch.clamp_min(
                8.0 * k / torch.clamp_min(cones.eps_max, 1e-6), 1.0)))
        m = _pair_m(cull_m, g)
        kparams = scene.prim_params[kind][row_lo:row_hi].detach() \
            .to(torch.float32)
        kb = _prim_bound_rows(kind, kparams)
        cmask = _cand_mask(kb, cones_f, converging) \
            .reshape(grid, SUBF, -1).any(1)
        sel = _cone_candidates(kb, cones, m, converging, cmask)
        if m < g:
            # a tile's count can exceed its table (:1914-1919)
            ovf = (sel.count > m).any()
            overflow = ovf if overflow is None else overflow | ovf
        idx, lo_key, hi_key = sel.idx, sel.lo_key, sel.hi_key
        if idx.shape[1] < m:
            # group smaller than the chunk-rounded table: repeat the last
            # column, keys at +BIG (always "ahead", :1920-1932)
            padn = m - idx.shape[1]
            idx = torch.cat([idx, idx[:, -1:].expand(grid, padn)], 1)
            big = torch.full((grid, padn), _BIG, dtype=lo_key.dtype,
                             device=lo_key.device)
            lo_key = torch.cat([lo_key, big], 1)
            hi_key = torch.cat([hi_key, big], 1)
        rows = _table_rows(scene, kind, row_lo, row_hi)
        chunks = m // CAND_UNROLL
        lo_c = lo_key.reshape(grid, chunks, CAND_UNROLL).amax(-1)
        hi_c = hi_key.reshape(grid, chunks, CAND_UNROLL).amin(-1)
        suf = torch.flip(torch.cummin(torch.flip(hi_key, [1]), 1).values,
                         [1])
        misc = torch.stack([sel.count.to(torch.float32), cones.cos_lo,
                            clamp, 8.0 * cones.eps_max + 1e-3], 1)
        tables.append(PairTable(
            gid=gid, op=groups[gid].op, kind=kind, row_lo=row_lo,
            row_hi=row_hi, m=m, idx=idx,
            count=sel.count, table=rows[idx].contiguous(),
            keys=torch.stack([lo_c, hi_c], 1).contiguous(),
            misc=misc.contiguous(),
            hsuf=suf[:, ::CAND_UNROLL].contiguous()))
    return CullTables(pairs=tuple(pairs), tables=tables, oa=oa, ca=ca,
                      overflow=overflow, early_out=bool(early_out))
