"""K1/K2/K3 host side: the counterpart of ``pallas_march_raw`` for
``cull=False`` (``fraytracer_tpu/ops/pallas/march_kernel.py``).

The CSG plan is lowered to a small program (:func:`lower_program`) that the
kernels in ``csrc/march.cu`` interpret per ray: groups of primitives with a
min/max/sumexp reduction (``_build_groups``, the TPU kernel's grouping) and
the tree over them in postfix.  Parameters stay runtime tensors, so a scene
edit rebuilds nothing.

Each kernel has a wrapper and a plain PyTorch version beside it:

* :func:`march_kernel` / :func:`march_plain` — K1 (march) and K2
  (occlusion, hit mask only);
* :func:`surface_kernel` / :func:`surface_plain` — K3, the slot-mode
  surface pass (winning leaf code, its gradient as the normal, material
  argmin).

A wrapper launches the kernel for CUDA tensors and counts the launch in
``LAUNCHES``; for CPU tensors it runs the plain version (the CPU tests go
through the same host glue); any other device raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List

import numpy as np
import torch

from ...scene.flatten import FlatScene, Plan, PARAM_WIDTH, KINDS, \
    visible_materials
from ...types import MarchResult, Rays, normalize
from .. import sdf
from ..march import (MarchConfig, bound_skip_start, check_config, chunked,
                     sphere_trace)

Tensor = torch.Tensor

LAUNCHES = {"march": 0, "occlusion": 0, "surface": 0}

PSTRIDE = 10      # floats per primitive row (csrc/ft_sdf.cuh FT_PSTRIDE)
MAX_STACK = 16    # CSG value-stack depth (FT_MAX_STACK)

_OPCODE = {"union": 1, "intersect": 2, "subtract": 3, "smooth_union": 4}
_GROUP_OP = {"min": 0, "max": 1, "sumexp": 2}

_AD_ITEM = ("the surface kernel's AD mode (smooth unions) is not ported "
            "yet: ROADMAP Queue 2, 'K3 AD mode'; use fuse_surface=False")


# ---------------------------------------------------------------------------
# Plan → group-reduced form (port of march_kernel.py:_build_groups)
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


def slot_surface_mode(plan: Plan) -> bool:
    """True when the surface kernel's slot mode applies: no smooth union
    anywhere in the plan, so CSG min/max names one winning leaf.  (The JAX
    predicate looks only for sumexp groups and so misses a smooth union
    whose operands are all sub-plans — ROADMAP, Queue 3.)"""
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
        ("slot_entry", ctypes.c_void_p), ("n_slots", ctypes.c_int),
    ]


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
    slot_entry: Tensor   # int32 [K]

    def struct(self) -> FtProgram:
        return FtProgram(
            self.ops.data_ptr(), self.op_k.data_ptr(), self.ops.shape[0],
            self.groups.data_ptr(), self.group_k.data_ptr(),
            self.groups.shape[0],
            self.ent_kind.data_ptr(), self.ent_slot.data_ptr(),
            self.ent_mat.data_ptr(), self.ent_params.data_ptr(),
            self.ent_kind.shape[0],
            self.slot_entry.data_ptr(), self.slot_entry.shape[0])


@functools.lru_cache(maxsize=32)
def _lower_static(plan: Plan, kind_counts, prim_material):
    """The static part of the program as numpy arrays (cached per scene
    structure): postfix ops, groups, entry order and per-entry tables."""
    groups, tree = _build_groups(plan)
    entries, rows = [], []
    for g in groups:
        members = sorted(g.slots)   # ascending slot: first extremum wins
        rows.append((len(entries), len(entries) + len(members),
                     _GROUP_OP[g.op]))
        entries += members

    ops, op_k = [], []
    depth = max_depth = 0

    def emit(node):
        nonlocal depth, max_depth
        if node[0] == "g":
            ops.append((0, node[1]))
            op_k.append(0.0)
            depth += 1
            max_depth = max(max_depth, depth)
            return
        op, k, kids = node
        for kid in kids:
            emit(kid)
        ops.append((_OPCODE[op], len(kids)))
        op_k.append(float(k))
        depth -= len(kids) - 1

    emit(tree)
    if max_depth > MAX_STACK:
        raise NotImplementedError(
            f"CSG plan needs a value stack of {max_depth} > {MAX_STACK} "
            "(csrc/ft_sdf.cuh FT_MAX_STACK)")

    kind_of_slot = np.concatenate(
        [np.full(c, KINDS.index(k), np.int32) for k, c in kind_counts])
    mat_vis = np.asarray(visible_materials(plan, prim_material), np.int32)
    ent = np.asarray(entries, np.int64)
    slot_entry = np.empty(len(kind_of_slot), np.int32)
    slot_entry[ent] = np.arange(len(ent), dtype=np.int32)
    return dict(
        ops=np.asarray(ops, np.int32).reshape(-1, 2),
        op_k=np.asarray(op_k, np.float32),
        groups=np.asarray(rows, np.int32).reshape(-1, 3),
        group_k=np.asarray([g.k for g in groups], np.float32),
        ent_kind=kind_of_slot[ent],
        ent_slot=ent.astype(np.int32),
        ent_mat=mat_vis[ent],
        slot_entry=slot_entry,
        entries=ent,
    )


@functools.lru_cache(maxsize=32)
def _static_on(plan: Plan, kind_counts, prim_material, device: str):
    st = _lower_static(plan, kind_counts, prim_material)
    return {k: torch.as_tensor(v, device=device) for k, v in st.items()}


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


def _lowered_for(scene: FlatScene, device: str):
    """The scene's memoized program for ``device``, if the plan and every
    parameter tensor (identity and in-place version) are unchanged."""
    memo = scene.__dict__.get("_lowered")
    if memo is None:
        return None
    dev, plan, params, versions, prog = memo
    cur = tuple(scene.prim_params.values())
    if (dev == device and plan is scene.plan and len(params) == len(cur)
            and all(a is b for a, b in zip(params, cur))
            and versions == tuple(p._version for p in cur)):
        return prog
    return None


def lower_program(scene: FlatScene, device) -> Program:
    """Lower ``scene`` to the kernels' program on ``device``.  The program
    is kept on the scene object and reused by every launch until the plan
    or a parameter tensor changes (an in-place edit bumps the tensor's
    version; an edit through ``.data`` does not, and is not seen), so a
    frame lowers its scene once."""
    device = str(torch.device(device))
    prog = _lowered_for(scene, device)
    if prog is not None:
        return prog
    st = _static_on(scene.plan, scene.kind_counts, scene.prim_material,
                    device)
    params = slot_param_rows(scene).to(device)
    prog = Program(ops=st["ops"], op_k=st["op_k"], groups=st["groups"],
                   group_k=st["group_k"], ent_kind=st["ent_kind"],
                   ent_slot=st["ent_slot"], ent_mat=st["ent_mat"],
                   ent_params=params.index_select(0, st["entries"])
                   .contiguous(),
                   slot_entry=st["slot_entry"])
    cur = tuple(scene.prim_params.values())
    scene.__dict__["_lowered"] = (device, scene.plan, cur,
                                  tuple(p._version for p in cur), prog)
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


def march_plain(scene: FlatScene, origin: Tensor, direction: Tensor,
                length: Tensor, epsilon: Tensor, t0: Tensor, *,
                max_steps: int, omega: float, occlusion: bool = False):
    """Plain version of K1/K2: the kernel's stepping (per-lane
    ``max_steps`` cap, ω-relaxation with the overstep revert) on tensors,
    over ``sdf.scene_distance``.  Returns ``(t, hit, d, steps)``, or
    ``(hit, steps)`` for occlusion."""
    t, hit, d, steps, _it = sphere_trace(scene, origin, direction, length,
                                         epsilon, t0, max_steps, omega)
    return (hit, steps) if occlusion else (t, hit, d, steps)


def march_kernel(scene: FlatScene, origin: Tensor, direction: Tensor,
                 length: Tensor, epsilon: Tensor, t0: Tensor, *,
                 max_steps: int, omega: float, occlusion: bool = False):
    """K1 (``occlusion=False``) / K2 (``occlusion=True``) over flat lanes:
    ``origin``/``direction [N, 3]``, ``length``/``epsilon``/``t0 [N]``
    (lanes with ``length <= 0`` or ``t0 >= length`` never step).
    Returns ``(t, hit, d, steps)``, or ``(hit, steps)`` for occlusion."""
    if not _route(origin):
        return march_plain(scene, origin, direction, length, epsilon, t0,
                           max_steps=max_steps, omega=omega,
                           occlusion=occlusion)
    n = origin.shape[0]
    _check_lanes(n, origin=_f32("origin", origin),
                 direction=_f32("direction", direction),
                 length=_f32("length", length),
                 epsilon=_f32("epsilon", epsilon), t0=_f32("t0", t0))
    from .build import check, library
    lib = library()
    dev = origin.device
    prog = lower_program(scene, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    hit = torch.empty(n, dtype=torch.int32, device=dev)
    steps = torch.empty(n, dtype=torch.int32, device=dev)
    t = None if occlusion else torch.empty(n, **f32)
    d = None if occlusion else torch.empty(n, **f32)
    s = prog.struct()
    with torch.cuda.device(dev):
        err = lib.ft_march(
            origin.data_ptr(), direction.data_ptr(), length.data_ptr(),
            epsilon.data_ptr(), t0.data_ptr(), n, ctypes.byref(s),
            int(max_steps), float(omega), int(occlusion),
            None if occlusion else t.data_ptr(), hit.data_ptr(),
            None if occlusion else d.data_ptr(), steps.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "ft_march")
    LAUNCHES["occlusion" if occlusion else "march"] += 1
    if occlusion:
        return hit.bool(), steps
    return t, hit.bool(), d, steps


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
                  t: Tensor, epsilon: Tensor, hit: Tensor):
    """Plain version of K3 at ``p = o + (t - ε)·d`` on hit lanes:
    ``winning_leaf_code`` + the leaf gradient by autograd (unit normal via
    ``g·rsqrt(g·g + 1e-20)``) + the material argmin.  Miss lanes: normal
    (0, 0, 1), material -1, code 0.  Returns ``(normal, midx, code)``."""
    n = origin.shape[0]
    dev = origin.device
    normal = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    normal[:, 2] = 1.0
    midx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    code = torch.zeros(n, dtype=torch.float32, device=dev)
    idx = torch.nonzero(hit).squeeze(1)
    if idx.numel():
        p = origin[idx] + (t[idx] - epsilon[idx])[:, None] * direction[idx]
        c = chunked(sdf.winning_leaf_code, scene, p)
        g = leaf_gradient(scene, p, c)
        normal[idx] = g * torch.rsqrt(torch.sum(g * g, -1) + 1e-20)[:, None]
        midx[idx] = chunked(sdf.material_index_at, scene, p)
        code[idx] = c
    return normal, midx, code


def surface_kernel(scene: FlatScene, origin: Tensor, direction: Tensor,
                   t: Tensor, epsilon: Tensor, hit: Tensor):
    """K3, slot mode: ``(normal [N, 3], material [N] int32, code [N])`` at
    the epsilon backed-off hit points (see :func:`surface_plain`)."""
    if not slot_surface_mode(scene.plan):
        raise NotImplementedError(_AD_ITEM)
    if not _route(origin):
        return surface_plain(scene, origin, direction, t, epsilon, hit)
    n = origin.shape[0]
    hit_i = hit.to(torch.int32).contiguous()
    _check_lanes(n, origin=_f32("origin", origin),
                 direction=_f32("direction", direction), t=_f32("t", t),
                 epsilon=_f32("epsilon", epsilon), hit=hit_i)
    from .build import check, library
    lib = library()
    dev = origin.device
    prog = lower_program(scene, dev)
    normal = torch.empty((n, 3), dtype=torch.float32, device=dev)
    midx = torch.empty(n, dtype=torch.int32, device=dev)
    code = torch.empty(n, dtype=torch.float32, device=dev)
    s = prog.struct()
    with torch.cuda.device(dev):
        err = lib.ft_surface(
            origin.data_ptr(), direction.data_ptr(), t.data_ptr(),
            epsilon.data_ptr(), hit_i.data_ptr(), n, ctypes.byref(s),
            normal.data_ptr(), midx.data_ptr(), code.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "ft_surface")
    LAUNCHES["surface"] += 1
    return normal, midx, code


# ---------------------------------------------------------------------------
# host glue (pallas_march_raw, cull=False)
# ---------------------------------------------------------------------------

@torch.no_grad()
def cuda_march_raw(scene: FlatScene, rays: Rays, cfg: MarchConfig,
                   want_surface: bool = False, occlusion: bool = False):
    """March a flat ray batch ``[N]`` through K1 (or K2), then K3.

    Applies the root-bound skip and clamps the budget to the bound's exit
    (march_kernel.py:1809-1818); lanes that miss the bound get a zero
    budget.  ``occlusion=True`` returns the hit mask ``[N] bool`` only;
    ``want_surface=True`` returns ``(MarchResult, normal [N, 3],
    material [N], code [N])`` with ``material = -1`` off hit lanes."""
    check_config(cfg)
    if want_surface and not slot_surface_mode(scene.plan):
        raise NotImplementedError(_AD_ITEM)
    origin = rays.origin.contiguous()
    direction = rays.direction.contiguous()
    epsilon = rays.epsilon.contiguous()
    n = origin.shape[0]
    t0 = torch.zeros(n, dtype=torch.float32, device=origin.device)
    miss0 = torch.zeros(n, dtype=torch.bool, device=origin.device)
    length = rays.length
    if cfg.bound_skip:
        t0, miss0, t_exit = bound_skip_start(scene, rays)
        length = torch.minimum(length, t_exit)
    length = torch.where(miss0, 0.0, length).contiguous()
    kw = dict(max_steps=cfg.max_steps, omega=cfg.relax_omega)
    if occlusion:
        hit, _steps = march_kernel(scene, origin, direction, length, epsilon,
                                   t0.contiguous(), occlusion=True, **kw)
        return hit & ~miss0
    t, hit_k, d, steps = march_kernel(scene, origin, direction, length,
                                      epsilon, t0.contiguous(), **kw)
    hit = hit_k & ~miss0
    res = MarchResult(hit=hit, t=t, distance=d, steps=steps)
    if not want_surface:
        return res
    normal, midx, code = surface_kernel(scene, origin, direction, t,
                                        epsilon, hit_k)
    return res, normal, torch.where(hit, midx, -1), code
