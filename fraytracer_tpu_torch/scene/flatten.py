"""Scene flattening: builder tree → flat tagged parameter tensors.

Counterpart of ``fraytracer_tpu.scene.flatten``: the reference's closure tree
becomes

* **dynamic data** — per-kind parameter matrices ``[K_t, P_t]``, material
  and light tensors (the differentiable degrees of freedom), and
* **static structure** — a hashable :class:`Plan` of how per-primitive
  distances combine, plus the slot assignment of primitives.

:func:`from_jax_arrays` rebuilds a port ``FlatScene`` from a JAX
``FlatScene``'s leaves (as numpy arrays) and static fields, so the same
scene state can be handed to both implementations.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from . import nodes as N

__all__ = ["Plan", "FlatScene", "flatten", "from_jax_arrays",
           "visible_materials", "KINDS", "PARAM_WIDTH"]

# Canonical primitive kind order == global slot order.
KINDS: Tuple[str, ...] = (
    "sphere", "capsule", "torus", "triangle", "box", "cone", "plane",
)

PARAM_WIDTH: Dict[str, int] = {
    "sphere": 4, "capsule": 7, "torus": 8, "triangle": 10,
    "box": 7, "cone": 8, "plane": 4,
}

_ARRAY_FIELDS = ("mat_albedo", "mat_emission", "mat_reflectivity", "mat_ior",
                 "mat_tint", "light_vec", "light_color", "light_shadow_len",
                 "background")


@dataclasses.dataclass(frozen=True, eq=True)
class Plan:
    """Static CSG combine plan node (hashable).

    ``op`` ∈ {'prim', 'union', 'smooth_union', 'intersect', 'subtract'}.
    ``prim_slots`` are leaf-primitive children as global slot indices;
    ``children`` are interior sub-plans.  'subtract' has exactly two
    operands, (a, b), as ``children``.
    """

    op: str
    prim_slots: Tuple[int, ...] = ()
    children: Tuple["Plan", ...] = ()
    k: float = 0.0


@dataclasses.dataclass
class FlatScene:
    """Flattened scene: SoA parameter tensors + static topology."""

    prim_params: Dict[str, torch.Tensor]   # kind -> [K_t, P_t] float32
    mat_albedo: torch.Tensor               # [M, 3]
    mat_emission: torch.Tensor             # [M, 3]
    mat_reflectivity: torch.Tensor         # [M]
    mat_ior: torch.Tensor                  # [M, 2] Cauchy (A, B)
    mat_tint: torch.Tensor                 # [M, 3]
    light_vec: torch.Tensor                # [L, 3] direction or position
    light_color: torch.Tensor              # [L, 3]
    light_shadow_len: torch.Tensor         # [L]
    background: torch.Tensor               # [3]
    # --- static structure ---
    plan: Plan
    kind_counts: Tuple[Tuple[str, int], ...]
    prim_material: Tuple[int, ...]         # per slot, -1 = none
    mat_kind: Tuple[int, ...]              # per material
    light_kind: Tuple[int, ...]

    @property
    def device(self) -> torch.device:
        return self.background.device

    def to(self, device) -> "FlatScene":
        """Copy every tensor to ``device`` (static fields are shared)."""
        kw = {f: getattr(self, f).to(device) for f in _ARRAY_FIELDS}
        kw["prim_params"] = {k: v.to(device)
                             for k, v in self.prim_params.items()}
        return dataclasses.replace(self, **kw)

    @property
    def num_prims(self) -> int:
        return sum(c for _, c in self.kind_counts)

    @property
    def num_lights(self) -> int:
        return len(self.light_kind)

    def visible_material(self) -> Tuple[int, ...]:
        """CSG-aware material visibility per slot (-1 = not visible)."""
        return visible_materials(self.plan, self.prim_material)

    def visible_material_slots(self) -> np.ndarray:
        """Slots whose material participates in the argmin (static)."""
        vis = self.visible_material()
        return np.array([i for i, m in enumerate(vis) if m >= 0], np.int64)


@functools.lru_cache(maxsize=128)
def visible_materials(plan: Plan,
                      prim_material: Tuple[int, ...]) -> Tuple[int, ...]:
    """CSG-aware material visibility per global slot (-1 = none visible): a
    primitive's material participates in the argmin iff the path from the
    root reaches it without passing through a subtract's *b* operand
    (reference ``SdfObject.fs:50-64``)."""
    vis = [-1] * len(prim_material)

    def walk(p: Plan, flag: bool):
        if flag:
            for s in p.prim_slots:
                vis[s] = prim_material[s]
        if p.op == "subtract":
            walk(p.children[0], flag)
            walk(p.children[1], False)
            return
        for c in p.children:
            walk(c, flag)

    walk(plan, True)
    return tuple(vis)


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


def flatten(scene: N.Scene, device="cpu") -> FlatScene:
    """Lower a builder :class:`~fraytracer_tpu_torch.scene.nodes.Scene` to a
    :class:`FlatScene` on ``device``.  Deduplicates materials by value; slot
    order is kind-major (``KINDS``), encounter order within a kind."""
    prims_by_kind: Dict[str, list] = {k: [] for k in KINDS}
    prim_entries: list = []  # (kind, index_within_kind, material_id)
    materials: list = []
    mat_index: Dict[N.Material, int] = {}

    def get_mat(m: Optional[N.Material]) -> int:
        if m is None:
            return -1
        if m not in mat_index:
            mat_index[m] = len(materials)
            materials.append(m)
        return mat_index[m]

    def visit(node: N.SdfNode) -> Plan:
        if isinstance(node, N.Prim):
            if node.kind not in PARAM_WIDTH:
                raise ValueError(f"unknown primitive kind {node.kind!r}")
            if len(node.params) != PARAM_WIDTH[node.kind]:
                raise ValueError(
                    f"{node.kind} expects {PARAM_WIDTH[node.kind]} params, "
                    f"got {len(node.params)}")
            idx_in_kind = len(prims_by_kind[node.kind])
            prims_by_kind[node.kind].append(np.asarray(node.params, np.float32))
            entry_id = len(prim_entries)
            prim_entries.append((node.kind, idx_in_kind, get_mat(node.material)))
            return Plan("prim", prim_slots=(entry_id,))  # provisional id
        if isinstance(node, N.Union):
            return _nary("union", node.children)
        if isinstance(node, N.SmoothUnion):
            p = _nary("smooth_union", node.children)
            return dataclasses.replace(p, k=node.k)
        if isinstance(node, N.Intersect):
            return _nary("intersect", node.children)
        if isinstance(node, N.Subtract):
            return Plan("subtract", children=(visit(node.a), visit(node.b)))
        raise TypeError(f"not an SdfNode of this package: "
                        f"{type(node).__module__}.{type(node).__name__}")

    def _nary(op: str, children) -> Plan:
        slots, subs = [], []
        for c in children:
            p = visit(c)
            if p.op == "prim":
                slots.append(p.prim_slots[0])
            else:
                subs.append(p)
        return Plan(op, prim_slots=tuple(slots), children=tuple(subs))

    plan_provisional = visit(scene.root)

    entry_to_slot = {}
    slot = 0
    kind_counts = []
    for kind in KINDS:
        cnt = 0
        for entry_id, (k, _idx, _m) in enumerate(prim_entries):
            if k == kind:
                entry_to_slot[entry_id] = slot
                slot += 1
                cnt += 1
        if cnt:
            kind_counts.append((kind, cnt))

    def remap(p: Plan) -> Plan:
        return Plan(p.op,
                    prim_slots=tuple(entry_to_slot[s] for s in p.prim_slots),
                    children=tuple(remap(c) for c in p.children),
                    k=p.k)

    plan = remap(plan_provisional)

    prim_material_by_slot = [0] * len(prim_entries)
    for entry_id, (_k, _i, m) in enumerate(prim_entries):
        prim_material_by_slot[entry_to_slot[entry_id]] = m

    if not materials:
        materials.append(N.solid(1.0, 1.0, 1.0))

    lights = scene.lights
    n_l = len(lights)
    return FlatScene(
        prim_params={kind: _f32(np.stack(prims_by_kind[kind], axis=0), device)
                     for kind, _ in kind_counts},
        mat_albedo=_f32([m.albedo for m in materials], device),
        mat_emission=_f32([m.emission for m in materials], device),
        mat_reflectivity=_f32([m.reflectivity for m in materials], device),
        mat_ior=_f32([[m.ior_a, m.ior_b] for m in materials], device),
        mat_tint=_f32([m.tint for m in materials], device),
        light_vec=_f32(np.array([l.vec for l in lights],
                                np.float32).reshape(n_l, 3), device),
        light_color=_f32(np.array([l.color for l in lights],
                                  np.float32).reshape(n_l, 3), device),
        light_shadow_len=_f32([l.shadow_length for l in lights], device),
        background=_f32(scene.background, device),
        plan=plan,
        kind_counts=tuple(kind_counts),
        prim_material=tuple(prim_material_by_slot),
        mat_kind=tuple(m.kind for m in materials),
        light_kind=tuple(l.kind for l in lights),
    )


def _plan_from(p) -> Plan:
    """Rebuild a plan from any object with the Plan fields (e.g. the JAX
    package's own ``Plan``)."""
    return Plan(str(p.op), prim_slots=tuple(int(s) for s in p.prim_slots),
                children=tuple(_plan_from(c) for c in p.children),
                k=float(p.k))


def from_jax_arrays(prim_params: Mapping[str, np.ndarray], *, plan,
                    kind_counts, prim_material, mat_kind, light_kind,
                    device="cpu", **arrays) -> FlatScene:
    """Port ``FlatScene`` from a JAX ``FlatScene``'s leaves and static fields.

    ``prim_params`` maps kind → ``[K_t, P_t]`` array; ``arrays`` holds the
    remaining leaves by field name (``mat_albedo`` … ``background``), each
    as a numpy array.  ``plan`` may be the JAX package's ``Plan``; it is
    rebuilt as this package's ``Plan``."""
    missing = set(_ARRAY_FIELDS) - set(arrays)
    extra = set(arrays) - set(_ARRAY_FIELDS)
    if missing or extra:
        raise ValueError(f"from_jax_arrays: missing {sorted(missing)}, "
                         f"unexpected {sorted(extra)}")
    return FlatScene(
        prim_params={str(k): _f32(v, device) for k, v in prim_params.items()},
        **{f: _f32(arrays[f], device) for f in _ARRAY_FIELDS},
        plan=_plan_from(plan),
        kind_counts=tuple((str(k), int(c)) for k, c in kind_counts),
        prim_material=tuple(int(m) for m in prim_material),
        mat_kind=tuple(int(m) for m in mat_kind),
        light_kind=tuple(int(m) for m in light_kind),
    )
