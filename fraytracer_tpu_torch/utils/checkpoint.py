"""Scene checkpoint/resume: save and load FlatScene parameters.

Counterpart of ``fraytracer_tpu.utils.checkpoint``, in the same ``.npz``
layout — every array leaf under its name (``prim::<kind>`` for the
parameter matrices) plus the JSON-encoded static structure under
``__static__`` — so a file written by either package loads in the other.
Inverse rendering *optimizes* scene parameters; this is how a fit resumes.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..scene.flatten import _ARRAY_FIELDS, FlatScene, Plan

__all__ = ["save_scene", "load_scene"]


def _plan_to_obj(p: Plan):
    return {"op": p.op, "prim_slots": list(p.prim_slots),
            "children": [_plan_to_obj(c) for c in p.children], "k": p.k}


def _plan_from_obj(o) -> Plan:
    return Plan(o["op"], tuple(o["prim_slots"]),
                tuple(_plan_from_obj(c) for c in o["children"]), o["k"])


def save_scene(path: str, scene: FlatScene) -> None:
    """Write a FlatScene (arrays + static structure) to ``path`` (.npz)."""
    arrays = {f"prim::{kind}": scene.prim_params[kind]
              for kind, _ in scene.kind_counts}
    arrays.update({name: getattr(scene, name) for name in _ARRAY_FIELDS})
    arrays = {k: v.detach().cpu().numpy() for k, v in arrays.items()}
    static = {
        "plan": _plan_to_obj(scene.plan),
        "kind_counts": list(map(list, scene.kind_counts)),
        "prim_material": list(scene.prim_material),
        "mat_kind": list(scene.mat_kind),
        "light_kind": list(scene.light_kind),
        "version": 1,
    }
    arrays["__static__"] = np.frombuffer(
        json.dumps(static).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_scene(path: str, device="cuda") -> FlatScene:
    """Load a FlatScene written by :func:`save_scene` onto ``device`` (the
    GPU unless the caller names the CPU)."""
    data = np.load(path)
    static = json.loads(bytes(data["__static__"]).decode())
    if static.get("version") != 1:
        raise ValueError(f"unsupported scene checkpoint version: "
                         f"{static.get('version')}")
    kind_counts = tuple((k, int(c)) for k, c in static["kind_counts"])

    def leaf(name):
        return torch.tensor(np.asarray(data[name], np.float32), device=device)

    return FlatScene(
        prim_params={k: leaf(f"prim::{k}") for k, _ in kind_counts},
        **{name: leaf(name) for name in _ARRAY_FIELDS},
        plan=_plan_from_obj(static["plan"]),
        kind_counts=kind_counts,
        prim_material=tuple(static["prim_material"]),
        mat_kind=tuple(static["mat_kind"]),
        light_kind=tuple(static["light_kind"]),
    )
