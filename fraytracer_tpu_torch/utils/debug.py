"""Debug and validation helpers (counterpart of
``fraytracer_tpu.utils.debug``).

The reference has no sanitizers; its safety comes from immutability.  What
is worth checking is numeric health (NaN from degenerate geometry) and the
scene's well-formedness.
"""
from __future__ import annotations

import contextlib
from typing import List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..scene.flatten import FlatScene

_aten = torch.ops.aten
# allocations whose contents are whatever the memory held
_UNINITIALIZED = {_aten.empty, _aten.empty_like, _aten.empty_strided,
                  _aten.new_empty, _aten.new_empty_strided}


class _NanCheck(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first operator whose floating
    output holds a NaN (each check reads the device: a debugging aid)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in _UNINITIALIZED:
            return out
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextlib.contextmanager
def nan_guard():
    """Raise at the first NaN produced in the scope, in the forward and in
    the backward: every operator's floating outputs are checked (a
    ``TorchDispatchMode``), and autograd's anomaly mode checks each
    backward function's outputs.  A hand-written kernel writes into a
    tensor that torch allocated, so a NaN it produces is raised at the next
    operator that reads it (the allocation itself is not checked)."""
    with torch.autograd.detect_anomaly(check_nan=True), _NanCheck():
        yield


def validate_scene(scene: FlatScene) -> List[str]:
    """Well-formedness checks on a flattened scene; returns a list of
    problems (empty = valid): non-finite parameters, non-positive radii,
    degenerate axes, out-of-range material indices (the JAX checks and
    messages)."""
    problems: List[str] = []

    def arr(x):
        return x.detach().cpu().numpy()

    for kind, _ in scene.kind_counts:
        p = arr(scene.prim_params[kind])
        if not np.isfinite(p).all():
            problems.append(f"{kind}: non-finite parameters")
        if kind == "sphere" and (p[:, 3] <= 0).any():
            problems.append("sphere: non-positive radius")
        if kind == "capsule" and (p[:, 6] <= 0).any():
            problems.append("capsule: non-positive radius")
        if kind == "torus":
            if (p[:, 6] <= 0).any() or (p[:, 7] <= 0).any():
                problems.append("torus: non-positive radius")
            if (np.linalg.norm(p[:, 3:6], axis=1) < 1e-6).any():
                problems.append("torus: degenerate axis")
        if kind == "box" and (p[:, 3:6] <= 0).any():
            problems.append("box: non-positive half extent")
        if kind == "plane":
            if (np.linalg.norm(p[:, 0:3], axis=1) < 1e-6).any():
                problems.append("plane: degenerate normal")

    m = len(scene.mat_kind)
    for midx in scene.prim_material:
        if midx >= m:
            problems.append(f"primitive material index {midx} out of range")

    for name in ("mat_albedo", "mat_emission", "mat_reflectivity",
                 "mat_ior", "mat_tint", "light_vec", "light_color",
                 "background"):
        if not np.isfinite(arr(getattr(scene, name))).all():
            problems.append(f"{name}: non-finite values")

    return problems
