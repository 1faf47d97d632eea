"""The implicit backward of a slot-mode march as one kernel: host side of
``csrc/leaf_vjp.cu``.

:func:`leaf_vjp` gives what ``ops/march.py::implicit_vjp`` gives for the
winning-leaf scene distance (``_leaf_scene_d``) without the rays'
cotangents: each parameter matrix's cotangent.  ``leaf_vjp_kernel``
evaluates each hit lane's one leaf three times in forward-mode duals and
writes the lane's row cotangent; ``rows_scatter_kernel``
(``ops/cuda/scatter.py``) sums the lanes into a ``[K, PSTRIDE]`` table in
slot order.  The kernel differentiates the rows as the forward kernels read
them (``march_kernel.slot_param_rows``: torus axes normalized), so the
torus rows then take the normalization's vjp (:func:`raw_rows_grad`).

CUDA tensors only; ``implicit_vjp`` is the plain version (CPU tensors and
every backward the kernel does not take: ``_MarchFn._backward`` holds the
rule).  ``LAUNCHES`` counts ``leaf_vjp``, the kernel's launches, and
``leaf_vjp_plain``, the backward calls on CUDA tensors that took the
composition.
"""
from __future__ import annotations

import ctypes

import torch

from ...scene.flatten import KINDS, PARAM_WIDTH, FlatScene
from ...utils.profiling import anchor
from . import scatter
from .build import check, library, on_device
from .cull import PSTRIDE

Tensor = torch.Tensor

LAUNCHES = {"leaf_vjp": 0, "leaf_vjp_plain": 0}


def raw_rows_grad(raw: Tensor, g: Tensor) -> Tensor:
    """The cotangent ``g [K, 8]`` of torus rows whose axis was read
    normalized, ``n / sqrt(|n|² + 1e-20)`` (``types.normalize``), as the
    cotangent of the raw rows ``raw``: the axis columns take that map's
    vjp, the others pass."""
    n = raw[:, 3:6].detach()
    inv = torch.rsqrt((n * n).sum(-1, keepdim=True) + 1e-20)
    u = n * inv
    gn = g[:, 3:6]
    gn = inv * (gn - u * (u * gn).sum(-1, keepdim=True))
    return torch.cat([g[:, 0:3], gn, g[:, 6:]], -1)


def lane_cotangents(scene: FlatScene, origin: Tensor, direction: Tensor,
                    epsilon: Tensor, t: Tensor, hit: Tensor, code: Tensor,
                    ct_t: Tensor, ct_n: Tensor, sign: Tensor | None,
                    min_denom: float):
    """The kernel's launch on ``n`` flat lanes (arguments as
    :func:`leaf_vjp`'s, CUDA tensors only): ``(bar [PSTRIDE, n], idx
    [n])``, each lane's cotangent of its leaf's row as the forward kernels
    read it and the row's global slot (zeros and slot 0 on the lanes that
    add nothing)."""
    from .march_kernel import _check_lanes, _f32, slot_param_rows
    n, dev = t.shape[0], t.device
    origin, direction, epsilon, t, code, ct_t, ct_n = (
        _f32(name, x.detach()).contiguous() for name, x in (
            ("origin", origin), ("direction", direction),
            ("epsilon", epsilon), ("t", t), ("code", code), ("ct_t", ct_t),
            ("ct_n", ct_n)))
    if hit.dtype != torch.bool:
        raise TypeError(f"hit must be bool, got {hit.dtype}")
    hit = hit.detach().contiguous()
    sign = None if sign is None else _f32("sign", sign.detach()).contiguous()
    _check_lanes(n, origin=origin, direction=direction, epsilon=epsilon, t=t,
                 hit=hit, code=code, ct_t=ct_t, ct_n=ct_n,
                 **({} if sign is None else {"sign": sign}))
    rows = slot_param_rows(scene)
    first, kinds = 0, []
    for kind, cnt in scene.kind_counts:
        kinds += [KINDS.index(kind), first]
        first += cnt
    bar = torch.empty((PSTRIDE, n), dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.long, device=dev)
    with on_device(dev):
        err = library().ft_leaf_vjp(
            origin.data_ptr(), direction.data_ptr(), t.data_ptr(),
            epsilon.data_ptr(), hit.data_ptr(), code.data_ptr(),
            None if sign is None else sign.data_ptr(), ct_t.data_ptr(),
            ct_n.data_ptr(), n, rows.data_ptr(),
            (ctypes.c_int * len(kinds))(*kinds), len(kinds) // 2,
            float(min_denom), bar.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(err, "ft_leaf_vjp")
    if n:
        anchor("leaf_vjp_kernel")
        LAUNCHES["leaf_vjp"] += 1
    return bar, idx


def leaf_vjp(scene: FlatScene, origin: Tensor, direction: Tensor,
             epsilon: Tensor, t: Tensor, hit: Tensor, code: Tensor,
             ct_t: Tensor, ct_n: Tensor, sign: Tensor | None,
             min_denom: float) -> dict:
    """Each parameter matrix's cotangent (kind → ``[K_t, P_t]``, in
    ``scene.prim_params`` order) of the slot-mode march's implicit backward
    on ``n`` flat lanes: the rays' ``origin`` / ``direction [n, 3]`` and
    ``epsilon``, the raw march's ``t`` / ``hit``, the surface kernel's leaf
    ``code``, the cotangents of ``t`` and of the normal ``[n, 3]``, the
    per-lane march ``sign`` (or None)."""
    bar, idx = lane_cotangents(scene, origin, direction, epsilon, t, hit,
                               code, ct_t, ct_n, sign, min_denom)
    table = scatter.scatter_rows(bar.t(), idx, 0,
                                 (scene.num_prims, PSTRIDE))
    out, off = {}, 0
    for kind, cnt in scene.kind_counts:
        g = table[off:off + cnt, :PARAM_WIDTH[kind]]
        if kind == "torus":
            g = raw_rows_grad(scene.prim_params[kind], g)
        # a matrix of its own, as autograd hands a leaf's gradient on: a
        # strided view of the table would reach a graph's outputs, whose
        # copy out would then be a kernel, not a memcpy
        out[kind] = g.contiguous()
        off += cnt
    return {k: out[k] for k in scene.prim_params}
