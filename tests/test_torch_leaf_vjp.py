"""The formula the leaf backward's kernel (``csrc/leaf_vjp.cu``) implements,
pinned on the CPU.  Per lane, in float64 with ``torch.func`` (jacobians and
Hessian-vector products):

    θ̄ = sg·∂θf(x)·(w − dᵀH(p)v / den) + ∂θ(vᵀ∇ₓf)(p)

with ``f = sign(code)·d_leaf``, ``x = o + t·d``, ``den`` the guarded
``sg·∇ₓf(x)·d``, ``w = −ct_t / den``, ``p = o + (t − ε)·d``, ``g = ∇ₓf(p)``
and ``v = (ct_n − n(n·ct_n)) / |g|``, ``n = g / |g|``: summed into each
lane's leaf row, against ``ops/march.py::implicit_vjp`` (the kernel's plain
version) with the winning-leaf scene distance.  Lanes of each of the seven
kinds: leaf codes of both signs, march signs ±1, a grazing lane whose
denominator is clamped at ``min_denom`` (``∇ₓf·d`` = 0.01, so that its
sign is not rounding's), a miss lane (t = 3e38) and a code-0
lane.  The torus rows also as the kernel reads them: the formula on the
kernel's torus distance over axis-normalized rows, taken back to the raw
rows by ``leaf_vjp.raw_rows_grad``.  Bound: 1e-9 of each table's largest
|entry|, float64 on both sides.  Every tensor is on the CPU; the kernel
itself runs in ``tests/test_torch_vjp_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.func import grad, jacrev, jvp

import fraytracer_tpu_torch as ft
from fraytracer_tpu_torch.ops import march as M, sdf
from fraytracer_tpu_torch.ops.cuda import leaf_vjp
from fraytracer_tpu_torch.scene import nodes as N
from fraytracer_tpu_torch.types import Rays

REL = 1e-9
MIN_DENOM = M.MarchConfig().min_denom

# two rows a kind (the second shifted); the torus axis is not unit length,
# as a fit leaves it
KIND_ROWS = {
    "sphere": [0.1, 0.2, 0.3, 0.7],
    "capsule": [0, 0, 0, 1, 0.5, 0.2, 0.3],
    "torus": [0.1, 0, 0, 0.2, 0.1, 1.3, 1.0, 0.25],
    "triangle": [0, 0, 0, 1, 0, 0, 0, 1, 0, 0.05],
    "box": [0, 0, 0, 0.5, 0.4, 0.3, 0.05],
    "cone": [0, 0, 0, 0, 1, 0, 0.5, 0.2],
    "plane": [0, 1, 0, -0.5],
}


def kind_scene(kind: str, dtype=torch.float64):
    """A union of two leaves of ``kind`` on the CPU, its rows in ``dtype``."""
    rows = np.asarray([KIND_ROWS[kind], KIND_ROWS[kind]], np.float64)
    rows[1, :3] += 0.15
    scene = ft.flatten(N.Scene(root=N.union(
        *(N.Prim(kind, tuple(r), N.solid(0.5, 0.5, 0.5)) for r in rows))),
        device="cpu")
    return dataclasses.replace(scene, prim_params={
        kind: torch.tensor(rows, dtype=dtype)})


def leaf_fn(kind: str, sgn: float, dist=None):
    """``f(θ, x) = sgn·d(θ, x)`` for one row ``θ [P]`` and point ``x [3]``
    (the plain version's formula unless ``dist`` is given)."""
    gen = dist or sdf.GEN_FNS[kind]
    return lambda th, x: sgn * gen(lambda j: th[j], x[0], x[1], x[2])


def lane_bar(f, th, o, d, t, eps, sg, ct_t, cn):
    """θ̄ of one hit lane by the formula of the module docstring."""
    x = o + t * d
    den0 = sg * torch.dot(grad(f, 1)(th, x), d)
    den = torch.sign(den0) * torch.clamp_min(den0.abs(), MIN_DENOM)
    den = torch.where(den == 0, MIN_DENOM, den)
    w = -ct_t / den
    p = o + (t - eps) * d
    g = grad(f, 1)(th, p)
    r = torch.rsqrt(torch.dot(g, g) + 1e-20)
    n = g * r
    v = r * (cn - n * torch.dot(n, cn))
    _, hv = jvp(lambda y: grad(f, 1)(th, y), (p,), (v,))
    d_vg = grad(lambda t_: torch.dot(grad(f, 1)(t_, p), v))(th)
    return sg * jacrev(f, 0)(th, x) * (w - torch.dot(d, hv) / den) + d_vg


def lanes(scene, seed: int):
    """Residuals of 14 lanes on ``scene``'s two leaves: eleven hit lanes
    (codes ±, march signs ±1), one grazing (``∇ₓf·d`` = 0.01 at x, the
    denominator clamped), one miss with t = 3e38, one hit with code 0."""
    (kind, rows), = scene.prim_params.items()
    dt = rows.dtype
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64).to(dt)
    n = 14
    slot = torch.arange(n) % 2
    code = ((slot + 1) * torch.where(torch.arange(n) % 3 == 2, -1, 1)).to(dt)
    sign = torch.where(torch.arange(n) % 4 == 3, -1.0, 1.0).to(dt)
    d = rnd(n, 3)
    d = d / d.norm(dim=-1, keepdim=True)
    t = 2.0 + torch.rand(n, generator=g, dtype=torch.float64).to(dt) * 2
    y = rows[slot, :3] + 0.8 * rnd(n, 3)
    # lane 11 grazes: ∇ₓf·d = 0.01 at its point, under the clamp (its
    # march sign is -1: den = -min_denom)
    gy = grad(leaf_fn(kind, 1.0), 1)(rows[1], y[11])
    c = torch.linalg.cross(gy, d[11])
    s = 0.01 / gy.norm()
    d[11] = c / c.norm() * torch.sqrt(1 - s * s) + gy / gy.norm() * s
    o = y - t[:, None] * d
    hit = torch.ones(n, dtype=torch.bool)
    hit[12] = False
    t[12] = 3.0e38
    code[13] = 0.0
    eps = torch.full((n,), 1e-3, dtype=dt)
    return dict(origin=o, direction=d, epsilon=eps, t=t, hit=hit, code=code,
                sign=sign, ct_t=rnd(n), ct_n=rnd(n, 3))


def plain_vjp(scene, lane):
    """``implicit_vjp``'s parameter cotangents on the lanes, as
    ``_MarchFn._backward`` calls it for a slot-mode surface march."""
    rays = Rays(lane["origin"], lane["direction"],
                torch.zeros_like(lane["t"]), lane["epsilon"])
    t = torch.where(lane["hit"], lane["t"], 0.0)
    bar_p, bar_o, bar_d = M.implicit_vjp(
        scene, rays, t, lane["hit"], M._leaf_scene_d(scene, lane["code"]),
        M.MarchConfig(), lane["ct_t"], lane["ct_n"], lane["sign"],
        need_rays=False)
    assert bar_o is None and bar_d is None
    return bar_p


def formula_table(kind, rows, lane, dist=None):
    """The formula over the lanes, summed into ``rows``' shape."""
    out = torch.zeros_like(rows)
    for i in range(lane["t"].shape[0]):
        c = float(lane["code"][i])
        if not bool(lane["hit"][i]) or c == 0.0:
            continue
        slot = int(abs(c)) - 1
        f = leaf_fn(kind, float(np.sign(c)), dist)
        out[slot] += lane_bar(
            f, rows[slot], lane["origin"][i], lane["direction"][i],
            lane["t"][i], lane["epsilon"][i], lane["sign"][i],
            lane["ct_t"][i], lane["ct_n"][i])
    return out


def assert_table_close(got, want):
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= REL * scale


@pytest.mark.parametrize("kind", sorted(KIND_ROWS))
def test_formula_is_the_plain_backward(kind):
    scene = kind_scene(kind)
    lane = lanes(scene, seed=len(kind))
    want = plain_vjp(scene, lane)[kind]
    assert_table_close(formula_table(kind, scene.prim_params[kind], lane),
                       want)
    # the grazing lane's denominator is the clamp's
    x = lane["origin"][11] + lane["t"][11] * lane["direction"][11]
    gx = grad(leaf_fn(kind, 1.0), 1)(scene.prim_params[kind][1], x)
    assert 0.005 < float(torch.dot(gx, lane["direction"][11])) < MIN_DENOM


def _kernel_torus(g, px, py, pz):
    """``csrc/ft_sdf.cuh::d_torus``: the axis read as given (unit length
    when the forward kernels' rows hold it)."""
    nx, ny, nz = g(3), g(4), g(5)
    qx, qy, qz = px - g(0), py - g(1), pz - g(2)
    h = qx * nx + qy * ny + qz * nz
    wx, wy, wz = qx - h * nx, qy - h * ny, qz - h * nz
    radial = torch.sqrt(wx * wx + wy * wy + wz * wz + 1e-20) - g(6)
    return torch.sqrt(h * h + radial * radial + 1e-20) - g(7)


def test_torus_rows_as_the_kernel_reads_them():
    """The formula on the kernel's torus distance over the rows with unit
    axes (``march_kernel.slot_param_rows``), then ``raw_rows_grad``: the
    plain backward's cotangent of the raw rows."""
    scene = kind_scene("torus")
    lane = lanes(scene, seed=5)
    raw = scene.prim_params["torus"]
    unit = torch.cat([raw[:, :3], raw[:, 3:6] * torch.rsqrt(
        (raw[:, 3:6] ** 2).sum(-1, keepdim=True) + 1e-20), raw[:, 6:]], -1)
    got = leaf_vjp.raw_rows_grad(
        raw, formula_table("torus", unit, lane, dist=_kernel_torus))
    assert_table_close(got, plain_vjp(scene, lane)["torus"])


def test_kernel_wrapper_refuses_cpu_tensors():
    """CPU tensors never reach the kernel: ``_MarchFn._backward`` gives
    them the plain version, and the wrapper raises for them."""
    scene = kind_scene("sphere", torch.float32)
    lane = lanes(scene, seed=1)
    with pytest.raises(ValueError, match="not a CUDA device"):
        leaf_vjp.leaf_vjp(scene, lane["origin"], lane["direction"],
                          lane["epsilon"], lane["t"], lane["hit"],
                          lane["code"], lane["ct_t"], lane["ct_n"],
                          lane["sign"], MIN_DENOM)
