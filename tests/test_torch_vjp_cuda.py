"""The leaf backward's kernel (``csrc/leaf_vjp.cu``) against
``ops/march.py::implicit_vjp``, its plain version, on the same residuals.
Needs a CUDA device (marker ``cuda``); skipped without one.  Imports only
torch and the port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_vjp_cuda.py

Cases: 65,536 lanes on 24 leaves of each of the seven kinds, and on a
scene of all seven, with leaf codes of both signs, march signs of -1 (and
no ``sign``), grazing lanes whose denominator the clamp sets (``∇ₓf·d`` =
±0.01), misses, misses with t = 3e38 and code-0 lanes.  The reference is
the composition in float64 on the CPU; the kernel (float32) and the
composition in float32 on the card are each held to it, by the largest
difference over each table's largest |entry|.  The random points come
near the kinds' singular sets (a torus's or cone's axis, a triangle's
edges), where float32 loses digits in both: read on an H100, the kernel
1.1e-6 (sphere), 1.4e-4 (capsule), 4.0e-5 (torus), 4.0e-4 (triangle),
7.0e-6 (box), 1.1e-2 (cone), 7.5e-7 (plane), 5.0e-3 (all seven); the
float32 composition 1.2e-6, 1.5e-4, 6.7e-3, 3.8e-3, 7.0e-6, 5.7e-3,
4.4e-7, 5.0e-3.  Bar: the kernel within ``F32_TIMES`` (4) times the
float32 composition's reading, or ``REL`` (5e-5) where that is smaller
(it read at most 2.0 times).  On a march's own residuals
(``torus_csg_scene(19, 96)`` at 256²), the kernel against the composition
taken with the rays differentiated: within ``MARCH_REL`` (1e-4) of each
table's largest |entry| (read 1.8e-7 sphere, 1.4e-5 torus).  A graph step
of the torus scene against the eager step within
``tests/test_torch_cuda.py``'s 2e-4 of each leaf's largest |g|, with one
``leaf_vjp`` launch and three row scatters a step; a blended
(smooth-union) step and a march whose rays require grad count
``leaf_vjp_plain`` and launch no ``leaf_vjp``."""
import dataclasses
import functools
import sys

import pytest
import torch

import fraytracer_tpu_torch as ft
from fraytracer_tpu_torch.ops import cuda as ops_cuda, graph, sdf
from fraytracer_tpu_torch.ops import march as M
from fraytracer_tpu_torch.ops.cuda import leaf_vjp
from fraytracer_tpu_torch.scene import nodes as N
from fraytracer_tpu_torch.scene.flatten import KINDS
from fraytracer_tpu_torch.scene.generators import torus_csg_scene
from fraytracer_tpu_torch.types import Rays

pytestmark = pytest.mark.cuda

REL = 5e-5
F32_TIMES = 4.0
MARCH_REL = 1e-4
STEP_GRAD_REL = 2e-4     # tests/test_torch_cuda.py's graph-step bound
MIN_DENOM = M.MarchConfig().min_denom

# one row a kind (tests/test_torch_leaf_vjp.py's), shifted per leaf
BASE_ROWS = {
    "sphere": [0.1, 0.2, 0.3, 0.7],
    "capsule": [0, 0, 0, 1, 0.5, 0.2, 0.3],
    "torus": [0.1, 0, 0, 0.2, 0.1, 1.3, 1.0, 0.25],
    "triangle": [0, 0, 0, 1, 0, 0, 0, 1, 0, 0.05],
    "box": [0, 0, 0, 0.5, 0.4, 0.3, 0.05],
    "cone": [0, 0, 0, 0, 1, 0, 0.5, 0.2],
    "plane": [0, 1, 0, -0.5],
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def leaves_scene(kinds, per_kind, dev, seed=0):
    """A union of ``per_kind`` leaves of each of ``kinds``, their rows
    jittered (the plane's normal left as it is)."""
    g = torch.Generator().manual_seed(seed)
    prims = []
    for kind in kinds:
        for _ in range(per_kind):
            row = torch.tensor(BASE_ROWS[kind], dtype=torch.float64)
            if kind != "plane":
                row = row + 0.1 * torch.randn(row.shape, generator=g,
                                              dtype=torch.float64)
            prims.append(N.Prim(kind, tuple(row.tolist()),
                                N.solid(0.5, 0.5, 0.5)))
    return ft.flatten(N.Scene(root=N.union(*prims)), device=dev)


def residuals(scene, n, seed, with_sign):
    """Synthetic residuals of ``n`` lanes on ``scene`` (module docstring),
    float32 on its device."""
    dev = scene.device
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)
    k = scene.num_prims
    slot = torch.randint(0, k, (n,), generator=g)
    sgn = torch.where(torch.rand(n, generator=g) < 0.3, -1.0, 1.0)
    code = sgn * (slot + 1)
    sign = torch.where(torch.rand(n, generator=g) < 0.25, -1.0, 1.0)
    rows = {kd: v.double().cpu() for kd, v in scene.prim_params.items()}
    rows64 = dataclasses.replace(scene, prim_params=rows)
    centre = torch.cat([rows[kd][:, :3] for kd, _c in scene.kind_counts])
    y = centre[slot] + 0.8 * rnd(n, 3)
    q = y.clone().requires_grad_(True)
    f = sdf.leaf_distance(rows64.kind_counts, code.abs())(rows, q)
    (gy,) = torch.autograd.grad(f.sum(), q)
    gy = gy * sgn[:, None]
    d = rnd(n, 3)
    d = d / d.norm(dim=-1, keepdim=True)
    ghat = gy / gy.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    # a sixteenth graze: ∇ₓf·d = ±0.01, under the clamp
    graze = torch.arange(n) % 16 == 5
    u = torch.linalg.cross(ghat, d)
    u = u / u.norm(dim=-1, keepdim=True)
    s = (0.01 / gy.norm(dim=-1)).clamp(max=0.5) \
        * torch.where(torch.rand(n, generator=g) < 0.5, -1.0, 1.0)
    d = torch.where(graze[:, None], u * torch.sqrt(1 - s * s)[:, None]
                    + ghat * s[:, None], d)
    # elsewhere ∇ₓf·d far from 0: its sign is not rounding's
    cos = (ghat * d).sum(-1)
    hit = graze | (cos.abs() > 1e-3)
    t = 2.0 + 2.0 * torch.rand(n, generator=g, dtype=torch.float64)
    o = y - t[:, None] * d
    miss = torch.arange(n) % 16 == 9
    hit &= ~miss
    t = torch.where(miss & (torch.arange(n) % 32 == 9), 3.0e38, t)
    code = torch.where(torch.arange(n) % 16 == 13, 0.0, code)
    out = dict(origin=o, direction=d, epsilon=torch.full((n,), 1e-3), t=t,
               hit=hit, code=code, sign=sign if with_sign else None,
               ct_t=rnd(n), ct_n=rnd(n, 3))
    return {kd: None if v is None else
            (v.to(dev) if v.dtype == torch.bool else v.float().to(dev))
            for kd, v in out.items()}


def plain(scene, r, dtype, device):
    """``implicit_vjp``'s parameter cotangents, as ``_MarchFn._backward``
    calls it, in ``dtype`` on ``device``."""
    def cast(x):
        return None if x is None else (
            x.to(device) if x.dtype == torch.bool else x.to(device, dtype))
    sc = dataclasses.replace(scene, prim_params={
        k: cast(v) for k, v in scene.prim_params.items()})
    r = {k: cast(v) for k, v in r.items()}
    rays = Rays(r["origin"], r["direction"], torch.zeros_like(r["t"]),
                r["epsilon"])
    t = torch.where(r["hit"], r["t"], 0.0)
    bar_p, _o, _d = M.implicit_vjp(
        sc, rays, t, r["hit"], M._leaf_scene_d(sc, r["code"]),
        M.MarchConfig(), r["ct_t"], r["ct_n"], r["sign"], need_rays=False)
    return bar_p


def kernel(scene, r):
    return leaf_vjp.leaf_vjp(scene, r["origin"], r["direction"],
                             r["epsilon"], r["t"], r["hit"], r["code"],
                             r["ct_t"], r["ct_n"], r["sign"], MIN_DENOM)


def rel_err(got, want):
    """Largest |got − want| over the largest |want|, per table."""
    out = {}
    for k, w in want.items():
        scale = float(w.abs().max())
        assert scale > 0, k
        out[k] = float((got[k].double().cpu() - w.cpu()).abs().max()) / scale
    return out


@pytest.mark.parametrize("with_sign", [True, False],
                         ids=["sign", "no_sign"])
@pytest.mark.parametrize("kinds", [(k,) for k in KINDS] + [KINDS],
                         ids=list(KINDS) + ["all"])
def test_kernel_matches_the_composition(dev, kinds, with_sign):
    scene = leaves_scene(kinds, 24 if len(kinds) == 1 else 4, dev)
    r = residuals(scene, 1 << 16, 7 + len(kinds), with_sign)
    ops_cuda.reset_launch_counts()
    got = kernel(scene, r)
    counts = {k: v for k, v in ops_cuda.launch_counts().items() if v}
    assert counts == {"leaf_vjp": 1, "rows_scatter_smem": 1}
    want = plain(scene, r, torch.float64, "cpu")
    f32 = plain(scene, r, torch.float32, dev)
    assert list(got) == list(scene.prim_params)
    for k, v in got.items():
        assert v.shape == scene.prim_params[k].shape
        assert v.dtype == torch.float32 and torch.isfinite(v).all()
    err, err32 = rel_err(got, want), rel_err(f32, want)
    print(f"kernel {err} composition float32 {err32}")
    assert max(err.values()) <= max(REL, F32_TIMES * max(err32.values())), \
        (err, err32)


def test_dead_lanes_add_nothing(dev):
    """Miss lanes, code-0 lanes and t = 3e38 lanes give zero tables."""
    scene = leaves_scene(("torus", "sphere"), 8, dev)
    r = residuals(scene, 4096, 3, True)
    r["hit"] = torch.zeros_like(r["hit"])
    r["t"] = torch.full_like(r["t"], 3.0e38)
    for k, v in kernel(scene, r).items():
        assert torch.equal(v, torch.zeros_like(v)), k
    r = residuals(scene, 4096, 3, True)
    r["code"] = torch.zeros_like(r["code"])
    bar, idx = leaf_vjp.lane_cotangents(
        scene, r["origin"], r["direction"], r["epsilon"], r["t"], r["hit"],
        r["code"], r["ct_t"], r["ct_n"], r["sign"], MIN_DENOM)
    assert not bar.any() and not idx.any()


def test_march_backward_matches_the_composition(dev):
    """A fused-surface march of ``torus_csg_scene(19, 96)`` at 256²: the
    parameters' gradient of a random linear form of ``t`` and the normal,
    through the kernel (rays without grad) and through the composition
    (the rays require grad)."""
    scene = ft.flatten(torus_csg_scene(19, 96), device=dev)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), device=dev)
    rays = ft.camera_rays(cam, 256, 256, 0.01, 30.0)
    cfg = ft.MarchConfig(max_steps=192, relax_omega=1.4)
    g = torch.Generator(device=dev).manual_seed(4)
    wt = torch.randn((256, 256), generator=g, device=dev)
    wn = torch.randn((256, 256, 3), generator=g, device=dev)

    def grads(rays_grad):
        params = [v.detach().requires_grad_(True)
                  for v in scene.prim_params.values()]
        sc = dataclasses.replace(scene, prim_params=dict(
            zip(scene.prim_params, params)))
        ry = rays.map(lambda x: x.detach().clone())
        if rays_grad:
            ry.origin.requires_grad_(True)
        ops_cuda.reset_launch_counts()
        res, normal, _m = M.march_surface(sc, ry, cfg)
        loss = (torch.where(res.hit, res.t, 0.0) * wt).sum() \
            + (normal * wn).sum()
        out = torch.autograd.grad(loss, params)
        return dict(zip(scene.prim_params, out)), ops_cuda.launch_counts()
    got, c_kernel = grads(False)
    want, c_plain = grads(True)
    assert (c_kernel["leaf_vjp"], c_kernel["leaf_vjp_plain"]) == (1, 0)
    assert (c_plain["leaf_vjp"], c_plain["leaf_vjp_plain"]) == (0, 1)
    err = rel_err(got, {k: v.double() for k, v in want.items()})
    print(f"kernel against the composition {err}")
    assert max(err.values()) <= MARCH_REL, err


def test_graph_step_takes_the_kernel(dev):
    """A captured step of ``torus_csg_scene`` at 128² against the eager
    step: loss bit for bit, gradients within 2e-4 of each leaf's largest
    |g|; a replay launches ``leaf_vjp`` once and three row scatters (the
    leaf rows, albedo, emission), and takes no composition."""
    R = sys.modules["fraytracer_tpu_torch.render"]
    scene = ft.flatten(torus_csg_scene(19, 96), device=dev)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), device=dev)
    cfg = ft.RenderConfig(width=128, height=128, march=ft.MarchConfig(
        max_steps=192, relax_omega=1.4))
    graph._graphs.clear()

    def loss(img):
        return (img ** 2).sum()
    ops_cuda.reset_launch_counts()
    out = graph.eager(functools.partial(R._step, loss), scene, cam, cfg,
                      grad=True)
    eager = ops_cuda.launch_counts()
    assert (eager["leaf_vjp"], eager["leaf_vjp_plain"]) == (1, 0)
    want = (out[0], dict(zip(scene.tensors(), out[1:])))
    ft.render_value_and_grad(loss, scene, cam, cfg)
    ops_cuda.reset_launch_counts()
    got = ft.render_value_and_grad(loss, scene, cam, cfg)
    counts = ops_cuda.launch_counts()
    assert ops_cuda.graph_counts()["replays"] == 1
    assert (counts["leaf_vjp"], counts["leaf_vjp_plain"]) == (1, 0)
    assert (counts["rows_scatter_smem"], counts["rows_scatter_global"]) \
        == (3, 0)
    assert torch.equal(got[0], want[0])
    for k, w in want[1].items():
        scale = float(w.abs().max())
        assert float((got[1][k] - w).abs().max()) <= STEP_GRAD_REL * scale, k
    assert float(want[1]["prim_params/torus"].abs().sum()) > 0


def test_smooth_union_step_takes_the_composition(dev):
    """A step of the torus scene smooth-united with a sphere (AD mode,
    code 0): the composition, counted ``leaf_vjp_plain``."""
    R = sys.modules["fraytracer_tpu_torch.render"]
    base = torus_csg_scene(19, 96)
    scene = ft.flatten(N.Scene(root=N.smooth_union(
        0.25, base.root, N.sphere((0, 0, 0), 1.5,
                                  material=N.solid(0.8, 0.7, 0.3))),
        background=base.background, lights=base.lights), device=dev)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), device=dev)
    cfg = ft.RenderConfig(width=128, height=128, march=ft.MarchConfig(
        max_steps=192, relax_omega=1.4))
    ops_cuda.reset_launch_counts()
    out = graph.eager(functools.partial(R._step, lambda img: img.sum()),
                      scene, cam, cfg, grad=True)
    counts = ops_cuda.launch_counts()
    assert (counts["leaf_vjp"], counts["leaf_vjp_plain"]) == (0, 1)
    assert float(out[1 + list(scene.tensors()).index(
        "prim_params/torus")].abs().sum()) > 0
