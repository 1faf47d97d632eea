"""Port parity, the gradient path: gradients through ``march`` and
``render`` (the backward as a pure function is held against ``jax.vjp`` in
``test_torch_vjp.py``).

Every tensor is on the CPU, where the "cuda" backend runs the kernels'
plain versions behind the real host glue.

Tolerances:

* frames (``grad`` of ``sum(render**2)``), each package marching for
  itself: the 24² two-primitive frame within 5e-5 of each leaf's max |g|
  (no lane differs); the 64² / 48-tori culled frame within 2% — the port's
  per-warp windows step differently from JAX's per-tile ones, so hits land
  elsewhere in the ε shell (t within 3ε) and a few grazing lanes flip
  (≤ 0.5% of lanes, tests/test_torch_render.py); a moved hit point moves
  its lane's gradient, and each leaf sums ~10³ such lanes;
* the counterparts of the JAX package's ``tests/test_grad.py`` keep its
  bounds.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fraytracer_tpu as jft
import fraytracer_tpu_torch as tft
from fraytracer_tpu.ops.march import MarchConfig as JMC
from fraytracer_tpu.scene import generators as JG
from fraytracer_tpu_torch import camera as tcam
from fraytracer_tpu_torch.ops import march as tmarch_mod
from fraytracer_tpu_torch.ops import sdf as tsdf
from fraytracer_tpu_torch.ops.march import MarchConfig as TMC
from fraytracer_tpu_torch.ops.march import march as tmarch
from fraytracer_tpu_torch.scene import generators as TG
from fraytracer_tpu_torch.scene.flatten import (PARAM_WIDTH, from_jax_arrays,
                                                grads_to_numpy)
from fraytracer_tpu_torch.types import dot
from test_torch_scene import ARRAYS, flat_camera_rays

CFG = TMC(bound_skip=False, max_steps=256, backend="torch")


def port_of(js, requires_grad=False):
    """The JAX FlatScene's state as a port FlatScene on the CPU."""
    return from_jax_arrays(
        {k: np.asarray(v) for k, v in js.prim_params.items()},
        plan=js.plan, kind_counts=js.kind_counts,
        prim_material=js.prim_material, mat_kind=js.mat_kind,
        light_kind=js.light_kind, device="cpu", requires_grad=requires_grad,
        **{f: np.asarray(getattr(js, f)) for f in ARRAYS})


def jax_grads(g):
    """A JAX gradient pytree keyed like ``grads_to_numpy``."""
    out = {f"prim_params/{k}": np.asarray(v)
           for k, v in g.prim_params.items()}
    out.update({f: np.asarray(getattr(g, f)) for f in ARRAYS})
    return out


def assert_leaves_close(got, want, rel, names=None):
    for k in names or want:
        scale = max(np.abs(want[k]).max(), 1e-30)
        err = np.abs(got[k] - want[k]).max() / scale
        assert err <= rel, (k, err, scale)


# ---------------------------------------------------------------------------
# (ii) counterparts of tests/test_grad.py, with its bounds
# ---------------------------------------------------------------------------

def sphere_scene(radius=1.0, cz=0.0):
    return tft.flatten(tft.Scene(
        root=tft.sphere((0.0, 0.0, cz), radius,
                        material=tft.solid(1, 1, 1)),
        background=(0.1, 0.1, 0.1),
        lights=(tft.directional_light((0, 0, 1), (1.0, 1.0, 1.0)),),
    ), device="cpu")


def _with_entry(scene, kind, row, col, value):
    """The scene with ``prim_params[kind][row, col]`` replaced by the
    (differentiable) scalar ``value``."""
    p = scene.prim_params[kind].clone()
    mask = torch.zeros_like(p, dtype=torch.bool)
    mask[row, col] = True
    return dataclasses.replace(
        scene, prim_params={**scene.prim_params,
                            kind: torch.where(mask, value, p)})


def _grad(fn, x0):
    x = torch.tensor(x0, dtype=torch.float32, requires_grad=True)
    (g,) = torch.autograd.grad(fn(x), x)
    return float(g)


def test_dt_dradius_matches_analytic():
    """Head-on ray onto a sphere: t* = |o - c| - r ⇒ dt*/dr = -1."""
    rays = tft.make_rays([0, 0, -5.0], [0, 0, 1.0], 100.0, 1e-4,
                         device="cpu")
    g = _grad(lambda r: tmarch(_with_entry(sphere_scene(), "sphere", 0, 3,
                                           r), rays, CFG).t.sum(), 1.0)
    np.testing.assert_allclose(g, -1.0, atol=1e-3)


def test_dt_dcenter_matches_analytic():
    """dt*/dcz = +1 for a head-on ray marching in +z."""
    rays = tft.make_rays([0, 0, -5.0], [0, 0, 1.0], 100.0, 1e-4,
                         device="cpu")
    g = _grad(lambda c: tmarch(_with_entry(sphere_scene(), "sphere", 0, 2,
                                           c), rays, CFG).t.sum(), 0.0)
    np.testing.assert_allclose(g, 1.0, atol=1e-3)


def test_dt_dorigin_and_direction():
    """dt/doz = -1/(d·n) = -1 head-on; the direction gets a gradient."""
    def t_of(oz):
        o = torch.stack([torch.zeros(()), torch.zeros(()), oz])
        rays = tft.make_rays(o, [0, 0, 1.0], 100.0, 1e-4, device="cpu")
        return tmarch(sphere_scene(), rays, CFG).t.sum()

    np.testing.assert_allclose(_grad(t_of, -5.0), -1.0, atol=1e-3)
    d = torch.tensor([0.0, 0.0, 1.0], requires_grad=True)
    rays = tft.make_rays([0.3, 0.0, -5.0], d, 100.0, 1e-4, device="cpu")
    (gd,) = torch.autograd.grad(tmarch(sphere_scene(), rays, CFG).t.sum(), d)
    assert torch.isfinite(gd).all() and float(gd.abs().sum()) > 0


def test_grad_vs_finite_difference_offaxis():
    """Implicit-diff grads match central finite differences for an
    off-axis ray on a CSG scene."""
    base = 0.8
    dirn = np.array([0.05, -0.03, 1.0]) / np.linalg.norm([0.05, -0.03, 1.0])
    rays = tft.make_rays([0.3, 0.2, -4.0], dirn.astype(np.float32), 100.0,
                         1e-4, device="cpu")
    flat = tft.flatten(tft.Scene(root=tft.subtract(
        tft.sphere((0, 0, 0), 1.2, material=tft.solid(1, 1, 1)),
        tft.sphere((0.5, 0.3, -0.8), 0.6))), device="cpu")

    def t_of_r(r):
        return tmarch(_with_entry(flat, "sphere", 0, 3, r), rays,
                      CFG).t.sum()

    g = _grad(t_of_r, base)
    h = 1e-3
    with torch.no_grad():
        fd = (float(t_of_r(torch.tensor(base + h)))
              - float(t_of_r(torch.tensor(base - h)))) / (2 * h)
    np.testing.assert_allclose(g, fd, rtol=0.05, atol=5e-3)


def two_prim_scene(ft, flatten):
    return flatten(ft.Scene(
        root=ft.union(
            ft.sphere((0, 0, 0), 1.0, material=ft.solid(0.8, 0.2, 0.2)),
            ft.box((1.2, 0, 0), (0.4, 0.4, 0.4), 0.05,
                   material=ft.solid(0.2, 0.8, 0.2)),
        ),
        background=(0.1, 0.1, 0.1),
        lights=(ft.directional_light((-0.5, -1, 1), (0.5, 0.5, 0.5)),
                ft.point_light((0, 2, -3), (5.0, 5.0, 5.0))),
    ))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_pixel_gradient_flows_to_all_param_groups(backend):
    """d(image)/d(everything) is finite and nonzero for geometry,
    materials, lights and background."""
    scene = two_prim_scene(
        tft, lambda s: tft.flatten(s, device="cpu")).requires_grad_(True)
    camera = tft.look_at((0, 0, -6), (0, 0, 0), device="cpu")
    cfg = tft.RenderConfig(width=24, height=24, epsilon=0.01, length=30.0,
                           march=TMC(max_steps=128, backend=backend))
    torch.sum(tft.render(scene, camera, cfg) ** 2).backward()
    g = grads_to_numpy(scene)
    assert all(np.isfinite(v).all() for v in g.values())
    for leaf in ("prim_params/sphere", "prim_params/box", "mat_albedo",
                 "light_color", "background"):
        assert np.abs(g[leaf]).sum() > 0, leaf


def test_inverse_rendering_descends():
    """Gradient descent on a sphere's radius moves toward the target."""
    camera = tft.look_at((0, 0, -5), (0, 0, 0), device="cpu")
    cfg = tft.RenderConfig(width=24, height=24, epsilon=0.01, length=20.0,
                           march=TMC(max_steps=128, backend="torch"))
    base = sphere_scene()
    target = tft.render(_with_entry(base, "sphere", 0, 3,
                                    torch.tensor(1.0)), camera, cfg)
    r = torch.tensor(0.7)
    l0 = None
    for _ in range(40):
        r = r.detach().requires_grad_(True)
        img = tft.render(_with_entry(base, "sphere", 0, 3, r), camera, cfg)
        loss = torch.mean((img - target) ** 2)
        (g,) = torch.autograd.grad(loss, r)
        r = r - 2.0 * g
        l0 = float(loss.detach()) if l0 is None else l0
    assert float(loss.detach()) < 0.7 * l0
    assert 0.78 < float(r.detach()) < 1.1


def test_min_denom_silhouette_envelope():
    """dt*/dr = -1/cos(theta) away from the silhouette; inside the clamp
    band the gradient saturates at -1/min_denom."""
    md = 0.05
    cfg = TMC(backend="torch", max_steps=4096, min_denom=md,
              bound_skip=False)
    scene = tft.flatten(tft.Scene(root=tft.sphere((0.0, 0.0, 0.0), 1.0)),
                        device="cpu")
    for b in (0.0, 0.5, 0.9, 0.99, 0.999, 0.99999):
        rays = tft.make_rays([[b, 0.0, -5.0]], [[0.0, 0.0, 1.0]], 100.0,
                             1e-5, device="cpu")
        g = _grad(lambda r: tmarch(_with_entry(scene, "sphere", 0, 3, r),
                                   rays, cfg).t.sum(), 1.0)
        cos = float(np.sqrt(max(1.0 - b * b, 0.0)))
        expected = -1.0 / max(cos, md)
        assert abs(g - expected) < 0.03 * abs(expected) + 2e-2, \
            (b, cos, g, expected)
        assert abs(g) <= 1.0 / md + 1e-3


@functools.lru_cache(maxsize=1)
def _tori48_frame_grads():
    """(JAX gradient, port gradient, port launch counts) of
    ``sum(render**2)`` on the 64² / 48-tori culled frame, a size where the
    block tier of the material repair is live (n % 1024 == 0)."""
    from fraytracer_tpu_torch.ops.cuda import gather
    js = jft.flatten(JG.torus_csg_scene(seed=19, n_tori=48))
    jcam = jft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0)
    jcfg = jft.RenderConfig(width=64, height=64, march=JMC(
        backend="pallas_interpret", max_steps=96))
    g = jax.grad(lambda s: jnp.sum(jft.render(s, jcam, jcfg) ** 2))(js)
    ts = port_of(js, requires_grad=True)
    cam = tft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device="cpu")
    cfg = tft.RenderConfig(width=64, height=64,
                           march=TMC(backend="cuda", max_steps=96))
    before = gather.LAUNCHES["block_gather"]
    torch.sum(tft.render(ts, cam, cfg) ** 2).backward()
    return jax_grads(g), grads_to_numpy(ts), \
        gather.LAUNCHES["block_gather"] - before


def test_grad_through_render_with_block_repair():
    """The gradient of a full "cuda"-backend render at a size where the
    block-granular material repair tier is live: finite, nonzero, and the
    block gather (which has no backward) never on the graph."""
    _jg, g, _launches = _tori48_frame_grads()
    prims = [v for k, v in g.items() if k.startswith("prim_params")]
    assert all(np.isfinite(v).all() for v in prims)
    assert any(np.abs(v).sum() > 0 for v in prims)
    # resolve_material runs without a graph whatever the caller's mode
    from fraytracer_tpu_torch.ops import shade
    ts = tft.flatten(TG.torus_csg_scene(seed=19, n_tori=16),
                     device="cpu").requires_grad_(True)
    pos = torch.zeros(2048, 3, requires_grad=True)
    hit = torch.ones(2048, dtype=torch.bool)
    midx = torch.full((2048,), -1, dtype=torch.int32)
    midx[1024:] = 0          # one bad block of two: the block tier
    out = shade.resolve_material(ts, pos, hit, midx, backend="cuda")
    assert not out.requires_grad and out.dtype == torch.int32
    assert int((out < 0).sum()) == 0


def test_clamped_lane_fraction_bounded_on_benchmark():
    """The min_denom clamp biases only grazing lanes: under 2% of the hits
    of the benchmark-style scene at 128² / 100 tori."""
    scene = tft.flatten(TG.torus_csg_scene(seed=19, n_tori=100),
                        device="cpu")
    camera = tft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0,
                         device="cpu")
    cfg = TMC(max_steps=192, backend="torch")
    rays = tmarch_mod.flat_rays(tcam.camera_rays(camera, 128, 128, 0.01,
                                                 30.0))
    res = tmarch(scene, rays, cfg)
    x0 = rays.at(res.t).requires_grad_(True)
    (g,) = torch.autograd.grad(tsdf.scene_distance(scene, x0).sum(), x0)
    den = dot(g, rays.direction).abs()
    assert int(res.hit.sum()) > 1000, "sanity"
    frac = float(((den < cfg.min_denom) & res.hit).sum() / res.hit.sum())
    assert frac < 0.02, frac


# ---------------------------------------------------------------------------
# (iii) frames against jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jbackend,tbackend", [("jnp", "torch"),
                                               ("pallas_interpret", "cuda")])
def test_two_primitive_frame_gradient_matches_jax(jbackend, tbackend):
    js = two_prim_scene(jft, jft.flatten)
    jcam = jft.look_at((0, 0, -6), (0, 0, 0))
    jcfg = jft.RenderConfig(width=24, height=24,
                            march=JMC(max_steps=128, backend=jbackend))
    g = jax.grad(lambda s: jnp.sum(jft.render(s, jcam, jcfg) ** 2))(js)
    ts = port_of(js, requires_grad=True)
    cam = tft.look_at((0, 0, -6), (0, 0, 0), device="cpu")
    cfg = tft.RenderConfig(width=24, height=24,
                           march=TMC(max_steps=128, backend=tbackend))
    torch.sum(tft.render(ts, cam, cfg) ** 2).backward()
    assert_leaves_close(grads_to_numpy(ts), jax_grads(g), 5e-5)


def test_culled_frame_gradient_matches_jax():
    want, got, k4_launches = _tori48_frame_grads()
    assert k4_launches == 0      # CPU tensors: the plain gather, no launch
    live = [k for k, v in want.items() if np.abs(v).max() > 0]
    assert {"prim_params/torus", "prim_params/sphere", "mat_albedo",
            "light_color", "light_vec", "background"} <= set(live)
    assert_leaves_close(got, want, 2e-2, live)


# ---------------------------------------------------------------------------
# (iv) second-order autograd of every distance kind is finite
# ---------------------------------------------------------------------------

KIND_PARAMS = {
    "sphere": [0.1, 0.2, 0.3, 0.7],
    "capsule": [0, 0, 0, 1, 0.5, 0.2, 0.3],
    "torus": [0.1, 0, 0, 0, 0, 2.0, 1.0, 0.25],
    "triangle": [0, 0, 0, 1, 0, 0, 0, 1, 0, 0.05],
    "box": [0, 0, 0, 0.5, 0.4, 0.3, 0.05],
    "cone": [0, 0, 0, 0, 1, 0, 0.5, 0.2],
    "plane": [0, 1, 0, -0.5],
}
# points where a naive formula divides by zero or takes sqrt(0): centres,
# axes, vertices, edges, faces, cap rims
SPECIAL = [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0.5, 0.4, 0.3], [0, 0, 5],
           [0.1, 0, 1.0], [0, 0.5, 0], [0.25, 0.25, 0], [1.1, 0, 0],
           [0.5, 0, 0], [0, 2, 0], [0.1, 0.2, 0.3], [0.5, 0.5, 0],
           [0, 1, 0.2], [0.5, 0, 0.5]]


@pytest.mark.parametrize("form", ["DIST_FNS", "GEN_FNS"])
@pytest.mark.parametrize("kind", sorted(KIND_PARAMS))
def test_second_order_autograd_is_finite(kind, form):
    """The backward differentiates ∇ₚf once more: no ``nan·0`` from a
    ``sqrt``, clamp or ``where`` at a degenerate point."""
    assert len(KIND_PARAMS[kind]) == PARAM_WIDTH[kind]
    rng = np.random.default_rng(0)
    pts = np.concatenate([np.asarray(SPECIAL, np.float32),
                          1.5 * rng.normal(size=(200, 3)).astype(np.float32)])
    params = torch.tensor([KIND_PARAMS[kind]], dtype=torch.float32,
                          requires_grad=True)
    q = torch.tensor(pts, requires_grad=True)
    if form == "DIST_FNS":
        f = tsdf.DIST_FNS[kind](params, q)[:, 0]
    else:
        f = tsdf.GEN_FNS[kind](lambda j: params[0, j], *q.unbind(-1))
    (g,) = torch.autograd.grad(f.sum(), q, create_graph=True)
    n = g / torch.sqrt((g * g).sum(-1, keepdim=True) + 1e-20)
    w = torch.from_numpy(rng.normal(size=n.shape).astype(np.float32))
    gp, gq = torch.autograd.grad((n * w).sum() + (f * w[:, 0]).sum(),
                                 (params, q))
    for x in (f, g, gp, gq):
        assert torch.isfinite(x).all()
    assert float(gp.abs().sum()) > 0


@pytest.mark.parametrize("kind", sorted(KIND_PARAMS))
def test_gen_fns_equal_dist_fns(kind):
    """The accessor-style distances are the ``[..., K]`` ones."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(1.5 * rng.normal(size=(256, 3)).astype(np.float32))
    params = torch.tensor([KIND_PARAMS[kind]], dtype=torch.float32)
    a = tsdf.DIST_FNS[kind](params, q)[:, 0]
    b = tsdf.GEN_FNS[kind](lambda j: params[0, j], *q.unbind(-1))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6)


def test_leaf_normal_matches_jax():
    """``leaf_normal`` against the JAX package's on the same codes."""
    from fraytracer_tpu.ops import sdf as jsdf
    js = jft.flatten(JG.csg_demo_scene())
    ts = port_of(js)
    rng = np.random.default_rng(3)
    p = rng.normal(size=(128, 3)).astype(np.float32)
    k = ts.num_prims
    code = rng.integers(-k, k + 1, size=128).astype(np.float32)
    want = np.asarray(jsdf.leaf_normal(js, jnp.asarray(code, jnp.int32),
                                       jnp.asarray(p)))
    got = tsdf.leaf_normal(ts, torch.from_numpy(code), torch.from_numpy(p))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# ---------------------------------------------------------------------------
# (vi) a forward-only frame builds no graph; the bwd_* fields are live
# ---------------------------------------------------------------------------

def test_forward_only_render_builds_no_graph(monkeypatch):
    ts = tft.flatten(TG.torus_csg_scene(seed=19, n_tori=48), device="cpu")
    cam = tft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device="cpu")
    cfg = tft.RenderConfig(width=32, height=32,
                           march=TMC(backend="cuda", max_steps=96))

    def no_function(*a, **k):
        raise AssertionError("the autograd Function ran on a forward-only "
                             "frame")

    monkeypatch.setattr(tmarch_mod._MarchFn, "apply", no_function)
    img = tft.render(ts, cam, cfg)
    assert img.grad_fn is None and not img.requires_grad
    ts.requires_grad_(True)
    with torch.no_grad():
        img2 = tft.render(ts, cam, cfg)
    assert img2.grad_fn is None
    np.testing.assert_array_equal(img.numpy(), img2.numpy())


def test_bwd_cull_fields_steer_the_backward(monkeypatch):
    """``bwd_cull_m`` / ``bwd_point_tile`` reach ``build_culled_eval``, and
    the gradient does not depend on them (the certificate keeps it
    exact)."""
    from fraytracer_tpu_torch.ops import point_eval
    seen = []
    real = point_eval.build_culled_eval

    def spy(scene, pos, hit=None, **kw):
        seen.append((kw["m"], kw["tile"], kw["for_materials"]))
        return real(scene, pos, hit, **kw)

    monkeypatch.setattr(point_eval, "build_culled_eval", spy)
    _jr, tr = flat_camera_rays(24, 24)
    grads = []
    for m, tile in ((48, 256), (24, 64)):
        ts = tft.flatten(TG.torus_csg_scene(seed=19, n_tori=48),
                         device="cpu").requires_grad_(True)
        cfg = TMC(backend="cuda", max_steps=96, cull_threshold=32,
                  bwd_cull_m=m, bwd_point_tile=tile)
        res = tmarch(ts, tr, cfg)
        torch.sum(torch.where(res.hit, res.t, 0.0)).backward()
        grads.append(ts.prim_params["torus"].grad.numpy())
    assert seen == [(48, 256, False), (24, 64, False)]
    scale = np.abs(grads[0]).max()
    assert scale > 0
    assert np.abs(grads[0] - grads[1]).max() <= 1e-5 * scale


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_tiled_render_gradient_matches_untiled(backend):
    """``render._trace`` rematerializes each tile in the backward: the
    gradient of a frame traced in 5 tiles (the last one padded) equals
    the one-batch frame's."""
    cam = tft.look_at((0, 0, -6), (0, 0, 0), device="cpu")
    grads = []
    for tile in (0, 128):
        scene = two_prim_scene(
            tft, lambda s: tft.flatten(s, device="cpu")).requires_grad_(True)
        cfg = tft.RenderConfig(width=24, height=24, tile_rays=tile,
                               tile_rays_pallas=tile,
                               march=TMC(max_steps=128, backend=backend))
        img, n_rays = tft.render_with_stats(scene, cam, cfg)
        torch.sum(img ** 2).backward()
        grads.append((grads_to_numpy(scene), int(n_rays)))
    (one, n_one), (tiled, n_tiled) = grads
    assert n_one == n_tiled
    assert np.abs(one["prim_params/sphere"]).max() > 0
    assert_leaves_close(tiled, one, 1e-5)
