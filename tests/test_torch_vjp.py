"""Port parity, the backward as a pure function: ``implicit_vjp`` fed JAX's
own ``t``, ``hit`` and winning-leaf ``code`` and the same cotangents (from
a numpy seed), against ``jax.grad`` through the JAX package's custom VJPs
of ``march`` / ``march_surface`` on "jnp" and "pallas_interpret".

Cases: the dense scene distance ("jnp"), per-tile candidate lists
(``point_eval``; ``bwd_cull_m`` 16 of 48 overlapping tori, which the
exactness certificate refuses in both packages: the dense route), the
winning leaf of slot mode, the same with per-lane ``sign`` on rays started
inside the scene, a plan with a smooth union (code 0; lists of the full
group), and a lattice of well-separated tori, alone and smooth-united with
a sphere cap, where lists of 8 of 64 candidates certify: the culled route
with real truncation.  Each case asserts the route it took.

Tolerance: every gradient leaf (each parameter matrix, the rays' origin
and direction) within 1e-5 of the leaf's max |g| — float32, two frameworks
summing ~10³ lanes in two orders.  Every tensor is on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fraytracer_tpu as jft
import fraytracer_tpu_torch as tft
from fraytracer_tpu.ops.march import MarchConfig as JMC
from fraytracer_tpu.ops.march import _surf_raw
from fraytracer_tpu.ops.march import march as jmarch
from fraytracer_tpu.ops.march import march_surface as jmarch_surface
from fraytracer_tpu.scene import generators as JG, nodes as JN
from fraytracer_tpu.types import Rays as JRays
from fraytracer_tpu_torch.ops import march as tmarch_mod, point_eval
from fraytracer_tpu_torch.ops.march import MarchConfig as TMC
from fraytracer_tpu_torch.scene import generators as TG
from test_torch_grad import assert_leaves_close, port_of
from test_torch_scene import flat_camera_rays, to_port_rays


def blend48(N, G):
    base = G.torus_csg_scene(seed=19, n_tori=48)
    return N.Scene(root=N.smooth_union(
        0.25, base.root, N.sphere((0, 0, 0), 1.5,
                                  material=N.solid(0.8, 0.7, 0.3))),
        background=base.background, lights=base.lights)


def lattice(N, G, side=8, blend=False, spacing=1.1):
    """``side²`` small tori on a square lattice in the plane z = 0, far
    enough apart that a tile of nearby points certifies a short candidate
    list; ``blend`` smooth-unites them with a shallow sphere cap just
    behind (apex at z = 0.15), so hits off the tori stay close to one."""
    rng = np.random.default_rng(3)
    base = G.torus_csg_scene(seed=19, n_tori=2)
    tori = []
    for i in range(side):
        for j in range(side):
            c = ((i - (side - 1) / 2) * spacing,
                 (j - (side - 1) / 2) * spacing, 0.0)
            nrm = rng.normal(size=3) + np.array([0.0, 0.0, -2.0])
            tori.append(N.torus(c, nrm, 0.3, 0.1,
                                material=N.solid(*rng.uniform(0.2, 0.9, 3))))
    root = N.union(*tori)
    if blend:
        root = N.smooth_union(0.1, root, N.sphere(
            (0, 0, 10.15), 10.0, material=N.solid(0.8, 0.7, 0.3)))
    return N.Scene(root=root, background=base.background, lights=base.lights)


def patch_rays(tiles=4, tile=256, spacing=1.1, seed=6):
    """``tiles·tile`` parallel rays down +z, each tile of ``tile``
    consecutive rays over a 0.6-wide patch around one lattice site, so a
    tile's hit points lie together."""
    rng = np.random.default_rng(seed)
    site = rng.integers(-1, 1, size=(tiles, 1, 2)) * spacing + spacing / 2
    xy = site + rng.uniform(-0.3, 0.3, size=(tiles, tile, 2))
    o = np.concatenate([xy, np.full((tiles, tile, 1), -10.0)], -1)
    o = o.reshape(-1, 3).astype(np.float32)
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (o.shape[0], 1))
    n = o.shape[0]
    return JRays(origin=jnp.asarray(o), direction=jnp.asarray(d),
                 length=jnp.full((n,), 20.0, jnp.float32),
                 epsilon=jnp.full((n,), 0.01, jnp.float32))


def inside_rays(n, seed=4):
    rng = np.random.default_rng(seed)
    o = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jr = JRays(origin=jnp.asarray(o), direction=jnp.asarray(d),
               length=jnp.full((n,), 20.0, jnp.float32),
               epsilon=jnp.full((n,), 0.01, jnp.float32))
    sign = np.where(rng.uniform(size=n) > 0.5, 1.0, -1.0).astype(np.float32)
    return jr, sign


VJP_CASES = {
    # name: (scene, JAX backend, surface, rays, sign, JAX/port cfg extras)
    "jnp-march-dense": ("csg_demo", "jnp", False, (16, 16), False, {}),
    "pallas-march-culled": ("torus48", "pallas_interpret", False, (32, 32),
                            False, dict(cull_threshold=32, bwd_cull_m=16,
                                        bwd_point_tile=256)),
    # candidate lists that really truncate (8 of 64) and certify
    "pallas-march-lattice": ("lattice", "pallas_interpret", False, "patch",
                             False, dict(cull_threshold=32, bwd_cull_m=8,
                                         bwd_point_tile=256)),
    "pallas-surface-lattice-blend": ("lattice-blend", "pallas_interpret",
                                     True, "patch", False,
                                     dict(cull_threshold=32, bwd_cull_m=8,
                                          bwd_point_tile=256)),
    "pallas-surface-slot": ("torus48", "pallas_interpret", True, (48, 48),
                            False, dict(cull_threshold=32, cull_m=64)),
    "pallas-surface-sign": ("torus48", "pallas_interpret", True, None, True,
                            dict(cull_threshold=32, cull_m=64)),
    "pallas-surface-blend": ("blend48", "pallas_interpret", True, (32, 32),
                             False, dict(cull_threshold=32, bwd_cull_m=48,
                                         bwd_point_tile=256)),
}


# which branch of ``point_eval`` the certificate sends a case to (one host
# read each); the other cases never build candidate lists
ROUTES = {"pallas-march-culled": "dense",           # 16 of 48: refused
          "pallas-surface-blend": "culled",         # 48 of 48: the full group
          "pallas-march-lattice": "culled",         # 8 of 64, certified
          "pallas-surface-lattice-blend": "culled"}


def _build(name, N, G):
    if name == "blend48":
        return blend48(N, G)
    if name.startswith("lattice"):
        return lattice(N, G, blend=name.endswith("blend"))
    if name == "csg_demo":
        return G.csg_demo_scene()
    return G.torus_csg_scene(seed=19, n_tori=int(name[5:]))


LATTICE_CASES = sorted(c for c in VJP_CASES if "lattice" in c)


@pytest.mark.parametrize("case", sorted(set(VJP_CASES) - set(LATTICE_CASES)))
def test_backward_fed_jax_residuals_matches_jax_vjp(case):
    check_backward_against_jax(case)


def check_backward_against_jax(case):
    name, jbackend, surface, size, signed, extra = VJP_CASES[case]
    js = jft.flatten(_build(name, JN, JG))
    if size == "patch":
        jr, sign = patch_rays(), None
    elif size is None:
        jr, sign = inside_rays(1024)
    else:
        jr, _ = flat_camera_rays(*size)
        sign = None
    n = jr.origin.shape[0]
    rng = np.random.default_rng(11)
    w_t = rng.normal(size=n).astype(np.float32)
    w_n = rng.normal(size=(n, 3)).astype(np.float32)
    jcfg = JMC(backend=jbackend, max_steps=96, **extra)
    jsign = None if sign is None else jnp.asarray(sign)

    def loss(s, o, d):
        rays = JRays(origin=o, direction=d, length=jr.length,
                     epsilon=jr.epsilon)
        if surface:
            res, nrm, _m = jmarch_surface(s, rays, jcfg, sign=jsign)
            return (jnp.sum(jnp.where(res.hit, res.t, 0.0) * w_t)
                    + jnp.sum(nrm * w_n))
        res = jmarch(s, rays, jcfg, sign=jsign)
        return jnp.sum(jnp.where(res.hit, res.t, 0.0) * w_t)

    g_s, g_o, g_d = jax.grad(loss, argnums=(0, 1, 2))(js, jr.origin,
                                                       jr.direction)
    # JAX's own residuals: t, hit and (surface) the winning-leaf code
    if surface:
        res, _nrm, _m, code = _surf_raw(
            js, jr, jnp.float32(0.0) if jsign is None else jsign, jcfg)
        code = torch.from_numpy(np.array(code, np.float32))
    else:
        res = jmarch(js, jr, jcfg, sign=jsign)
        code = None
    t = torch.from_numpy(np.array(res.t, np.float32))
    hit = torch.from_numpy(np.array(res.hit))
    assert int(hit.sum()) > n // 20

    ts = port_of(js)
    tr = to_port_rays(jr)
    tcfg = TMC(backend="cuda", max_steps=96, **extra)
    tsign = None if sign is None else torch.from_numpy(sign)
    stats0 = dict(point_eval.STATS)
    if surface:
        scene_d = tmarch_mod._surface_scene_d(ts, tr, t, hit, code, tcfg,
                                              tsign)
    elif jbackend == "jnp":
        scene_d = tmarch_mod._dense_scene_d(ts, t.device)
    else:
        scene_d = tmarch_mod._culled_scene_d(ts, tr.at(t), hit, tcfg)
    route = {k: point_eval.STATS[k] - stats0[k] for k in stats0}
    want_route = dict.fromkeys(route, 0)
    if case in ROUTES:
        want_route.update({"certificate_reads": 1, ROUTES[case]: 1})
    assert route == want_route
    bar_p, bar_o, bar_d = tmarch_mod.implicit_vjp(
        ts, tr, t, hit, scene_d, tcfg, torch.from_numpy(w_t),
        torch.from_numpy(w_n) if surface else None, tsign)

    want = {f"prim_params/{k}": np.asarray(v)
            for k, v in g_s.prim_params.items()}
    want.update(origin=np.asarray(g_o), direction=np.asarray(g_d))
    got = {f"prim_params/{k}": v.numpy() for k, v in bar_p.items()}
    got.update(origin=bar_o.numpy(), direction=bar_d.numpy())
    assert any(np.abs(v).max() > 0 for k, v in want.items()
               if k.startswith("prim_params"))
    assert_leaves_close(got, want, 1e-5)


def test_march_function_equals_its_pure_backward():
    """``march(...).t.backward`` runs ``implicit_vjp`` on the march's own
    residuals: the Function adds nothing to it."""
    ts = tft.flatten(TG.torus_csg_scene(seed=19, n_tori=48),
                     device="cpu").requires_grad_(True)
    _jr, tr = flat_camera_rays(24, 24)
    cfg = TMC(backend="cuda", max_steps=96, cull_threshold=32)
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=24 * 24).astype(np.float32))
    res, nrm, _m = tmarch_mod.march_surface(ts, tr, cfg)
    assert res.t.grad_fn is not None and nrm.grad_fn is not None
    assert not res.hit.requires_grad and not res.distance.requires_grad
    torch.sum(res.t * w).backward()
    from fraytracer_tpu_torch.ops.cuda.march_kernel import cuda_march_raw
    raw, _n, _mm, code = cuda_march_raw(ts, tr, cfg, want_surface=True)
    bar_p, _o, _d = tmarch_mod.implicit_vjp(
        ts, tr, raw.t, raw.hit,
        tmarch_mod._leaf_scene_d(ts, code), cfg, w,
        torch.zeros(24 * 24, 3), need_rays=False)
    for k, v in bar_p.items():
        np.testing.assert_allclose(ts.prim_params[k].grad.numpy(),
                                   v.numpy(), rtol=1e-6, atol=1e-7)


def test_backward_is_finite_with_lanes_that_miss_the_bound():
    """A lane that never enters the scene's bound carries ``t = 3e38`` (the
    raw march's mark): the backward evaluates such lanes at their origin,
    so their zero cotangent meets no overflowed distance — the gradients
    are finite and equal those of the same lanes marked ``t = 0``."""
    ts = tft.flatten(TG.torus_csg_scene(seed=19, n_tori=48),
                     device="cpu").requires_grad_(True)
    _jr, tr = flat_camera_rays(24, 24)
    cfg = TMC(backend="cuda", max_steps=96, cull_threshold=32)
    from fraytracer_tpu_torch.ops.cuda.march_kernel import cuda_march_raw
    raw, _n, _mm, code = cuda_march_raw(ts, tr, cfg, want_surface=True)
    assert 0 < int(raw.hit.sum()) < raw.hit.numel()
    rng = np.random.default_rng(2)
    w_t = torch.from_numpy(rng.normal(size=24 * 24).astype(np.float32))
    w_n = torch.from_numpy(rng.normal(size=(24 * 24, 3)).astype(np.float32))
    got = {}
    for mark in (3.0e38, 0.0):
        t = torch.where(raw.hit, raw.t, mark)
        got[mark] = tmarch_mod.implicit_vjp(
            ts, tr, t, raw.hit, tmarch_mod._leaf_scene_d(ts, code), cfg,
            w_t, w_n)
    for a, b in zip(got[3.0e38][0].values(), got[0.0][0].values()):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(got[3.0e38][1:], got[0.0][1:]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # the same through the entry point: a frame whose corner rays miss
    hp = tmarch_mod.hit_points(tr, torch.where(raw.hit, raw.t, 3.0e38),
                               raw.hit)
    assert float(hp.abs().max()) < 100.0
