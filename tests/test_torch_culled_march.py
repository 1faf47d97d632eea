"""Port parity, the culled march (``MarchConfig(backend="cuda")`` with its
default ``cull=True``): on CPU tensors the "cuda" backend runs the culled
kernels' plain versions behind the real host glue (candidate tables,
per-warp windows, overflow re-run).  Held against JAX ``pallas_interpret``
culled, against the port's own dense march, and through the JAX suite's
culling tests (tests/test_pallas_march.py:321-627).

Tolerance: hit masks equal on ≥ 99.5% of lanes, every flip grazing (final
|d| within 1e-3 of ε); hit t within 3ε = 0.03 on lanes both hit — the JAX
suite's bound for two step sequences of one ray (``test_relaxed_march_
equivalent`` :439).  The port's windows span a warp (32 lanes) and JAX's a
tile, so the caps and hence the step sequences differ, and a hit lands
anywhere in the ε-shell, further along the ray at grazing incidence: JAX's
own culled march differs from its dense march by up to 0.0097 on the
96-torus scene at 32².  Where the JAX suite asserts exact
equality (occlusion vs march on the same tables, early-out on/off, the
overflow re-run) the port is held to exact equality too."""
import dataclasses

import numpy as np
import pytest
import torch

import fraytracer_tpu as jft
import fraytracer_tpu_torch as tft
from fraytracer_tpu.ops.march import MarchConfig as JMC
from fraytracer_tpu.ops.march import march as jmarch
from fraytracer_tpu_torch.ops import sdf as tsdf
from fraytracer_tpu_torch.ops.cuda import cull as tcull
from fraytracer_tpu_torch.ops.march import MarchConfig as TMC
from fraytracer_tpu_torch.ops.march import march as tmarch
from fraytracer_tpu_torch.ops.march import march_occlusion as tocclusion
from fraytracer_tpu_torch.ops.march import march_surface as tsurface
from test_torch_scene import flat_camera_rays, scene_pair

EPS = 0.01
CULL = TMC(backend="cuda", max_steps=192)
DENSE = dataclasses.replace(CULL, cull=False)


def assert_shell_close(hit_a, t_a, d_a, hit_b, t_b):
    """≥ 99.5% equal hits, flips grazing (|d_a| within 1e-3 of ε), t of
    lanes both hit within 3ε."""
    flips = hit_a != hit_b
    assert flips.mean() <= 0.005, f"{flips.sum()} hit flips"
    if flips.any():
        assert np.abs(np.abs(d_a[flips]) - EPS).max() < 1e-3
    both = hit_a & hit_b
    assert both.any()
    assert np.abs(t_a[both] - t_b[both]).max() < 3 * EPS


@pytest.fixture(scope="module")
def torus96():
    js, ts = scene_pair("torus96")
    jr, tr = flat_camera_rays(32, 32)
    return js, ts, jr, tr


@pytest.fixture(scope="module")
def jax_culled(torus96):
    """JAX pallas_interpret culled marches, once per file."""
    js, _ts, jr, _tr = torus96
    return {om: jmarch(js, jr, JMC(backend="pallas_interpret",
                                   max_steps=192, relax_omega=om))
            for om in (1.0, 1.4)}


@pytest.mark.parametrize("omega", [1.0, 1.4])
def test_culled_matches_jax_pallas(torus96, jax_culled, omega):
    _js, ts, _jr, tr = torus96
    assert tcull._cull_pairs(ts.kind_counts, ts.plan, 48)
    j = jax_culled[omega]
    t = tmarch(ts, tr, dataclasses.replace(CULL, relax_omega=omega))
    assert_shell_close(np.asarray(j.hit), np.asarray(j.t),
                       np.asarray(j.distance), t.hit.numpy(), t.t.numpy())


@pytest.mark.parametrize("omega", [1.0, 1.4])
def test_culled_matches_port_dense(torus96, omega):
    _js, ts, _jr, tr = torus96
    c = tmarch(ts, tr, dataclasses.replace(CULL, relax_omega=omega))
    d = tmarch(ts, tr, dataclasses.replace(DENSE, relax_omega=omega))
    assert_shell_close(d.hit.numpy(), d.t.numpy(), d.distance.numpy(),
                       c.hit.numpy(), c.t.numpy())
    # the culled march evaluates a window, not every primitive, per step
    assert int(c.steps.max()) <= 192


@pytest.mark.parametrize("omega", [1.0, 1.4])
def test_occlusion_equals_culled_march(omega):
    """Occlusion on the same tables steps exactly like the march (:321)."""
    _js, ts = scene_pair("torus96")
    _jr, tr = flat_camera_rays(48, 48)
    cfg = dataclasses.replace(CULL, relax_omega=omega, cull_threshold=64,
                              cull_m=128, cull_m_shadow=128)
    np.testing.assert_array_equal(tocclusion(ts, tr, cfg).numpy(),
                                  tmarch(ts, tr, cfg).hit.numpy())


def shell_rays(n=1024, seed=3):
    light = np.array([-0.5, 0.0, -2.0], np.float32)
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 3.2
    diff = light - o
    dist = np.linalg.norm(diff, axis=-1)
    act = rng.uniform(size=n) > 0.2
    rays = tft.Rays(torch.tensor(o, dtype=torch.float32),
                    torch.tensor(diff / dist[:, None], dtype=torch.float32),
                    torch.tensor(np.where(act, dist, 0.0),
                                 dtype=torch.float32),
                    torch.full((n,), EPS))
    return rays, torch.from_numpy(light)


@pytest.mark.parametrize("omega", [1.0, 1.4])
def test_occlusion_converging_cone(omega):
    """Point-light rays: occlusion without the apex equals the march; with
    the converging cone at most 0.5% grazing flips (:382)."""
    _js, ts = scene_pair("torus96")
    rays, light = shell_rays()
    cfg = dataclasses.replace(CULL, relax_omega=omega, cull_threshold=64,
                              cull_m=128, cull_m_shadow=128)
    full = tmarch(ts, rays, cfg).hit.numpy()
    np.testing.assert_array_equal(tocclusion(ts, rays, cfg).numpy(), full)
    conv = tocclusion(ts, rays, cfg, cone_apex=light).numpy()
    assert (conv != full).mean() <= 0.005
    assert full.any()


def test_occlusion_converging_cone_mixed_side_exact():
    """Origins straddling the light: far-side lanes pass through a fat
    occluder and must stay occluded under the two-sided envelope (:444)."""
    rng = np.random.default_rng(7)
    n = 1024
    o = rng.normal(scale=0.3, size=(n, 3)) + np.array([0.0, 0.0, -3.0])
    far = np.arange(48)
    o[far] = np.array([2.0, 0.0, 3.0]) + rng.normal(scale=0.05,
                                                    size=(48, 3))
    diff = -o
    dist = np.linalg.norm(diff, axis=-1)
    rays = tft.Rays(torch.tensor(o, dtype=torch.float32),
                    torch.tensor(diff / dist[:, None], dtype=torch.float32),
                    torch.tensor(dist, dtype=torch.float32),
                    torch.full((n,), EPS))
    spheres = [tft.sphere(tuple(c), 0.4) for c in
               rng.normal(scale=0.5, size=(95, 3)) + np.array([8.0] * 3)]
    spheres.append(tft.sphere((1.0, 0.0, 1.5), 0.45))
    spheres.append(tft.sphere((-1.2, 0.0, -2.5), 0.3))
    scene = tft.flatten(tft.Scene(root=tft.union(*spheres)), device="cpu")
    cfg = dataclasses.replace(CULL, cull_threshold=64, cull_m=128,
                              cull_m_shadow=128)
    plain = tocclusion(scene, rays, cfg).numpy()
    conv = tocclusion(scene, rays, cfg,
                      cone_apex=torch.zeros(3)).numpy()
    assert plain[far].all()
    np.testing.assert_array_equal(conv[far], plain[far])


def intersect_scene(extra):
    """256 fat spheres around the origin in one intersect (+ ``extra`` far
    members the camera tiles' cones exclude)."""
    rng = np.random.default_rng(5 if extra else 11)
    if extra:
        members = [tft.sphere(tuple(c), 2.0) for c in
                   rng.uniform(-0.3, 0.3, size=(256, 3))]
        members += [tft.sphere(tuple(c), 1.0) for c in
                    rng.normal(scale=0.5, size=(extra, 3)) + 40.0]
        target = tft.sphere((0, 0, 0), 1.0, material=tft.solid(0.9, 0.2, 0.1))
        return tft.flatten(tft.Scene(root=tft.union(
            tft.intersect(*members), target)), device="cpu")
    members = [tft.sphere(tuple(rng.uniform(-0.5, 0.5, 3)), 2.0,
                          material=tft.solid(*rng.uniform(0.2, 1.0, 3)))
               for _ in range(256)]
    return tft.flatten(tft.Scene(root=tft.intersect(*members),
                                 background=(0.1, 0.1, 0.1)), device="cpu")


def surface_vs_dense(scene, rays, cfg):
    """Fused culled surface pass against the dense normal / material at
    the culled march's own hit points."""
    res, nrm, midx = tsurface(scene, rays, cfg)
    h = res.hit.numpy()
    pos = rays.at(res.t - rays.epsilon)
    n_ref = tsdf.scene_normal(scene, pos).numpy()
    m_ref = tsdf.material_index_at(scene, pos).numpy()
    return res, h, np.abs(nrm.numpy() - n_ref)[h].max(), \
        (midx.numpy()[h] == m_ref[h]).all()


def test_intersect_group_cull_parity():
    """A 256-member intersect group takes the culled max path (skip bounds
    + excluded-member floor): hits equal the dense march's, normals and
    materials equal the dense ones (:343)."""
    scene = intersect_scene(0)
    pairs = tcull._cull_pairs(scene.kind_counts, scene.plan, 192)
    assert pairs
    _jr, rays = flat_camera_rays(32, 32, pos=(0, 0, -6))
    cfg = dataclasses.replace(CULL, cull_threshold=192, cull_m=512)
    c = tmarch(scene, rays, cfg)
    d = tmarch(scene, rays, DENSE)
    assert c.hit.numpy().mean() > 0.1
    np.testing.assert_array_equal(c.hit.numpy(), d.hit.numpy())
    h = c.hit.numpy()
    assert np.abs(c.t.numpy() - d.t.numpy())[h].max() < 3 * EPS
    _res, _h, nerr, mat_ok = surface_vs_dense(scene, rays, cfg)
    assert nerr < 1e-3 and mat_ok


def test_surface_max_group_excluded_member_floor():
    """A culled intersect with cone-excluded members at the hit tiles:
    without the 2·eps floor its scanned max wins the union and flips every
    normal; with it normals and materials equal the dense ones (:494)."""
    scene = intersect_scene(8)
    pairs = tcull._cull_pairs(scene.kind_counts, scene.plan, 192)
    assert any(p[4] - p[3] == 264 for p in pairs)
    _jr, rays = flat_camera_rays(32, 32, pos=(0, 0, -6))
    cfg = dataclasses.replace(CULL, cull_threshold=192, cull_m=512)
    _res, h, nerr, mat_ok = surface_vs_dense(scene, rays, cfg)
    assert h.mean() > 0.05
    assert nerr < 1e-3 and mat_ok


@pytest.mark.parametrize("omega", [1.0, 1.4])
def test_early_out_exact(omega):
    """The running-min early-out only skips chunks that cannot change the
    group min: t, hits and steps are identical with it on (:611)."""
    _js, ts = scene_pair("torus96")
    _jr, tr = flat_camera_rays(48, 48)
    base = dataclasses.replace(CULL, relax_omega=omega, cull_threshold=64,
                               cull_m=128)
    off = tmarch(ts, tr, base)
    on = tmarch(ts, tr, dataclasses.replace(base, cull_early_out=True))
    for f in ("hit", "t", "distance", "steps"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f


def test_overflow_rerun_equals_full_tables(monkeypatch):
    """cull_m=8 overflows every tile; the re-run with full-group tables
    gives exactly the result of asking for them (:2018-2043), for the
    march and for the fused surface pass."""
    from fraytracer_tpu_torch.ops.cuda import march_kernel as tmk
    _js, ts = scene_pair("torus96")
    _jr, tr = flat_camera_rays(32, 32)
    calls = []
    real = tmk.build_pair_tables
    monkeypatch.setattr(tmk, "build_pair_tables",
                        lambda *a, **k: calls.append(a[7]) or real(*a, **k))
    small = tmarch(ts, tr, dataclasses.replace(CULL, cull_m=8))
    assert calls == [8, 96]
    full = tmarch(ts, tr, dataclasses.replace(CULL, cull_m=96))
    for f in ("hit", "t", "distance", "steps"):
        assert torch.equal(getattr(small, f), getattr(full, f)), f
    a = tsurface(ts, tr, dataclasses.replace(CULL, cull_m=8))
    b = tsurface(ts, tr, dataclasses.replace(CULL, cull_m=96))
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def kinds_scene(N, per=8, seed=21):
    """A culled union group of every bounded kind (``per`` primitives
    each) plus a plane, spread around the origin."""
    rng = np.random.default_rng(seed)
    c = lambda: tuple(rng.uniform(-2.5, 2.5, 3))
    prims = []
    for _ in range(per):
        a = np.array(c())
        prims += [
            N.sphere(c(), 0.3, material=N.solid(1, 0, 0)),
            N.capsule(tuple(a), tuple(a + rng.normal(0, 0.4, 3)), 0.15),
            N.torus(c(), tuple(rng.normal(size=3)), 0.35, 0.1,
                    material=N.solid(0, 0, 1)),
            N.triangle(tuple(a), tuple(a + [0.5, 0, 0]),
                       tuple(a + [0, 0.5, 0.2]), 0.05),
            N.box(c(), (0.2, 0.3, 0.25), 0.03, material=N.solid(0, 1, 0)),
            N.cone(tuple(a), tuple(a + [0, 0.6, 0]), 0.3, 0.05),
        ]
    prims.append(N.plane((0, 1, 0), -3.5, material=N.solid(.5, .5, .5)))
    return N.Scene(root=N.union(*prims))


def test_all_kinds_culled():
    """One culled pair per bounded kind of one union group: the culled
    march against JAX pallas_interpret culled and the port's dense march;
    the fused surface pass against the dense normal / material."""
    from fraytracer_tpu.scene import generators as JG, nodes as JN
    from fraytracer_tpu_torch.scene import generators as TG, nodes as TN
    js = jft.flatten(kinds_scene(JN))
    ts = tft.flatten(kinds_scene(TN), device="cpu")
    pairs = tcull._cull_pairs(ts.kind_counts, ts.plan, 8)
    assert sorted(p[1] for p in pairs) == sorted(
        ["sphere", "capsule", "torus", "triangle", "box", "cone"])
    jr, tr = flat_camera_rays(32, 32, length=40.0)
    cfg = dataclasses.replace(CULL, cull_threshold=8, relax_omega=1.4)
    t = tmarch(ts, tr, cfg)
    d = tmarch(ts, tr, dataclasses.replace(cfg, cull=False))
    j = jmarch(js, jr, JMC(backend="pallas_interpret", max_steps=192,
                           cull_threshold=8, relax_omega=1.4))
    assert_shell_close(np.asarray(j.hit), np.asarray(j.t),
                       np.asarray(j.distance), t.hit.numpy(), t.t.numpy())
    assert_shell_close(d.hit.numpy(), d.t.numpy(), d.distance.numpy(),
                       t.hit.numpy(), t.t.numpy())
    _res, h, nerr, mat_ok = surface_vs_dense(ts, tr, cfg)
    assert h.mean() > 0.1 and nerr < 1e-3 and mat_ok


def test_shadow_tables_use_the_shadow_size(monkeypatch):
    """march_occlusion sizes its tables with max(cull_m, cull_m_shadow)
    and passes the point light's apex through (march.py:636-638)."""
    from fraytracer_tpu_torch.ops.cuda import march_kernel as tmk
    _js, ts = scene_pair("torus96")
    rays, light = shell_rays()
    seen = []
    real = tmk.build_pair_tables
    monkeypatch.setattr(tmk, "build_pair_tables",
                        lambda *a, **k: seen.append(a[7:10:2])
                        or real(*a, **k))
    tocclusion(ts, rays, dataclasses.replace(CULL, cull_m=16,
                                             cull_m_shadow=64),
               cone_apex=light)
    assert seen[0][0] == 64 and torch.equal(seen[0][1], light)
