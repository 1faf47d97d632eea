"""Port parity, K1/K2 with a per-lane ``sign`` (-1 lanes march inside the
solid toward its exit surface).

The "torch" backend against JAX "jnp", and the "cuda" backend on CPU
tensors (``march_plain`` behind the real host glue, dense and culled)
against the JAX kernel in interpret mode, on the same rays and signs.

Tolerances: on the three inside rays of tests/test_fused_surface.py hit
sets equal and t within 1e-5 (a dozen steps of one sphere's distance; the
JAX test's own bound between its two backends); on the mixed-sign batch of
the 96-torus scene hit masks equal on ≥ 99.5% of lanes, every flip grazing,
and t within 1e-4 on lanes both hit (dense: up to 192 steps in two
frameworks, as in test_torch_march.py) or within the ε shell (culled: the
port's per-warp windows step differently from JAX's per-tile ones)."""
import numpy as np
import pytest
import torch

import fraytracer_tpu as jft
import fraytracer_tpu_torch as tft
import jax.numpy as jnp
from fraytracer_tpu.ops import sdf as jsdf
from fraytracer_tpu.ops.march import MarchConfig as JMC
from fraytracer_tpu.ops.march import march as jmarch
from fraytracer_tpu.ops.march import march_occlusion as jocclusion
from fraytracer_tpu.ops.march import march_surface as jmarch_surface
from fraytracer_tpu_torch.ops.cuda import cull as tcull
from fraytracer_tpu_torch.ops.march import MarchConfig as TMC
from fraytracer_tpu_torch.ops.march import march as tmarch
from fraytracer_tpu_torch.ops.march import march_occlusion as tocclusion
from fraytracer_tpu_torch.ops.march import march_surface as tmarch_surface
from test_torch_scene import flat_camera_rays, scene_pair, to_port_rays

EPS = 0.01
BACKENDS = {
    "torch_vs_jnp": (dict(backend="jnp"), dict(backend="torch")),
    "cuda_vs_pallas": (dict(backend="pallas_interpret", cull=False),
                       dict(backend="cuda", cull=False)),
    "cuda_vs_pallas_culled": (
        dict(backend="pallas_interpret", cull=True, cull_threshold=64,
             cull_m=128),
        dict(backend="cuda", cull=True, cull_threshold=64, cull_m=128)),
}


def two_spheres(N):
    return N.Scene(root=N.union(
        N.sphere((0, 0, 0), 1.0, material=N.solid(1, 1, 1)),
        N.sphere((3, 0, 0), 0.5)))


def inside_rays():
    """Three rays starting inside the unit sphere
    (tests/test_fused_surface.py::test_sign_march_pallas_matches_jnp)."""
    origins = np.array([[0.0, 0.0, 0.0], [0.2, 0.1, -0.5],
                        [0.0, 0.0, 0.9]], np.float32)
    dirs = np.array([[0, 0, 1.0]] * 3, np.float32)
    jr = jft.make_rays(origins, dirs, 100.0, 1e-3)
    return jr, to_port_rays(jr)


@pytest.mark.parametrize("case", ["torch_vs_jnp", "cuda_vs_pallas"])
def test_inside_rays_match_jax(case):
    jkw, tkw = BACKENDS[case]
    js = jft.flatten(two_spheres(jft))
    ts = tft.flatten(two_spheres(tft), device="cpu")
    jr, tr = inside_rays()
    j = jmarch(js, jr, JMC(max_steps=128, **jkw), sign=-jnp.ones(3))
    t = tmarch(ts, tr, TMC(max_steps=128, **tkw), sign=-torch.ones(3))
    assert t.hit.all() and np.asarray(j.hit).all()
    np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=1e-5)
    # the exit surface of the unit sphere along +z
    want = np.sqrt(1.0 - np.array([0.0, 0.05, 0.0])) - [0.0, -0.5, 0.9]
    np.testing.assert_allclose(t.t.numpy(), want, atol=2e-3)
    occ = tocclusion(ts, tr, TMC(max_steps=128, **tkw),
                     sign=-torch.ones(3))
    assert torch.equal(occ, t.hit)
    # a scalar sign broadcasts over the batch
    s = tmarch(ts, tr, TMC(max_steps=128, **tkw), sign=torch.tensor(-1.0))
    assert torch.equal(s.t, t.t)


def test_surface_on_sign_lanes_keeps_outward_normal():
    """The fused pass on sign lanes: the surface kernel takes no sign, its
    normal stays the outward gradient at the exit point."""
    js = jft.flatten(two_spheres(jft))
    ts = tft.flatten(two_spheres(tft), device="cpu")
    jr, tr = inside_rays()
    jres, jn, jm = jmarch_surface(js, jr, JMC(
        backend="pallas_interpret", cull=False, max_steps=128),
        sign=-jnp.ones(3))
    tres, tn, tm = tmarch_surface(ts, tr, TMC(
        backend="cuda", cull=False, max_steps=128), sign=-torch.ones(3))
    assert tres.hit.all()
    np.testing.assert_allclose(tres.t.numpy(), np.asarray(jres.t), atol=1e-5)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-4)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    pos = jr.at(jres.t - jr.epsilon)
    np.testing.assert_allclose(tn.numpy(),
                               np.asarray(jsdf.scene_normal(js, pos)),
                               atol=1e-4)
    assert (tn.numpy()[:, 2] > 0.9).all()        # outward along +z


def mixed_batch(js):
    """48×32 camera rays on the 96-torus scene; a seeded half of the lanes
    that hit restart 3ε inside the surface with sign -1, the rest keep
    their camera ray with sign +1."""
    jr, _tr = flat_camera_rays(48, 32)
    first = jmarch(js, jr, JMC(backend="jnp"))
    hit = np.asarray(first.hit)
    rng = np.random.default_rng(3)
    inside = hit & (rng.uniform(size=hit.shape) < 0.5)
    o, d = np.array(jr.origin), np.asarray(jr.direction)
    o[inside] = (o + (np.asarray(first.t) + 3 * EPS)[:, None] * d)[inside]
    sign = np.where(inside, -1.0, 1.0).astype(np.float32)
    jr = jft.make_rays(o, d, np.where(inside, 4.0, 30.0).astype(np.float32),
                       EPS)
    return jr, to_port_rays(jr), sign, inside


@pytest.mark.parametrize("case", sorted(BACKENDS))
def test_mixed_sign_batch_matches_jax(case):
    jkw, tkw = BACKENDS[case]
    js, ts = scene_pair("torus96")
    culled = tkw.get("cull", False)
    if culled:
        assert tcull._cull_pairs(ts.kind_counts, ts.plan, 64)
    jr, tr, sign, inside = mixed_batch(js)
    assert 100 < inside.sum() < inside.size - 100
    jcfg, tcfg = JMC(**jkw), TMC(**tkw)
    j = jmarch(js, jr, jcfg, sign=jnp.asarray(sign))
    t = tmarch(ts, tr, tcfg, sign=torch.from_numpy(sign))
    hj, ht = np.asarray(j.hit), t.hit.numpy()
    # the inside lanes find an exit surface
    assert hj[inside].mean() > 0.9
    flips = hj != ht
    assert flips.mean() <= 0.005
    if flips.any():
        assert np.abs(np.abs(np.asarray(j.distance)[flips]) - EPS).max() \
            < 1e-3, "a non-grazing hit flip"
    both = hj & ht
    np.testing.assert_allclose(t.t.numpy()[both], np.asarray(j.t)[both],
                               atol=EPS + 1e-4 if culled else 1e-4)
    # K2 names the hit set of K1 (the JAX kernel's occlusion mode takes no
    # sign in interpret mode, so JAX's occlusion is held only on "jnp")
    occ_t = tocclusion(ts, tr, tcfg, sign=torch.from_numpy(sign)).numpy()
    np.testing.assert_array_equal(occ_t, ht)
    if jkw["backend"] == "jnp":
        occ_j = np.asarray(jocclusion(js, jr, jcfg, sign=jnp.asarray(sign)))
        assert (occ_t == occ_j).mean() >= 0.995
