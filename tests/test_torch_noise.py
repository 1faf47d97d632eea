"""Port parity, procedural noise and the procedural albedo:
``fraytracer_tpu_torch.utils.noise`` against ``fraytracer_tpu.utils.noise``
on points from a numpy seed, and ``albedo_of`` / ``material_at`` with a
procedural material against JAX.

Tolerance 1e-5: both packages hash the same permutation table (numpy seed
19) and blend eight corners with the same quintic fade in float32; only the
rounding order of the lerps and the fbm sum differs.  Points stay off the
lattice planes by 1e-3 so that ``floor`` picks one cell in both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fraytracer_tpu as jft
import fraytracer_tpu_torch as tft
from fraytracer_tpu.ops import sdf as jsdf
from fraytracer_tpu.utils import noise as jnoise
from fraytracer_tpu_torch.ops import sdf as tsdf
from fraytracer_tpu_torch.utils import noise as tnoise

ATOL = 1e-5


def points(seed, n=512, span=20.0):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-span, span, size=(n, 3))
    frac = p - np.floor(p)
    p = np.floor(p) + np.clip(frac, 1e-3, 1.0 - 1e-3)
    return p.astype(np.float32)


def test_permutation_table_equal():
    np.testing.assert_array_equal(tnoise._PERM, np.asarray(jnoise._PERM))


@pytest.mark.parametrize("name", ["value_noise", "gradient_noise"])
def test_base_noise_matches_jax(name):
    p = points(1)
    got = getattr(tnoise, name)(torch.from_numpy(p)).numpy()
    want = np.asarray(getattr(jnoise, name)(jnp.asarray(p)))
    assert got.shape == (512,)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert got.std() > 0.1 and np.abs(got).max() <= 1.0 + 1e-5


@pytest.mark.parametrize("kw", [dict(), dict(octaves=3),
                                dict(octaves=5, lacunarity=2.5, gain=0.4),
                                dict(noise="value_noise")])
def test_fbm_matches_jax(kw):
    p = points(2, span=6.0).reshape(16, 32, 3)      # any batch shape
    base = kw.pop("noise", None)
    tkw, jkw = dict(kw), dict(kw)
    if base:
        tkw["noise"], jkw["noise"] = getattr(tnoise, base), \
            getattr(jnoise, base)
    got = tnoise.fbm(torch.from_numpy(p), **tkw).numpy()
    want = np.asarray(jnoise.fbm(jnp.asarray(p), **jkw))
    assert got.shape == (16, 32)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_noise_is_differentiable():
    p = torch.from_numpy(points(3, n=64)).requires_grad_(True)
    tnoise.fbm(p).sum().backward()
    assert bool(torch.isfinite(p.grad).all()) and bool(p.grad.abs().sum() > 0)


def procedural_scene(N):
    return N.Scene(root=N.union(
        N.sphere((0, 0, 0), 1.0,
                 material=N.procedural((1, 0, 0), (0, 0, 1), scale=3.0)),
        N.sphere((1.5, 0, 0), 0.8, material=N.solid(0.2, 0.9, 0.2)),
        N.box((0, -1.5, 0), (2, 0.2, 2), 0.05,
              material=N.procedural((0.9, 0.9, 0.1), (0.1, 0.1, 0.1)))))


def test_procedural_albedo_matches_jax():
    js = jft.flatten(procedural_scene(jft))
    ts = tft.flatten(procedural_scene(tft), device="cpu")
    p = points(4, n=1024, span=2.5)
    m_t, a_t = tsdf.material_at(ts, torch.from_numpy(p))
    m_j, a_j = jsdf.material_at(js, jnp.asarray(p))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=ATOL)
    # albedo_of alone, any batch shape, every material index
    midx = np.random.default_rng(5).integers(0, 3, size=(8, 128))
    q = p.reshape(8, 128, 3)
    got = tsdf.albedo_of(ts, torch.from_numpy(midx), torch.from_numpy(q))
    want = jsdf.albedo_of(js, jnp.asarray(midx), jnp.asarray(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the solid material is constant, the procedural ones vary with p
    solid = midx == list(ts.mat_kind).index(0)
    assert np.ptp(got.numpy()[solid], axis=0).max() == 0.0
    assert got.numpy()[~solid].std(0).max() > 0.05


def test_procedural_frame_matches_jax():
    """A 32² frame whose hits carry a procedural albedo, "cuda" backend on
    CPU tensors against JAX "jnp": max |Δ| < 2e-3 on ≥ 99.5% of pixels (the
    frame tolerance of test_torch_render.py)."""
    build = lambda N: N.Scene(
        root=procedural_scene(N).root, background=(0.1, 0.1, 0.1),
        lights=(N.directional_light((-0.4, -1.0, 0.6), (0.8, 0.8, 0.8)),))
    js, ts = jft.flatten(build(jft)), tft.flatten(build(tft), device="cpu")
    jimg = np.asarray(jft.render(
        js, jft.look_at((0, 1, -6), (0, 0, 0)),
        jft.RenderConfig(width=32, height=32)))
    timg = tft.render(
        ts, tft.look_at((0, 1, -6), (0, 0, 0), device="cpu"),
        tft.RenderConfig(width=32, height=32,
                         march=tft.MarchConfig(backend="cuda"))).numpy()
    diff = np.abs(timg - jimg).max(-1)
    assert (diff < 2e-3).mean() >= 0.995 and float(np.median(diff)) < 1e-5
    assert (np.abs(timg - 0.1).max(-1) > 1e-3).mean() > 0.2
