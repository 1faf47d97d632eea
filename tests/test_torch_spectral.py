"""Port parity, spectral optics: ``fraytracer_tpu_torch.ops.spectral``
against ``fraytracer_tpu.ops.spectral`` on the same seeded inputs.

The tables are numpy in both packages and must be equal bit for bit; the
functions run the same float32 formulas in two frameworks, held to 1e-6 on
4096 cases that include grazing incidence (below the 1e-6 cosine clamp)
and total internal reflection.  The property tests of
``tests/test_spectral.py`` run on the port as cases of one test."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fraytracer_tpu.ops import spectral as js
from fraytracer_tpu_torch.ops import spectral as ts

N_CASES = 4096
ATOL = 1e-6


def t(x):
    return torch.from_numpy(np.asarray(x))


def optics_cases(seed=19, glass_to_air=False):
    """Unit incident directions, unit normals oriented against them, media
    indices; a quarter of the cases graze (cos θ from 1e-8 to 1e-3), and
    glass → air cases past the critical angle reflect totally."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N_CASES, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = rng.normal(size=(N_CASES, 3))
    n -= np.sum(n * d, axis=1, keepdims=True) * d        # ⟂ d
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    cos = rng.uniform(0.0, 1.0, N_CASES)
    graze = rng.random(N_CASES) < 0.25
    cos[graze] = 10.0 ** rng.uniform(-8, -3, int(graze.sum()))
    # normal = -cos·d + sin·(⟂ d): d·n = -cos
    normal = -cos[:, None] * d + np.sqrt(1 - cos ** 2)[:, None] * n
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    glass = rng.uniform(1.3, 1.8, N_CASES)
    n1, n2 = (glass, np.ones(N_CASES)) if glass_to_air \
        else (np.ones(N_CASES), glass)
    return [x.astype(np.float32) for x in (d, normal, n1, n2)]


def test_tables_equal_jax_bit_for_bit():
    assert ts.NUM_BINS == js.NUM_BINS
    assert ts.WAVELENGTHS_UM.dtype == js.WAVELENGTHS_UM.dtype == np.float32
    np.testing.assert_array_equal(ts.WAVELENGTHS_UM, js.WAVELENGTHS_UM)
    assert ts.BIN_RGB.dtype == js.BIN_RGB.dtype == np.float32
    np.testing.assert_array_equal(ts.BIN_RGB, js.BIN_RGB)


def test_bin_rgb_and_cauchy_ior_match_jax():
    rng = np.random.default_rng(7)
    wl = rng.integers(0, ts.NUM_BINS, N_CASES).astype(np.int32)
    ab = np.stack([rng.uniform(1.3, 1.8, N_CASES),
                   rng.uniform(0.0, 0.02, N_CASES)], -1).astype(np.float32)
    got = ts.bin_rgb(t(wl))
    assert got.shape == (N_CASES, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(js.bin_rgb(jnp.asarray(wl))))
    np.testing.assert_allclose(
        ts.cauchy_ior(t(ab), t(wl)).numpy(),
        np.asarray(js.cauchy_ior(jnp.asarray(ab), jnp.asarray(wl))),
        rtol=0, atol=ATOL)


@pytest.mark.parametrize("glass_to_air", [False, True])
def test_fresnel_matches_jax(glass_to_air):
    d, nrm, n1, n2 = optics_cases(glass_to_air=glass_to_air)
    got = ts.fresnel(t(d), t(nrm), t(n1), t(n2))
    want = js.fresnel(*(jnp.asarray(x) for x in (d, nrm, n1, n2)))
    names = ("R", "reflect_dir", "refract_dir", "tir")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        if name == "tir":
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL,
                                       err_msg=name)
    tir = got[3].numpy()
    if glass_to_air:
        assert 0.2 < tir.mean() < 0.9          # both regimes are covered
        np.testing.assert_array_equal(got[0].numpy()[tir], 1.0)
    else:
        assert not tir.any()


def test_schlick_matches_jax():
    d, nrm, n1, n2 = optics_cases(seed=3)
    np.testing.assert_allclose(
        ts.schlick(t(d), t(nrm), t(n1), t(n2)).numpy(),
        np.asarray(js.schlick(*(jnp.asarray(x) for x in (d, nrm, n1, n2)))),
        rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# tests/test_spectral.py's properties, on the port
# ---------------------------------------------------------------------------

def f32(x):
    return torch.tensor(x, dtype=torch.float32)


def oblique(deg):
    th = np.radians(deg)
    return f32([[np.sin(th), 0.0, np.cos(th)]]), f32([[0.0, 0.0, -1.0]])


def bin_rgb_partitions_white():
    np.testing.assert_allclose(ts.BIN_RGB.sum(axis=0), [1.0, 1.0, 1.0],
                               atol=1e-5)


def bin_rgb_hue_ordering():
    first, last = ts.BIN_RGB[0], ts.BIN_RGB[-1]
    assert first[2] > first[0] and last[0] > last[2]


def cauchy_dispersion_monotone():
    n = ts.cauchy_ior(f32([1.5, 0.01]), torch.arange(ts.NUM_BINS)).numpy()
    assert np.all(np.diff(n) < 0)
    assert n[0] > 1.5 and n[-1] > 1.5


def fresnel_normal_incidence():
    d, n = f32([[0.0, 0.0, 1.0]]), f32([[0.0, 0.0, -1.0]])
    R, refl, refr, tir = ts.fresnel(d, n, f32([1.0]), f32([1.5]))
    np.testing.assert_allclose(float(R[0]), ((1 - 1.5) / (1 + 1.5)) ** 2,
                               atol=1e-4)
    assert not bool(tir[0])
    np.testing.assert_allclose(refl[0].numpy(), [0, 0, -1], atol=1e-6)
    np.testing.assert_allclose(refr[0].numpy(), [0, 0, 1], atol=1e-6)


def fresnel_grazing_reflectance_to_one():
    d, n = oblique(89.5)
    R, *_ = ts.fresnel(d, n, f32([1.0]), f32([1.5]))
    assert float(R[0]) > 0.9


def total_internal_reflection():
    d, n = oblique(60.0)
    R, _refl, _refr, tir = ts.fresnel(d, n, f32([1.5]), f32([1.0]))
    assert bool(tir[0])
    np.testing.assert_allclose(float(R[0]), 1.0, atol=1e-6)


def snell_refraction_angle():
    d, n = oblique(30.0)
    _R, _refl, refr, _ = ts.fresnel(d, n, f32([1.0]), f32([1.5]))
    refr = refr[0].numpy() / np.linalg.norm(refr[0].numpy())
    np.testing.assert_allclose(abs(refr[0]), np.sin(np.radians(30.0)) / 1.5,
                               atol=1e-4)


def reflection_is_mirror():
    d, n = oblique(45.0)
    _R, refl, *_ = ts.fresnel(d, n, f32([1.0]), f32([1.5]))
    np.testing.assert_allclose(refl[0].numpy(),
                               [np.sqrt(0.5), 0, -np.sqrt(0.5)], atol=1e-5)


def schlick_close_to_fresnel():
    for deg in (0.0, 30.0, 60.0):
        d, n = oblique(deg)
        R, *_ = ts.fresnel(d, n, f32([1.0]), f32([1.5]))
        Rs = ts.schlick(d, n, f32([1.0]), f32([1.5]))
        assert abs(float(R[0]) - float(Rs[0])) < 0.03


PROPERTIES = [bin_rgb_partitions_white, bin_rgb_hue_ordering,
              cauchy_dispersion_monotone, fresnel_normal_incidence,
              fresnel_grazing_reflectance_to_one, total_internal_reflection,
              snell_refraction_angle, reflection_is_mirror,
              schlick_close_to_fresnel]


@pytest.mark.parametrize("prop", PROPERTIES, ids=lambda f: f.__name__)
def test_spectral_property(prop):
    prop()
