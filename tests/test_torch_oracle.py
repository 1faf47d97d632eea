"""The port's float64 oracle (``fraytracer_tpu_torch/oracle/cpu_ref.py``)
and Catmull-Rom splines against the JAX package's, and ``chip_smoke.py``'s
oracle gate on the port's plain frames.

The oracle is the reference, so its copy must equal JAX's bit for bit
(``==`` on float64) on the same scenes, each built once with each
package's own ``nodes`` / ``generators``: ``build_distance`` dispatches on
the node classes, which are not shared between the packages.  Splines
within 1e-6 (float32 in two frameworks).  The gate is loaded from
``chip_smoke.py`` by path (the one gate the card runs, with
tests/test_benchmark_oracle.py's bounds)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fraytracer_tpu_torch as tft
from fraytracer_tpu.oracle import cpu_ref as jref
from fraytracer_tpu.scene import generators as JG, nodes as JN
from fraytracer_tpu.utils import noise as jnoise
from fraytracer_tpu_torch.oracle import cpu_ref as tref
from fraytracer_tpu_torch.ops.march import MarchConfig as TMC
from fraytracer_tpu_torch.scene import generators as TG, nodes as TN
from fraytracer_tpu_torch.utils import noise as tnoise
from test_torch_render import load_chip_smoke
from test_torch_surface_ad import blend96

EPS = 0.01
CAM = (0.0, 0.0, -10.0)
E2E_CAM = (0.0, 0.6, -2.6)


def primitives(N):
    """The seven kinds as tests/test_primitives.py::test_matches_oracle
    places them."""
    return {
        "sphere": N.sphere((0.3, -0.2, 0.5), 0.7),
        "capsule": N.capsule((-1, 0, 0), (1, 0.5, 0.3), 0.3),
        "torus": N.torus((0.1, 0.2, -0.3), (1, 2, 0.5), 0.8, 0.2),
        "triangle": N.triangle((0, 0, 0), (1, 0.2, 0), (0.3, 1, 0.5), 0.15),
        "box": N.box((0.2, -0.1, 0.4), (0.5, 0.8, 0.3), 0.05),
        "cone": N.cone((0, -1, 0), (0.2, 1, 0.1), 0.6, 0.2),
        "plane": N.plane((0.3, 1, -0.2), 0.4),
    }


def operators(N):
    """The operators of tests/test_csg.py on its A, B, C, its mixed tree,
    and a union of groups of 40 (the vectorized path for sphere, capsule,
    torus and box; the scalar fallback for cone)."""
    a = N.sphere((0, 0, 0), 1.0)
    b = N.sphere((1.2, 0, 0), 0.8)
    c = N.box((0, 1, 0), (0.5, 0.5, 0.5), 0.1)
    rng = np.random.default_rng(5)

    def at():
        return tuple(rng.uniform(-2, 2, 3).tolist())
    groups = []
    for _ in range(40):
        groups += [N.sphere(at(), 0.3), N.capsule(at(), at(), 0.1),
                   N.torus(at(), at(), 0.4, 0.1), N.box(at(), (0.2, 0.3, 0.1),
                                                        0.02),
                   N.cone(at(), at(), 0.3, 0.1)]
    return {
        "union": N.union(a, b, c),
        "intersect": N.intersect(a, b, c),
        "subtract": N.subtract(a, b),
        "smooth_union": N.smooth_union(0.2, a, b, c),
        "mixed": N.subtract(
            N.intersect(N.union(a, b, N.smooth_union(
                0.3, c, N.sphere((0, -1, 0), 0.7))),
                N.sphere((0, 0, 0), 2.5)),
            N.torus((0, 0, 0), (0, 0, 1), 1.5, 0.4)),
        "groups": N.union(*groups),
    }


def small_scene(N, G):
    """tests/test_render_e2e.py::small_scene."""
    return N.Scene(
        root=N.subtract(
            N.intersect(
                N.union(
                    N.sphere((0, 0, 0), 1.0, material=N.solid(0.8, 0.2, 0.2)),
                    N.torus((0.7, 0.2, 0), (0.3, 1, 0), 0.8, 0.25,
                            material=N.solid(0.2, 0.7, 0.3)),
                    N.box((-0.8, -0.4, 0.3), (0.4, 0.4, 0.4), 0.1,
                          material=N.solid(0.2, 0.3, 0.9)),
                ),
                N.sphere((0, 0, 0), 1.6),
            ),
            N.sphere((0.4, 0.6, -0.9), 0.6),
        ),
        background=(0.1, 0.1, 0.1),
        lights=(
            N.directional_light((-0.5, -1, 1), (0.5, 0.5, 0.5)),
            N.point_light((-0.5, 0, -2), (10.0, 0.0, 0.0)),
        ),
    )


RENDERED = {"torus96": lambda N, G: G.torus_csg_scene(seed=19, n_tori=96),
            "blend96": blend96}


@pytest.fixture(scope="module")
def cs():
    return load_chip_smoke()


def points(n=256, seed=3):
    return np.random.default_rng(seed).uniform(-3, 3, (n, 3))


@pytest.mark.parametrize("name", list(primitives(TN)) + list(operators(TN)))
def test_build_distance_bit_for_bit(name):
    """``build_distance`` of each kind and operator at 256 seeded points
    equals JAX's exactly."""
    build = primitives if name in primitives(TN) else operators
    fj = jref.build_distance(build(JN)[name])
    ft_ = tref.build_distance(build(TN)[name])
    pts = points()
    got = np.array([ft_(p) for p in pts])
    want = np.array([fj(p) for p in pts])
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_nodes_of_the_other_package_are_refused():
    """Each oracle takes its own package's nodes only."""
    with pytest.raises(TypeError):
        tref.build_distance(JN.union(JN.sphere((0, 0, 0), 1.0),
                                     JN.box((0, 1, 0), (1, 1, 1), 0.1)))
    with pytest.raises(TypeError):
        jref.build_distance(TN.subtract(TN.sphere((0, 0, 0), 1.0),
                                        TN.sphere((1, 0, 0), 0.5)))


def test_march_min_and_shade_ray_bit_for_bit(cs):
    """64 rays of the e2e scene (seeded pixels of its 128² frame): the
    march with its minimum distance, and the shaded color with every aux
    entry (hit, t, min_d, occlusion bits, shadow minima), equal."""
    jo = jref.Oracle(small_scene(JN, JG))
    to = tref.Oracle(small_scene(TN, TG))
    pixels = np.random.default_rng(2).choice(128 * 128, 64, replace=False)
    rays = cs.oracle_rays(E2E_CAM, 128, 128, pixels)
    hits = 0
    for o, d in rays:
        assert to.march_min(o, d, EPS, 30.0) == jo.march_min(o, d, EPS, 30.0)
        assert to.march(o, d, EPS, 30.0, 64) == jo.march(o, d, EPS, 30.0, 64)
        aux_t, aux_j = {}, {}
        np.testing.assert_array_equal(
            to.shade_ray(o, d, EPS, 30.0, aux=aux_t),
            jo.shade_ray(o, d, EPS, 30.0, aux=aux_j))
        assert aux_t == aux_j
        hits += aux_t["hit"]
    assert 16 <= hits < 64


@pytest.mark.parametrize("name", list(RENDERED))
def test_render_bit_for_bit(name):
    """``Oracle.render`` at 16² with its aux: the 96-torus scene and its
    blend (a smooth union over the torus root)."""
    kw = dict(fov_degrees=60.0, width=16, height=16, epsilon=EPS,
              length=30.0, return_aux=True)
    img_t, aux_t = tref.Oracle(RENDERED[name](TN, TG)).render(
        CAM, (0, 0, 0), **kw)
    img_j, aux_j = jref.Oracle(RENDERED[name](JN, JG)).render(
        CAM, (0, 0, 0), **kw)
    np.testing.assert_array_equal(img_t, img_j)
    assert aux_t == aux_j
    assert 0.05 < np.mean([a["hit"] for row in aux_t for a in row]) < 0.9


def test_chip_smoke_sample_equals_oracle_render(cs):
    """``chip_smoke.oracle_sample`` (its rays computed as ``Oracle.render``
    computes them) equals the render at the sampled pixels bit for bit."""
    scene = RENDERED["torus96"](TN, TG)
    img, aux = tref.Oracle(scene).render(
        CAM, (0, 0, 0), fov_degrees=60.0, width=24, height=16, epsilon=EPS,
        length=30.0, return_aux=True)
    pixels = np.random.default_rng(4).choice(24 * 16, 48, replace=False)
    want, got_aux, _secs = cs.oracle_sample(scene, CAM, 24, 16, pixels,
                                            workers=1)
    y, x = np.divmod(pixels, 24)
    np.testing.assert_array_equal(want, img[y, x])
    assert got_aux == [aux[i][j] for i, j in zip(y, x)]


def test_catmull_rom_matches_jax():
    """``catmull_rom`` on 4096 seeded cases and ``catmull_rom_1d`` through
    tests/test_noise_checkpoint.py's knots, inside and outside [0, n-1],
    within 1e-6 of JAX's."""
    rng = np.random.default_rng(8)
    p = rng.uniform(-4, 4, (5, 4096)).astype(np.float32)
    got = tnoise.catmull_rom(*(tft_t(x) for x in p)).numpy()
    want = np.asarray(jnoise.catmull_rom(*(jnp.asarray(x) for x in p)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    knots = [0.0, 1.0, 4.0, 9.0, 16.0]
    t = np.concatenate([np.arange(5.0), np.linspace(-1.5, 5.5, 57)]) \
        .astype(np.float32)
    got = tnoise.catmull_rom_1d(knots, tft_t(t)).numpy()
    want = np.asarray(jnoise.catmull_rom_1d(jnp.asarray(knots),
                                            jnp.asarray(t)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[:5], knots, atol=1e-6)
    assert 1.0 < float(tnoise.catmull_rom_1d(knots, 1.5,
                                             device="cpu")) < 4.0
    # knots given as a tensor and t as a float: the knots' device
    one = tnoise.catmull_rom_1d(tft_t(np.array(knots, np.float32)), 2.5)
    assert one.device.type == "cpu"
    assert one.shape == () and abs(float(one) - float(
        jnoise.catmull_rom_1d(jnp.asarray(knots), 2.5))) <= 1e-6


def tft_t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def torus96_frames(cs):
    """The port's plain 64² frames (the "cuda" route on CPU tensors) of
    the 96-torus scene, culled and dense, as tests/test_benchmark_oracle.py
    configures its frame, and the port's oracle over the whole frame."""
    scene = tft.flatten(TG.torus_csg_scene(19, 96), device="cpu")
    cam = tft.look_at(CAM, (0, 0, 0), fov_degrees=60.0, device="cpu")
    frames = {}
    for cull in (True, False):
        cfg = tft.RenderConfig(width=64, height=64, epsilon=EPS, length=30.0,
                               march=TMC(backend="cuda", cull=cull,
                                         bound_skip=True, max_steps=512))
        frames[cull] = cs.frame_outcomes(scene, cam, cfg)
    oracle = cs.oracle_sample(TG.torus_csg_scene(19, 96), CAM, 64, 64,
                              range(64 * 64), workers=1)
    return frames, oracle


@pytest.mark.parametrize("cull", [True, False])
def test_chip_smoke_gate_on_the_plain_frame(cs, torus96_frames, cull):
    """The card's gate function on the port's plain frame against the
    port's oracle: every bound of the benchmark gate holds."""
    frames, oracle = torus96_frames
    img, hit, t, facing, occ = frames[cull]
    assert img.shape == (64 * 64, 3) and len(facing) == len(occ) == 2
    r = cs.oracle_gate("torus96 64^2", frames[cull], oracle, oracle_hit=0.1)
    assert r["rays"] == 64 * 64
    assert r["clean_share"] > 0.6 and r["median"] < 1e-5


@pytest.mark.parametrize("fault", ["color", "hit", "occlusion", "t"])
def test_chip_smoke_gate_catches_a_faulty_frame(cs, torus96_frames, fault):
    """The gate is not vacuous: the culled frame with one kind of fault
    planted fails it, each with the bound that names the fault."""
    frames, oracle = torus96_frames
    want, aux, _s = oracle
    img, hit, t, facing, occ = (
        x.copy() if isinstance(x, np.ndarray) else [o.copy() for o in x]
        for x in frames[True])
    hit_o = np.array([a["hit"] for a in aux])
    min_o = np.array([a["min_d"] for a in aux])
    both = np.flatnonzero(hit & hit_o)
    if fault == "color":        # clean pixels off by 2e-4
        img[both[::4]] += 2e-4
        match = "clean-pixel error"
    elif fault == "hit":        # a miss far from every surface
        far = np.flatnonzero(~hit & ~hit_o & (min_o > 0.5))[0]
        hit[far] = True
        match = "not a grazing ray"
    elif fault == "occlusion":  # every both-hit pixel facing light 0
        occ[0][np.flatnonzero(hit & hit_o & facing[0])] = True
        match = "occlusion flip"
    else:                       # hits half a unit beyond the oracle's
        t[both[::2]] += 0.5
        match = "divergent"
    with pytest.raises(AssertionError, match=match):
        cs.oracle_gate("planted fault", (img, hit, t, facing, occ), oracle,
                       oracle_hit=0.1)
