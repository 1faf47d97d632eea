"""Port parity, spectral wavefront: ``fraytracer_tpu_torch.ops.wavefront``
on the plain "torch" backend against ``fraytracer_tpu.ops.wavefront`` on
"jnp", on the scenes of ``tests/test_wavefront.py``; and the queue
compaction of both tiers against the JAX package's on the same seeded
queue.

Tolerances: compaction exactly (the same stable sorts on the same keys);
the diffuse frame within 2e-5 of the port's own plain render (the JAX
test's bound) and within the frame tolerance against JAX (max |Δ| < 2e-3,
median < 1e-5); the specular scenes within the JAX suite's bound between
two of its backends (max |Δ| < 5e-2, mean < 2e-3,
``tests/test_fused_surface.py``: hit points drift within the ε shell and
refraction amplifies that on curved glass); rays marched within 0.5% (in
the diffuse frame, off the lanes without a hit: see its test)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fraytracer_tpu as jft
import fraytracer_tpu_torch as tft
from fraytracer_tpu.ops import wavefront as jw
from fraytracer_tpu.ops.march import MarchConfig as JMC
from fraytracer_tpu.ops.pallas.gather import flat_block_gather as jgather
from fraytracer_tpu.scene import nodes as JN
from fraytracer_tpu_torch.ops import wavefront as tw
from fraytracer_tpu_torch.ops.cuda.gather import BLOCK
from fraytracer_tpu_torch.scene import nodes as TN

JMARCH = JMC(max_steps=128)
TMARCH = tft.MarchConfig(max_steps=128, backend="torch")


def diffuse(N):
    return N.Scene(
        root=N.union(
            N.sphere((0, 0, 0), 1.0, material=N.solid(0.8, 0.3, 0.2)),
            N.box((1.4, 0, 0), (0.4, 0.4, 0.4), 0.05,
                  material=N.solid(0.2, 0.4, 0.9))),
        background=(0.1, 0.1, 0.1),
        lights=(N.directional_light((-0.4, -1, 0.8), (0.6, 0.6, 0.6)),))


def mirror_floor(N):
    return N.Scene(
        root=N.union(
            N.sphere((0, 0.8, 0), 0.8, material=N.solid(0.9, 0.1, 0.1)),
            N.plane((0, 1, 0), 0.0, material=N.mirror(0.9))),
        background=(0.05, 0.05, 0.05),
        lights=(N.directional_light((0.2, -1, 0.3), (1.0, 1.0, 1.0)),))


def glass_bar(N, dispersion=0.08):
    return N.Scene(
        root=N.union(
            N.sphere((0, 0, 0), 1.0,
                     material=N.dielectric(ior=1.5, dispersion=dispersion)),
            N.box((0, 0, 3.0), (0.15, 2.0, 0.05),
                  material=N.emissive(5.0, 5.0, 5.0))),
        background=(0.0, 0.0, 0.0))


def lone_sphere(mat):
    return lambda N: N.Scene(
        root=N.sphere((0, 0, 0), 1.0, material=mat(N)),
        background=(0.1, 0.1, 0.1),
        lights=(N.directional_light((0, 0, 1), (1.0, 1.0, 1.0)),))


def empty(N):
    return N.Scene(root=N.sphere((99, 99, 99), 0.1),
                   background=(0.2, 0.3, 0.4))


def both(build, pos, target, size, **wcfg):
    """The same scene and camera through both packages → (JAX image, JAX
    rays, port image, port rays)."""
    js = jft.flatten(build(JN))
    ts = tft.flatten(build(TN), device="cpu")
    ji, jn = jw.render_spectral_with_stats(
        js, jft.look_at(pos, target), size, size,
        jw.WavefrontConfig(march=JMARCH, **wcfg))
    ti, tn = tw.render_spectral_with_stats(
        ts, tft.look_at(pos, target, device="cpu"), size, size,
        tw.WavefrontConfig(march=TMARCH, **wcfg))
    assert ti.shape == (size, size, 3) and ti.dtype == torch.float32
    assert torch.isfinite(ti).all()
    return np.asarray(ji), float(jn), ti.numpy(), int(tn)


def assert_close_frames(ji, jn, ti, tn):
    d = np.abs(ti - ji)
    assert d.max() < 5e-2 and d.mean() < 2e-3, (d.max(), d.mean())
    assert abs(tn - jn) <= 5e-3 * jn, (tn, jn)


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------

def test_block_compact_key_prefers_dense_active_blocks():
    """tests/test_wavefront.py's case: the two fully active blocks first,
    the low-throughput block ahead of the sparse active one, the dead
    block last; the key equal to JAX's."""
    klass = np.asarray([0, 0, 0, 0, 0, 2, 2, 2, 0, 0, 0, 0, 1, 1, 1, 1,
                        2, 2, 2, 2], np.int32)
    key = tw.block_compact_key(torch.from_numpy(klass), 4)
    np.testing.assert_array_equal(
        key.numpy(), np.asarray(jw.block_compact_key(jnp.asarray(klass), 4)))
    order = np.argsort(key.numpy(), kind="stable")
    assert set(order[:2].tolist()) == {0, 2}
    assert order[2] == 3 and order[3] == 1 and order[4] == 4
    assert key[4] == 0 and (key[:4] < 0).all()


def seeded_children(two_c, seed=5):
    """A seeded double-width queue as numpy fields: per-block activity
    from empty to full (more active blocks than half the capacity, so the
    drop policy decides), throughputs across the drop threshold."""
    rng = np.random.default_rng(seed)
    nb = two_c // BLOCK
    density = rng.permutation(np.linspace(0.0, 1.0, nb))
    active = rng.random((nb, BLOCK)) < density[:, None]
    active = active.reshape(-1)
    T = np.where(active, rng.uniform(0.0, 0.2, two_c), 0.0)
    return dict(
        origin=rng.normal(size=(two_c, 3)).astype(np.float32),
        direction=rng.normal(size=(two_c, 3)).astype(np.float32),
        pixel=rng.integers(0, 1 << 20, two_c).astype(np.int32),
        wl=rng.integers(0, 8, two_c).astype(np.int32),
        throughput=T.astype(np.float32),
        length=np.where(active, rng.uniform(0, 30, two_c), 0)
        .astype(np.float32),
        inside=rng.random(two_c) < 0.3, active=active)


def jax_klass(q, cfg):
    """JAX's three classes (wavefront.py:262-263)."""
    low = q["active"] & (q["throughput"] < cfg.overflow_drop_threshold)
    return (~q["active"]).astype(jnp.int32) * 2 + low.astype(jnp.int32)


def assert_queue_equal(got: tw.RayQueue, want: dict):
    for f in dataclasses.fields(tw.RayQueue):
        g, w = getattr(got, f.name).numpy(), np.asarray(want[f.name])
        assert g.dtype == w.dtype, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)


def test_lane_tier_compaction_matches_jax():
    """The "torch" backend's lane tier against JAX's stable
    ``argsort(klass)[:C]`` gather (wavefront.py:268-271) on one 2C queue."""
    two_c = 6 * BLOCK
    q = seeded_children(two_c)
    cfg = tw.WavefrontConfig(march=TMARCH)
    got = tw._compact(tw.RayQueue(**{k: torch.from_numpy(v)
                                     for k, v in q.items()}),
                      two_c // 2, cfg)
    jq = {k: jnp.asarray(v) for k, v in q.items()}
    keep = jnp.argsort(jax_klass(jq, cfg), stable=True)[:two_c // 2]
    assert_queue_equal(got, {k: v[keep] for k, v in jq.items()})
    assert got.active.sum() == min(int(q["active"].sum()), two_c // 2)


def test_block_tier_compaction_matches_jax():
    """The "cuda" backend's block tier (through ``block_gather_plain`` on
    CPU tensors) against JAX's ``block_compact_key`` + stable argsort +
    ``flat_block_gather(..., interpret=True)`` (wavefront.py:248-266) on a
    queue of 8 × 1024 lanes, bool fields through int32 as in JAX."""
    two_c = 8 * BLOCK
    nb = two_c // 2 // BLOCK
    q = seeded_children(two_c, seed=11)
    cfg = tw.WavefrontConfig(march=tft.MarchConfig(backend="cuda"))
    got = tw._compact(tw.RayQueue(**{k: torch.from_numpy(v)
                                     for k, v in q.items()}),
                      two_c // 2, cfg)
    jq = {k: jnp.asarray(v) for k, v in q.items()}
    keep = jnp.argsort(jw.block_compact_key(jax_klass(jq, cfg), BLOCK),
                       stable=True)[:nb].astype(jnp.int32)

    def g(x):
        if x.dtype == jnp.bool_:
            return jgather(x.astype(jnp.int32), keep, nb,
                           interpret=True).astype(jnp.bool_)
        return jgather(x, keep, nb, interpret=True)
    assert_queue_equal(got, {k: g(v) for k, v in jq.items()})
    # the densest blocks were kept: more active lanes than any other pick
    per_block = q["active"].reshape(-1, BLOCK).sum(1)
    assert int(got.active.sum()) == int(np.sort(per_block)[-nb:].sum())


# ---------------------------------------------------------------------------
# frames (tests/test_wavefront.py's scenes)
# ---------------------------------------------------------------------------

def facing_misses(ft, march_surface, light_dir_and_dist, scene, cam, size):
    """Round 0's shadow lanes without a hit: lanes whose normal — what the
    backend leaves on a miss lane — faces a light.  Both packages march
    and count them (``_shade_local`` has no hit mask)."""
    rays = ft.camera_rays(cam, size, size, 0.01, 30.0)
    res, nrm, _m = march_surface(scene, rays, JMARCH if ft is jft
                                 else TMARCH)
    pos = rays.at(res.t - rays.epsilon)
    miss, nrm = ~np.asarray(res.hit), np.asarray(nrm)
    n = 0
    for i in range(scene.num_lights):
        ldir = np.asarray(light_dir_and_dist(scene, i, pos)[0])
        n += int(np.sum(miss & (np.sum(nrm * ldir, -1) > 0.0)))
    return n


def test_diffuse_scene_matches_plain_render_and_jax():
    """The bin filters sum to 1 and a diffuse scene skips the queue, so the
    frame is the plain render.  Rays marched: the two packages leave
    different normals on lanes without a hit (JAX at ``t − ε``, the port's
    plain route at the ray's origin, ``ops/march.py::hit_points``), and
    both count a shadow ray wherever that normal faces the light; off
    those lanes the counts agree within 0.5%."""
    from fraytracer_tpu.ops.march import march_surface as jsurf
    from fraytracer_tpu.ops.shade import light_dir_and_dist as jldir
    from fraytracer_tpu_torch.ops.march import march_surface as tsurf
    from fraytracer_tpu_torch.ops.shade import light_dir_and_dist as tldir
    cam = ((0, 0, -6), (0, 0, 0))
    ji, jn, ti, tn = both(diffuse, *cam, 24, depth=2, epsilon=0.01,
                          length=30.0)
    ts = tft.flatten(diffuse(TN), device="cpu")
    tcam = tft.look_at(*cam, device="cpu")
    plain = tft.render(ts, tcam,
                       tft.RenderConfig(width=24, height=24, epsilon=0.01,
                                        length=30.0, march=TMARCH))
    np.testing.assert_allclose(ti, plain.numpy(), atol=2e-5)
    d = np.abs(ti - ji).max(-1)
    assert d.max() < 2e-3 and np.median(d) < 1e-5
    jm = facing_misses(jft, jsurf, jldir, jft.flatten(diffuse(JN)),
                       jft.look_at(*cam), 24)
    tm = facing_misses(tft, tsurf, tldir, ts, tcam, 24)
    assert abs((tn - tm) - (jn - jm)) <= 5e-3 * (jn - jm), (tn, tm, jn, jm)


def test_mirror_reflects_scene():
    cam = ((0, 1.2, -5), (0, 0.4, 0))
    kw = dict(epsilon=0.005, length=40.0)
    ji, jn, ti, tn = both(mirror_floor, *cam, 32, depth=3, **kw)
    assert_close_frames(ji, jn, ti, tn)
    one = tw.render_spectral(tft.flatten(mirror_floor(TN), device="cpu"),
                             tft.look_at(*cam, device="cpu"), 32, 32,
                             tw.WavefrontConfig(depth=1, march=TMARCH, **kw))
    added = ti[20:] - one.numpy()[20:]     # reflected energy below the horizon
    assert added.max() > 0.01
    assert (added[..., 0] - added[..., 2]).max() > 0.005   # the red sphere


@pytest.mark.parametrize("dispersion", [0.08, 0.0])
def test_dielectric_matches_jax(dispersion):
    """Dispersive glass in front of an emissive bar, and the same glass
    without dispersion (the JAX test compares their chroma)."""
    ji, jn, ti, tn = both(lambda N: glass_bar(N, dispersion), (0, 0, -6),
                          (0, 0, 0), 48, depth=4, epsilon=0.005, length=40.0)
    assert_close_frames(ji, jn, ti, tn)


def test_dispersion_separates_wavelengths():
    """tests/test_wavefront.py's chroma property on the port alone."""
    cam = tft.look_at((0, 0, -6), (0, 0, 0), device="cpu")
    cfg = tw.WavefrontConfig(depth=4, epsilon=0.005, length=40.0,
                             march=TMARCH)
    imgs = [tw.render_spectral(tft.flatten(glass_bar(TN, disp),
                                           device="cpu"), cam, 48, 48,
                               cfg).numpy() for disp in (0.08, 0.0)]
    chroma = [(x.max(-1) - x.min(-1)).max() for x in imgs]
    assert chroma[0] > 2.0 * chroma[1] + 1e-3, chroma


@pytest.mark.parametrize("name", ["diffuse", "mirror"])
def test_energy_conservation_bound(name):
    """Each sphere against JAX, and no bounce creates energy: the mirror
    sphere's image sums to at most the diffuse one's."""
    mats = {"diffuse": lambda N: N.solid(1, 1, 1),
            "mirror": lambda N: N.mirror(0.95)}
    cam = ((0, 0, -5), (0, 0, 0))
    kw = dict(depth=4, epsilon=0.01, length=30.0)
    ji, jn, ti, tn = both(lone_sphere(mats[name]), *cam, 16, **kw)
    assert_close_frames(ji, jn, ti, tn)
    if name == "mirror":
        diffuse_img = tw.render_spectral(
            tft.flatten(lone_sphere(mats["diffuse"])(TN), device="cpu"),
            tft.look_at(*cam, device="cpu"), 16, 16,
            tw.WavefrontConfig(march=TMARCH, **kw))
        assert ti.sum() <= float(diffuse_img.sum()) * 1.05


def test_inactive_queue_is_stable():
    ji, jn, ti, tn = both(empty, (0, 0, -5), (0, 0, 0), 8, depth=4,
                          epsilon=0.01, length=20.0)
    assert_close_frames(ji, jn, ti, tn)
    np.testing.assert_allclose(
        ti, np.broadcast_to([0.2, 0.3, 0.4], (8, 8, 3)), atol=2e-5)
    assert tn == 64                          # the primary rays alone


def test_diffuse_scene_skips_the_queue(monkeypatch):
    """No mirror or dielectric material: the queue never runs, whatever
    the depth (read from the scene's material kinds, not the device)."""
    scene = tft.flatten(diffuse(TN), device="cpu")
    cam = tft.look_at((0, 0, -6), (0, 0, 0), device="cpu")
    calls = []
    real = tw._bounce
    monkeypatch.setattr(tw, "_bounce",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    a, na = tw.render_spectral_with_stats(
        scene, cam, 16, 16, tw.WavefrontConfig(depth=4, march=TMARCH))
    b, nb = tw.render_spectral_with_stats(
        scene, cam, 16, 16, tw.WavefrontConfig(depth=1, march=TMARCH))
    assert not calls
    assert torch.equal(a, b) and int(na) == int(nb)
