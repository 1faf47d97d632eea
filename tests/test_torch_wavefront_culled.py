"""Port parity, spectral wavefront on the "cuda" backend: the port's
kernel glue on CPU tensors — the culled marches' candidate tables and
windows, sign lanes, the surface pass, the material repair, the block-tier
compaction through ``block_gather_plain`` — with each kernel's plain
version in the kernel's place.

Held to the JAX suite's bound between two march backends (max |Δ| <
5e-2, mean < 2e-3, ``tests/test_fused_surface.py``): against JAX
"pallas_interpret" on that test's glass scene, and against JAX "jnp" on the
spectral benchmark scene at 32² (eight 1024-lane tiles, so the block tier
runs).  Rays marched are compared where both routes leave the same normal
on lanes without a hit (JAX's kernel and the port's: the glass scene);
``_shade_local`` counts a shadow ray wherever that normal faces a light,
and "jnp" leaves another normal there, so the benchmark scene's counts
differ by those lanes."""
import numpy as np
import torch

import fraytracer_tpu as jft
import fraytracer_tpu_torch as tft
from fraytracer_tpu.ops import wavefront as jw
from fraytracer_tpu.ops.march import MarchConfig as JMC
from fraytracer_tpu.scene import generators as JG, nodes as JN
from fraytracer_tpu_torch.ops import wavefront as tw
from fraytracer_tpu_torch.ops.cuda import gather, march_kernel as mk
from fraytracer_tpu_torch.scene import generators as TG, nodes as TN


def glass(N):
    """tests/test_fused_surface.py::test_spectral_render_pallas_matches_jnp."""
    return N.Scene(
        root=N.union(N.sphere((0, 0.2, 0), 0.9,
                              material=N.dielectric(ior=1.5)),
                     N.plane((0, 1, 0), -1.2,
                             material=N.solid(0.7, 0.7, 0.7))),
        lights=[N.directional_light((0.3, -1.0, 0.5), (1.0, 1.0, 1.0))],
        background=(0.05, 0.05, 0.08))


def assert_bound(ti, ji):
    d = np.abs(ti.numpy() - np.asarray(ji))
    assert np.isfinite(ti.numpy()).all()
    assert d.max() < 5e-2 and d.mean() < 2e-3, (d.max(), d.mean())


def test_glass_scene_matches_jax_pallas():
    cam = ((0, 0.3, -4), (0, 0, 0))
    ji, jn = jw.render_spectral_with_stats(
        jft.flatten(glass(JN)), jft.look_at(*cam), 24, 24,
        jw.WavefrontConfig(depth=3, epsilon=1e-3,
                           march=JMC(backend="pallas_interpret")))
    ti, tn = tw.render_spectral_with_stats(
        tft.flatten(glass(TN), device="cpu"),
        tft.look_at(*cam, device="cpu"), 24, 24,
        tw.WavefrontConfig(depth=3, epsilon=1e-3,
                           march=tft.MarchConfig(backend="cuda")))
    assert ti.shape == (24, 24, 3)
    assert_bound(ti, ji)
    assert abs(int(tn) - float(jn)) <= 5e-3 * float(jn)


def test_spectral_scene_culled_route_matches_jax(monkeypatch):
    """``spectral_csg_scene(19, 64)`` at 32², depth 3: the culled route
    builds candidate tables for the primary round, the bounce rounds (their
    tables sized by ``bounce_cull_m``, here the whole 64-torus group) and
    every shadow march, and compacts the queue by whole blocks."""
    tables, gathers = [], []
    real_tables, real_gather = mk.build_pair_tables, gather.flat_block_gather

    def spy_tables(*a, **k):
        out = real_tables(*a, **k)
        tables.append([q.m for q in out.tables])
        return out

    def spy_gather(x, idx, n):
        gathers.append((x.shape[0], n))
        return real_gather(x, idx, n)
    monkeypatch.setattr(mk, "build_pair_tables", spy_tables)
    monkeypatch.setattr(gather, "flat_block_gather", spy_gather)
    cam = dict(fov_degrees=60.0)
    ji, jn = jw.render_spectral_with_stats(
        jft.flatten(JG.spectral_csg_scene(19, 64)),
        jft.look_at((0, 0, -10), (0, 0, 0), **cam), 32, 32,
        jw.WavefrontConfig(depth=3, march=JMC(max_steps=192)))
    ti, tn = tw.render_spectral_with_stats(
        tft.flatten(TG.spectral_csg_scene(19, 64), device="cpu"),
        tft.look_at((0, 0, -10), (0, 0, 0), device="cpu", **cam), 32, 32,
        tw.WavefrontConfig(depth=3, march=tft.MarchConfig()))
    assert_bound(ti, ji)
    # a march and two shadow marches a round, three rounds
    assert len(tables) == 9 and all(m == [64] for m in tables), tables
    # 8 fields moved by whole blocks after rounds 0 and 1, 16 blocks → 8
    # each (any other gather is the material repair's block tier)
    assert gathers.count((16 * 1024, 8)) == 16, gathers
    assert int(tn) >= 32 * 32
