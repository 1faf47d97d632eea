"""Port parity, culled point evaluation (``ops/point_eval.py``): normals,
material argmin, the exactness certificate and the implicit-diff VJP
against the dense path and against the JAX package on the same points.

Counterparts of the five tests of ``tests/test_point_eval.py`` with their
bounds, plus ``dist_fn`` and the certificate held against JAX's on the same
numpy-made points (1e-5: float32 distances summed in two orders; the
candidate *order* differs — ``torch.topk`` and ``lax.top_k`` break ties
differently — so distances and the certificate are compared, not indices).
Every tensor is on the CPU.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fraytracer_tpu as jft
import fraytracer_tpu_torch as tft
from fraytracer_tpu.ops import point_eval as jpe
from fraytracer_tpu.scene import generators as JG
from fraytracer_tpu_torch.ops import point_eval as tpe
from fraytracer_tpu_torch.ops import sdf as tsdf
from fraytracer_tpu_torch.ops import shade as tshade
from fraytracer_tpu_torch.ops.march import MarchConfig as TMC
from fraytracer_tpu_torch.ops.march import march as tmarch
from fraytracer_tpu_torch.scene import generators as TG
from test_torch_grad import port_of
from test_torch_scene import flat_camera_rays

CULLED = TMC(backend="cuda", max_steps=128, cull=True, cull_threshold=48,
             cull_m=64)
DENSE_NM = TMC(backend="cuda", max_steps=128, cull=False)


def tori(n):
    return tft.flatten(TG.torus_csg_scene(seed=19, n_tori=n), device="cpu")


def _hits(scene, rays, cfg):
    res = tmarch(scene, rays, cfg)
    return res, rays.at(res.t - rays.epsilon)


def test_culled_normal_material_match_dense():
    scene = tori(64)
    _jr, rays = flat_camera_rays(48, 48)
    res, pos = _hits(scene, rays, CULLED)
    hit = res.hit.numpy()
    assert hit.any()
    reads = tpe.STATS["certificate_reads"]
    out = tpe.culled_surface_eval(scene, pos, res.hit, m=64, threshold=48)
    assert out is not None, "torus group should be cull-eligible"
    assert tpe.STATS["certificate_reads"] == reads + 1   # one host read
    n_c, m_c, a_c = (x.numpy() for x in out)
    n_d = tsdf.scene_normal(scene, pos).numpy()
    m_d, a_d = (x.numpy() for x in tsdf.material_at(scene, pos))
    np.testing.assert_allclose(n_c[hit], n_d[hit], atol=1e-5)
    np.testing.assert_array_equal(m_c[hit], m_d[hit])
    np.testing.assert_allclose(a_c[hit], a_d[hit], atol=1e-6)


def test_culled_eval_none_without_big_groups():
    scene = tori(8)
    _jr, rays = flat_camera_rays(8, 8)
    res, pos = _hits(scene, rays, DENSE_NM)
    assert tpe.culled_surface_eval(scene, pos, res.hit, m=64,
                                   threshold=48) is None


def test_culled_surface_hit_matches_dense_trace():
    """The culled route against the dense one (both on the kernels' plain
    versions): exact hit parity, t within the ε shell, shading within
    O(ε · curvature), tight where the hit points coincide — also for the
    non-fused branch, which takes ``culled_surface_eval``."""
    scene = tori(64)
    _jr, rays = flat_camera_rays(32, 32)
    r_c = tmarch(scene, rays, CULLED)
    r_d = tmarch(scene, rays, DENSE_NM)
    hits = r_d.hit.numpy()
    np.testing.assert_array_equal(r_c.hit.numpy(), hits)
    tdiff = np.abs(r_c.t.numpy() - r_d.t.numpy())
    assert tdiff[hits].max() < 3 * 0.01
    img_d = tshade.trace(scene, rays, DENSE_NM).numpy()
    exact = (~hits) | (tdiff < 1e-6)
    calls = dict(tpe.STATS)
    for cfg in (CULLED, dataclasses.replace(CULLED, fuse_surface=False)):
        img_c = tshade.trace(scene, rays, cfg).numpy()
        assert np.abs(img_c - img_d).max() < 3e-3
        np.testing.assert_allclose(img_c[exact], img_d[exact], atol=1e-5)
    # the non-fused trace went through point_eval exactly once
    assert tpe.STATS["certificate_reads"] == calls["certificate_reads"] + 1


def degenerate_tile():
    """12 spheres along x with distinct materials; a tile of points near
    sphere 0 with one outlier at sphere 11."""
    def build(ft):
        return ft.Scene(root=ft.union(*[
            ft.sphere((3.0 * i, 0, 0), 1.0,
                      material=ft.solid(i / 12.0, 0.2, 0.2))
            for i in range(12)]))
    n = 64
    pos = np.tile(np.array([[0.0, 0.0, -1.2]], np.float32), (n, 1))
    pos += np.linspace(0, 0.1, n)[:, None].astype(np.float32)
    pos[-1] = [33.0, 0.0, -1.2]
    return build, pos, np.ones((n,), bool)


def test_certificate_catches_degenerate_tile():
    """A tile whose hit points span the scene so widely that an outlier's
    true nearest primitive is ranked out of the candidates must fail the
    certificate and still give the exact dense result."""
    build, pos, hit = degenerate_tile()
    scene = tft.flatten(build(tft), device="cpu")
    tp, th = torch.from_numpy(pos), torch.from_numpy(hit)
    built = tpe.build_culled_eval(scene, tp, th, m=2, threshold=4)
    assert built is not None
    assert not bool(built[-1]), "certificate must fail"
    dense_before = tpe.STATS["dense"]
    n_c, m_c, _a = (x.numpy() for x in tpe.culled_surface_eval(
        scene, tp, th, m=2, threshold=4))
    assert tpe.STATS["dense"] == dense_before + 1     # the dense route ran
    m_d, _ = (x.numpy() for x in tsdf.material_at(scene, tp))
    np.testing.assert_array_equal(m_c, m_d)   # incl. the outlier's mat 11
    np.testing.assert_allclose(n_c, tsdf.scene_normal(scene, tp).numpy(),
                               atol=1e-5)
    pos2 = np.tile(np.array([[0.0, 0.0, -1.2]], np.float32), (64, 1))
    built2 = tpe.build_culled_eval(scene, torch.from_numpy(pos2), th, m=4,
                                   threshold=4)
    assert bool(built2[-1]), "coherent tile should pass the certificate"


def test_culled_vjp_matches_dense_gradients():
    """(a) the culled backward equals the dense backward on the lanes where
    the two (sound) marches stop at the same point, within JAX's bound for
    its hit-drift envelope (8e-3 on O(10) gradients).  The port's windows
    are per warp, JAX's per tile, so more lanes land elsewhere in the ε
    shell here (9 of 576 against 1, |Δt| ≤ 0.0085); a drifted grazing lane
    moves a torus gradient by up to 0.34, so those lanes (≤ 5%) are left
    out of the loss instead of widening the bound; (b) on the same march,
    the fused surface backward equals the unfused (march → point_eval
    normal) chain to float precision."""
    _jr, rays = flat_camera_rays(24, 24)
    scene0 = tori(64)
    r_c, r_d = tmarch(scene0, rays, CULLED), tmarch(scene0, rays, DENSE_NM)
    same = (~r_d.hit) | ((r_c.t - r_d.t).abs() < 1e-6)
    assert bool((r_c.hit == r_d.hit).all())
    assert float(same.float().mean()) >= 0.95

    def grads(cfg, mask=None):
        scene = tori(64).requires_grad_(True)
        img = tshade.trace(scene, rays, cfg)
        if mask is not None:
            img = img * mask[:, None]
        img.sum().backward()
        return {k: v.grad.numpy() for k, v in scene.prim_params.items()}

    g_c, g_d = grads(CULLED, same), grads(DENSE_NM, same)
    g_f = grads(CULLED)
    g_nf = grads(dataclasses.replace(CULLED, fuse_surface=False))
    for kind in ("torus", "sphere"):
        assert np.abs(g_d[kind]).max() > 1.0
        np.testing.assert_allclose(g_c[kind], g_d[kind], atol=8e-3)
        np.testing.assert_allclose(g_f[kind], g_nf[kind], atol=5e-5)


@pytest.mark.parametrize("m,for_materials", [(16, True), (16, False),
                                             (64, True)])
def test_dist_fn_and_certificate_match_jax(m, for_materials):
    """The same hit points through both packages' ``build_culled_eval``:
    tile distances within 1e-5, the same certificate."""
    js = jft.flatten(JG.torus_csg_scene(seed=19, n_tori=64))
    ts = port_of(js)
    _jr, rays = flat_camera_rays(32, 32)
    res, pos = _hits(ts, rays, CULLED)
    kw = dict(m=m, threshold=48, tile=256, for_materials=for_materials)
    jb = jpe.build_culled_eval(js, jnp.asarray(pos.numpy()),
                               jnp.asarray(res.hit.numpy()), **kw)
    tb = tpe.build_culled_eval(ts, pos, res.hit, **kw)
    assert bool(jb[-1]) == bool(tb[-1])
    jd = np.asarray(jb[0](js, jb[2](jnp.asarray(pos.numpy()))))
    td = tb[0](ts, tb[2](pos)).numpy()
    assert jd.shape == td.shape == (4, 256)
    if bool(tb[-1]):
        np.testing.assert_allclose(td, jd, atol=1e-5)
        hit = res.hit.numpy().reshape(4, 256)
        dense = tsdf.scene_distance(ts, pos).numpy().reshape(4, 256)
        np.testing.assert_allclose(td[hit], dense[hit], atol=1e-5)
    # the materials of the candidates, where the certificate covers them
    if for_materials and bool(tb[-1]):
        jm = np.asarray(jb[1](js, jb[2](jnp.asarray(pos.numpy()))))
        tm = tb[1](ts, tb[2](pos)).numpy()
        hit = res.hit.numpy().reshape(4, 256)
        np.testing.assert_array_equal(tm[hit], jm[hit])


def test_certificate_matches_jax_on_degenerate_tile():
    build, pos, hit = degenerate_tile()
    js = jft.flatten(build(jft))
    ts = port_of(js)
    for m, want in ((2, False), (12, True)):
        jb = jpe.build_culled_eval(js, jnp.asarray(pos), jnp.asarray(hit),
                                   m=m, threshold=4)
        tb = tpe.build_culled_eval(ts, torch.from_numpy(pos),
                                   torch.from_numpy(hit), m=m, threshold=4)
        assert bool(jb[-1]) == bool(tb[-1]) == want


def test_dense_dist_tiled_chunks_and_keeps_gradients(monkeypatch):
    """The tiled dense fallback equals the one-shot evaluation, values and
    gradients, when forced into many rematerialized chunks."""
    scene = tori(16).requires_grad_(True)
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(4, 64, 3)).astype(np.float32) * 3)
    q.requires_grad_(True)
    want = tsdf.scene_distance(scene, q)
    gw = torch.autograd.grad(want.sum(), [q, scene.prim_params["torus"]])
    monkeypatch.setattr(tpe, "_chunk_elems", lambda device: 18 * 40)
    got = tpe.dense_dist_tiled(scene, q)
    gg = torch.autograd.grad(got.sum(), [q, scene.prim_params["torus"]])
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=1e-6)
    for a, b in zip(gg, gw):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
