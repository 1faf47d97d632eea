"""Port parity, K3 in AD mode (plans with a smooth union).

The "cuda" backend on CPU tensors (``surface_ad_plain`` behind the real
host glue) against the JAX kernel's AD-mode surface pass in interpret mode
and against the dense ``sdf.scene_normal`` / ``material_at`` of both
packages, on scenes built from numpy seeds.

Tolerances:

* dense, the same ``t`` and hit mask fed to both: normals within 1e-4
  (one gradient, summed in two orders by two frameworks), materials equal
  on hit lanes, code 0 everywhere;
* culled, each package marching for itself: hit masks equal on ≥ 99.5% of
  lanes (grazing flips, as for K1), t within the ε shell (the port's
  per-warp windows step differently from JAX's per-tile ones); on the
  lanes whose t agree to 1e-4 (≥ 90% of those both hit) normals within
  1e-3 (JAX's own bound for its windowed AD pass against the dense normal)
  and materials equal; the port's normals within 1e-3 of the dense normal
  of both packages, and materials equal to the dense argmin, at the
  port's own hit points on every hit lane;
* a smooth union of sub-plans alone is held against the dense normal only:
  the JAX predicate sends that plan to slot mode, which names no leaf for
  a blend (ROADMAP, "Reference fault");
* the 64² blended frame: max |Δ| < 2e-3 off pixels whose hit, material,
  facing or occlusion outcome flipped (≤ 0.5%) and off ε-shell pixels, as
  for the culled 96-torus frame of test_torch_render.py;
* the blend's window clamp: culled against dense at 64², ≤ 0.5% flipped
  pixels and t within 3ε with it, both exceeded without it;
* an intersect directly under a smooth union, culled, on JAX's own hits
  (a pin of an inherited fault): materials equal; both packages leave the
  dense normal's 1e-3 on the same lanes, and agree to 1e-4 elsewhere."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fraytracer_tpu as jft
import fraytracer_tpu_torch as tft
from fraytracer_tpu.ops import sdf as jsdf
from fraytracer_tpu.ops.march import MarchConfig as JMC
from fraytracer_tpu.ops.march import march_surface as jmarch_surface
from fraytracer_tpu.ops.pallas.march_kernel import pallas_march_raw
from fraytracer_tpu.scene import generators as JG, nodes as JN
from fraytracer_tpu_torch.ops import sdf as tsdf
from fraytracer_tpu_torch.ops.cuda import cull as tcull
from fraytracer_tpu_torch.ops.cuda import march_kernel as tmk
from fraytracer_tpu_torch.ops.march import MarchConfig as TMC
from fraytracer_tpu_torch.ops.march import march_surface as tmarch_surface
from fraytracer_tpu_torch.scene import generators as TG, nodes as TN
from test_torch_render import (CAM, EPS, jax_masks, port_camera,
                               port_masks)
from test_torch_scene import SCENES, flat_camera_rays

PAL = JMC(backend="pallas_interpret", cull=False, max_steps=192)


def sumexp64(N, G):
    """64 tori in one smooth union: a large sumexp group."""
    rng = np.random.default_rng(5)
    return N.Scene(root=N.smooth_union(0.2, *[
        N.torus(tuple(rng.uniform(-2.5, 2.5, 3)),
                tuple(rng.uniform(-0.5, 0.5, 3) + (0, 0, 1e-3)), 0.5, 0.15,
                material=N.solid(0.1 + 0.01 * i, 0.5, 0.5))
        for i in range(64)]))


def intersect_blend(N, G):
    """256 spheres intersected (a culled max group) beside a smooth union
    of two spheres (tests/test_pallas_march.py::
    test_intersect_cull_with_smooth_union_coexists)."""
    rng = np.random.default_rng(13)
    members = [N.sphere(tuple(c), 2.0, material=N.solid(0.2, 0.6, 0.9))
               for c in rng.uniform(-0.4, 0.4, size=(256, 3))]
    return N.Scene(root=N.union(
        N.intersect(*members),
        N.smooth_union(0.3, N.sphere((2.4, 0.0, 0.0), 0.7,
                                     material=N.solid(0.9, 0.5, 0.1)),
                       N.sphere((2.9, 0.5, 0.0), 0.5)),
    ), background=(0.1, 0.1, 0.1))


def blend96(N, G):
    """The blended frame's scene at 96 tori: the torus scene (a culled min
    group under intersect and subtract) smooth-united with a sphere."""
    base = G.torus_csg_scene(seed=19, n_tori=96)
    return N.Scene(root=N.smooth_union(
        0.25, base.root, N.sphere((0, 0, 0), 1.5,
                                  material=N.solid(0.8, 0.7, 0.3))),
        background=base.background, lights=base.lights)


def subplans(N, G):
    """A smooth union whose operands are all sub-plans."""
    return N.Scene(root=N.smooth_union(
        0.3,
        N.union(N.sphere((0, 0, 0), 1.0, material=N.solid(1, 0, 0)),
                N.sphere((0, 1.2, 0), 0.5, material=N.solid(0, 0, 1))),
        N.intersect(N.sphere((1, 0, 0), 1.0, material=N.solid(0, 1, 0)),
                    N.box((1, 0, 0), (0.7, 0.7, 0.7), 0.05))))


BUILD = dict(SCENES, sumexp64=sumexp64, intersect_blend=intersect_blend,
             blend96=blend96, subplans=subplans)


def pair(name):
    build = BUILD[name]
    return (jft.flatten(build(JN, JG)),
            tft.flatten(build(TN, TG), device="cpu"))


@pytest.mark.parametrize("name,kw", [
    ("smooth_subtract", dict(w=24, h=24, pos=(0, 0, -5))),
    ("smooth_materials", dict(w=24, h=24, pos=(0, 0, -5))),
    ("sumexp64", dict(w=32, h=32, pos=(0, 0, -8))),
    ("blend96", dict(w=32, h=32)),
])
def test_surface_ad_matches_pallas_dense(name, kw):
    """K3 AD mode on JAX's own (t, hit): the wrapper on CPU tensors against
    the JAX AD-mode pass, and both against JAX's dense normal."""
    js, ts = pair(name)
    assert not tmk.slot_surface_mode(ts.plan)
    jr, tr = flat_camera_rays(**kw)
    res, normal, midx, code = pallas_march_raw(js, jr, PAL, interpret=True,
                                               want_surface=True)
    hit = np.array(res.hit)
    assert hit.sum() > 50
    n_t, m_t, c_t = tmk.surface_kernel(
        ts, tr.origin, tr.direction, torch.from_numpy(np.array(res.t)),
        tr.epsilon, torch.from_numpy(hit))
    n_t, m_t = n_t.numpy(), m_t.numpy()
    assert not c_t.any() and not np.asarray(code).any()
    np.testing.assert_allclose(n_t[hit], np.asarray(normal)[hit], atol=1e-4)
    np.testing.assert_array_equal(m_t[hit], np.asarray(midx)[hit])
    miss = ~hit
    assert (m_t[miss] == -1).all()
    np.testing.assert_array_equal(n_t[miss], np.tile([0, 0, 1.0],
                                                     (miss.sum(), 1)))
    pos = jr.at(res.t - jr.epsilon)
    n_ref = np.asarray(jsdf.scene_normal(js, pos))
    np.testing.assert_allclose(n_t[hit], n_ref[hit], atol=1e-4)
    if len(ts.visible_material_slots()):
        m_ref, _a = jsdf.material_at(js, pos)
        np.testing.assert_array_equal(m_t[hit], np.asarray(m_ref)[hit])


@pytest.mark.parametrize("name,kw,cull", [
    ("intersect_blend", dict(w=32, h=32, pos=(0, 0, -6)),
     dict(cull_threshold=192, cull_m=512)),
    ("blend96", dict(w=32, h=32), dict(cull_threshold=64, cull_m=128)),
])
def test_surface_ad_culled_matches_pallas(name, kw, cull):
    """The culled fused path, each package marching for itself: K1 and K3
    AD on candidate tables against JAX's windowed AD pass and the dense
    normal and material of both packages."""
    js, ts = pair(name)
    assert tcull._cull_pairs(ts.kind_counts, ts.plan, cull["cull_threshold"])
    jr, tr = flat_camera_rays(**kw)
    jres, jn, jm = jmarch_surface(js, jr, JMC(
        backend="pallas_interpret", max_steps=192, cull=True, **cull))
    tres, tn, tm = tmarch_surface(ts, tr, TMC(
        backend="cuda", max_steps=192, cull=True, **cull))
    hj, ht = np.asarray(jres.hit), tres.hit.numpy()
    assert hj.mean() > 0.1 and (hj == ht).mean() >= 0.995
    both = hj & ht
    dt = np.abs(tres.t.numpy() - np.asarray(jres.t))
    assert dt[both].max() <= 0.01 + 1e-4      # the ε shell
    near = both & (dt <= 1e-4)
    assert near.sum() >= 0.9 * both.sum()
    np.testing.assert_allclose(tn.numpy()[near], np.asarray(jn)[near],
                               atol=1e-3)
    np.testing.assert_array_equal(tm.numpy()[near], np.asarray(jm)[near])
    assert (tm.numpy() == np.asarray(jm))[both].mean() >= 0.995
    assert (tm.numpy()[~ht] == -1).all()
    # the dense normal and material of both packages at the port's points
    pos = tr.origin + (tres.t - tr.epsilon)[:, None] * tr.direction
    n_j = np.asarray(jsdf.scene_normal(js, jnp.asarray(pos.numpy())))
    n_p = tsdf.scene_normal(ts, pos).numpy()
    assert np.abs(tn.numpy() - n_j)[ht].max() < 1e-3
    assert np.abs(tn.numpy() - n_p)[ht].max() < 1e-3
    m_ref = tsdf.material_index_at(ts, pos).numpy()
    np.testing.assert_array_equal(tm.numpy()[ht], m_ref[ht])


def intersect_under_blend(N, G):
    """256 fat spheres intersected (a culled max group) directly under a
    smooth union (k 0.3) with a sphere: members that a tile's cone
    excludes still shape the blended surface (ROADMAP, Queue 3)."""
    rng = np.random.default_rng(13)
    members = [N.sphere(tuple(c), 2.0, material=N.solid(0.2, 0.6, 0.9))
               for c in rng.uniform(-0.4, 0.4, size=(256, 3))]
    return N.Scene(root=N.smooth_union(
        0.3, N.intersect(*members),
        N.sphere((2.4, 0.0, 0.0), 0.7, material=N.solid(0.9, 0.5, 0.1))),
        background=(0.1, 0.1, 0.1))


def test_culled_blend_excludes_members_within_its_reach():
    """Pins the inherited fault of culling under a smooth union: at 64²,
    rays in 32×32 blocks looking at where the intersect meets the blended
    sphere (fov 20), tables of m 512, the port's culled AD-mode K3 (plain
    version) and JAX's culled AD pass (interpret mode) on JAX's own hits.
    Both leave the dense ``scene_normal``'s 1e-3 on the same lanes — 46%
    of the hits: each tile's cone drops members whose bounds its rays miss,
    and under the blend those members still weigh — and there they differ
    from each other too (up to 0.31: the port scans the whole list, JAX
    windows and caps it); elsewhere they agree to 1e-4 as the dense pass
    does, and materials are equal everywhere.  Widening the cone margin
    by the blend's reach would repair it and change this test."""
    import jax
    from fraytracer_tpu_torch.ops.march import bound_skip_start
    from test_torch_scene import to_port_rays
    js = jft.flatten(intersect_under_blend(JN, JG))
    ts = tft.flatten(intersect_under_blend(TN, TG), device="cpu")
    size = 64
    rays = jft.camera_rays(jft.look_at((2, 0, -6), (2, 0, 0),
                                       fov_degrees=20.0),
                           size, size, EPS, 30.0)

    def blocks(x):
        x, tail = np.asarray(x), x.shape[2:]
        b = size // 32
        return jnp.asarray(x.reshape((b, 32, b, 32) + tail).swapaxes(1, 2)
                           .reshape((-1,) + tail))

    jr = jax.tree.map(blocks, rays)
    tr = to_port_rays(jr)
    cull = dict(cull_threshold=192, cull_m=512)
    res, jn, jm, _c = pallas_march_raw(js, jr, JMC(
        backend="pallas_interpret", max_steps=192, cull=True, **cull),
        interpret=True, want_surface=True)
    hit = np.asarray(res.hit)
    assert hit.mean() > 0.5
    t0, miss0, t_exit = bound_skip_start(ts, tr)
    length = torch.where(miss0, 0.0, torch.minimum(tr.length, t_exit))
    pairs = tcull._cull_pairs(ts.kind_counts, ts.plan, 192)
    assert len(pairs) == 1 and pairs[0][1] == "sphere"
    tables = tcull.build_pair_tables(ts, tr.origin, tr.direction, t0,
                                     length, tr.epsilon, pairs, 512, 0.125)
    n_t, m_t, c_t = tmk.surface_kernel(
        ts, tr.origin, tr.direction, torch.from_numpy(np.array(res.t)),
        tr.epsilon, torch.from_numpy(hit.copy()), cull=tables)
    n_t, jn = n_t.numpy(), np.asarray(jn)
    assert not c_t.any()
    np.testing.assert_array_equal(m_t.numpy()[hit], np.asarray(jm)[hit])
    assert (m_t.numpy()[~hit] == -1).all()
    pos = jr.at(res.t - jr.epsilon)
    n_j = np.asarray(jsdf.scene_normal(js, pos))
    n_p = tsdf.scene_normal(ts, torch.from_numpy(np.array(pos))).numpy()
    off_t = np.abs(n_t - n_p).max(-1) > 1e-3
    off_j = np.abs(jn - n_j).max(-1) > 1e-3
    np.testing.assert_array_equal(off_t[hit], off_j[hit])
    share = off_t[hit].mean()
    print(f"hit lanes outside the dense normal's 1e-3: {share:.4f} "
          f"({int(off_t[hit].sum())} of {int(hit.sum())}) in both packages")
    assert 0.3 < share < 0.6, share
    ok = hit & ~off_j
    np.testing.assert_allclose(n_t[ok], jn[ok], atol=1e-4)
    assert np.abs(n_t - jn)[hit & off_j].max() > 1e-2


def test_subplan_only_smooth_union_vs_dense():
    js, ts = pair("subplans")
    assert not tmk.slot_surface_mode(ts.plan)
    assert ts.plan.op == "smooth_union" and not ts.plan.prim_slots
    _jr, tr = flat_camera_rays(32, 32, pos=(0.5, 0.3, -5))
    res, normal, midx = tmarch_surface(ts, tr, TMC(backend="cuda",
                                                   cull=False))
    hit = res.hit.numpy()
    assert hit.sum() > 100
    pos = tr.origin + (res.t - tr.epsilon)[:, None] * tr.direction
    n_p = tsdf.scene_normal(ts, pos).numpy()
    n_j = np.asarray(jsdf.scene_normal(js, jnp.asarray(pos.numpy())))
    np.testing.assert_allclose(normal.numpy()[hit], n_p[hit], atol=1e-4)
    np.testing.assert_allclose(normal.numpy()[hit], n_j[hit], atol=1e-4)
    m_j, _a = jsdf.material_at(js, jnp.asarray(pos.numpy()))
    np.testing.assert_array_equal(midx.numpy()[hit], np.asarray(m_j)[hit])
    # the blend is real: the same operands under a hard union give other
    # normals somewhere
    hard = tft.flatten(tft.Scene(root=tft.union(
        *subplans(TN, TG).root.children)), device="cpu")
    n_h = tsdf.scene_normal(hard, pos).numpy()
    assert (np.abs(normal.numpy() - n_h)[hit].max(-1) > 1e-2).any()


def test_blend_frame_matches_jax_render():
    """The blended frame at 64² (96 tori, culled: the slice as a whole)
    against the JAX culled render."""
    size = 64
    js, ts = pair("blend96")
    kw = dict(cull=True, cull_threshold=64, cull_m=128, relax_omega=1.4)
    jcfg = JMC(backend="pallas_interpret", **kw)
    tcfg = TMC(backend="cuda", **kw)
    assert tcull._cull_pairs(ts.kind_counts, ts.plan, 64)
    jimg = np.asarray(jft.render(
        js, jft.look_at(CAM, (0, 0, 0), fov_degrees=60.0),
        jft.RenderConfig(width=size, height=size, march=jcfg)))
    timg = tft.render(ts, port_camera(), tft.RenderConfig(
        width=size, height=size, march=tcfg)).numpy()
    assert np.isfinite(timg).all()
    (jm, jt), (tm, tt) = (jax_masks(js, jcfg, size, size, with_t=True),
                          port_masks(ts, tcfg, size, size, with_t=True))
    assert tm[0].mean() > 0.1
    flipped = np.zeros((size, size), bool)
    for a, b in zip(jm, tm):
        flipped |= a != b
    assert flipped.mean() <= 0.005
    shell = ~flipped & tm[0] & (np.abs(jt - tt) > 1e-3)
    diff = np.abs(timg - jimg).max(-1)
    assert diff[~flipped & ~shell].max() < 2e-3
    off = shell & (diff >= 2e-3)
    assert off.mean() <= 0.005
    if off.any():
        assert diff[off].max() < 3e-2
    assert float(np.median(diff)) < 1e-5


def test_blend_window_clamp_holds_culled_to_dense(monkeypatch):
    """The 96-torus blend at 64², culled against dense in the port alone.
    With the blend's window clamp k·log(8k/ε) (``cull.build_pair_tables``)
    at most 0.5% of the pixels flip an outcome and every lane both hit
    lands within 3ε; with ``cull_window_clamp`` alone — the JAX rule, here
    forced by zeroing the groups' blend reach — the windows' caps leak
    through the smooth union and the same two checks fail."""
    size = 64
    ts = tft.flatten(blend96(TN, TG), device="cpu")
    kw = dict(cull_threshold=64, cull_m=128, relax_omega=1.4)
    assert tcull._cull_pairs(ts.kind_counts, ts.plan, 64)
    dm, dt = port_masks(ts, TMC(backend="cuda", cull=False, **kw), size,
                        size, with_t=True)

    def culled_vs_dense():
        cm, ct = port_masks(ts, TMC(backend="cuda", cull=True, **kw), size,
                            size, with_t=True)
        flipped = np.zeros((size, size), bool)
        for a, b in zip(cm, dm):
            flipped |= a != b
        both = cm[0] & dm[0]
        assert both.mean() > 0.1
        return flipped.mean(), np.abs(ct - dt)[both].max()

    flips, far = culled_vs_dense()
    assert flips <= 0.005 and far < 3 * EPS

    grouped = tcull._grouped

    def no_reach(plan):
        groups, tree, reach = grouped(plan)
        return groups, tree, dict.fromkeys(reach, 0.0)

    monkeypatch.setattr(tcull, "_grouped", no_reach)
    flips, far = culled_vs_dense()
    assert flips > 0.005 and far > 3 * EPS
