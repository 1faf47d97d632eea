"""Port parity, K3 (surface pass) and the material-repair tiers.

``surface_plain`` (the route of the K3 wrapper for CPU tensors) against the
JAX kernel's fused surface pass (``pallas_march_raw(..., want_surface=True)``
in interpret mode, ``cull=False``) on the same rays, t and hit mask: the
winning-leaf code equal on ≥ 99.5% of hit lanes; normals within 1e-4 and
materials equal on those.  ``resolve_material`` in each tier against JAX
``resolve_material(backend="pallas_interpret")``: results equal."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fraytracer_tpu.ops import shade as jshade
from fraytracer_tpu.ops.march import MarchConfig as JMC
from fraytracer_tpu.ops.pallas.march_kernel import pallas_march_raw
from fraytracer_tpu_torch.ops import shade as tshade
from fraytracer_tpu_torch.ops.cuda import gather as tgather
from fraytracer_tpu_torch.ops.cuda import march_kernel as tmk
from fraytracer_tpu_torch.ops.march import MarchConfig as TMC
from fraytracer_tpu_torch.ops.march import march_surface
from test_torch_scene import flat_camera_rays, scene_pair

PAL = JMC(backend="pallas_interpret", cull=False, relax_omega=1.4)


@pytest.mark.parametrize("name,kw", [
    ("torus48", dict(w=32, h=32)),
    ("all_kinds", dict(w=32, h=32, length=40.0)),
    ("csg_demo", dict(w=32, h=32, pos=(0.5, 1.5, -6.0))),
])
def test_surface_plain_matches_pallas(name, kw):
    js, ts = scene_pair(name)
    jr, tr = flat_camera_rays(**kw)
    res, normal, midx, code = pallas_march_raw(js, jr, PAL, interpret=True,
                                               want_surface=True)
    hit = np.array(res.hit)
    assert hit.sum() > 50
    n_t, m_t, c_t = tmk.surface_plain(
        ts, tr.origin, tr.direction, torch.from_numpy(np.array(res.t)),
        tr.epsilon, torch.from_numpy(hit))
    c_t, n_t, m_t = c_t.numpy(), n_t.numpy(), m_t.numpy()
    same = hit & (c_t == np.asarray(code))
    assert same.sum() >= 0.995 * hit.sum()
    np.testing.assert_allclose(n_t[same], np.asarray(normal)[same],
                               atol=1e-4)
    np.testing.assert_array_equal(m_t[same], np.asarray(midx)[same])
    # miss lanes: normal (0, 0, 1), material -1, code 0
    miss = ~hit
    assert (c_t[miss] == 0).all() and (m_t[miss] == -1).all()
    np.testing.assert_array_equal(n_t[miss], np.tile([0, 0, 1.0],
                                                     (miss.sum(), 1)))


def test_march_surface_cuda_backend_end_to_end():
    """The fused "cuda" path (K1 then K3) against the JAX fused pass."""
    js, ts = scene_pair("torus48")
    jr, tr = flat_camera_rays(24, 24)
    jres, jn, jm, _jc = pallas_march_raw(js, jr, PAL, interpret=True,
                                         want_surface=True)
    tres, tn, tm = march_surface(
        ts, tr, TMC(backend="cuda", cull=False, relax_omega=1.4))
    hit = np.asarray(jres.hit)
    assert (tres.hit.numpy() == hit).mean() >= 0.995
    both = hit & tres.hit.numpy()
    close = np.abs(tn.numpy() - np.asarray(jn)).max(-1) < 1e-3
    assert close[both].mean() >= 0.995
    assert (tm.numpy() == np.asarray(jm))[both].mean() >= 0.995
    assert (tm.numpy()[~tres.hit.numpy()] == -1).all()


def test_smooth_union_surface_raises_on_cuda_backend():
    """A smooth union no longer raises on the "cuda" backend (the name is
    kept from when it did): the fused pass takes the surface kernel's AD
    mode and agrees with the unfused path (march + dense normal and
    material) — normals within 1e-4 (one gradient, two evaluation orders),
    materials equal on hit lanes."""
    _js, ts = scene_pair("smooth_materials")
    _jr, tr = flat_camera_rays(24, 24, pos=(0, 0, -5))
    assert not tmk.slot_surface_mode(ts.plan)
    fres, fn, fm = march_surface(ts, tr, TMC(backend="cuda", cull=False))
    res, n, m = march_surface(ts, tr, TMC(backend="cuda", cull=False,
                                          fuse_surface=False))
    assert n.shape == (576, 3) and m.shape == (576,)
    hit = res.hit
    assert int(hit.sum()) > 50 and torch.equal(fres.hit, hit)
    assert (fn - n)[hit].abs().max().item() <= 1e-4
    assert torch.equal(fm[hit], m[hit]) and bool((fm[~hit] == -1).all())


def _repair_inputs(n_blocks, bad_lanes, seed):
    """Points in the scene ball, every lane a hit, material indices valid
    except at ``bad_lanes`` (-1)."""
    rng = np.random.default_rng(seed)
    n = n_blocks * tgather.BLOCK
    pos = rng.uniform(-3.0, 3.0, size=(n, 3)).astype(np.float32)
    midx = rng.integers(0, 40, size=n).astype(np.int32)
    midx[bad_lanes] = -1
    hit = np.ones(n, bool)
    hit[5::97] = False          # misses never get repaired
    return pos, hit, midx


TIERS = {
    # bad lanes in 5 blocks → block tier (K4 gathers those blocks)
    "block": (24, lambda rng: np.concatenate(
        [b * 1024 + rng.choice(1024, 40, replace=False)
         for b in (0, 3, 11, 12, 23)]), 1),
    # 300 bad lanes over 20+ blocks → lane tier
    "lane": (24, lambda rng: rng.choice(24 * 1024, 300, replace=False), 0),
    # > 4096 bad lanes → dense tier
    "dense": (24, lambda rng: rng.choice(24 * 1024, 5000, replace=False),
              0),
}


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_resolve_material_tiers_match_jax(tier, monkeypatch):
    js, ts = scene_pair("torus96")
    n_blocks, pick, want_gathers = TIERS[tier]
    rng = np.random.default_rng(7)
    pos, hit, midx = _repair_inputs(n_blocks, pick(rng), 7)
    calls = []
    real = tgather.flat_block_gather
    monkeypatch.setattr(tgather, "flat_block_gather",
                        lambda *a: calls.append(1) or real(*a))
    got = tshade.resolve_material(ts, torch.from_numpy(pos),
                                  torch.from_numpy(hit),
                                  torch.from_numpy(midx), backend="cuda")
    want = jshade.resolve_material(js, jnp.asarray(pos), jnp.asarray(hit),
                                   jnp.asarray(midx),
                                   backend="pallas_interpret")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(calls) == want_gathers
    assert (got.numpy()[hit] >= 0).all()
    np.testing.assert_array_equal(got.numpy()[~hit], midx[~hit])


def test_resolve_material_none_bad_is_identity():
    _js, ts = scene_pair("torus48")
    pos, hit, midx = _repair_inputs(4, np.array([], np.int64), 3)
    out = tshade.resolve_material(ts, torch.from_numpy(pos),
                                  torch.from_numpy(hit),
                                  torch.from_numpy(midx), backend="cuda")
    np.testing.assert_array_equal(out.numpy(), midx)


def test_program_lowering_orders_groups():
    """The lowered program: one entry range per group, members in
    ascending slot, postfix tree of the benchmark plan."""
    _js, ts = scene_pair("torus48")
    prog = tmk.lower_program(ts, "cpu")
    ops = prog.ops.tolist()
    # subtract(intersect(union(tori), sphere), sphere)
    assert ops == [[0, 0], [0, 1], [2, 2], [0, 2], [3, 2]]
    g = prog.groups.tolist()
    assert [r[2] for r in g] == [0, 1, 0]           # min, max, min
    slots = prog.ent_slot.tolist()
    assert sorted(slots) == list(range(ts.num_prims))
    for e0, e1, _op in g:
        assert slots[e0:e1] == sorted(slots[e0:e1])
    # torus axes are unit length in the program
    k = prog.ent_kind == 2
    ax = prog.ent_params[k][:, 3:6]
    torch.testing.assert_close(ax.norm(dim=-1), torch.ones(int(k.sum())))


def test_program_lowering_memoized_until_params_change():
    """A scene is lowered once and reused; an in-place parameter edit or a
    new parameter tensor lowers it again with the new values."""
    _js, ts = scene_pair("torus48")
    ts = dataclasses.replace(
        ts, prim_params={k: v.clone() for k, v in ts.prim_params.items()})
    prog = tmk.lower_program(ts, "cpu")
    assert tmk.lower_program(ts, torch.device("cpu")) is prog
    ts.prim_params["sphere"][0, 3] += 0.25     # in place
    again = tmk.lower_program(ts, "cpu")
    assert again is not prog
    e = int(torch.nonzero(again.ent_slot == 0)[0])
    assert float(again.ent_params[e, 3]) == float(ts.prim_params["sphere"][0, 3])
    ts.prim_params["sphere"] = ts.prim_params["sphere"] * 1.0
    assert tmk.lower_program(ts, "cpu") is not again


def test_deep_plan_stack_limit():
    """Left-nested CSG keeps the value stack shallow; a right-nested tree
    deeper than the kernels' stack raises instead of overflowing."""
    import fraytracer_tpu_torch as tft
    node = tft.sphere((0, 0, 0), 1.0)
    for i in range(20):
        node = tft.subtract(node, tft.sphere((0, 0, 0.1 * i), 0.2))
    prog = tmk.lower_program(tft.flatten(tft.Scene(root=node),
                                         device="cpu"), "cpu")
    assert prog.ops.shape[0] == 41
    node = tft.sphere((0, 0, 0), 1.0)
    for i in range(20):
        node = tft.subtract(tft.sphere((0, 0, 0.1 * i), 2.0), node)
    with pytest.raises(NotImplementedError,
                       match="stack of 21 > 16.*20 combinators deep"):
        tmk.lower_program(tft.flatten(tft.Scene(root=node), device="cpu"),
                          "cpu")
