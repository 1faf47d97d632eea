"""Port parity, culled host prep (``fraytracer_tpu_torch/ops/cuda/cull.py``):
per-tile cones, candidacy masks, axially sorted candidates, cull pairs and
the per-pair tables against the JAX host prep
(``fraytracer_tpu/ops/pallas/march_kernel.py``) on the same numpy inputs at
a 1024-ray tile; then the JAX suite's soundness tests of the selection
(tests/test_pallas_march.py:144-320) on the port's functions.

Tolerance: cone fields and keys within 1e-5 relative (float32 sums in
another order).  The converging tangents ``tan_conv``/``tan_neg`` are
compared as angles (arctan, within 1e-6 rad): each is a maximum of
λ/o_par, set by lanes almost level with the light (ratios up to ~1.6e4 on
these inputs), where one float32 ulp of o_par moves the ratio by 4e-4
relative but the angle by < 1e-7.  Candidate counts and sets equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fraytracer_tpu.ops import sdf as JS
from fraytracer_tpu.ops.march import bound_skip_start as j_bound_skip
from fraytracer_tpu.ops.pallas import march_kernel as JK
from fraytracer_tpu.types import Rays as JRays
from fraytracer_tpu_torch.ops import sdf as TS
from fraytracer_tpu_torch.ops.cuda import cull as TC
from test_torch_scene import scene_pair

TILE = TC.TILE
FIELDS = TC.TileCones._fields


def camera_lanes(js, w=64, h=32):
    """Two tiles of camera rays (row order) with the root-bound range."""
    import fraytracer_tpu as jft
    cam = jft.look_at((0, 0, -10), (0, 0, 0))
    r = jft.camera_rays(cam, w, h, 0.01, 30.0)
    r = JRays(*(x.reshape((-1,) + x.shape[2:]) for x in
                (r.origin, r.direction, r.length, r.epsilon)))
    t0, miss0, t_exit = j_bound_skip(js, r)
    length = jnp.where(miss0, 0.0, jnp.minimum(r.length, t_exit))
    t_hi = jnp.where(length > 0.0, length, t0)
    return {k: np.array(v, np.float32) for k, v in dict(
        o=r.origin, d=r.direction, lo=t0, hi=t_hi, eps=r.epsilon).items()}


def shadow_lanes(n=2 * TILE, seed=3):
    """Point-light shadow rays: origins on a shell, directions at the
    light, some inactive (tests/test_pallas_march.py:382-405)."""
    rng = np.random.default_rng(seed)
    light = np.array([-0.5, 0.0, -2.0], np.float32)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 3.2
    diff = light - o
    dist = np.linalg.norm(diff, axis=-1)
    act = rng.uniform(size=n) > 0.2
    return dict(o=o.astype(np.float32),
                d=(diff / dist[:, None]).astype(np.float32),
                lo=np.zeros(n, np.float32),
                hi=np.where(act, dist, 0.0).astype(np.float32),
                eps=np.full(n, 0.01, np.float32)), light


@pytest.fixture(scope="module")
def torus96():
    return scene_pair("torus96")


def cones_both(lanes, apex, grid, tile=TILE):
    j = JK._tile_cones(*(jnp.asarray(lanes[k]) for k in
                         ("o", "d", "lo", "hi", "eps")), grid, tile,
                       conv_apex=None if apex is None else jnp.asarray(apex))
    t = TC._tile_cones(*(torch.from_numpy(lanes[k]) for k in
                         ("o", "d", "lo", "hi", "eps")), grid, tile,
                       conv_apex=None if apex is None
                       else torch.from_numpy(apex))
    return j, t


def lanes_for(kind, torus96):
    if kind == "camera":
        return camera_lanes(torus96[0]), None
    return shadow_lanes()


@pytest.mark.parametrize("kind", ["camera", "point_light"])
@pytest.mark.parametrize("sub", [1, TC.SUBF])
def test_tile_cones_match_jax(torus96, kind, sub):
    lanes, apex = lanes_for(kind, torus96)
    grid = lanes["o"].shape[0] // TILE * sub
    j, t = cones_both(lanes, apex, grid, TILE // sub)
    for f in FIELDS:
        got, want = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        if f in ("tan_conv", "tan_neg"):
            np.testing.assert_allclose(np.arctan(got), np.arctan(want),
                                       rtol=0, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=f)


@pytest.mark.parametrize("kind", ["camera", "point_light"])
def test_candidates_match_jax(torus96, kind):
    """Sub-tile masks OR-ed per tile, then the axial selection: counts and
    candidate sets equal, keys of each candidate within 1e-5."""
    js, ts = torus96
    lanes, apex = lanes_for(kind, torus96)
    conv = apex is not None
    grid = lanes["o"].shape[0] // TILE
    jc, tc = cones_both(lanes, apex, grid)
    jf, tf = cones_both(lanes, apex, grid * TC.SUBF, TILE // TC.SUBF)
    jb = JS._prim_bound_rows("torus", js.prim_params["torus"])
    tb = TS._prim_bound_rows("torus", ts.prim_params["torus"])
    jm = jnp.any(JK._cand_mask(jb, jf, conv).reshape(grid, TC.SUBF, -1), 1)
    tm = TC._cand_mask(tb, tf, conv).reshape(grid, TC.SUBF, -1).any(1)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    m = 96
    js_ = JK._cone_candidates(jb, jc, m, conv, jm)
    ts_ = TC._cone_candidates(tb, tc, m, conv, tm)
    count = np.asarray(js_.count)
    np.testing.assert_array_equal(ts_.count.numpy(), count)
    assert count.max() > 0
    for g in range(grid):
        c = int(count[g])
        jrow = {int(i): j for j, i in enumerate(np.asarray(js_.idx[g])[:c])}
        trow = {int(i): j for j, i in enumerate(ts_.idx[g].numpy()[:c])}
        assert set(jrow) == set(trow), g
        for prim, jj in jrow.items():
            tj = trow[prim]
            for key in ("lo_key", "hi_key"):
                np.testing.assert_allclose(
                    float(getattr(ts_, key)[g, tj]),
                    float(np.asarray(getattr(js_, key))[g, jj]),
                    rtol=1e-5, atol=1e-5)


def intersect_scene(N, G, n=256, extra=0):
    rng = np.random.default_rng(11)
    members = [N.sphere(tuple(c), 2.0) for c in
               rng.uniform(-0.5, 0.5, size=(n, 3))]
    members += [N.sphere(tuple(c), 1.0) for c in
                rng.normal(scale=0.5, size=(extra, 3)) + 40.0]
    return N.Scene(root=N.union(N.intersect(*members),
                                N.sphere((0, 0, 0), 1.0)))


@pytest.mark.parametrize("name,threshold", [
    ("torus96", 48), ("torus96", 97), ("torus1000", 48), ("all_kinds", 1),
    ("csg_demo", 2), ("intersect", 192)])
def test_cull_pairs_match_jax(name, threshold):
    if name == "intersect":
        import fraytracer_tpu as jft
        import fraytracer_tpu_torch as tft
        from fraytracer_tpu.scene import generators as JG, nodes as JN
        from fraytracer_tpu_torch.scene import generators as TG, nodes as TN
        js = jft.flatten(intersect_scene(JN, JG, extra=8))
        ts = tft.flatten(intersect_scene(TN, TG, extra=8), device="cpu")
    else:
        js, ts = scene_pair(name)
    want = JK._cull_pairs(js.kind_counts, js.plan, threshold)
    got = TC._cull_pairs(ts.kind_counts, ts.plan, threshold)
    assert got == want
    assert TC._pair_m(256, 96) == JK._pair_m(256, 96) == 96
    assert TC._pair_m(5, 3) == JK._pair_m(5, 3) == 8


def jax_pair_tables(js, lanes, pairs, cull_m, clamp, apex):
    """The per-pair tables exactly as pallas_march_raw builds them
    (:1862-1962), from the JAX functions."""
    grid = lanes["o"].shape[0] // TILE
    args = [jnp.asarray(lanes[k]) for k in ("o", "d", "lo", "hi", "eps")]
    conv = None if apex is None else jnp.asarray(apex)
    cones = JK._tile_cones(*args, grid, TILE, conv_apex=conv)
    cones_f = JK._tile_cones(*args, grid * 4, TILE // 4, conv_apex=conv)
    clamp_eff = jnp.maximum(jnp.float32(clamp), 8.0 * cones.eps_max)
    out = []
    for (_gid, kind, _ki, r0, r1) in pairs:
        m = JK._pair_m(cull_m, r1 - r0)
        kb = JS._prim_bound_rows(kind, js.prim_params[kind][r0:r1])
        cmask = jnp.any(JK._cand_mask(kb, cones_f, apex is not None)
                        .reshape(grid, 4, -1), axis=1)
        sel = JK._cone_candidates(kb, cones, m, apex is not None, cmask)
        lo_key, hi_key = sel.lo_key, sel.hi_key
        if lo_key.shape[1] < m:
            padn = m - lo_key.shape[1]
            lo_key = jnp.pad(lo_key, ((0, 0), (0, padn)),
                             constant_values=JK._BIG)
            hi_key = jnp.pad(hi_key, ((0, 0), (0, padn)),
                             constant_values=JK._BIG)
        cu = JK.CAND_UNROLL
        keys = jnp.stack([jnp.max(lo_key.reshape(grid, -1, cu), -1),
                          jnp.min(hi_key.reshape(grid, -1, cu), -1)], 1)
        misc = jnp.stack([sel.count.astype(jnp.float32), cones.cos_lo,
                          clamp_eff, 8.0 * cones.eps_max + 1e-3], axis=1)
        suf = jax_cummin_rev(hi_key)
        out.append(dict(keys=keys, misc=misc, hsuf=suf[:, ::cu],
                        idx=sel.idx, count=sel.count))
    return out


def jax_cummin_rev(x):
    import jax
    return jax.lax.cummin(x[:, ::-1], axis=1)[:, ::-1]


@pytest.mark.parametrize("kind", ["camera", "point_light"])
@pytest.mark.parametrize("cull_m", [64, 256])
def test_pair_tables_match_jax(torus96, kind, cull_m):
    """build_pair_tables against the JAX prep: chunk keys, suffix-min,
    misc (count, cos_lo, clamp, margin), candidate rows and the table's
    parameter / material / slot columns; overflow iff a count exceeds m."""
    js, ts = torus96
    lanes, apex = lanes_for(kind, torus96)
    pairs = TC._cull_pairs(ts.kind_counts, ts.plan, 48)
    want = jax_pair_tables(js, lanes, pairs, cull_m, 0.125, apex)
    got = TC.build_pair_tables(
        ts, *(torch.from_numpy(lanes[k]) for k in ("o", "d", "lo")),
        torch.from_numpy(np.where(lanes["hi"] > lanes["lo"], lanes["hi"],
                                  0.0).astype(np.float32)),
        torch.from_numpy(lanes["eps"]), pairs, cull_m, 0.125,
        None if apex is None else torch.from_numpy(apex))
    assert len(got.tables) == len(want) == 1
    q, w = got.tables[0], want[0]
    for key in ("keys", "misc", "hsuf"):
        np.testing.assert_allclose(getattr(q, key).numpy(),
                                   np.asarray(w[key]), rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    count = np.asarray(w["count"])
    np.testing.assert_array_equal(q.count.numpy(), count)
    rows = np.asarray(ts.prim_params["torus"])
    for g in range(q.idx.shape[0]):
        c = min(int(count[g]), q.m)
        assert set(q.idx[g, :c].tolist()) == \
            set(np.asarray(w["idx"][g])[:c].tolist())
        tab = q.table[g, :c].numpy()
        np.testing.assert_array_equal(tab[:, 0:3], rows[q.idx[g, :c], 0:3])
        np.testing.assert_array_equal(tab[:, 11], q.idx[g, :c].numpy() + 2)
        vis = np.asarray(ts.visible_material(), np.float32)
        np.testing.assert_array_equal(tab[:, 10], vis[tab[:, 11].astype(int)])
    assert (got.overflow is not None) == (q.m < 96)
    if got.overflow is not None:
        assert bool(got.overflow) == bool((count > q.m).any())
    # per-lane axial coordinates of the lane's tile cone
    cones = TC._tile_cones(*(torch.from_numpy(lanes[k]) for k in
                             ("o", "d", "lo")),
                           torch.from_numpy(lanes["hi"]),
                           torch.from_numpy(lanes["eps"]),
                           lanes["o"].shape[0] // TILE, TILE,
                           None if apex is None
                           else torch.from_numpy(apex))
    tile = np.arange(lanes["o"].shape[0]) // TILE
    ca = (lanes["d"] * cones.axis.numpy()[tile]).sum(-1)
    np.testing.assert_allclose(got.ca.numpy(), ca, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# soundness of the selection (the JAX suite's tests on the port)
# ---------------------------------------------------------------------------

def port_scene(seed, n_tori):
    import fraytracer_tpu_torch as tft
    from fraytracer_tpu_torch.scene.generators import torus_csg_scene
    return tft.flatten(torus_csg_scene(seed=seed, n_tori=n_tori),
                       device="cpu")


def port_camera(w=32, h=32):
    import fraytracer_tpu_torch as tft
    r = tft.camera_rays(tft.look_at((0, 0, -10), (0, 0, 0), device="cpu"),
                        w, h, 0.01, 30.0)
    return r.map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])))


def test_cull_candidates_conservative(rng):
    """Every primitive whose bound any tile ray comes within 2·eps of is a
    candidate of that tile (:144)."""
    scene = port_scene(3, 64)
    flat = port_camera()
    grid = flat.origin.shape[0] // TILE
    cones = TC._tile_cones(flat.origin, flat.direction,
                           torch.zeros_like(flat.length), flat.length,
                           flat.epsilon, grid)
    bounds = TS._prim_bound_rows("torus", scene.prim_params["torus"])
    sel = TC._cone_candidates(bounds, cones, 64)
    cand = [set(sel.idx[g][:int(sel.count[g])].tolist())
            for g in range(grid)]
    o = flat.origin.numpy().reshape(grid, TILE, 3)
    d = flat.direction.numpy().reshape(grid, TILE, 3)
    b = bounds.numpy()
    ts = np.linspace(0.0, 30.0, 40)
    for g in range(grid):
        pick = rng.choice(TILE, size=24, replace=False)
        pts = (o[g, pick, None, :] + ts[None, :, None]
               * d[g, pick, None, :]).reshape(-1, 3)
        dist = np.linalg.norm(pts[:, None, :] - b[None, :, 0:3], axis=-1) \
            - b[None, :, 3]
        for prim in np.where(dist.min(axis=0) < 2 * 0.01)[0]:
            assert prim in cand[g], (g, prim)


def test_cull_candidates_conservative_boundskip(rng):
    """The same with the kernel's march range from the root-bound skip
    (t_lo > 0 exercises the entry-side prune, :182)."""
    from fraytracer_tpu_torch.ops.march import bound_skip_start
    scene = port_scene(7, 48)
    rays = port_camera()
    t0, miss0, t_exit = bound_skip_start(scene, rays)
    length = torch.where(miss0, 0.0, torch.minimum(rays.length, t_exit))
    t_hi = torch.where(length > 0.0, length, t0)
    grid = rays.origin.shape[0] // TILE
    cones = TC._tile_cones(rays.origin, rays.direction, t0, t_hi,
                           rays.epsilon, grid)
    bounds = TS._prim_bound_rows("torus", scene.prim_params["torus"])
    sel = TC._cone_candidates(bounds, cones, 48)
    cand = [set(sel.idx[g][:int(sel.count[g])].tolist())
            for g in range(grid)]
    o = rays.origin.numpy().reshape(grid, TILE, 3)
    d = rays.direction.numpy().reshape(grid, TILE, 3)
    lo = t0.numpy().reshape(grid, TILE)
    hi = t_hi.numpy().reshape(grid, TILE)
    b = bounds.numpy()
    fr = np.linspace(0.0, 1.0, 40)
    for g in range(grid):
        for ri in rng.choice(TILE, size=24, replace=False):
            if hi[g, ri] <= lo[g, ri]:
                continue
            ts = lo[g, ri] + fr * (hi[g, ri] - lo[g, ri])
            pts = o[g, ri] + ts[:, None] * d[g, ri]
            dist = np.linalg.norm(pts[:, None, :] - b[None, :, 0:3],
                                  axis=-1) - b[None, :, 3]
            for prim in np.where(dist.min(axis=0) < 2 * 0.01)[0]:
                assert prim in cand[g], (g, int(prim))


def test_axial_window_keys_sound(rng):
    """The per-step window's skip predicates never drop a primitive within
    ``clamp`` of an active ray point (:225)."""
    scene = port_scene(11, 48)
    rays = port_camera()
    grid = rays.origin.shape[0] // TILE
    cones = TC._tile_cones(rays.origin, rays.direction,
                           torch.zeros_like(rays.length), rays.length,
                           rays.epsilon, grid)
    bounds = TS._prim_bound_rows("torus", scene.prim_params["torus"])
    m = 48
    sel = TC._cone_candidates(bounds, cones, m)
    clamp = 0.5
    o = rays.origin.numpy().reshape(grid, TILE, 3)
    d = rays.direction.numpy().reshape(grid, TILE, 3)
    apex, axis = cones.apex.numpy(), cones.axis.numpy()
    b = bounds.numpy()
    idx, lo_key, hi_key = (sel.idx.numpy(), sel.lo_key.numpy(),
                           sel.hi_key.numpy())
    cos_lo = cones.cos_lo.numpy()
    for g in range(grid):
        cnt = int(sel.count[g])
        row_of = {int(idx[g, j]): j for j in range(min(cnt, m))}
        oa = np.sum((o[g] - apex[g]) * axis[g], axis=-1)
        for _ in range(6):
            tau_lo = float(rng.uniform(0, 25))
            tau_hi = tau_lo + float(rng.uniform(0.1, 5))
            plo = (oa + tau_lo * cos_lo[g]).min()
            phi = (oa + tau_hi).max()
            pick = rng.choice(TILE, size=12, replace=False)
            ts = np.linspace(tau_lo, tau_hi, 12)
            pts = (o[g, pick, None, :]
                   + ts[None, :, None] * d[g, pick, None, :]).reshape(-1, 3)
            dist = np.linalg.norm(pts[:, None, :] - b[None, :, 0:3],
                                  axis=-1) - b[None, :, 3]
            for prim in np.where(dist.min(axis=0) < clamp - 1e-2)[0]:
                j = row_of.get(int(prim))
                if j is None:
                    continue   # the selection tests cover it
                assert lo_key[g, j] >= plo - clamp, (g, int(prim))
                assert hi_key[g, j] <= phi + clamp, (g, int(prim))


def test_cull_candidates_conservative_divergent(rng):
    """Tiles whose directions span more than 90° (cos_lo < 0): the entry
    bound must follow backward-pointing lanes (:284)."""
    scene = port_scene(5, 64)
    n = TILE
    o = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32) * 0.5)
    dn = rng.normal(size=(n, 3)).astype(np.float32)
    dn /= np.linalg.norm(dn, axis=-1, keepdims=True)
    d = torch.from_numpy(dn)
    cones = TC._tile_cones(o, d, torch.zeros(n), torch.full((n,), 12.0),
                           torch.full((n,), 0.01), 1)
    assert float(cones.cos_lo[0]) < 0.0
    bounds = TS._prim_bound_rows("torus", scene.prim_params["torus"])
    sel = TC._cone_candidates(bounds, cones, 64)
    cand = set(sel.idx[0][:int(sel.count[0])].tolist())
    b = bounds.numpy()
    ts = np.linspace(0.0, 12.0, 60)
    pick = rng.choice(n, size=48, replace=False)
    pts = (o.numpy()[pick, None, :] + ts[None, :, None]
           * dn[pick, None, :]).reshape(-1, 3)
    dist = np.linalg.norm(pts[:, None, :] - b[None, :, 0:3], axis=-1) \
        - b[None, :, 3]
    for prim in np.where(dist.min(axis=0) < 2 * 0.01)[0]:
        assert prim in cand, int(prim)


# ---------------------------------------------------------------------------
# the per-tile slices as the march kernel stages them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cull_m,m", [(8, 8), (24, 24), (256, 256),
                                      (512, 512)])
def test_tile_slices_contiguous_and_aligned(cull_m, m):
    """Every per-tile slice the march kernel stages (table, keys, hsuf,
    misc) is contiguous; ``table[tile]`` and ``misc[tile]`` start at a
    multiple of 16 bytes for every tile of an odd tile count; and the host
    rule (``bulk_slices``) names keys / hsuf for the bulk copy exactly when
    their slice — hence every tile's start — is a multiple of 16 bytes."""
    scene = port_scene(5, 520)
    flat = port_camera(32, 96)              # 3 tiles
    n = flat.origin.shape[0] - 40           # a ragged last tile
    pairs = TC._cull_pairs(scene.kind_counts, scene.plan, 48)
    assert TC._pair_m(cull_m, 520) == m
    got = TC.build_pair_tables(
        scene, flat.origin[:n], flat.direction[:n],
        torch.zeros(n), flat.length[:n], flat.epsilon[:n], pairs, cull_m,
        0.125)
    (q,) = got.tables
    tiles = 3
    chunks = m // TC.CAND_UNROLL
    assert q.m == m and q.table.shape == (tiles, m, TC.TABLE_W)
    assert q.keys.shape == (tiles, 2, chunks)
    assert q.hsuf.shape == (tiles, chunks) and q.misc.shape == (tiles, 4)
    want = TC.pair_slice_bytes(m)
    for name in ("table", "keys", "hsuf", "misc"):
        x = getattr(q, name)
        assert x.is_contiguous() and x.dtype == torch.float32, name
        assert x[1].is_contiguous(), name
        # a tile's slice is one run of bytes of the stated size
        assert x[0].numel() * 4 == want[name], name
        assert (x[1].data_ptr() - x[0].data_ptr()) == want[name], name
    for name in ("table", "misc"):
        x = getattr(q, name)
        for tile in range(tiles):
            assert (x[tile].data_ptr() - x.data_ptr()) % 16 == 0, \
                (name, tile)
    bulk = TC.bulk_slices(m)
    assert "table" in bulk
    for name in ("keys", "hsuf"):
        assert (name in bulk) == (want[name] % 16 == 0), (name, m)
    assert ("keys" in bulk) == (m % 16 == 0)
    assert ("hsuf" in bulk) == (m % 32 == 0)
