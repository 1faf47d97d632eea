"""The table build's kernels (``csrc/cull.cu``) against the plain build
(``cull.build_pair_tables_plain``) on the same CUDA tensors.  Needs a CUDA
device (marker ``cuda``); skipped without one.  Imports only torch and the
port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cull_cuda.py

The bar: counts and candidate sets exact; the rows that follow the
candidates (members that are not, in row order; past the group the last
column again) exact; the cones' frames (apex, axis), ``oa`` / ``ca`` and
misc within 1e-5 (the kernel sums a tile's lanes in another order), every
other cone statistic exactly the plain formulas' in the kernel's own
frame; the candidates' order equal but among axial keys within 1e-5 of
each other; the table
exactly the plain rows at the kernel's ``idx``; the chunk keys exactly the
chunk max / min of the kernel's own keys, ``hsuf`` exactly their suffix
minima; the overflow flag the plain one.  (On these small batches the
cones' lane sums, in another order, move no member across its test;
``chip_smoke.py``'s ``[cull]`` phase holds the full-size sites to the
plain build run on the kernel's cones, and counts the members that the
plain cones' last bits move.)  A culled graph frame and graph
step on the kernels' tables against the eager ones on the plain tables
(the bounds of ``tests/test_torch_cuda.py``), with one cones and one select
launch at every culled site."""
import pytest
import torch

import fraytracer_tpu_torch as ft
from fraytracer_tpu_torch.ops import cuda as ops_cuda
from fraytracer_tpu_torch.ops.cuda import cull, cull_kernel as ck, \
    march_kernel as mk
from fraytracer_tpu_torch.ops.march import bound_skip_start
from fraytracer_tpu_torch.ops.sdf import _prim_bound_rows
from fraytracer_tpu_torch.scene.generators import torus_csg_scene

pytestmark = pytest.mark.cuda

TOL = 1e-5
STEP_GRAD_REL = 2e-4     # tests/test_torch_cuda.py's graph-step bound


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _mat():
    return ft.solid(0.5, 0.5, 0.5)


def _rand(g, n, scale=1.0):
    return ((torch.rand(n, 3, generator=g) - 0.5) * scale).tolist()


def _scene(name):
    """The scene of a case, as nodes (before ``flatten``)."""
    g = torch.Generator().manual_seed(7)
    if name == "intersect256":
        return ft.Scene(root=ft.intersect(
            *[ft.sphere(tuple(x), 2.0, material=_mat())
              for x in _rand(g, 256)]))
    if name == "blend96":
        base = torus_csg_scene(19, 96)
        return ft.Scene(root=ft.smooth_union(0.25, base.root, ft.sphere(
            (0, 0, 0), 1.5, material=_mat())), background=base.background,
            lights=base.lights)
    if name == "multi_pair":
        # five intersections of 512 fat spheres: five culled max pairs
        return ft.Scene(root=ft.union(*[ft.intersect(*[
            ft.sphere(((i - 2) * 2.0 + x, y, z), 0.9, material=_mat())
            for x, y, z in _rand(g, 512, 0.4)]) for i in range(5)]))
    if name == "kinds":
        # one union of six kinds, 40 of each: a pair a kind
        c = _rand(g, 240, 6.0)
        e = _rand(g, 240, 0.6)

        def plus(p, q):
            return tuple(x + y for x, y in zip(p, q))
        prims = []
        for i in range(40):
            a, b = c[6 * i:6 * i + 6], e[6 * i:6 * i + 6]
            prims += [
                ft.sphere(a[0], 0.2, _mat()),
                ft.capsule(a[1], plus(a[1], b[1]), 0.1, _mat()),
                ft.torus(a[2], b[2], 0.3, 0.05, _mat()),
                ft.triangle(a[3], plus(a[3], b[3]), plus(a[3], b[4]), 0.02,
                            _mat()),
                ft.box(a[4], (0.2, 0.1, 0.15), 0.02, _mat()),
                ft.cone(a[5], plus(a[5], b[5]), 0.2, 0.05, _mat())]
        return ft.Scene(root=ft.union(*prims))
    if name == "large":
        # one group past a select block's shared memory: the large path
        return ft.Scene(root=ft.union(*[
            ft.sphere(tuple(x), 0.02, material=_mat())
            for x in _rand(g, 16_400, 4.0)]))
    if name == "large_pairs":
        # two such groups: two pairs of one launch on the large path
        return ft.Scene(root=ft.union(*[ft.intersect(*[
            ft.sphere((i - 0.5 + x, y, z), 1.0, material=_mat())
            for x, y, z in _rand(g, 16_400, 0.5)]) for i in range(2)]))
    n_tori = {"padding": 101, "bench1000": 1000}.get(name, 96)
    return torus_csg_scene(19, n_tori)


# name: (cull_m, threshold, point light?, camera z, size, select path)
CASES = {
    "torus96": (256, 48, False, -10, 128, "cull_select"),
    "intersect256": (512, 192, False, -6, 128, "cull_select"),
    "point_light": (256, 48, True, -10, 128, "cull_select"),
    "blend96": (256, 48, False, -10, 128, "cull_select"),
    "sign": (256, 48, False, -10, 128, "cull_select"),
    "overflow": (16, 48, False, -10, 128, "cull_select"),
    "padding": (256, 48, False, -10, 128, "cull_select"),
    "multi_pair": (1024, 512, False, -10, 64, "cull_select"),
    "kinds": (256, 16, False, -10, 64, "cull_select"),
    "bench1000": (1024, 48, False, -10, 64, "cull_select"),
    "large": (256, 48, False, -10, 32, "cull_select_large"),
    "large_pairs": (256, 48, False, -10, 32, "cull_select_large"),
}


def table_case(name, dev):
    """``(scene, lanes, pairs, cull_m, apex)`` of a case: camera rays in
    32×32 block order with the root-bound start and budget (``sign``:
    every other lane at -1, its start taken inside), or point-light shadow
    rays with the converging cone."""
    from fraytracer_tpu_torch.render import _to_blocks
    cull_m, threshold, point, z, size, _path = CASES[name]
    scene = ft.flatten(_scene(name), device=dev)
    cam = ft.look_at((0, 0, z), (0, 0, 0), device=dev)
    rays = ft.camera_rays(cam, size, size, 0.01, 30.0).map(
        lambda x: _to_blocks(x, size, size, 32).contiguous())
    apex = sign = None
    if point:
        apex = torch.tensor([-0.5, 0.0, -2.0], device=dev)
        o = rays.origin + 9.0 * rays.direction
        diff = apex - o
        dist = diff.norm(dim=-1)
        rays = ft.Rays(o.contiguous(), (diff / dist[:, None]).contiguous(),
                       dist.contiguous(), rays.epsilon)
    if name == "sign":
        sign = torch.where(torch.arange(size * size, device=dev) % 2 == 0,
                           -1.0, 1.0)
    t0, miss0, t_exit = bound_skip_start(scene, rays, sign)
    length = torch.where(miss0, 0.0, torch.minimum(rays.length, t_exit))
    lanes = (rays.origin, rays.direction, t0.contiguous(),
             length.contiguous(), rays.epsilon)
    pairs = cull._cull_pairs(scene.kind_counts, scene.plan, threshold)
    assert pairs
    return scene, lanes, pairs, cull_m, apex


def _close(a, b, label):
    assert a.shape == b.shape and a.dtype == b.dtype, label
    d = (a.double() - b.double()).abs()
    lim = TOL * (1.0 + b.double().abs())
    assert bool((d <= lim).all()), (label, float(d.max()))


def _axial(scene, q, cones):
    """``[G, g]`` axial key of every member of pair ``q`` in each tile
    cone's frame, as the plain build computes it."""
    kb = _prim_bound_rows(q.kind, scene.prim_params[q.kind][
        q.row_lo:q.row_hi].detach().to(torch.float32))
    v = kb[None, :, 0:3] - cones.apex[:, None, :]
    return (v * cones.axis[:, None, :]).sum(-1), kb[:, 3]


def plain_tables(args, cones=None):
    """The plain build of ``args`` (``build_pair_tables``' arguments);
    with ``cones`` (tile, sub-tile ``TileCones``) in place of its own."""
    if cones is None:
        return cull.build_pair_tables_plain(*args)
    real = cull.lane_cones

    def given(*lane_args):
        return cones + real(*lane_args)[2:]
    cull.lane_cones = given
    try:
        return cull.build_pair_tables_plain(*args)
    finally:
        cull.lane_cones = real


def assert_cones_close(lanes, apex):
    """The kernel's cones of tiles and sub-tiles: their frames (apex and
    axis, from sums over the lanes in another order) within 1e-5 of the
    plain build's, and every statistic exactly the plain formulas' in the
    kernel's own frame.  (In the plain build's frame a statistic that
    cancels, as the converging tangents λ/o_par do for lanes near the
    axis, can move by far more than the frame's last bits.)  Returns
    them."""
    kt, kf, _oa, _ca = ck.tile_cones(*lanes, apex)
    pt, pf, _o, _d = cull.lane_cones(*lanes, apex)
    padded = cull.padded_lanes(*lanes)
    grid = padded[0].shape[0] // cull.TILE
    for k, p, g, label in ((kt, pt, grid, "tile"),
                           (kf, pf, grid * cull.SUBF, "sub-tile")):
        _close(k.apex, p.apex, f"{label} apex")
        _close(k.axis, p.axis, f"{label} axis")
        want = cull._cones_in_frame(*padded, g, cull.TILE * grid // g,
                                    k.apex, k.axis, apex is not None)
        for f in cull.TileCones._fields:
            assert torch.equal(getattr(k, f), getattr(want, f)), (label, f)
    return kt, kf


def assert_tables_match(scene, lanes, apex, got, want):
    """The kernels' CullTables against the plain ones (module docstring)."""
    assert got.pairs == want.pairs and len(got.tables) == len(want.tables)
    assert (got.overflow is None) == (want.overflow is None)
    if want.overflow is not None:
        assert got.overflow.dtype == torch.bool and got.overflow.ndim == 0
        assert bool(got.overflow) == bool(want.overflow)
    _close(got.oa, want.oa, "oa")
    _close(got.ca, want.ca, "ca")
    kcones, _kf, _oa, _ca = ck.tile_cones(*lanes, apex)
    for q, w in zip(got.tables, want.tables):
        for f in ("gid", "op", "kind", "row_lo", "row_hi", "m"):
            assert getattr(q, f) == getattr(w, f), f
        for f in ("idx", "count", "table", "keys", "misc", "hsuf"):
            a, b = getattr(q, f), getattr(w, f)
            assert a.shape == b.shape and a.dtype == b.dtype, f
            assert a.is_contiguous(), f
        assert torch.equal(q.count, w.count)
        assert torch.equal(q.misc[:, 0], w.misc[:, 0])
        _close(q.misc[:, 1:], w.misc[:, 1:], "misc")
        grid, m = q.idx.shape
        g = q.row_hi - q.row_lo
        pos = torch.arange(m, device=q.idx.device)
        cand = pos[None, :] < q.count.clamp(max=m)[:, None].long()
        # candidate sets exact, the rows after them exact
        big = torch.iinfo(torch.int64).max
        assert torch.equal(torch.where(cand, q.idx, big).sort(1).values,
                           torch.where(cand, w.idx, big).sort(1).values)
        assert torch.equal(q.idx[~cand], w.idx[~cand])
        # order: where the rows differ, their keys tie within 1e-5
        a, rb = _axial(scene, w, cull.lane_cones(*lanes[:2], lanes[2],
                                                 lanes[3], lanes[4],
                                                 apex)[0])
        ka, kw = a.gather(1, q.idx), a.gather(1, w.idx)
        diff = cand & (q.idx != w.idx)
        assert bool(((ka - kw).abs() <= TOL * (1 + kw.abs()))[diff].all())
        # the table: the plain rows at the kernel's idx
        rows = cull._table_rows(scene, q.kind, q.row_lo, q.row_hi)
        assert torch.equal(q.table, rows[q.idx])
        # chunk keys and suffix minima of the kernel's own keys
        ak, _rb = _axial(scene, q, kcones)
        key = torch.where(pos[None, :] < q.count[:, None].long(),
                          ak.gather(1, q.idx), cull._BIG)
        r = rb[q.idx]
        lo = torch.where(pos[None, :] < g, key + r + 1e-3, cull._BIG)
        hi = torch.where(pos[None, :] < g, key - r - 1e-3, cull._BIG)
        chunks = m // cull.CAND_UNROLL
        assert torch.equal(q.keys[:, 0], lo.reshape(grid, chunks, -1)
                           .amax(-1))
        assert torch.equal(q.keys[:, 1], hi.reshape(grid, chunks, -1)
                           .amin(-1))
        suf = torch.flip(torch.cummin(torch.flip(q.keys[:, 1], [1]), 1)
                         .values, [1])
        assert torch.equal(q.hsuf, suf)


@pytest.mark.parametrize("name", list(CASES))
def test_table_build_kernels_match_plain(dev, name):
    """``build_pair_tables`` on CUDA tensors launches the cones kernel and
    one select launch (the large path for a group past shared memory) and
    gives the plain build's tables by the module's bar; the cone
    statistics of tiles and sub-tiles within 1e-5."""
    scene, lanes, pairs, cull_m, apex = table_case(name, dev)
    args = (scene, *lanes, pairs, cull_m, 0.125, apex)
    ops_cuda.reset_launch_counts()
    got = cull.build_pair_tables(*args)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops_cuda.launch_counts().items() if v}
    assert counts == {"cull_cones": 1, CASES[name][-1]: 1}
    want = cull.build_pair_tables_plain(*args)
    if name == "overflow":
        assert want.overflow is not None and bool(want.overflow)
    if name == "padding":
        assert got.tables[0].m > got.tables[0].row_hi - got.tables[0].row_lo
    if name == "blend96":
        assert bool((got.tables[0].misc[:, 2] > 0.125).any())
    assert_tables_match(scene, lanes, apex, got, want)
    assert_cones_close(lanes, apex)


def test_table_build_without_lanes_launches_nothing(dev):
    """An empty batch: tables of no tile, no launch."""
    scene, lanes, pairs, cull_m, apex = table_case("torus96", dev)
    empty = tuple(x[:0] for x in lanes)
    ops_cuda.reset_launch_counts()
    got = cull.build_pair_tables(scene, *empty, pairs, cull_m, 0.125)
    assert not any(ops_cuda.launch_counts().values())
    (q,) = got.tables
    assert q.table.shape == (0, q.m, cull.TABLE_W)
    assert q.idx.shape == (0, q.m) and got.oa.shape == (0,)


def _with_plain_tables(fn):
    """``fn()`` with every culled site on the plain build."""
    saved = mk.build_pair_tables
    mk.build_pair_tables = cull.build_pair_tables_plain
    try:
        return fn()
    finally:
        mk.build_pair_tables = saved


def _graph_setup(dev, size=128):
    import sys
    scene = ft.flatten(torus_csg_scene(19, 96), device=dev)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), device=dev)
    cfg = ft.RenderConfig(width=size, height=size, march=ft.MarchConfig(
        max_steps=192, relax_omega=1.4))
    sys.modules["fraytracer_tpu_torch.render"]._graphs.clear()
    return scene, cam, cfg


def _sites(counts):
    return counts["march_culled"] + counts["occlusion_culled"]


def test_graph_frame_on_kernel_tables_is_the_plain_tables_frame(dev):
    """The captured culled frame (kernel tables at its three sites)
    against the eager frame on the plain tables: every pixel within 1e-4
    on ≥ 99.9 % of them, ``n_rays`` within 0.1 %; a replay launches one
    cones and one select kernel a site."""
    scene, cam, cfg = _graph_setup(dev)
    rays = ft.camera_rays(cam, cfg.width, cfg.height, cfg.epsilon,
                          cfg.length)
    want, wn = _with_plain_tables(lambda: ft.render_grid(scene, rays, cfg))
    ft.render_with_stats(scene, cam, cfg)
    ops_cuda.reset_launch_counts()
    img, n = ft.render_with_stats(scene, cam, cfg)
    counts = ops_cuda.launch_counts()
    assert ops_cuda.graph_counts()["replays"] == 1
    assert _sites(counts) == 3
    assert counts["cull_cones"] == counts["cull_select"] == 3
    assert counts["cull_select_large"] == 0
    same = (img - want).abs().amax(-1) <= 1e-4
    assert same.float().mean().item() >= 0.999
    assert abs(int(n) - int(wn)) <= 1e-3 * int(wn)


def test_graph_step_on_kernel_tables_is_the_plain_tables_step(dev):
    """The captured culled step against the eager step on the plain
    tables: loss within 1e-5 of it, each leaf's gradient within 2e-4 of
    its largest |g|; a replay launches one cones and one select kernel at
    each of the forward's sites (the backward builds none)."""
    import sys
    R = sys.modules["fraytracer_tpu_torch.render"]
    scene, cam, cfg = _graph_setup(dev)

    def loss(img):
        return (img ** 2).sum()
    out = _with_plain_tables(lambda: R._eager_step(loss, scene, cam, cfg))
    want = (out[0], dict(zip(scene.tensors(), out[1:])))
    ft.render_value_and_grad(loss, scene, cam, cfg)
    ops_cuda.reset_launch_counts()
    got = ft.render_value_and_grad(loss, scene, cam, cfg)
    counts = ops_cuda.launch_counts()
    assert ops_cuda.graph_counts()["replays"] == 1
    assert _sites(counts) == 3
    assert counts["cull_cones"] == counts["cull_select"] == 3
    assert abs(float(got[0]) - float(want[0])) <= 1e-5 * abs(float(want[0]))
    for k, w in want[1].items():
        scale = float(w.abs().max())
        assert float((got[1][k] - w).abs().max()) <= STEP_GRAD_REL * scale, k
