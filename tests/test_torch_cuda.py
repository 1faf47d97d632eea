"""The CUDA kernels against their plain PyTorch versions on the same CUDA
tensors.  Needs a CUDA device (marker ``cuda``); skipped without one.

Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: hit masks equal on ≥ 99.9% of lanes and t within 1e-4 on lanes
that both hit in the same number of steps (nvcc contracts a*b+c into FMA,
the plain version rounds twice); surface outputs on identical inputs:
codes equal on ≥ 99.9% of hit lanes, normals within 1e-4 there; the block
gather is exact.  The culled forms are held to the same bounds on the
same candidate tables; K3 on synthesised hit masks (an empty tile, a full
block, a ragged batch, staged and unstaged pairs) to equal codes and
materials on every lane and normals within 1e-4.  The AD-mode surface
pass (plans with a smooth union): normals within 1e-4 of the plain version on ≥ 99.9% of hit lanes
(both sum the same exp weights, in another order and with FMA), materials
equal, and within 1e-3 of the dense autograd normal.  ``sign`` lanes: hit
masks equal and t within 1e-4 of the plain version.  The gradient path:
the backward fed the kernels' residuals on the card against the same
backward on the CPU (1e-5 of each leaf's max |g|: the same plain PyTorch
on two devices); a frame's gradient through the kernels against the plain
route with the lanes whose outcome or t differ masked out (1e-3 of each
leaf's norm).  W, P1 and P2 exact, P3 within rtol 1e-6, P4 equal trips and
1e-5."""
import pytest
import torch

import fraytracer_tpu_torch as ft
from fraytracer_tpu_torch.ops import cuda as ops_cuda
from fraytracer_tpu_torch.ops.cuda import gather, march_kernel as mk
from fraytracer_tpu_torch.ops.march import bound_skip_start
from fraytracer_tpu_torch.scene.generators import csg_demo_scene, \
    torus_csg_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def lanes(scene, size, dev):
    cam = ft.look_at((0, 0, -10), (0, 0, 0), device=dev)
    rays = ft.camera_rays(cam, size, size, 0.01, 30.0).map(
        lambda x: x.reshape((size * size,) + tuple(x.shape[2:])))
    t0, miss0, t_exit = bound_skip_start(scene, rays)
    length = torch.where(miss0, 0.0, torch.minimum(rays.length, t_exit))
    return (rays.origin, rays.direction, length.contiguous(), rays.epsilon,
            t0.contiguous())


@pytest.mark.parametrize("omega", [1.0, 1.4])
@pytest.mark.parametrize("name", ["torus", "csg_demo", "torus1000"])
def test_march_and_surface_kernels_match_plain(dev, name, omega):
    """Dense K1/K2/K3 against the plain versions: the 96-torus scene and
    ``csg_demo_scene`` at 128², the benchmark's 1002 entries at 64² (the
    dense form's packed rows staged in shared memory)."""
    scene = ft.flatten(torus_csg_scene(19, 96) if name == "torus"
                       else torus_csg_scene(19, 1000) if name == "torus1000"
                       else csg_demo_scene(), device=dev)
    args = lanes(scene, 64 if name == "torus1000" else 128, dev)
    kw = dict(max_steps=192, omega=omega)
    ops_cuda.reset_launch_counts()
    tk, hk, _dk, sk = mk.march_kernel(scene, *args, **kw)
    tp, hp, _dp, sp = mk.march_plain(scene, *args, **kw)
    assert (hk == hp).float().mean().item() >= 0.999
    same = hk & hp & (sk == sp)
    assert int(same.sum()) >= 0.999 * int((hk & hp).sum())
    assert (tk - tp).abs()[same].max().item() <= 1e-4
    ho, _so = mk.march_kernel(scene, *args, **kw, occlusion=True)
    assert torch.equal(ho, hk)

    o, d, _l, e, _t0 = args
    nk, mk_, ck = mk.surface_kernel(scene, o, d, tk, e, hk)
    np_, mp, cp = mk.surface_plain(scene, o, d, tk, e, hk)
    agree = hk & (ck == cp)
    assert int(agree.sum()) >= 0.999 * int(hk.sum())
    assert (nk - np_).abs()[agree].max().item() <= 1e-4
    assert torch.equal(mk_[agree], mp[agree])
    counts = ops_cuda.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "march": 1, "occlusion": 1, "surface": 1}


def culled_inputs(name, dev):
    """Lanes and candidate tables of one culled case: camera rays in 32×32
    block order on the 96-torus scene or a 256-sphere intersect, or
    point-light shadow rays with the converging cone."""
    from fraytracer_tpu_torch.ops.cuda import cull
    from fraytracer_tpu_torch.render import _to_blocks
    if name == "intersect256":
        g = torch.Generator().manual_seed(11)
        c = (torch.rand(256, 3, generator=g) - 0.5).tolist()
        scene = ft.flatten(ft.Scene(root=ft.intersect(
            *[ft.sphere(tuple(x), 2.0, material=ft.solid(0.5, 0.5, 0.5))
              for x in c])), device=dev)
        pos, threshold, m = (0, 0, -6), 192, 512
    else:
        scene = ft.flatten(torus_csg_scene(19, 96), device=dev)
        pos, threshold, m = (0, 0, -10), 48, 256
    size, apex = 128, None
    cam = ft.look_at(pos, (0, 0, 0), device=dev)
    rays = ft.camera_rays(cam, size, size, 0.01, 30.0).map(
        lambda x: _to_blocks(x, size, size, 32).contiguous())
    if name == "point_light":
        apex = torch.tensor([-0.5, 0.0, -2.0], device=dev)
        o = rays.origin + 9.0 * rays.direction
        diff = apex - o
        dist = diff.norm(dim=-1)
        rays = ft.Rays(o.contiguous(), (diff / dist[:, None]).contiguous(),
                       dist.contiguous(), rays.epsilon)
    t0, miss0, t_exit = bound_skip_start(scene, rays)
    length = torch.where(miss0, 0.0, torch.minimum(rays.length, t_exit))
    args = (rays.origin, rays.direction, length.contiguous(), rays.epsilon,
            t0.contiguous())
    pairs = cull._cull_pairs(scene.kind_counts, scene.plan, threshold)
    tables = cull.build_pair_tables(scene, *args[:2], args[4], args[2],
                                    args[3], pairs, m, 0.125, apex)
    return scene, args, tables


@pytest.mark.parametrize("early_out", [False, True])
@pytest.mark.parametrize("name", ["torus96", "intersect256", "point_light"])
def test_culled_kernels_match_plain(dev, name, early_out):
    """Culled K1/K2/K3 against their plain versions on the same tables:
    hit masks ≥ 99.9% equal, t within 1e-4 on lanes with equal step
    counts, occlusion == march, codes ≥ 99.9% equal with normals within
    1e-4 and materials equal there."""
    scene, args, tables = culled_inputs(name, dev)
    assert tables.tables
    tables.early_out = early_out
    kw = dict(max_steps=192, omega=1.4, cull=tables)
    ops_cuda.reset_launch_counts()
    tk, hk, _dk, sk = mk.march_kernel(scene, *args, **kw)
    tp, hp, _dp, sp = mk.march_plain(scene, *args, **kw)
    assert (hk == hp).float().mean().item() >= 0.999
    same = hk & hp & (sk == sp)
    assert int(same.sum()) >= 0.999 * int((hk & hp).sum())
    assert (tk - tp).abs()[same].max().item() <= 1e-4
    ho, _so = mk.march_kernel(scene, *args, **kw, occlusion=True)
    assert torch.equal(ho, hk)
    o, d, _l, e, _t0 = args
    nk, mk_, ck = mk.surface_kernel(scene, o, d, tk, e, hk, cull=tables)
    np_, mp, cp = mk.surface_plain(scene, o, d, tk, e, hk, cull=tables)
    agree = hk & (ck == cp)
    assert int(agree.sum()) >= 0.999 * int(hk.sum())
    assert (nk - np_).abs()[agree].max().item() <= 1e-4
    assert torch.equal(mk_[agree], mp[agree])
    counts = ops_cuda.launch_counts()
    assert (counts["march_culled"], counts["occlusion_culled"],
            counts["surface_culled"], counts["march"]) == (1, 1, 1, 0)


def smooth_scene(name):
    """Plans with a smooth union: a sumexp group under intersect and
    subtract; a smooth union of sub-plans alone; a 64-torus sumexp group;
    256 spheres intersected (a culled max group) beside a smooth union of
    two spheres; 96 tori (a culled min group) smooth-united with a sphere."""
    g = torch.Generator().manual_seed(5)
    if name == "smooth_subtract":
        root = ft.subtract(
            ft.intersect(ft.smooth_union(
                0.3, ft.sphere((0, 0, 0), 1.0, material=ft.solid(1, 0, 0)),
                ft.sphere((0.8, 0.3, 0), 0.7, material=ft.solid(0, 1, 0))),
                ft.sphere((0, 0, 0), 1.5)),
            ft.box((0.3, 0.5, -0.7), (0.4, 0.4, 0.4), 0.05))
    elif name == "subplans":
        root = ft.smooth_union(
            0.3, ft.union(ft.sphere((0, 0, 0), 1.0,
                                    material=ft.solid(1, 0, 0)),
                          ft.sphere((0, 1.2, 0), 0.5,
                                    material=ft.solid(0, 0, 1))),
            ft.intersect(ft.sphere((1, 0, 0), 1.0,
                                   material=ft.solid(0, 1, 0)),
                         ft.box((1, 0, 0), (0.7, 0.7, 0.7), 0.05)))
    elif name == "sumexp64":
        c = ((torch.rand(64, 3, generator=g) - 0.5) * 5.0).tolist()
        a = (torch.rand(64, 3, generator=g) - 0.5).tolist()
        root = ft.smooth_union(0.2, *[
            ft.torus(tuple(x), tuple(y), 0.5, 0.15,
                     material=ft.solid(0.1 + 0.01 * i, 0.5, 0.5))
            for i, (x, y) in enumerate(zip(c, a))])
    elif name == "intersect_blend":
        c = ((torch.rand(256, 3, generator=g) - 0.5) * 0.8).tolist()
        root = ft.union(
            ft.intersect(*[ft.sphere(tuple(x), 2.0,
                                     material=ft.solid(0.2, 0.6, 0.9))
                           for x in c]),
            ft.smooth_union(0.3, ft.sphere((2.4, 0.0, 0.0), 0.7,
                                           material=ft.solid(0.9, 0.5, 0.1)),
                            ft.sphere((2.9, 0.5, 0.0), 0.5)))
    else:
        root = ft.smooth_union(
            0.25, torus_csg_scene(19, 96).root,
            ft.sphere((0, 0, 0), 1.5, material=ft.solid(0.8, 0.7, 0.3)))
    return ft.Scene(root=root)


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("name", ["smooth_subtract", "subplans", "sumexp64",
                                  "intersect_blend", "blend96"])
def test_surface_ad_kernel_matches_plain_and_dense(dev, name, cull):
    """K3 AD mode on (t, hit) from K1, dense and on candidate tables."""
    from fraytracer_tpu_torch.ops import sdf
    from fraytracer_tpu_torch.ops.cuda import cull as C
    from fraytracer_tpu_torch.render import _to_blocks
    scene = ft.flatten(smooth_scene(name), device=dev)
    assert not mk.slot_surface_mode(scene.plan)
    size = 128
    cam = ft.look_at((0, 0, -7), (0, 0, 0), device=dev)
    rays = ft.camera_rays(cam, size, size, 0.01, 30.0).map(
        lambda x: _to_blocks(x, size, size, 32).contiguous())
    t0, miss0, t_exit = bound_skip_start(scene, rays)
    length = torch.where(miss0, 0.0,
                         torch.minimum(rays.length, t_exit)).contiguous()
    args = (rays.origin, rays.direction, length, rays.epsilon,
            t0.contiguous())
    tables = None
    if cull:
        pairs = C._cull_pairs(scene.kind_counts, scene.plan, 48)
        if not pairs:
            pytest.skip("no group large enough to cull")
        tables = C.build_pair_tables(scene, *args[:2], args[4], args[2],
                                     args[3], pairs, 512, 0.125)
    kw = dict(max_steps=192, omega=1.4, cull=tables)
    tk, hk, _d, _s = mk.march_kernel(scene, *args, **kw)
    assert int(hk.sum()) > 100
    o, d, _l, e, _t0 = args
    ops_cuda.reset_launch_counts()
    nk, mk_, ck = mk.surface_kernel(scene, o, d, tk, e, hk, cull=tables)
    counts = ops_cuda.launch_counts()
    key = "surface_ad_culled" if cull else "surface_ad"
    assert counts[key] == 1 and counts["surface"] == 0 \
        and counts["surface_culled"] == 0
    np_, mp, cp = mk.surface_plain(scene, o, d, tk, e, hk, cull=tables)
    assert not ck.any() and not cp.any()
    close = (nk - np_).abs().amax(-1) <= 1e-4
    assert int((close & hk).sum()) >= 0.999 * int(hk.sum())
    assert torch.equal(mk_[hk], mp[hk])
    assert torch.equal(nk[~hk], np_[~hk]) and bool((mk_[~hk] == -1).all())
    pos = (o + (tk - e)[:, None] * d)[hk]
    dense = sdf.scene_normal(scene, pos)
    close = (nk[hk] - dense).abs().amax(-1) <= 1e-3
    assert int(close.sum()) >= 0.999 * int(hk.sum())


def test_sign_lanes_match_plain(dev):
    """K1/K2 with per-lane sign: rays starting inside a solid march to its
    exit surface; a mixed-sign batch on the 96-torus scene, dense and
    culled, and on the benchmark's 1002 entries at 64², dense."""
    scene = ft.flatten(ft.Scene(root=ft.union(
        ft.sphere((0, 0, 0), 1.0), ft.box((2.5, 0, 0), (0.5, 0.5, 0.5)))),
        device=dev)
    o = torch.tensor([[0.0, 0, 0], [0.2, 0.1, 0], [2.5, 0, 0]], device=dev)
    d = torch.tensor([[0.0, 0, 1], [1.0, 0, 0], [0.0, 1, 0]], device=dev)
    ln = torch.full((3,), 10.0, device=dev)
    e = torch.full((3,), 1e-3, device=dev)
    t0 = torch.zeros(3, device=dev)
    sg = -torch.ones(3, device=dev)
    kw = dict(max_steps=128, omega=1.0, sign=sg)
    tk, hk, _dk, _sk = mk.march_kernel(scene, o, d, ln, e, t0, **kw)
    tp, hp, _dp, _sp = mk.march_plain(scene, o, d, ln, e, t0, **kw)
    assert bool(hk.all()) and torch.equal(hk, hp)
    assert (tk - tp).abs().max().item() <= 1e-4
    want = torch.tensor([1.0, (1 - 0.01) ** 0.5 - 0.2, 0.5], device=dev)
    assert (tk - want).abs().max().item() <= 2e-3

    scene, args, tables = culled_inputs("torus96", dev)
    bench = ft.flatten(torus_csg_scene(19, 1000), device=dev)
    g = torch.Generator().manual_seed(3)
    for scene, args, cull in ((scene, args, None), (scene, args, tables),
                              (bench, block_lanes(bench, 64, dev), None)):
        sg = torch.where(torch.rand(args[0].shape[0], generator=g) < 0.5,
                         -1.0, 1.0).to(dev)
        kw = dict(max_steps=192, omega=1.4, cull=cull, sign=sg)
        tk, hk, _dk, sk = mk.march_kernel(scene, *args, **kw)
        tp, hp, _dp, sp = mk.march_plain(scene, *args, **kw)
        assert (hk == hp).float().mean().item() >= 0.999
        same = hk & hp & (sk == sp)
        assert int(same.sum()) >= 0.999 * int((hk & hp).sum())
        assert (tk - tp).abs()[same].max().item() <= 1e-4
        ho, _so = mk.march_kernel(scene, *args, **kw, occlusion=True)
        assert torch.equal(ho, hk)
        # the outward lanes are the unsigned march's
        t1, h1, _d1, _s1 = mk.march_kernel(scene, *args, max_steps=192,
                                           omega=1.4, cull=cull)
        out = sg > 0
        assert torch.equal(hk[out], h1[out])
        # dense: bit for bit; culled: a warp's window follows its active
        # lanes, so these lanes step otherwise and land within 3ε
        dt = (tk - t1).abs()[out & h1].max().item()
        assert dt <= (0.0 if cull is None else 0.03)


def test_dense_refill_beyond_the_persistent_grid(dev):
    """Dense K1/K2 on more rays than the persistent grid holds at once
    (512² on the 96-torus scene: 262,144 lanes against at most 6 blocks of
    128 lanes an SM), so lanes take new rays as theirs end: against the
    plain version; each ray's outputs bit for bit those of the same rays
    launched as a batch of their own (a lane's march reads its own ray
    alone); the warps' issue count covers the evaluations."""
    scene = ft.flatten(torus_csg_scene(19, 96), device=dev)
    args = block_lanes(scene, 512, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert args[0].shape[0] > sms * 6 * 128
    kw = dict(max_steps=192, omega=1.4)
    issued = torch.zeros(1, dtype=torch.int64, device=dev)
    tk, hk, dk, sk = mk.march_kernel(scene, *args, **kw, issued=issued)
    tp, hp, _dp, sp = mk.march_plain(scene, *args, **kw)
    assert int(hk.sum()) > 10000
    assert (hk == hp).float().mean().item() >= 0.999
    same = hk & hp & (sk == sp)
    assert int(same.sum()) >= 0.999 * int((hk & hp).sum())
    assert (tk - tp).abs()[same].max().item() <= 1e-4
    evals = int(sk.sum())
    assert 0 < evals <= 32 * int(issued)
    part = slice(100_003, 105_003)
    alone = mk.march_kernel(scene, *[a[part].contiguous() for a in args],
                            **kw)
    for got, want in zip(alone, (tk, hk, dk, sk)):
        assert torch.equal(got, want[part])
    ho, so = mk.march_kernel(scene, *args, **kw, occlusion=True)
    assert torch.equal(ho, hk) and torch.equal(so, sk)


def test_dense_kernels_with_unstaged_rows(dev):
    """The dense form on 8002 entries at 64²: their packed rows (256,032
    bytes) exceed a block's shared memory, so K1/K2 and K3 read them from
    device memory through the same code (K3 still stages each entry's
    material and slot); against the plain versions."""
    from fraytracer_tpu_torch.ops.cuda import cull
    scene = ft.flatten(torus_csg_scene(19, 8000), device=dev)
    prog = mk.lower_program(scene, dev)
    plan, splan = mk.march_stage_plan(prog, None), \
        mk.surface_stage_plan(prog, None)
    assert plan.rows_bytes == 8000 * 32 + 2 * 16 > cull.SMEM_LIMIT
    assert not plan.staged and not splan.staged and splan.ms_off >= 0
    args = block_lanes(scene, 64, dev)
    kw = dict(max_steps=192, omega=1.4)
    tk, hk, _dk, sk = mk.march_kernel(scene, *args, **kw)
    tp, hp, _dp, sp = mk.march_plain(scene, *args, **kw)
    assert int(hk.sum()) > 500
    assert (hk == hp).float().mean().item() >= 0.999
    same = hk & hp & (sk == sp)
    assert int(same.sum()) >= 0.999 * int((hk & hp).sum())
    assert (tk - tp).abs()[same].max().item() <= 1e-4
    o, d, _l, e, _t0 = args
    assert_surface_matches_plain(scene, o, d, tk, e, hk, None)


def overbudget_scene(dev, groups=5, per_group=1024):
    """``groups`` intersections of ``per_group`` fat spheres, united: as
    many culled max pairs, each with a table of ``per_group`` rows a tile
    (50,688 bytes of shared memory at 1024) — more than a block may hold,
    so one launch reads staged and unstaged pairs."""
    g = torch.Generator().manual_seed(23)
    parts = []
    for i in range(groups):
        cx = (i - (groups - 1) / 2) * 2.0
        c = (torch.rand(per_group, 3, generator=g) - 0.5) * 0.4
        parts.append(ft.intersect(*[
            ft.sphere((cx + float(x), float(y), float(z)), 0.9,
                      material=ft.solid(0.2 + 0.1 * i, 0.5, 0.5))
            for x, y, z in c.tolist()]))
    return ft.flatten(ft.Scene(root=ft.union(*parts)), device=dev)


def block_lanes(scene, size, dev, z=-10.0):
    """Camera rays in 32×32 block order with the root-bound start and
    budget, as ``cuda_march_raw`` hands them to K1."""
    from fraytracer_tpu_torch.render import _to_blocks
    cam = ft.look_at((0, 0, z), (0, 0, 0), device=dev)
    rays = ft.camera_rays(cam, size, size, 0.01, 30.0).map(
        lambda x: _to_blocks(x, size, size, 32).contiguous())
    t0, miss0, t_exit = bound_skip_start(scene, rays)
    length = torch.where(miss0, 0.0, torch.minimum(rays.length, t_exit))
    return (rays.origin, rays.direction, length.contiguous(), rays.epsilon,
            t0.contiguous())


def overbudget_inputs(dev):
    """The over-budget scene at 64² with tables of m 1024: 5 pairs."""
    from fraytracer_tpu_torch.ops.cuda import cull
    scene = overbudget_scene(dev)
    args = block_lanes(scene, 64, dev)
    pairs = cull._cull_pairs(scene.kind_counts, scene.plan, 512)
    assert len(pairs) == 5
    tables = cull.build_pair_tables(scene, *args[:2], args[4], args[2],
                                    args[3], pairs, 1024, 0.125)
    return scene, args, tables


def test_culled_march_with_staged_and_unstaged_pairs(dev):
    """Culled K1/K2 on a plan whose pairs exceed a block's shared memory:
    the first pairs are staged, the rest read from device memory, in one
    launch, against the plain version (the K1 bounds)."""
    from fraytracer_tpu_torch.ops.cuda import cull
    scene, args, tables = overbudget_inputs(dev)
    prog = mk.lower_program(scene, dev, tables.pairs)
    plan = mk.march_stage_plan(prog, tables)
    assert plan.staged == (True, True, True, True, False)
    assert 48 * 1024 < plan.bytes <= cull.SMEM_LIMIT
    kw = dict(max_steps=192, omega=1.4, cull=tables)
    tk, hk, _dk, sk = mk.march_kernel(scene, *args, **kw)
    tp, hp, _dp, sp = mk.march_plain(scene, *args, **kw)
    assert int(hk.sum()) > 100
    assert (hk == hp).float().mean().item() >= 0.999
    same = hk & hp & (sk == sp)
    assert int(same.sum()) >= 0.999 * int((hk & hp).sum())
    assert (tk - tp).abs()[same].max().item() <= 1e-4
    ho, _so = mk.march_kernel(scene, *args, **kw, occlusion=True)
    assert torch.equal(ho, hk)


def assert_surface_matches_plain(scene, o, d, t, e, hit, tables):
    """K3 against its plain version on the same inputs: codes and
    materials equal on every lane, normals within 1e-4 (miss lanes exact);
    one launch of the form's kernel."""
    ad = not mk.slot_surface_mode(scene.plan)
    name = ("surface_ad" if ad else "surface") \
        + ("" if tables is None else "_culled")
    ops_cuda.reset_launch_counts()
    nk, mk_, ck = mk.surface_kernel(scene, o, d, t, e, hit, cull=tables)
    assert {k: v for k, v in ops_cuda.launch_counts().items() if v} \
        == {name: 1}
    np_, mp, cp = mk.surface_plain(scene, o, d, t, e, hit, cull=tables)
    assert torch.equal(ck, cp) and (not ad or not ck.any())
    assert torch.equal(mk_, mp)
    assert (nk - np_).abs().max().item() <= 1e-4
    assert torch.equal(nk[~hit], np_[~hit])


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("name", ["torus96", "blend96"])
def test_surface_kernels_on_compacted_blocks(dev, name, cull):
    """K3, slot mode (the 96-torus scene) and AD mode (its blend), culled
    and dense, against the plain versions on K1's hits at 128², then on
    the same hits with one tile's lanes all misses (its blocks leave before
    they stage) and one block's lanes all hits (its misses placed 9 along
    the ray), and on a ragged batch of 16,384 - 700 lanes."""
    from fraytracer_tpu_torch.ops.cuda import cull as C
    scene = ft.flatten(torus_csg_scene(19, 96) if name == "torus96"
                       else smooth_scene(name), device=dev)
    args = block_lanes(scene, 128, dev)
    pairs = C._cull_pairs(scene.kind_counts, scene.plan, 48)
    tables = C.build_pair_tables(scene, *args[:2], args[4], args[2],
                                 args[3], pairs, 256, 0.125)
    t, hit, _d, _s = mk.march_kernel(scene, *args, max_steps=192, omega=1.4,
                                     cull=tables)
    tables = tables if cull else None
    o, d, _l, e, _t0 = args
    per_tile = hit.view(-1, 1024).sum(1)
    per_block = hit.view(-1, 128).sum(1)
    tile = int(torch.nonzero(per_tile > 0)[0])
    part = torch.nonzero((per_block > 0) & (per_block < 128)).flatten()
    blk = int(part[part // 8 != tile][0])
    assert bool((per_block == 0).any())
    h, t2 = hit.clone(), t.clone()
    h[tile * 1024:(tile + 1) * 1024] = False
    lanes = slice(blk * 128, (blk + 1) * 128)
    t2[lanes] = torch.where(hit[lanes], t[lanes], 9.0)
    h[lanes] = True
    assert int(hit.sum()) > 1000
    assert_surface_matches_plain(scene, o, d, t, e, hit, tables)
    assert_surface_matches_plain(scene, o, d, t2, e, h, tables)
    n = o.shape[0] - 700
    assert n % 1024 and n % 128
    assert_surface_matches_plain(scene, o[:n], d[:n], t2[:n], e[:n], h[:n],
                                 tables)


def test_surface_kernel_with_staged_and_unstaged_pairs(dev):
    """Culled K3 on the over-budget plan: its shared-memory plan stages
    the first four pairs and reads the fifth from device memory, in one
    launch; against the plain version."""
    scene, args, tables = overbudget_inputs(dev)
    prog = mk.lower_program(scene, dev, tables.pairs)
    assert mk.surface_stage_plan(prog, tables).staged \
        == (True, True, True, True, False)
    t, hit, _d, _s = mk.march_kernel(scene, *args, max_steps=192, omega=1.4,
                                     cull=tables)
    assert int(hit.sum()) > 100
    o, d, _l, e, _t0 = args
    assert_surface_matches_plain(scene, o, d, t, e, hit, tables)
    with pytest.raises(TypeError):
        mk.surface_kernel(scene, o, d, t, e, hit.int(), cull=tables)


@pytest.mark.parametrize("block_floats,n_blocks", [(100, 7), (1100, 7),
                                                   (1024, 4096)])
def test_block_gather_ragged_words_and_many_blocks(dev, block_floats,
                                                   n_blocks):
    """K4 exact where a block is not a whole number of 256-word thread
    blocks (25 and 275 sixteen-byte words) and at 4096 blocks, with
    repeats and out-of-range indices (zeros)."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(n_blocks, block_floats, generator=g).to(dev)
    idx = torch.randint(-2, n_blocks + 2, (n_blocks + 3,), generator=g,
                        dtype=torch.int32).to(dev)
    n0 = gather.LAUNCHES["block_gather"]
    out = gather._gather_blocks(x, idx)
    assert gather.LAUNCHES["block_gather"] == n0 + 1
    assert torch.equal(out, gather.block_gather_plain(x, idx))
    bad = (idx < 0) | (idx >= n_blocks)
    assert bool(bad.any()) and not bool(out[bad].any())


def test_block_gather_kernel_exact(dev):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(9, 8, 128, generator=g).to(dev)
    idx = torch.tensor([8, 8, 0, 3, -1, 9], dtype=torch.int32, device=dev)
    assert torch.equal(gather.block_gather(x, idx),
                       gather.block_gather_plain(x, idx))
    pay = torch.randint(0, 99, (4 * gather.BLOCK, 3), generator=g,
                        dtype=torch.int32).to(dev)
    i3 = torch.tensor([3, 1], dtype=torch.int32, device=dev)
    assert torch.equal(gather.flat_block_gather(pay, i3, 2),
                       pay.reshape(4, -1)[i3.long()].reshape(-1, 3))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    scene = ft.flatten(torus_csg_scene(19, 8), device=dev)
    o, d, ln, e, t0 = lanes(scene, 16, dev)
    with pytest.raises(TypeError):
        mk.march_kernel(scene, o.double(), d, ln, e, t0, max_steps=8,
                        omega=1.0)
    with pytest.raises(ValueError):
        mk.march_kernel(scene, o, d, ln[:-1], e, t0, max_steps=8, omega=1.0)
    with pytest.raises(ValueError):
        mk.march_kernel(scene, o, d, ln.cpu(), e, t0, max_steps=8, omega=1.0)
    with pytest.raises(TypeError):
        gather.block_gather(torch.zeros(2, 8, 128, dtype=torch.float16,
                                        device=dev),
                            torch.zeros(1, dtype=torch.int32, device=dev))


def test_culled_overflow_rerun_on_the_card(dev):
    """cull_m=8 overflows every tile: the march is launched again with
    full-group tables (two culled launches) and equals asking for them."""
    import dataclasses
    from fraytracer_tpu_torch.ops.march import MarchConfig, march
    scene = ft.flatten(torus_csg_scene(19, 96), device=dev)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), device=dev)
    rays = ft.camera_rays(cam, 64, 64, 0.01, 30.0)
    cfg = MarchConfig(backend="cuda", max_steps=192, relax_omega=1.4)
    ops_cuda.reset_launch_counts()
    small = march(scene, rays, dataclasses.replace(cfg, cull_m=8))
    assert ops_cuda.launch_counts()["march_culled"] == 2
    full = march(scene, rays, dataclasses.replace(cfg, cull_m=96))
    for f in ("hit", "t", "distance", "steps"):
        assert torch.equal(getattr(small, f), getattr(full, f)), f


# ---------------------------------------------------------------------------
# the gradient path and the probes
# ---------------------------------------------------------------------------

def test_backward_on_card_matches_cpu(dev):
    """``implicit_vjp`` fed the kernels' own t, hit and leaf code, on the
    card and on the CPU."""
    from fraytracer_tpu_torch.ops import march as M
    from fraytracer_tpu_torch.render import _to_blocks
    scene = ft.flatten(torus_csg_scene(19, 96), device=dev)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), device=dev)
    rays = ft.camera_rays(cam, 128, 128, 0.01, 30.0).map(
        lambda x: _to_blocks(x, 128, 128, 32).contiguous())
    cfg = ft.MarchConfig(max_steps=192, relax_omega=1.4)
    raw, _n, _m, code = mk.cuda_march_raw(scene, rays, cfg,
                                          want_surface=True)
    g = torch.Generator().manual_seed(3)
    ct_t = torch.randn(128 * 128, generator=g)
    ct_n = torch.randn(128 * 128, 3, generator=g)
    out = {}
    for d in (dev, torch.device("cpu")):
        sc, ry = scene.to(d), rays.map(lambda x: x.to(d))
        out[d.type] = M.implicit_vjp(
            sc, ry, raw.t.to(d), raw.hit.to(d),
            M._leaf_scene_d(sc, code.to(d)), cfg, ct_t.to(d), ct_n.to(d))
    for a, b in zip(out["cuda"][0].values(), out["cpu"][0].values()):
        assert float(b.abs().max()) > 0
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * float(b.abs().max())
    for a, b in zip(out["cuda"][1:], out["cpu"][1:]):
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_frame_gradient_kernels_match_plain_route(dev):
    """``grad`` of ``sum(render²)`` at 128² / 96 tori through the culled
    kernels and through their plain versions on the same CUDA tensors."""
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    cfg = ft.RenderConfig(width=128, height=128, march=ft.MarchConfig(
        max_steps=192, relax_omega=1.4))

    def run(plain, mask=None):
        scene = ft.flatten(torus_csg_scene(19, 96),
                           device=dev).requires_grad_(True)
        saved = (mk.march_kernel, mk.surface_kernel)
        if plain:
            mk.march_kernel, mk.surface_kernel = mk.march_plain, \
                mk.surface_plain
        try:
            ops_cuda.reset_launch_counts()
            img = ft.render(scene, cam, cfg)
            if mask is not None:
                (img * mask[..., None]).pow(2).sum().backward()
            counts = ops_cuda.launch_counts()
        finally:
            mk.march_kernel, mk.surface_kernel = saved
        return img.detach(), scene, counts

    ik, _s, counts = run(False)
    ip, _s, _c = run(True)
    same = (ik - ip).abs().amax(-1) < 1e-4
    assert same.float().mean().item() >= 0.995
    _i, sk, counts = run(False, same)
    _i, sp, _c = run(True, same)
    assert {k: v for k, v in counts.items() if v} == {
        "march_culled": 1, "surface_culled": 1, "occlusion_culled": 2}
    for (name, a), b in zip(sk.tensors().items(), sp.tensors().values()):
        if b.grad is None or float(b.grad.norm()) == 0:
            continue
        assert torch.isfinite(a.grad).all(), name
        err = float((a.grad - b.grad).norm() / b.grad.norm())
        assert err <= 1e-3, (name, err)


def test_spectral_frame_kernels_match_plain_route(dev):
    """The spectral wavefront at 64² × 8 bins, depth 3, on
    ``spectral_csg_scene(19, 1000)`` (bounce tables of m 1000, inside-glass
    lanes): through the kernels and through their plain versions (K4
    included) on the same CUDA tensors — max |Δ| < 1e-4 (the kernels and
    their plain versions differ by ulps; the order of ``index_add_``'s
    atomic sums varies), rays marched within 0.5%; the kernel route
    launches each culled kernel a round and K4 for the block-tier
    compaction."""
    from fraytracer_tpu_torch.scene.generators import spectral_csg_scene
    scene = ft.flatten(spectral_csg_scene(19, 1000), device=dev)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    cfg = ft.WavefrontConfig(depth=3, march=ft.MarchConfig(relax_omega=1.4))

    def run(plain):
        saved = (mk.march_kernel, mk.surface_kernel, gather._gather_blocks)
        if plain:
            mk.march_kernel, mk.surface_kernel = mk.march_plain, \
                mk.surface_plain
            gather._gather_blocks = gather.block_gather_plain
        try:
            ops_cuda.reset_launch_counts()
            img, n = ft.render_spectral_with_stats(scene, cam, 64, 64, cfg)
            torch.cuda.synchronize()
            return img, int(n), ops_cuda.launch_counts()
        finally:
            mk.march_kernel, mk.surface_kernel, gather._gather_blocks = saved

    ik, nk, counts = run(False)
    ip, np_, plain_counts = run(True)
    assert torch.isfinite(ik).all() and ik.shape == (64, 64, 3)
    d = (ik - ip).abs()
    assert d.max().item() < 1e-4
    assert abs(nk - np_) <= 5e-3 * np_
    assert not any(plain_counts.values())
    assert counts["march_culled"] >= 3 and counts["surface_culled"] >= 3
    assert counts["occlusion_culled"] >= 6
    assert counts["block_gather"] >= 16        # 8 fields × 2 compactions
    assert counts["march"] == counts["surface"] == counts["occlusion"] == 0


def test_probe_kernels_match_plain(dev):
    from fraytracer_tpu_torch.ops.cuda import probe
    inp = probe.probe_inputs(dev)
    ops_cuda.reset_launch_counts()
    for name, (kernel, plain, ok) in probe.features(inp).items():
        assert ok(kernel(), plain()), name
    x = torch.randn(8, 128, device=dev)
    assert torch.equal(probe.warm(x), probe.warm_plain(x))
    probe.empty_launch(dev)
    torch.cuda.synchronize()
    counts = ops_cuda.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "warm": 1, "smem_block": 1, "smem_block_2d": 1, "dyn_loop": 2,
        "while_loop": 2, "empty": 1}
    with pytest.raises(ValueError):
        probe.warm(x.double())
    with pytest.raises(ValueError):
        probe.dyn_loop(inp["x3"], inp["cand3"].cpu(), inp["keys3"])
