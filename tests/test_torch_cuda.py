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
1e-5.  The kernels' 64² frame of the benchmark scene against the port's
float64 oracle: tests/test_benchmark_oracle.py's bounds, through
``chip_smoke.oracle_gate`` (a facing flip the frame did not march is not
graded, as JAX's gate spares one the oracle did not).  The graph frame
(``render.py``): bit for bit ``render_grid``'s frame, after a parameter
edit too, a flagged replay run again eagerly, a key whose first frame
flags kept eager, two keys' graphs in one pool, and a capture that fails
raises.  The graph step (``render_value_and_grad``): its loss bit for bit
the eager step's and its gradients within 2e-4 of each leaf's largest |g|
(the backward's atomic adds sum in another order), after an edit too, a
flagged replay run again eagerly, a failing certificate kept eager, a
capture that fails raises, one pool with the frame graphs, the checkpoint
sites captured.  The graph spectral frame (``render_spectral_with_stats``):
within 1e-5 of the eager frame (``index_add_``'s atomic order) with
``n_rays`` equal, one capture with its overflowing sites promoted and no
eager re-run, after an edit too; K1/K2/K3 on unfilled tables of m 512
bit for bit the full group's; a capture that fails raises; one pool with
the frame graphs.  The sharded graph frame (``parallel/mesh.py``) on one
NCCL rank: the replay ``render_grid``'s frame bit for bit, 0 syncs in a
replay."""
import dataclasses

import pytest
import torch

import fraytracer_tpu_torch as ft
from fraytracer_tpu_torch.camera import to_blocks
from fraytracer_tpu_torch.ops import cuda as ops_cuda, graph as tgraph
from fraytracer_tpu_torch.ops import wavefront as tw
from fraytracer_tpu_torch.ops.cuda import cull, gather, march_kernel as mk
from fraytracer_tpu_torch.ops.march import bound_skip_start
from fraytracer_tpu_torch.scene.generators import csg_demo_scene, \
    torus_csg_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def with_tables(counts):
    """``counts`` of culled K1/K2 launches with their sites' table builds:
    one cones and one select launch a culled march or occlusion launch."""
    sites = counts.get("march_culled", 0) + counts.get("occlusion_culled", 0)
    if not sites:
        return dict(counts)
    return {**counts, "cull_cones": sites, "cull_select": sites}


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
        lambda x: to_blocks(x, size, size, 32).contiguous())
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
    scene = ft.flatten(smooth_scene(name), device=dev)
    assert not mk.slot_surface_mode(scene.plan)
    size = 128
    cam = ft.look_at((0, 0, -7), (0, 0, 0), device=dev)
    rays = ft.camera_rays(cam, size, size, 0.01, 30.0).map(
        lambda x: to_blocks(x, size, size, 32).contiguous())
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


def test_dense_parts_march_one_wide_block_an_sm(dev):
    """Dense K1/K2 on 1,000 machined parts (``benchmark/parts.py``, the
    ``parts1000`` configuration): the 176,144-byte stage fits one block an
    SM, so the block is 768 threads wide (``cull.dense_march_threads``),
    as ``dense_counts()`` reads back; 512² rays, more than 132 × 768
    resident lanes, so lanes refill.  Against the plain version on every
    16th ray with the bounds of the refill test above; a slice launched
    alone equals the batch bit for bit; the warps' issue count covers the
    lane-steps.  The 1,000-torus program keeps 128 threads × 6 blocks.
    The shared memory the width rule assumes is the card's."""
    import json
    from pathlib import Path
    from benchmark import parts
    spec = json.loads((Path(__file__).resolve().parents[1] / "benchmark"
                       / "configs" / "parts1000.json").read_text())
    scene = parts.port_scene(parts.draw(spec, 2 ** 31 + 11), dev)
    props = torch.cuda.get_device_properties(dev)
    assert props.shared_memory_per_multiprocessor == cull.SMEM_PER_SM
    assert props.shared_memory_per_block_optin == cull.SMEM_LIMIT \
        == cull.SMEM_PER_SM - cull.SMEM_BLOCK_RESERVED
    args = block_lanes(scene, 512, dev)
    assert args[0].shape[0] > props.multi_processor_count \
        * cull.DENSE_THREADS
    kw = dict(max_steps=192, omega=1.4)
    issued = torch.zeros(1, dtype=torch.int64, device=dev)
    ops_cuda.reset_launch_counts()
    tk, hk, dk, sk = mk.march_kernel(scene, *args, **kw, issued=issued)
    counts = ops_cuda.dense_counts()
    assert (counts["march_threads"], counts["march_blocks_per_sm"]) \
        == (cull.DENSE_THREADS, 1)
    evals = int(sk.sum())
    assert counts["lane_steps"] == evals
    assert 0 < evals <= 32 * int(issued)
    every = slice(None, None, 16)
    tp, hp, _dp, sp = mk.march_plain(
        scene, *[a[every].contiguous() for a in args], **kw)
    hs, ss, ts = hk[every], sk[every], tk[every]
    assert int(hs.sum()) > 1000
    assert (hs == hp).float().mean().item() >= 0.999
    same = hs & hp & (ss == sp)
    assert int(same.sum()) >= 0.999 * int((hs & hp).sum())
    assert (ts - tp).abs()[same].max().item() <= 1e-4
    part = slice(100_003, 105_003)
    alone = mk.march_kernel(scene, *[a[part].contiguous() for a in args],
                            **kw)
    for got, want in zip(alone, (tk, hk, dk, sk)):
        assert torch.equal(got, want[part])
    ho, so = mk.march_kernel(scene, *args, **kw, occlusion=True)
    assert torch.equal(ho, hk) and torch.equal(so, sk)
    tori = ft.flatten(torus_csg_scene(19, 1000), device=dev)
    mk.march_kernel(tori, *block_lanes(tori, 64, dev), **kw)
    counts = ops_cuda.dense_counts()
    assert (counts["march_threads"], counts["march_blocks_per_sm"]) \
        == (cull.BLOCK, 6)


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
    cam = ft.look_at((0, 0, z), (0, 0, 0), device=dev)
    rays = ft.camera_rays(cam, size, size, 0.01, 30.0).map(
        lambda x: to_blocks(x, size, size, 32).contiguous())
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
# the graph frame (render.py): one captured CUDA graph a key
# ---------------------------------------------------------------------------

def _graph_setup(dev, size=128, **march):
    import sys
    scene = ft.flatten(torus_csg_scene(19, 96), device=dev)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), device=dev)
    cfg = ft.RenderConfig(width=size, height=size, march=ft.MarchConfig(
        max_steps=192, relax_omega=1.4, **march))
    render_mod = sys.modules["fraytracer_tpu_torch.render"]
    tgraph._graphs.clear()
    ops_cuda.reset_launch_counts()
    return scene, cam, cfg, render_mod


def _eager(scene, cam, cfg):
    rays = ft.camera_rays(cam, cfg.width, cfg.height, cfg.epsilon,
                          cfg.length)
    return ft.render_grid(scene, rays, cfg)


@pytest.mark.parametrize("cull", [True, False])
def test_graph_frame_is_the_eager_frame(dev, cull):
    """The first call captures, the second replays; both are
    ``render_grid``'s frame bit for bit, with one frame's launches each."""
    scene, cam, cfg, R = _graph_setup(dev, cull=cull)
    want, wn = _eager(scene, cam, cfg)
    ops_cuda.reset_launch_counts()
    for call in range(2):
        img, n = ft.render_with_stats(scene, cam, cfg)
        assert torch.equal(img, want) and int(n) == int(wn)
    counts = {k: v for k, v in ops_cuda.launch_counts().items() if v}
    sfx = "_culled" if cull else ""
    assert counts == with_tables({"march" + sfx: 2, "surface" + sfx: 2,
                                  "occlusion" + sfx: 4})
    assert ops_cuda.graph_counts() == {"captures": 1, "replays": 1,
                                       "eager_reruns": 0, "eager_frames": 0}
    # the outputs are the caller's: a later replay leaves them alone
    ft.render_with_stats(scene, cam, cfg)
    assert torch.equal(img, want)


def test_graph_frame_after_a_parameter_edit(dev):
    """A parameter edited in place, or a new scene object of the same
    structure, between two replays: the replay is the eager frame of the
    scene it was given."""
    scene, cam, cfg, R = _graph_setup(dev)
    ft.render_with_stats(scene, cam, cfg)
    with torch.no_grad():
        scene.prim_params["torus"][:, 0:3] += 0.05
        scene.light_color.mul_(0.5)
    img, _n = ft.render_with_stats(scene, cam, cfg)
    assert torch.equal(img, _eager(scene, cam, cfg)[0])
    other = scene.with_tensors({k: v * 1.01
                                for k, v in scene.tensors().items()})
    img, _n = ft.render_with_stats(other, cam, cfg)
    assert torch.equal(img, _eager(other, cam, cfg)[0])
    assert len(tgraph._graphs) == 1
    assert ops_cuda.graph_counts()["captures"] == 1


def test_graph_capture_failure_raises(dev, monkeypatch):
    """A host read inside the frame cannot be captured: the call raises,
    keeps no graph, and does not fall back to the eager frame."""
    from fraytracer_tpu_torch.ops import shade
    scene, cam, cfg, R = _graph_setup(dev)
    real = shade.resolve_material

    def reads_the_host(scene_, pos, hit, midx, backend="cuda"):
        int(hit.sum())
        return real(scene_, pos, hit, midx, backend=backend)
    monkeypatch.setattr(shade, "resolve_material", reads_the_host)
    ops_cuda.reset_launch_counts()
    with pytest.raises(RuntimeError):
        ft.render_with_stats(scene, cam, cfg)
    assert not tgraph._graphs
    assert ops_cuda.graph_counts() == {"captures": 0, "replays": 0,
                                       "eager_reruns": 0, "eager_frames": 0}
    monkeypatch.setattr(shade, "resolve_material", real)
    # the next capture takes a new pool and replays
    for _ in range(2):
        img, _n = ft.render_with_stats(scene, cam, cfg)
        assert torch.equal(img, _eager(scene, cam, cfg)[0])
    assert ops_cuda.graph_counts()["replays"] == 1


def test_graph_frame_overflow_reruns_eagerly(dev):
    """cull_m 8 overflows: the key's first frame raises the flag, promotes
    the overflowed sites to full-group tables, runs once more and is
    captured with them; that call and the replays are the eager frame bit
    for bit (its overflowing calls re-run on full-group tables), and
    nothing runs eagerly."""
    scene, cam, cfg, R = _graph_setup(dev, cull_m=8, cull_m_shadow=8)
    want, wn = _eager(scene, cam, cfg)
    for _ in range(3):
        img, n = ft.render_with_stats(scene, cam, cfg)
        assert torch.equal(img, want) and int(n) == int(wn)
    fg = R.frame_graph(scene, cam, cfg)
    assert fg.graph is not None and fg.frame.promoted
    assert ops_cuda.graph_counts() == {"captures": 1, "replays": 2,
                                       "eager_reruns": 0, "eager_frames": 0}


def test_graph_frame_flagged_replay_reruns_eagerly(dev):
    """A captured key (cull_m 64: no table overflows) whose replay
    overflows after the tori's centres are pulled together in place: the
    eager frame runs again, equal to the edited scene's, and counted;
    undone, the replay is the first frame."""
    scene, cam, cfg, R = _graph_setup(dev, cull_m=64, cull_m_shadow=64)
    first = ft.render_with_stats(scene, cam, cfg)[0]
    assert R.frame_graph(scene, cam, cfg).graph is not None
    tori = scene.prim_params["torus"]
    old = tori.clone()
    with torch.no_grad():
        tori[:, 0:3] *= 0.05
    img, n = ft.render_with_stats(scene, cam, cfg)
    want, wn = _eager(scene, cam, cfg)
    assert torch.equal(img, want) and int(n) == int(wn)
    assert ops_cuda.graph_counts() == {"captures": 1, "replays": 1,
                                       "eager_reruns": 1, "eager_frames": 0}
    with torch.no_grad():
        tori.copy_(old)
    assert torch.equal(ft.render_with_stats(scene, cam, cfg)[0], first)


def test_graph_frames_of_two_keys_share_one_pool(dev):
    """Two keys' graphs in one memory pool, replayed in turns: each replay
    is its key's eager frame bit for bit."""
    scene, cam, cfg, R = _graph_setup(dev)
    dense = dataclasses.replace(cfg, march=dataclasses.replace(
        cfg.march, cull=False))
    want = {c: _eager(scene, cam, c) for c in (cfg, dense)}
    for c in (cfg, dense, cfg, dense, cfg):
        img, n = ft.render_with_stats(scene, cam, c)
        assert torch.equal(img, want[c][0]) and int(n) == int(want[c][1])
    assert ops_cuda.graph_counts()["captures"] == 2
    pools = {R.frame_graph(scene, cam, c).graph.pool() for c in want}
    assert len(pools) == 1


# ---------------------------------------------------------------------------
# the graph step (render.py::render_value_and_grad)
# ---------------------------------------------------------------------------

# two steps of one key sum the backward's row scatters in another order
# (their atomic adds): the gradients are held within 2e-4 of each leaf's largest
# |g|, as the sharded step is (chip_smoke.py GRAD_REL); the loss is exact
STEP_GRAD_REL = 2e-4


def _sum_sq(img):
    return (img ** 2).sum()


def _eager_step(scene, cam, cfg, loss_fn=_sum_sq, *args):
    import functools
    import sys
    out = tgraph.eager(functools.partial(
        sys.modules["fraytracer_tpu_torch.render"]._step, loss_fn), scene,
        cam, cfg, args, grad=True)
    return out[0], dict(zip(scene.tensors(), out[1:]))


def _assert_step_close(got, want):
    assert torch.equal(got[0], want[0])
    assert got[1].keys() == want[1].keys()
    for k, w in want[1].items():
        scale = float(w.abs().max())
        assert float((got[1][k] - w).abs().max()) <= STEP_GRAD_REL * scale, k
    assert float(want[1]["prim_params/torus"].abs().sum()) > 0


def _chip_smoke():
    """``chip_smoke.py`` loaded by path (it imports only torch at module
    level)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_by_path", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _blend96(dev):
    from fraytracer_tpu_torch.scene import nodes as N
    base = torus_csg_scene(19, 96)
    return ft.flatten(N.Scene(root=N.smooth_union(
        0.25, base.root, N.sphere((0, 0, 0), 1.5,
                                  material=N.solid(0.8, 0.7, 0.3))),
        background=base.background, lights=base.lights), device=dev)


@pytest.mark.parametrize("cull", [True, False])
def test_graph_step_is_the_eager_step(dev, cull):
    """The first call captures the step, the second replays it: each the
    eager step (loss bit for bit), with one frame's launches and six row
    scatters each (the sphere and torus rows twice, albedo, emission)."""
    scene, cam, cfg, R = _graph_setup(dev, cull=cull)
    want = _eager_step(scene, cam, cfg)
    ops_cuda.reset_launch_counts()
    for _ in range(2):
        _assert_step_close(ft.render_value_and_grad(_sum_sq, scene, cam,
                                                    cfg), want)
    counts = {k: v for k, v in ops_cuda.launch_counts().items() if v}
    sfx = "_culled" if cull else ""
    assert counts == with_tables({"march" + sfx: 2, "surface" + sfx: 2,
                                  "occlusion" + sfx: 4,
                                  "rows_scatter_smem": 12})
    assert ops_cuda.graph_counts() == {"captures": 1, "replays": 1,
                                       "eager_reruns": 0, "eager_frames": 0}
    assert R.step_graph(_sum_sq, scene, cam, cfg).graph is not None
    # the scene's tensors gain no .grad
    assert all(x.grad is None for x in scene.tensors().values())


def test_graph_step_after_a_parameter_edit(dev):
    """A parameter edited in place, and a target changed, between two
    replays: the replay is the eager step of what it was given."""
    scene, cam, cfg, R = _graph_setup(dev)

    def mse(img, target):
        return torch.mean((img - target) ** 2)
    target = torch.full((cfg.height, cfg.width, 3), 0.25, device=dev)
    ft.render_value_and_grad(mse, scene, cam, cfg, target)
    with torch.no_grad():
        scene.prim_params["torus"][:, 0:3] += 0.05
        scene.light_color.mul_(0.5)
    target = target * 0.5
    _assert_step_close(ft.render_value_and_grad(mse, scene, cam, cfg,
                                                target),
                       _eager_step(scene, cam, cfg, mse, target))
    assert ops_cuda.graph_counts()["replays"] == 1


def test_graph_step_flagged_replay_reruns_eagerly(dev):
    """A captured step (cull_m 64) whose replay overflows after the tori's
    centres are pulled together in place: the eager step runs again, equal
    to the edited scene's eager step, and counted."""
    scene, cam, cfg, R = _graph_setup(dev, cull_m=64, cull_m_shadow=64)
    first = ft.render_value_and_grad(_sum_sq, scene, cam, cfg)
    assert R.step_graph(_sum_sq, scene, cam, cfg).graph is not None
    tori = scene.prim_params["torus"]
    old = tori.clone()
    with torch.no_grad():
        tori[:, 0:3] *= 0.05
    _assert_step_close(ft.render_value_and_grad(_sum_sq, scene, cam, cfg),
                       _eager_step(scene, cam, cfg))
    assert ops_cuda.graph_counts() == {"captures": 1, "replays": 1,
                                       "eager_reruns": 1, "eager_frames": 0}
    with torch.no_grad():
        tori.copy_(old)
    assert torch.equal(ft.render_value_and_grad(_sum_sq, scene, cam, cfg)[0],
                       first[0])


def test_graph_step_failing_certificate_is_kept_eager(dev):
    """The blended 96-torus step (the ``blend1000`` kind): its backward's
    certificate fails on the overlapping tori, so the deferred first run
    raises the flag; nothing is captured and the key's steps run the eager
    step (the dense branch), counted."""
    from fraytracer_tpu_torch.ops import point_eval
    _s, cam, cfg, R = _graph_setup(dev)
    scene = _blend96(dev)
    want = _eager_step(scene, cam, cfg)
    stats = dict(point_eval.STATS)
    for _ in range(2):
        _assert_step_close(ft.render_value_and_grad(_sum_sq, scene, cam,
                                                    cfg), want)
    assert R.step_graph(_sum_sq, scene, cam, cfg).graph is None
    assert ops_cuda.graph_counts() == {"captures": 0, "replays": 0,
                                       "eager_reruns": 1, "eager_frames": 1}
    # the two eager steps read the certificate, the deferred run did not
    assert {k: point_eval.STATS[k] - stats[k] for k in stats} == {
        "certificate_reads": 2, "culled": 0, "dense": 2}


def test_graph_step_capture_failure_raises(dev, monkeypatch):
    """A host read inside the backward cannot be captured: the call
    raises, keeps no graph, and does not fall back to the eager step."""
    from fraytracer_tpu_torch.ops import march as M
    scene, cam, cfg, R = _graph_setup(dev)
    real = M.implicit_vjp

    def reads_the_host(scene_, rays, t, hit, *a, **k):
        int(hit.sum())
        return real(scene_, rays, t, hit, *a, **k)
    monkeypatch.setattr(M, "implicit_vjp", reads_the_host)
    with pytest.raises(RuntimeError):
        ft.render_value_and_grad(_sum_sq, scene, cam, cfg)
    assert not tgraph._graphs
    assert ops_cuda.graph_counts() == {"captures": 0, "replays": 0,
                                       "eager_reruns": 0, "eager_frames": 0}
    monkeypatch.setattr(M, "implicit_vjp", real)
    for _ in range(2):
        _assert_step_close(ft.render_value_and_grad(_sum_sq, scene, cam,
                                                    cfg),
                           _eager_step(scene, cam, cfg))
    assert ops_cuda.graph_counts()["replays"] == 1


def test_graph_step_shares_the_frame_graphs_pool(dev):
    """A frame graph and a step graph of one scene in one memory pool,
    replayed in turns: each its eager counterpart."""
    scene, cam, cfg, R = _graph_setup(dev)
    frame = _eager(scene, cam, cfg)
    step = _eager_step(scene, cam, cfg)
    for _ in range(3):
        img, n = ft.render_with_stats(scene, cam, cfg)
        assert torch.equal(img, frame[0]) and int(n) == int(frame[1])
        _assert_step_close(ft.render_value_and_grad(_sum_sq, scene, cam,
                                                    cfg), step)
    assert ops_cuda.graph_counts()["captures"] == 2
    assert R.frame_graph(scene, cam, cfg).graph.pool() == \
        R.step_graph(_sum_sq, scene, cam, cfg).graph.pool()


@pytest.mark.parametrize("site", ["point_eval", "render"])
def test_graph_step_captures_checkpointed_chunks(dev, monkeypatch, site):
    """The ``torch.utils.checkpoint`` sites a step reaches, captured with
    their default ``preserve_rng_state``: ``point_eval``'s chunked normals
    (the non-fused culled step on the separated lattice, 256²) and
    ``render._trace``'s ray tiles (``tile_rays_pallas``)."""
    from fraytracer_tpu_torch.ops import point_eval
    _s, _c, cfg, R = _graph_setup(dev, size=256)
    mod = point_eval if site == "point_eval" else R
    real, calls = mod.checkpoint, []

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(mod, "checkpoint", counted)
    if site == "point_eval":
        scene = _chip_smoke().lattice_scene(dev)
        cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=20.0,
                         device=dev)
        cfg = dataclasses.replace(cfg, march=dataclasses.replace(
            cfg.march, fuse_surface=False))
    else:
        scene = ft.flatten(torus_csg_scene(19, 96), device=dev)
        cam = ft.look_at((0, 0, -10), (0, 0, 0), device=dev)
        cfg = dataclasses.replace(cfg, tile_rays_pallas=16384)
    want = _eager_step(scene, cam, cfg)
    calls.clear()
    for _ in range(2):
        _assert_step_close(ft.render_value_and_grad(_sum_sq, scene, cam,
                                                    cfg), want)
    assert calls, "no checkpoint in the step"
    assert ops_cuda.graph_counts()["replays"] == 1


# ---------------------------------------------------------------------------
# the gradient path and the probes
# ---------------------------------------------------------------------------

def test_backward_on_card_matches_cpu(dev):
    """``implicit_vjp`` fed the kernels' own t, hit and leaf code, on the
    card and on the CPU."""
    from fraytracer_tpu_torch.ops import march as M
    scene = ft.flatten(torus_csg_scene(19, 96), device=dev)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), device=dev)
    rays = ft.camera_rays(cam, 128, 128, 0.01, 30.0).map(
        lambda x: to_blocks(x, 128, 128, 32).contiguous())
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
        saved = (mk.march_kernel, mk.surface_kernel, mk.build_pair_tables)
        if plain:
            mk.march_kernel, mk.surface_kernel = mk.march_plain, \
                mk.surface_plain
            mk.build_pair_tables = cull.build_pair_tables_plain
        try:
            ops_cuda.reset_launch_counts()
            img = ft.render(scene, cam, cfg)
            if mask is not None:
                (img * mask[..., None]).pow(2).sum().backward()
            counts = ops_cuda.launch_counts()
        finally:
            mk.march_kernel, mk.surface_kernel, mk.build_pair_tables = saved
        return img.detach(), scene, counts

    ik, _s, counts = run(False)
    ip, _s, _c = run(True)
    same = (ik - ip).abs().amax(-1) < 1e-4
    assert same.float().mean().item() >= 0.995
    _i, sk, counts = run(False, same)
    _i, sp, _c = run(True, same)
    assert {k: v for k, v in counts.items() if v} == with_tables({
        "march_culled": 1, "surface_culled": 1, "occlusion_culled": 2,
        "rows_scatter_smem": 6})
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
    compaction.  Both run the eager frame (``_spectral_frame``): the graph
    frame's second call would replay the first call's kernels."""
    from fraytracer_tpu_torch.ops.wavefront import _spectral_frame
    from fraytracer_tpu_torch.scene.generators import spectral_csg_scene
    scene = ft.flatten(spectral_csg_scene(19, 1000), device=dev)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    cfg = ft.WavefrontConfig(depth=3, march=ft.MarchConfig(relax_omega=1.4))

    def run(plain):
        saved = (mk.march_kernel, mk.surface_kernel, gather._gather_blocks,
                 mk.build_pair_tables)
        if plain:
            mk.march_kernel, mk.surface_kernel = mk.march_plain, \
                mk.surface_plain
            mk.build_pair_tables = cull.build_pair_tables_plain
            gather._gather_blocks = gather.block_gather_plain
        try:
            ops_cuda.reset_launch_counts()
            img, n = _spectral_frame(scene, cam, 64, 64, cfg)
            torch.cuda.synchronize()
            return img, int(n), ops_cuda.launch_counts()
        finally:
            (mk.march_kernel, mk.surface_kernel, gather._gather_blocks,
             mk.build_pair_tables) = saved

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
    # a table build at every culled site, re-runs included
    assert counts["cull_cones"] == counts["cull_select"] == \
        counts["march_culled"] + counts["occlusion_culled"]
    assert counts["march"] == counts["surface"] == counts["occlusion"] == 0


# ---------------------------------------------------------------------------
# the graph spectral frame (ops/wavefront.py::render_spectral_with_stats)
# ---------------------------------------------------------------------------

# the graph spectral frame against the eager frame: each sums the image
# with index_add_, whose atomic adds land in another order run to run
SPECTRAL_GRAPH_MAX = 1e-5
SPECTRAL_REPLAY = with_tables({"march_culled": 4, "surface_culled": 4,
                               "occlusion_culled": 8, "block_gather": 24})


def _spectral_setup(dev, size=128):
    """``spectral_csg_scene(19, 1000)`` at ``size``², 8 bins, depth 4, the
    bench's march configuration; no graph kept, counts at 0."""
    import sys
    from fraytracer_tpu_torch.ops.wavefront import _spectral_frame
    from fraytracer_tpu_torch.scene.generators import spectral_csg_scene
    scene = ft.flatten(spectral_csg_scene(19, 1000), device=dev)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    cfg = ft.WavefrontConfig(depth=4, epsilon=0.01, length=30.0,
                             march=ft.MarchConfig(max_steps=192,
                                                  bound_skip=True,
                                                  relax_omega=1.4))
    R = sys.modules["fraytracer_tpu_torch.render"]
    tgraph._graphs.clear()
    ops_cuda.reset_launch_counts()
    return (scene, cam, cfg, R,
            lambda s=scene: _spectral_frame(s, cam, size, size, cfg),
            lambda s=scene: ft.render_spectral_with_stats(s, cam, size,
                                                          size, cfg))


def _assert_spectral_close(got, want):
    assert float((got[0] - want[0]).abs().max()) <= SPECTRAL_GRAPH_MAX
    assert int(got[1]) == int(want[1])


def test_graph_spectral_frame_is_the_eager_frame(dev):
    """The key's first call promotes the sites whose tables overflowed
    (round 0's shadow marches at least) and captures; later calls replay
    with no eager re-run, each within 1e-5 of the eager frame with
    ``n_rays`` equal, launching 4 / 4 / 8 / 24 a replay (a promoted site
    runs once, on full-group tables)."""
    scene, cam, cfg, R, eager, graph = _spectral_setup(dev)
    want = eager()
    ops_cuda.reset_launch_counts()
    _assert_spectral_close(graph(), want)
    assert ops_cuda.graph_counts() == {"captures": 1, "replays": 0,
                                       "eager_reruns": 0, "eager_frames": 0}
    sg = tw.spectral_graph(scene, cam, 128, 128, cfg)
    assert sg.graph is not None and sg.frame.promoted
    assert max(sg.frame.promoted) < 1 + scene.num_lights
    assert {k: v for k, v in sg.launches.items() if v} == SPECTRAL_REPLAY
    ops_cuda.reset_launch_counts()
    for _ in range(2):
        _assert_spectral_close(graph(), want)
    assert {k: v for k, v in ops_cuda.launch_counts().items() if v} == {
        k: 2 * v for k, v in SPECTRAL_REPLAY.items()}
    assert ops_cuda.graph_counts() == {"captures": 0, "replays": 2,
                                       "eager_reruns": 0, "eager_frames": 0}


def test_graph_spectral_frame_after_a_parameter_edit(dev):
    """Every torus moved in place, and a new scene object of the same
    structure, between two replays: each call is its scene's eager frame
    within the bound, whether or not its flag was raised."""
    scene, cam, cfg, R, eager, graph = _spectral_setup(dev)
    graph()
    with torch.no_grad():
        scene.prim_params["torus"][:, 0:3] += 0.05
        scene.light_color.mul_(0.5)
    _assert_spectral_close(graph(), eager())
    other = scene.with_tensors({k: v * 1.01
                                for k, v in scene.tensors().items()})
    _assert_spectral_close(graph(other), eager(other))
    assert len(tgraph._graphs) == 1
    assert ops_cuda.graph_counts()["captures"] == 1


def test_spectral_promotion_is_exact_on_the_kernels(dev):
    """The condition that makes a promoted site exact: K1, K3 and K2 of
    both lights (the point light with its converging cone) on tables of m
    512 that no tile fills give the outputs of the full group's tables (m
    1000), bit for bit, each launch with its own shared-memory plan
    (1024² primary lanes of ``spectral_csg_scene(19, 1000)``)."""
    from fraytracer_tpu_torch.ops.march import MarchConfig
    from fraytracer_tpu_torch.ops.shade import light_dir_and_dist
    from fraytracer_tpu_torch.scene.generators import spectral_csg_scene
    from fraytracer_tpu_torch.types import Rays
    scene = ft.flatten(spectral_csg_scene(19, 1000), device=dev)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    flat = ft.camera_rays(cam, 1024, 1024, 0.01, 30.0).map(
        lambda x: to_blocks(x, 1024, 1024, 32))
    own, full = (MarchConfig(max_steps=192, bound_skip=True,
                             relax_omega=1.4, cull_m=m, cull_m_shadow=m)
                 for m in (512, 1000))
    res, nrm, midx, code = mk.cuda_march_raw(scene, flat, full,
                                             want_surface=True)
    cases = [(flat, {}, "march")]
    pos = flat.at(res.t - flat.epsilon)
    for i in range(scene.num_lights):
        ldir, budget, _s = light_dir_and_dist(scene, i, pos)
        facing = res.hit & ((nrm * ldir).sum(-1) > 0.0)
        apex = scene.light_vec[i] if scene.light_kind[i] == 1 else None
        cases.append((Rays(origin=pos, direction=ldir,
                           length=torch.where(facing, budget, 0.0),
                           epsilon=flat.epsilon),
                      dict(occlusion=True, cone_apex=apex), f"light {i}"))
    for rays, kw, label in cases:
        tabs = [mk.march_tables(scene, rays, c, kw.get("cone_apex"))[3]
                for c in (own, full)]
        assert [[q.m for q in t.tables] for t in tabs] == [[512], [1000]]
        assert not bool(tabs[0].overflow), label
        plans = [mk.march_stage_plan(mk.lower_program(scene, dev, t.pairs),
                                     t).bytes for t in tabs]
        assert plans[0] != plans[1], label
        if kw:
            a = mk.cuda_march_raw(scene, rays, own, **kw)
            b = mk.cuda_march_raw(scene, rays, full, **kw)
            assert bool(a.any()) and torch.equal(a, b), label
        else:
            a = mk.cuda_march_raw(scene, rays, own, want_surface=True)
            b = (res, nrm, midx, code)
            for f in ("hit", "t", "distance", "steps"):
                assert torch.equal(getattr(a[0], f), getattr(b[0], f)), f
            for x, y in zip(a[1:], b[1:]):
                assert torch.equal(x, y)


def test_graph_spectral_capture_failure_raises(dev, monkeypatch):
    """A host read inside the spectral frame cannot be captured: the call
    raises, keeps no graph, and does not fall back to the eager frame; the
    next capture takes a new pool and replays."""
    from fraytracer_tpu_torch.ops import wavefront as tw
    scene, cam, cfg, R, eager, graph = _spectral_setup(dev, size=64)
    real = tw.resolve_material

    def reads_the_host(scene_, pos, hit, midx, backend="cuda"):
        int(hit.sum())
        return real(scene_, pos, hit, midx, backend=backend)
    monkeypatch.setattr(tw, "resolve_material", reads_the_host)
    with pytest.raises(RuntimeError):
        graph()
    assert not tgraph._graphs
    assert ops_cuda.graph_counts() == {"captures": 0, "replays": 0,
                                       "eager_reruns": 0, "eager_frames": 0}
    monkeypatch.setattr(tw, "resolve_material", real)
    want = eager()
    for _ in range(2):
        _assert_spectral_close(graph(), want)
    assert ops_cuda.graph_counts()["replays"] == 1


def test_graph_spectral_frame_shares_the_frame_graphs_pool(dev):
    """A forward frame's graph and the spectral frame's in one memory pool,
    replayed in turns: each its eager counterpart."""
    scene, cam, cfg, R, eager, graph = _spectral_setup(dev)
    # tables of the whole group: a 128² tile's candidates would overflow
    # the default tables, and the forward key's first call would promote
    rcfg = ft.RenderConfig(width=128, height=128, march=dataclasses.replace(
        cfg.march, cull_m=1000, cull_m_shadow=1000))
    frame = _eager(scene, cam, rcfg)
    want = eager()
    for _ in range(3):
        img, n = ft.render_with_stats(scene, cam, rcfg)
        assert torch.equal(img, frame[0]) and int(n) == int(frame[1])
        _assert_spectral_close(graph(), want)
    assert ops_cuda.graph_counts()["captures"] == 2
    assert R.frame_graph(scene, cam, rcfg).graph.pool() == \
        tw.spectral_graph(scene, cam, 128, 128, cfg).graph.pool()


# ---------------------------------------------------------------------------
# the sharded graph frame (parallel/mesh.py) on a world of one NCCL rank
# ---------------------------------------------------------------------------

def test_graph_sharded_frame_on_one_nccl_rank(dev):
    """``render_sharded`` on the in-memory world of one NCCL rank
    (``multihost.initialize()``): the first call captures the band's frame
    and the flag's ``all_reduce``, the replay is ``render_grid``'s frame
    bit for bit with one frame's launches, and a replay makes no host
    sync.  The group is torn down at the end."""
    import torch.distributed as dist
    from fraytracer_tpu_torch.parallel import mesh as pm, multihost
    scene, cam, cfg, R = _graph_setup(dev)
    want = _eager(scene, cam, cfg)[0]
    assert not dist.is_initialized()
    multihost.initialize(backend="nccl")
    try:
        mesh = pm.make_mesh()
        assert (mesh.size, mesh.backend) == (1, "nccl")
        ops_cuda.reset_launch_counts()
        for _ in range(2):
            assert torch.equal(pm.render_sharded(scene, cam, cfg, mesh),
                               want)
        assert {k: v for k, v in ops_cuda.launch_counts().items() if v} \
            == with_tables({"march_culled": 2, "surface_culled": 2,
                            "occlusion_culled": 4})
        assert ops_cuda.graph_counts() == {"captures": 1, "replays": 1,
                                           "eager_reruns": 0,
                                           "eager_frames": 0}
        fg = tgraph._graphs[tgraph.key("frame", scene, cam, cfg,
                                       extra=("sharded", 0, 1))]
        assert fg.agree_in_graph
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fg.graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.synchronize()
        assert torch.equal(fg.outputs[0], want)
        assert not bool(fg.frame.flag)
    finally:
        dist.destroy_process_group()


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


@pytest.fixture(scope="module")
def oracle64():
    """``chip_smoke.py`` loaded by path (its gate function; it imports
    only torch at module level) and the port's float64 oracle over the 64²
    frame of tests/test_benchmark_oracle.py, in this process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cs = _chip_smoke()
    oracle = cs.oracle_sample(torus_csg_scene(19, 1000), (0.0, 0.0, -10.0),
                              64, 64, range(64 * 64), workers=1)
    return cs, oracle


@pytest.mark.parametrize("cull", [True, False])
def test_benchmark_oracle_gate_on_the_card(dev, oracle64, cull):
    """tests/test_benchmark_oracle.py's gate and bounds on the
    kernels' 64² frame of the 1000-torus scene (ω 1.0, 512 steps, the
    bound skip), culled and dense (dense K1/K2 step with ``sqrt.approx``),
    against the port's oracle, through ``chip_smoke.oracle_gate``."""
    cs, oracle = oracle64
    scene = ft.flatten(torus_csg_scene(19, 1000), device=dev)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    cfg = ft.RenderConfig(width=64, height=64, epsilon=0.01, length=30.0,
                          march=ft.MarchConfig(bound_skip=True, max_steps=512,
                                               cull=cull))
    ops_cuda.reset_launch_counts()
    frame = cs.frame_outcomes(scene, cam, cfg)
    counts = ops_cuda.launch_counts()
    sfx = "_culled" if cull else ""
    assert counts["march" + sfx] >= 1 and counts["surface" + sfx] >= 1
    assert counts["occlusion" + sfx] >= 2
    r = cs.oracle_gate(f"64^2 {'culled' if cull else 'dense'}", frame,
                       oracle)
    assert r["rays"] == 64 * 64
