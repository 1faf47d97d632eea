"""The CUDA kernels against their plain PyTorch versions on the same CUDA
tensors.  Needs a CUDA device (marker ``cuda``); skipped without one.

Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: hit masks equal on ≥ 99.9% of lanes and t within 1e-4 on lanes
that both hit in the same number of steps (nvcc contracts a*b+c into FMA,
the plain version rounds twice); surface outputs on identical inputs:
codes equal on ≥ 99.9% of hit lanes, normals within 1e-4 there; the block
gather is exact.  The culled forms are held to the same bounds on the
same candidate tables."""
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
@pytest.mark.parametrize("name", ["torus", "csg_demo"])
def test_march_and_surface_kernels_match_plain(dev, name, omega):
    scene = ft.flatten(torus_csg_scene(19, 96) if name == "torus"
                       else csg_demo_scene(), device=dev)
    args = lanes(scene, 128, dev)
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
    assert ops_cuda.launch_counts() == {
        "march": 1, "occlusion": 1, "surface": 1, "block_gather": 0,
        "march_culled": 0, "occlusion_culled": 0, "surface_culled": 0}


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
