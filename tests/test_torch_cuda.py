"""The CUDA kernels against their plain PyTorch versions on the same CUDA
tensors.  Needs a CUDA device (marker ``cuda``); skipped without one.

Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: hit masks equal on ≥ 99.9% of lanes and t within 1e-4 on lanes
that both hit in the same number of steps (nvcc contracts a*b+c into FMA,
the plain version rounds twice); surface outputs on identical inputs:
codes equal on ≥ 99.9% of hit lanes, normals within 1e-4 there; the block
gather is exact."""
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
    assert ops_cuda.launch_counts() == {"march": 1, "occlusion": 1,
                                        "surface": 1, "block_gather": 0}


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
