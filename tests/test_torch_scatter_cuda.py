"""The row scatter's kernel (``csrc/scatter.cu``) against ``index_add_`` on
the same CUDA tensors.  Needs a CUDA device (marker ``cuda``); skipped
without one.  Imports only torch and the port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_scatter_cuda.py

The bar: each table within 1e-5 of its largest |entry| of ``index_add_``'s
on the gradient in float64 (the sum the float32 kernel rounds; a float32
``index_add_`` adds up to a million terms to one address one after
another, and on the material rows strays further than that), the launch
counted under its path; an empty or all-zero gradient gives a zero table
exactly.  A graph
step of the torus scene against the eager step within
``tests/test_torch_cuda.py``'s 2e-4 of each leaf's largest |g|, its
scatters on the shared-memory path."""
import functools

import pytest
import torch

import fraytracer_tpu_torch as ft
from fraytracer_tpu_torch.ops import cuda as ops_cuda, graph
from fraytracer_tpu_torch.ops.cuda import scatter
from fraytracer_tpu_torch.scene.generators import torus_csg_scene

pytestmark = pytest.mark.cuda

REL = 1e-5
STEP_GRAD_REL = 2e-4     # tests/test_torch_cuda.py's graph-step bound


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _lanes(dev, n, k, share, runs, seed):
    """``n`` lane rows in ``[0, k)``: runs of ``runs`` neighbouring lanes
    on one row (the pixels of one surface), and a mask of the ``share`` of
    lanes whose gradient is not zero."""
    g = torch.Generator().manual_seed(seed)
    row = torch.randint(0, k, (-(-n // runs),), generator=g)
    row = row.repeat_interleave(runs)[:n]
    live = torch.rand(n, generator=g) < share
    # lanes of another kind read any row (sdf.leaf_distance)
    row = torch.where(live, row, torch.arange(n) % k)
    return row.to(dev), live.to(dev)


def _check(grad, idx, dim, shape, path):
    ops_cuda.reset_launch_counts()
    got = scatter.scatter_rows(grad, idx, dim, shape)
    counts = {k: v for k, v in ops_cuda.launch_counts().items() if v}
    want = torch.zeros(shape, dtype=torch.float64,
                       device=grad.device).index_add_(dim, idx, grad.double())
    assert got.shape == want.shape and got.dtype == torch.float32
    assert counts == ({"rows_scatter_" + path: 1} if idx.numel() else {})
    scale = float(want.abs().max())
    assert float((got.double() - want).abs().max()) <= REL * scale
    return got, want.float()


@pytest.mark.parametrize("case", [
    # (table [P, K] gathered along K: params.t(); lanes, share of the
    # lanes of this kind, run length, path)
    ("spheres", (4, 2), 65536, 0.05, 64, "smem"),
    ("tori", (8, 1000), 1 << 20, 0.6, 24, "smem"),
    ("tori_scattered", (8, 1000), 65536, 1.0, 1, "smem"),
    ("smem_full", (8, 1536), 65536, 0.6, 24, "smem"),
    ("global", (8, 20000), 1 << 18, 0.6, 24, "global"),
], ids=lambda c: c[0])
def test_leaf_rows_scatter_matches_index_add(dev, case):
    """``leaf_distance``'s layout: a ``[P, n]`` gradient into ``[P, K]``,
    most lanes of another kind carrying a zero gradient."""
    _name, shape, n, share, runs, path = case
    idx, live = _lanes(dev, n, shape[1], share, runs, n + shape[1])
    g = torch.Generator(device=dev).manual_seed(2)
    grad = torch.randn((shape[0], n), generator=g, device=dev)
    grad = torch.where(live, grad, 0.0)
    assert scatter.scatter_path(shape) == path
    got, _want = _check(grad, idx, 1, shape, path)
    assert float(got.abs().max()) > 0


def test_material_rows_scatter_matches_index_add(dev):
    """``take_rows``' layout: an ``[n, 3]`` gradient into ``[M, 3]``, a
    handful of rows under a million lanes."""
    n = 1 << 20
    idx, _live = _lanes(dev, n, 5, 1.0, 512, 3)
    grad = torch.randn((n, 3), device=dev)
    _check(grad, idx, 0, (5, 3), "smem")


def test_scatter_kernel_takes_float32_only(dev):
    grad = torch.ones((8, 16), device=dev, dtype=torch.float64)
    idx = torch.zeros(16, dtype=torch.long, device=dev)
    with pytest.raises(TypeError, match="float32"):
        scatter.scatter_rows(grad, idx, 1, (8, 4))


@pytest.mark.parametrize("path", ["smem", "global"])
def test_empty_and_zero_gradients_give_zero_tables(dev, path):
    k = 1000 if path == "smem" else 20000
    empty = torch.zeros((8, 0), device=dev)
    none = torch.zeros(0, dtype=torch.long, device=dev)
    ops_cuda.reset_launch_counts()
    out = scatter.scatter_rows(empty, none, 1, (8, k))
    assert torch.equal(out, torch.zeros(8, k, device=dev))
    assert not any(ops_cuda.launch_counts().values())
    idx, _live = _lanes(dev, 4096, k, 1.0, 8, 5)
    zero = torch.zeros((8, 4096), device=dev)
    got, want = _check(zero, idx, 1, (8, k), path)
    assert torch.equal(got, want)


def test_gather_rows_backward_launches_the_kernel(dev):
    """Through autograd: ``gather_rows``' backward is the kernel's
    scatter, its double backward the gather."""
    table = torch.randn(7, 3, device=dev, requires_grad=True)
    idx = torch.randint(0, 7, (5000,), device=dev)
    y = scatter.gather_rows(table, idx)
    ct = torch.randn(y.shape, device=dev, requires_grad=True)
    ops_cuda.reset_launch_counts()
    (gt,) = torch.autograd.grad(y, table, ct, create_graph=True)
    assert ops_cuda.launch_counts()["rows_scatter_smem"] == 1
    want = torch.zeros(7, 3, device=dev).index_add_(0, idx, ct.detach())
    assert float((gt - want).abs().max()) <= REL * float(want.abs().max())
    (gct,) = torch.autograd.grad((gt * gt).sum(), ct)
    assert torch.equal(gct, (2 * gt.detach()).index_select(0, idx))


def test_graph_step_scatters_on_the_shared_memory_path(dev):
    """A captured step of ``torus_csg_scene`` at 128² against the eager
    step: loss bit for bit, gradients within 2e-4 of each leaf's largest
    |g|; three scatters a step (the leaf rows, albedo, emission), all on
    the shared-memory path."""
    import sys
    R = sys.modules["fraytracer_tpu_torch.render"]
    scene = ft.flatten(torus_csg_scene(19, 96), device=dev)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), device=dev)
    cfg = ft.RenderConfig(width=128, height=128, march=ft.MarchConfig(
        max_steps=192, relax_omega=1.4))
    graph._graphs.clear()

    def loss(img):
        return (img ** 2).sum()
    out = graph.eager(functools.partial(R._step, loss), scene, cam, cfg,
                      grad=True)
    want = (out[0], dict(zip(scene.tensors(), out[1:])))
    ft.render_value_and_grad(loss, scene, cam, cfg)
    ops_cuda.reset_launch_counts()
    got = ft.render_value_and_grad(loss, scene, cam, cfg)
    counts = ops_cuda.launch_counts()
    assert ops_cuda.graph_counts()["replays"] == 1
    assert (counts["rows_scatter_smem"], counts["rows_scatter_global"]) \
        == (3, 0)
    assert torch.equal(got[0], want[0])
    for k, w in want[1].items():
        scale = float(w.abs().max())
        assert float((got[1][k] - w).abs().max()) <= STEP_GRAD_REL * scale, k
    assert float(want[1]["prim_params/torus"].abs().sum()) > 0
