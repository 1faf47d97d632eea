"""The row gather with its own backward (``ops/cuda/scatter.py``) on CPU
tensors: ``gather_rows`` is ``index_select`` and its backward autograd's
``index_add_`` bit for bit; first and second derivatives through
``sdf.leaf_distance`` and ``sdf.take_rows`` pass ``gradcheck`` and
``gradgradcheck`` in float64.  The kernel itself runs only on a card
(``tests/test_torch_scatter_cuda.py``)."""
import pytest
import torch

import fraytracer_tpu_torch as ft
from fraytracer_tpu_torch.ops import sdf
from fraytracer_tpu_torch.ops.cuda import scatter
from fraytracer_tpu_torch.scene.generators import torus_csg_scene


def _native(table, idx, dim):
    return table.index_select(dim, idx)


@pytest.mark.parametrize("case", ["rows", "transposed", "flat", "int32",
                                  "empty"])
def test_gather_rows_is_index_select_bit_for_bit(case):
    g = torch.Generator().manual_seed(5)
    base = torch.randn(7, 4, generator=g)
    table, dim = {"rows": (base, 0), "transposed": (base.t(), 1),
                  "flat": (base[:, 0].contiguous(), 0),
                  "int32": (base, 0), "empty": (base, 0)}[case]
    n = 0 if case == "empty" else 300
    idx = torch.randint(0, table.shape[dim], (n,), generator=g)
    if case == "int32":
        idx = idx.int()
    out = {}
    for name, fn in (("got", scatter.gather_rows), ("want", _native)):
        leaf = table.detach().clone().requires_grad_(True)
        y = fn(leaf, idx, dim)
        ct = torch.randn(y.shape, generator=torch.Generator().manual_seed(9))
        (gr,) = torch.autograd.grad(y, leaf, ct)
        out[name] = (y.detach(), gr)
    assert torch.equal(out["got"][0], out["want"][0])
    assert torch.equal(out["got"][1], out["want"][1])
    assert out["got"][1].shape == table.shape


def test_gather_rows_without_grad_is_the_plain_op():
    table = torch.randn(5, 3, requires_grad=True)
    idx = torch.tensor([4, 0, 0, 2])
    with torch.no_grad():
        assert scatter.gather_rows(table, idx).grad_fn is None
    assert scatter.gather_rows(table.detach(), idx).grad_fn is None
    assert scatter.gather_rows(table, idx).grad_fn is not None


def test_scatter_rows_plain_on_cpu_and_refuses_other_devices():
    grad = torch.randn(6, 2)
    idx = torch.tensor([1, 1, 0, 3, 1, 0])
    want = torch.zeros(4, 2).index_add_(0, idx, grad)
    assert torch.equal(scatter.scatter_rows(grad, idx, 0, (4, 2)), want)
    with pytest.raises(ValueError, match="unsupported device"):
        scatter.scatter_rows(grad.to("meta"), idx.to("meta"), 0, (4, 2))


@pytest.mark.parametrize("shape,path", [
    ((4, 2), "smem"),           # the clip and cut spheres
    ((8, 1000), "smem"),        # 1,000 tori: 32 KB
    ((8, 1536), "smem"),        # 48 KB, the most a block keeps
    ((8, 1537), "global"),
    ((8, 10000), "global"),     # 10,000 tori: 320 KB
])
def test_scatter_path_by_table_bytes(shape, path):
    assert scatter.scatter_path(shape) == path


def _leaf_case():
    """A float64 torus scene's parameters, signed winning-leaf codes over
    every slot (and misses), and points near the leaves."""
    scene = ft.flatten(torus_csg_scene(19, 4), device="cpu")
    g = torch.Generator().manual_seed(3)
    k = scene.num_prims
    code = torch.randint(-k, k + 1, (24,), generator=g).to(torch.int32)
    params = {kind: v.double() for kind, v in scene.prim_params.items()}
    x = (torch.rand(24, 3, generator=g, dtype=torch.float64) - 0.5) * 4.0
    return scene.kind_counts, code, params, x


def test_leaf_distance_grads_are_index_select_bit_for_bit(monkeypatch):
    counts, code, params, x = _leaf_case()
    out = []
    for patch in (False, True):
        if patch:
            monkeypatch.setattr(scatter, "gather_rows", _native)
        ps = {k: v.float().requires_grad_(True) for k, v in params.items()}
        q = x.float().requires_grad_(True)
        f = sdf.leaf_distance(counts, code)(ps, q)
        (gq,) = torch.autograd.grad(f.sum(), q, create_graph=True)
        loss = (f * f).sum() + (gq * gq).sum()
        out.append(torch.autograd.grad(loss, list(ps.values()) + [q]))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert all(float(a.abs().sum()) > 0 for a in out[0])


@pytest.mark.parametrize("kind", ["sphere", "torus", "x"])
def test_leaf_distance_gradcheck_and_gradgradcheck(kind):
    counts, code, params, x = _leaf_case()
    names = list(params)
    wrt = params[kind] if kind in params else x

    def fn(v):
        if kind in params:
            return sdf.leaf_distance(counts, code)({**params, kind: v}, x)
        return sdf.leaf_distance(counts, code)(params, v)

    v = wrt.clone().requires_grad_(True)
    assert names == ["sphere", "torus"]
    assert torch.autograd.gradcheck(fn, (v,))
    assert torch.autograd.gradgradcheck(fn, (v,))


def test_take_rows_gradcheck_and_gradgradcheck():
    g = torch.Generator().manual_seed(11)
    table = torch.randn(5, 3, generator=g, dtype=torch.float64)
    idx = torch.randint(0, 5, (4, 6), generator=g)

    def fn(t):
        return sdf.take_rows(t, idx) ** 2

    t = table.clone().requires_grad_(True)
    assert sdf.take_rows(t, idx).shape == (4, 6, 3)
    assert torch.autograd.gradcheck(fn, (t,))
    assert torch.autograd.gradgradcheck(fn, (t,))
