"""The row gather with its own backward: host side of ``csrc/scatter.cu``.

:func:`gather_rows` is ``table.index_select(dim, idx)``, the op every
frame runs, whose backward adds the gradient's rows back into a zero table
(:func:`scatter_rows`).  CUDA tensors take ``rows_scatter_kernel``, which
sums the lanes of one row inside a warp, and inside a block where the
table fits its shared memory, before it touches device memory; CPU tensors
take :func:`scatter_rows_plain`, autograd's own ``index_add_``.  The
scatter's backward is the gather again, so a double backward runs through
it.  ``LAUNCHES`` counts the kernel's launches by path: ``rows_scatter_smem``
(a table of at most ``SMEM_TABLE`` bytes) and ``rows_scatter_global``.
"""
from __future__ import annotations

import math

import torch

from ...utils.profiling import anchor
from .build import check, library, on_device

Tensor = torch.Tensor

LAUNCHES = {"rows_scatter_smem": 0, "rows_scatter_global": 0}

# bytes of a table a block keeps in shared memory: the most a launch takes
# without opting in; csrc/scatter.cu takes the path this module picks
SMEM_TABLE = 48 * 1024


def scatter_path(shape) -> str:
    """The kernel's path for a float32 table of ``shape``: ``"smem"`` where
    it fits ``SMEM_TABLE`` bytes, else ``"global"``."""
    return "smem" if 4 * math.prod(shape) <= SMEM_TABLE else "global"


def scatter_rows_plain(grad: Tensor, idx: Tensor, dim: int,
                       shape: tuple) -> Tensor:
    """Plain version: a zero table of ``shape`` with ``grad``'s slices
    added at ``idx`` along ``dim`` (``index_select``'s own backward)."""
    return grad.new_zeros(shape).index_add_(dim, idx, grad)


def _scatter_kernel(grad: Tensor, idx: Tensor, dim: int,
                    shape: tuple) -> Tensor:
    if grad.dtype != torch.float32:
        raise TypeError(f"rows_scatter takes float32, got {grad.dtype}")
    if idx.ndim != 1 or idx.device != grad.device:
        raise ValueError("idx must be a 1-D tensor on grad's device")
    k, n = shape[dim], idx.shape[0]
    rest = tuple(shape[:dim]) + tuple(shape[dim + 1:])
    w = math.prod(rest)
    if k * w >= 2 ** 31:
        raise ValueError(f"rows_scatter: a table of {k * w} entries (the "
                         "kernel takes < 2**31)")
    # lanes first: [n, W] as a view of the gradient where its strides allow
    g = grad.movedim(dim, 0).reshape(n, w)
    idx = idx.to(torch.long).contiguous()
    out = torch.zeros((k, w), dtype=grad.dtype, device=grad.device)
    path = scatter_path(shape)
    with on_device(grad.device):
        err = library().ft_rows_scatter(
            g.data_ptr(), g.stride(0), g.stride(1), idx.data_ptr(), n, k, w,
            int(path == "smem"), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(err, "ft_rows_scatter")
    if n and k and w:
        anchor("rows_scatter_kernel")
        LAUNCHES["rows_scatter_" + path] += 1
    return out.reshape((k,) + rest).movedim(0, dim)


def scatter_rows(grad: Tensor, idx: Tensor, dim: int, shape: tuple) -> Tensor:
    """The transpose of ``index_select(dim, idx)`` on a table of ``shape``:
    the kernel for CUDA tensors, the plain version for CPU tensors;
    anything else raises."""
    if grad.device.type == "cpu":
        return scatter_rows_plain(grad, idx, dim, shape)
    if grad.device.type != "cuda":
        raise ValueError(f"rows_scatter: unsupported device {grad.device}")
    return _scatter_kernel(grad, idx, dim, shape)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, dim):
        ctx.save_for_backward(idx)
        ctx.dim, ctx.shape = dim, tuple(table.shape)
        return table.index_select(dim, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return _ScatterRows.apply(grad, idx, ctx.dim, ctx.shape), None, None


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grad, idx, dim, shape):
        ctx.save_for_backward(idx)
        ctx.dim = dim
        return scatter_rows(grad, idx, dim, shape)

    @staticmethod
    def backward(ctx, gg):
        (idx,) = ctx.saved_tensors
        return _GatherRows.apply(gg, idx, ctx.dim), None, None, None


def gather_rows(table: Tensor, idx: Tensor, dim: int = 0) -> Tensor:
    """``table.index_select(dim, idx)`` (``idx`` 1-D), differentiable in
    ``table`` through :func:`scatter_rows`; without a gradient to take it
    is the plain op."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table.index_select(dim, idx)
    return _GatherRows.apply(table, idx, dim)
