"""K4: block gather (counterpart of ``fraytracer_tpu.ops.pallas.gather``).

``out[i] = x[block_idx[i]]`` over whole blocks of 4-byte elements — the
reorder primitive of the material-repair block tier and of queue
compaction.  CUDA tensors launch ``csrc/gather.cu``; CPU tensors take
:func:`block_gather_plain`.  ``LAUNCHES["block_gather"]`` counts kernel
launches.
"""
from __future__ import annotations

import math

import torch

from .build import check, library, on_device

BLOCK_SUB = 8            # sublanes per gathered block (the TPU block shape)
BLOCK_LANE = 128         # lanes per gathered block
BLOCK = BLOCK_SUB * BLOCK_LANE

LAUNCHES = {"block_gather": 0}


def block_gather_plain(x: torch.Tensor, block_idx: torch.Tensor) -> torch.Tensor:
    """Plain version: ``index_select`` on the block view ``x [B, ...]``; an
    index outside ``[0, B)`` yields a zero block, as in the kernel."""
    idx = block_idx.to(device=x.device, dtype=torch.long)
    ok = (idx >= 0) & (idx < x.shape[0])
    out = x.index_select(0, torch.where(ok, idx, 0))
    return torch.where(ok.view((-1,) + (1,) * (x.ndim - 1)), out,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _gather_blocks(x: torch.Tensor, block_idx: torch.Tensor) -> torch.Tensor:
    """``x [B, *block]`` → ``[Bo, *block]``: the kernel for CUDA tensors,
    the plain version for CPU tensors; anything else raises."""
    if x.device.type == "cpu":
        return block_gather_plain(x, block_idx)
    if x.device.type != "cuda":
        raise ValueError(f"block_gather: unsupported device {x.device}")
    if x.element_size() != 4:
        raise TypeError(f"block_gather wants 4-byte elements, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("block_gather wants a contiguous 16-byte aligned x")
    if (block_idx.dtype != torch.int32 or block_idx.ndim != 1
            or block_idx.device != x.device
            or not block_idx.is_contiguous()):
        raise ValueError("block_idx must be a contiguous 1-D int32 tensor "
                         "on x's device")
    block_bytes = 4 * math.prod(x.shape[1:])
    if block_bytes % 16:
        raise ValueError(f"block of {block_bytes} bytes is not a multiple "
                         "of 16")
    if x.shape[0] >= 2 ** 31 or block_idx.shape[0] >= 2 ** 31:
        raise ValueError("block_gather: too many blocks for int32 indices")
    if block_bytes // 16 > 65535 * 256:
        raise ValueError(f"block of {block_bytes} bytes exceeds the grid")
    bo = block_idx.shape[0]
    out = torch.empty((bo,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    with on_device(x.device):
        err = library().ft_block_gather(
            x.data_ptr(), block_idx.data_ptr(), x.shape[0], bo,
            block_bytes // 16, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(err, "ft_block_gather")
    LAUNCHES["block_gather"] += 1
    return out


def block_gather(x: torch.Tensor, block_idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = x[block_idx[i]]`` over (8, 128) blocks: ``x [B, 8, 128]``
    (4-byte elements), ``block_idx [Bo]`` int32 → ``[Bo, 8, 128]``.
    Indices may repeat and ``Bo`` may differ from ``B``."""
    if x.ndim != 3 or tuple(x.shape[1:]) != (BLOCK_SUB, BLOCK_LANE):
        raise ValueError(f"block_gather wants x [B, 8, 128], got "
                         f"{tuple(x.shape)}")
    return _gather_blocks(x, block_idx)


def flat_block_gather(x: torch.Tensor, block_idx: torch.Tensor,
                      n_out_blocks: int) -> torch.Tensor:
    """Block gather over a flat array's leading axis: ``x [N, ...]`` with
    ``N`` divisible by ``BLOCK`` → ``[n_out_blocks · BLOCK, ...]`` where out
    block ``i`` is x's block ``block_idx[i]`` (its ``BLOCK`` rows with all
    trailing elements — one launch for ``[N]`` and ``[N, k]`` payloads)."""
    n = x.shape[0]
    if n % BLOCK:
        raise ValueError(f"flat_block_gather: {n} rows is not a multiple "
                         f"of {BLOCK}")
    if block_idx.shape[0] != n_out_blocks:
        raise ValueError(f"{block_idx.shape[0]} indices for "
                         f"{n_out_blocks} output blocks")
    trail = math.prod(x.shape[1:])
    out = _gather_blocks(x.contiguous().reshape(n // BLOCK, BLOCK * trail),
                         block_idx)
    return out.reshape((n_out_blocks * BLOCK,) + tuple(x.shape[1:]))
