"""W and P1–P4: the bench warm-up kernel and the four feature probes.

Counterparts of ``bench.py::_warm_kernel`` (W) and of
``tools/probe_pallas_features.py`` (P1 ``smem_block``, P2
``smem_block_2d``, P3 ``dyn_fori_scalar_loop``, P4
``while_with_inner_fori``) as CUDA kernels in ``csrc/probe.cu``.  Each
wrapper launches its kernel for CUDA tensors and counts the launch in
``LAUNCHES``; for CPU tensors it runs the plain PyTorch version beside it
(what the CPU tests hold against the numpy oracles of the TPU probe);
any other device raises.

On the TPU the question was whether Mosaic compiles these constructs.  On
this card it is what they cost, so the probe (``python -m
fraytracer_tpu_torch.ops.cuda.probe``) prints ``PASS``/``FAIL`` per feature
with its device time (``device_ms``), P3 and P4 once with the table staged
in shared memory and once read through ``__ldg`` from device memory as the
march kernel reads its candidate tables.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .timing import back_to_back_ms, device_ms  # noqa: F401  (the probe's)

Tensor = torch.Tensor

G, M, P = 4, 128, 8      # grid steps, table rows, table columns
TILE = 8 * 128           # elements of one (8, 128) tile: one thread each
SMEM_MAX = 48 * 1024     # static limit of a block's shared memory (bytes)

LAUNCHES = {"warm": 0, "smem_block": 0, "smem_block_2d": 0,
            "dyn_loop": 0, "while_loop": 0, "empty": 0}


def _on_card(*tensors: Tensor) -> bool:
    """True → launch the kernel (all CUDA, one device); False → the plain
    version (all CPU); anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError("probe: tensors must all be on the CPU or all on "
                         "one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("probe: tensors must be contiguous float32")
    return True


def _check_shapes(x: Tensor, cand: Tensor, m: int, p: int) -> int:
    """``x [g·8, 128]`` and a table of ``g·m·p`` floats → ``g``."""
    if x.ndim != 2 or x.shape[1] != 128 or x.shape[0] % 8:
        raise ValueError(f"probe: x must be [g*8, 128], got {tuple(x.shape)}")
    g = x.shape[0] // 8
    if cand.numel() != g * m * p:
        raise ValueError(f"probe: table of {cand.numel()} floats, want "
                         f"{g}*{m}*{p}")
    if m * p * 4 > SMEM_MAX:
        raise ValueError(f"probe: a table slice of {m * p * 4} bytes does "
                         f"not fit {SMEM_MAX} bytes of shared memory")
    return g


def _launch(name: str, counter: str, *args) -> None:
    from .build import check, library
    check(getattr(library(), name)(*args), name)
    LAUNCHES[counter] += 1


def _stream(x: Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# ---------------------------------------------------------------------------
# W
# ---------------------------------------------------------------------------

def warm_plain(x: Tensor) -> Tensor:
    return x * 2.0


def warm(x: Tensor) -> Tensor:
    """W: ``x * 2`` (float32, any shape; the bench warms up on one (8, 128)
    tile)."""
    if not _on_card(x):
        return warm_plain(x)
    o = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("ft_warm", "warm", x.data_ptr(), o.data_ptr(), x.numel(),
                _stream(x))
    return o


def empty_launch(device) -> None:
    """Launch a kernel that does nothing (the launch-time floor)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("empty_launch needs a CUDA device")
    with torch.cuda.device(device):
        _launch("ft_probe_empty", "empty",
                torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# P1 / P2
# ---------------------------------------------------------------------------

def smem_scalar_plain(x: Tensor, cand: Tensor, m: int, p: int, row: int,
                      col: int) -> Tensor:
    """Plain P1/P2: every tile times the scalar at ``(row, col)`` of its
    ``(m, p)`` table slice."""
    g = x.shape[0] // 8
    s = cand.reshape(g, m, p)[:, row, col]
    return (x.reshape(g, TILE) * s[:, None]).reshape(x.shape)


def _smem_scalar(x: Tensor, cand: Tensor, m: int, p: int, row: int, col: int,
                 counter: str) -> Tensor:
    g = _check_shapes(x, cand, m, p)
    if not _on_card(x, cand):
        return smem_scalar_plain(x, cand, m, p, row, col)
    o = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("ft_probe_smem_scalar", counter, cand.data_ptr(),
                x.data_ptr(), o.data_ptr(), g, m, p, row, col, _stream(x))
    return o


def smem_block(x: Tensor, cand: Tensor) -> Tensor:
    """P1: ``o[tile g] = x[tile g] · cand[g, 0, 3]``; ``cand [G, M, P]``,
    ``x [G·8, 128]``.  CPU tensors take the plain product."""
    if cand.ndim != 3:
        raise ValueError("smem_block wants cand [G, M, P]")
    return _smem_scalar(x, cand, cand.shape[1], cand.shape[2], 0, 3,
                        "smem_block")


def smem_block_2d(x: Tensor, cand: Tensor, m: int = M) -> Tensor:
    """P2: the table as ``[G·M, P]``; ``o[tile g] = x[tile g] ·
    cand[g·M + 3, 1]``."""
    if cand.ndim != 2:
        raise ValueError("smem_block_2d wants cand [G*M, P]")
    return _smem_scalar(x, cand, m, cand.shape[1], 3, 1, "smem_block_2d")


# ---------------------------------------------------------------------------
# P3
# ---------------------------------------------------------------------------

def dyn_loop_plain(x: Tensor, cand: Tensor, keys: Tensor) -> Tensor:
    """Plain P3: per tile ``g`` the window ``[w_lo, w_hi)`` of keys below
    the tile's max, then ``min_c(|x - cand[c, 0]| + cand[c, 1])`` over it
    (1e30 when the window is empty)."""
    g, m = keys.shape
    xt = x.reshape(g, TILE)
    c = cand.reshape(g, m, -1)
    rel = keys < xt.amax(1, keepdim=True)                     # [g, m]
    idx = torch.arange(m, device=x.device)
    w_lo = torch.where(rel, idx, m).amin(1)
    w_hi = torch.where(rel, idx + 1, 0).amax(1)
    inwin = (idx >= w_lo[:, None]) & (idx < w_hi[:, None])    # [g, m]
    v = (xt[:, :, None] - c[:, None, :, 0]).abs() + c[:, None, :, 1]
    v = torch.where(inwin[:, None, :], v, 1e30)
    return v.amin(2).reshape(x.shape)


def dyn_loop(x: Tensor, cand: Tensor, keys: Tensor,
             table: str = "smem") -> Tensor:
    """P3: ``x [G·8, 128]``, ``cand [G·M, P]``, ``keys [G, M]``; ``table``
    places the kernel's table: "smem" (staged in shared memory) or "ldg"
    (read from device memory through the read-only path)."""
    if table not in ("smem", "ldg"):
        raise ValueError(f"table must be 'smem' or 'ldg', got {table!r}")
    if keys.ndim != 2 or cand.ndim != 2:
        raise ValueError("dyn_loop wants cand [G*M, P] and keys [G, M]")
    g = _check_shapes(x, cand, keys.shape[1], cand.shape[1])
    if keys.shape[0] != g:
        raise ValueError(f"keys for {keys.shape[0]} tiles, x has {g}")
    if not _on_card(x, cand, keys):
        return dyn_loop_plain(x, cand, keys)
    o = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("ft_probe_dyn_loop", "dyn_loop", cand.data_ptr(),
                keys.data_ptr(), x.data_ptr(), o.data_ptr(), g,
                keys.shape[1], cand.shape[1], int(table == "smem"),
                _stream(x))
    return o


# ---------------------------------------------------------------------------
# P4
# ---------------------------------------------------------------------------

def while_loop_plain(x: Tensor, cand: Tensor, m: int = M):
    """Plain P4: per tile, ``while max(t) < 10 and i < 50: n = min(i + 1,
    4); t += Σ_{c<n} cand[c, 0]·0.01 + 0.5``.  Returns ``(t, trips [G]
    int32)``."""
    g = x.shape[0] // 8
    c0 = cand.reshape(g, m, -1)[:, :, 0]
    t = x.reshape(g, TILE).clone()
    trips = torch.zeros(g, dtype=torch.int32, device=x.device)
    for i in range(50):
        live = t.amax(1) < 10.0
        d = torch.zeros(g, dtype=torch.float32, device=x.device)
        for c in range(min(i + 1, 4)):
            d = d + c0[:, c] * 0.01
        t = torch.where(live[:, None], t + d[:, None] + 0.5, t)
        trips += live.to(torch.int32)
    return t.reshape(x.shape), trips


def while_loop(x: Tensor, cand: Tensor, m: int = M, table: str = "smem"):
    """P4: ``x [G·8, 128]``, ``cand [G·M, P]`` → ``(t, trips [G] int32)``;
    ``table`` as in :func:`dyn_loop`."""
    if table not in ("smem", "ldg"):
        raise ValueError(f"table must be 'smem' or 'ldg', got {table!r}")
    if cand.ndim != 2:
        raise ValueError("while_loop wants cand [G*M, P]")
    g = _check_shapes(x, cand, m, cand.shape[1])
    if not _on_card(x, cand):
        return while_loop_plain(x, cand, m)
    o = torch.empty_like(x)
    trips = torch.empty(g, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        _launch("ft_probe_while", "while_loop", cand.data_ptr(),
                x.data_ptr(), o.data_ptr(), trips.data_ptr(), g, m,
                cand.shape[1], int(table == "smem"), _stream(x))
    return o, trips


# ---------------------------------------------------------------------------
# The TPU probe's own inputs, and the probe as a program
# ---------------------------------------------------------------------------

def probe_inputs(device) -> dict:
    """The inputs of ``tools/probe_pallas_features.py`` (numpy-made, so
    both packages see the same values) on ``device``."""
    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)
    ramp = np.arange(G * M * P, dtype=np.float32)
    cand3 = np.zeros((G * M, P), np.float32)
    cand3[:, 0] = np.tile(np.linspace(0, 1, M), G)
    cand3[:, 1] = 0.25
    return dict(
        ones=dev(np.ones((G * 8, 128), np.float32)),
        ramp3=dev(ramp.reshape(G, M, P)), ramp2=dev(ramp.reshape(G * M, P)),
        x3=dev(np.linspace(0, 1, G * 8 * 128,
                           dtype=np.float32).reshape(G * 8, 128)),
        cand3=dev(cand3),
        keys3=dev(np.tile(np.linspace(0, 2, M, dtype=np.float32), (G, 1))),
        zeros=dev(np.zeros((G * 8, 128), np.float32)),
        cand4=dev(np.ones((G * M, P), np.float32)),
    )


def features(inp: dict) -> dict:
    """name → (kernel call, plain call, check(kernel out, plain out))."""
    def exact(a, b):
        return bool(torch.equal(a, b))

    def close(a, b):
        return bool(torch.allclose(a, b, rtol=1e-6, atol=0.0))

    def p4(a, b):
        return bool(torch.equal(a[1], b[1]) and float(a[0].min()) > 9.9
                    and torch.allclose(a[0], b[0], rtol=0.0, atol=1e-5))

    out = {
        "smem_block_3d": (lambda: smem_block(inp["ones"], inp["ramp3"]),
                          lambda: smem_scalar_plain(inp["ones"], inp["ramp3"],
                                                    M, P, 0, 3), exact),
        "smem_block_2d": (lambda: smem_block_2d(inp["ones"], inp["ramp2"]),
                          lambda: smem_scalar_plain(inp["ones"], inp["ramp2"],
                                                    M, P, 3, 1), exact),
    }
    for table in ("smem", "ldg"):
        out[f"dyn_fori_scalar_loop[{table}]"] = (
            lambda table=table: dyn_loop(inp["x3"], inp["cand3"],
                                         inp["keys3"], table=table),
            lambda: dyn_loop_plain(inp["x3"], inp["cand3"], inp["keys3"]),
            close)
        out[f"while_with_inner_fori[{table}]"] = (
            lambda table=table: while_loop(inp["zeros"], inp["cand4"],
                                           table=table),
            lambda: while_loop_plain(inp["zeros"], inp["cand4"]), p4)
    return out


def main(argv=None) -> int:
    del argv
    if not torch.cuda.is_available():
        print("probe: no CUDA device (the probes are CUDA kernels)",
              file=sys.stderr)
        return 1
    inp = probe_inputs("cuda")
    failed = 0
    for name, (kernel, plain, check) in features(inp).items():
        ok = check(kernel(), plain())
        torch.cuda.synchronize()
        failed += not ok
        print(f"{'PASS' if ok else 'FAIL'} {name}: {device_ms(kernel):.5f} ms "
              "on the device", flush=True)
    empty = lambda: empty_launch("cuda")
    print(f"empty launch: {device_ms(empty):.5f} ms on the device, "
          f"{back_to_back_ms(empty):.5f} ms a launch back to back (the "
          "host's launch rate)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
