"""Build and load the hand-written CUDA kernels (``fraytracer_tpu_torch/csrc``).

The sources are compiled at first use with ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  The library lands in ``fraytracer_tpu_torch/_build/``
under a name that carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the existing file.

Nothing here runs at import: :func:`library` builds on the first call, which
happens only when a kernel wrapper is handed a CUDA tensor.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              # one compile job per source file, all at once
              "--threads", "0")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C entry points: name -> argtypes (every function returns cudaError_t)
SIGNATURES = {
    # rays: origin, direction, length, epsilon, t0, sign (or null), n;
    # program*, cull*, stage*; max_steps, omega, occlusion; outputs t,
    # hit, d, steps; stream
    "ft_march": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _F, _I, _P, _P,
                 _P, _P, _P],
    # the instrumented twin: ft_march's arguments with the sections
    # buffer (uint64 [SEC_N + CNT_N]) before the stream
    "ft_march_sections": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _F, _I,
                          _P, _P, _P, _P, _P, _P],
    # the dense form: ft_march's arguments without cull*, with the block's
    # threads after stage*, and the ray counter (int32 [1]), the issue
    # count and the lane-step count (uint64 [1] each, or null) and the
    # blocks an SM (int [1] on the host, or null) before the stream
    "ft_march_dense": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _F, _I,
                       _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # origin, direction, t, epsilon, hit (bool), n; program*, cull*,
    # stage*; outputs normal [n,3], midx, code; stream (slot mode / AD mode)
    "ft_surface": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P],
    "ft_surface_ad": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P],
    # the dense form: the same without cull*
    "ft_surface_dense": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P],
    "ft_surface_ad_dense": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P],
    # x, idx, n_in_blocks, n_out_blocks, block_words (16-byte words), out,
    # stream
    "ft_block_gather": [_P, _P, _I, _I, _I, _P, _P],
    # the warm-up kernel and the feature probes (csrc/probe.cu)
    # x, out, n, stream
    "ft_warm": [_P, _P, _I, _P],
    "ft_probe_empty": [_P],
    # table, x, out, g, m, p, row, col, stream
    "ft_probe_smem_scalar": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # table, keys, x, out, g, m, p, use_smem, stream
    "ft_probe_dyn_loop": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # table, x, out, trips, g, m, p, use_smem, stream
    "ft_probe_while": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # the table build (csrc/cull.cu): origin, direction, t0, length,
    # epsilon, n, cone apex (or null); outputs cones, oa, ca; the overflow
    # flag to clear (or null); stream
    "ft_cull_cones": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P],
    # FtBuild*, tiles, dynamic shared memory bytes, stream
    "ft_cull_select": [_P, _I, _I, _P],
    # the gather's transpose (csrc/scatter.cu): g, its lane and column
    # strides, idx (int64), n, K, W, shared-memory path, out (a zeroed
    # K x W table), stream
    "ft_rows_scatter": [_P, _L, _L, _P, _L, _I, _I, _I, _P, _P],
    # the leaf backward (csrc/leaf_vjp.cu): origin, direction, t,
    # epsilon, hit (bool), code, sign (or null), ct_t, ct_n, n; rows
    # [K, PSTRIDE], kinds (host ints: kind, first slot), n_kinds,
    # min_denom; outputs bar [PSTRIDE, n], idx (int64); stream
    "ft_leaf_vjp": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _F,
                    _P, _P, _P],
    # host only (csrc/capture.cu): stream under capture, kinds (char
    # [cap] or null), cap, out n_ops (int64 [1])
    "ft_capture_ops": [_P, _P, _I, _P],
}
# cudaGetErrorString for a code returned above
ERROR_STRING = "ft_error_string"


class BuildInfo:
    """What the last :func:`library` call did (for logs and PERF.md)."""
    path: Path | None = None
    seconds: float = 0.0
    built: bool = False
    log: str = ""


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (when the sources changed) and load the kernel library."""
    so = BUILD_DIR / f"libfraytracer_kernels_{_digest()}.so"
    t0 = time.perf_counter()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(s) for s in sorted(SRC_DIR.glob("*.cu"))]]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        BuildInfo.log = proc.stdout + proc.stderr
        (BUILD_DIR / "build.log").write_text(
            " ".join(cmd) + "\n" + BuildInfo.log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{BuildInfo.log}")
        os.replace(tmp, so)
        BuildInfo.built = True
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.path = so
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    es = getattr(lib, ERROR_STRING)
    es.argtypes = [_I]
    es.restype = ctypes.c_char_p
    return lib


def on_device(dev):
    """Context that makes the CUDA device ``dev`` current for a launch;
    nothing to enter when it already is."""
    import torch
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def check(err: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        text = getattr(library(), ERROR_STRING)(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch ({text})")
