"""Process groups across hosts, or spawned on this one (counterpart of
``fraytracer_tpu.parallel.multihost``).

The reference is one process (SURVEY.md §2c).  Here every rank is a
process with one device, in one ``torch.distributed`` group: started by
``torchrun`` (one process a card on each host), by the caller on each host
with an explicit coordinator, or spawned on this host by
:func:`run_ranks`.  The code of ``mesh.py`` is the same in every case; the
assembled frame is gathered only where a host needs the whole image.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import socket
import time
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, all_gather, local_rank, make_mesh, teardown


def default_backend(device: Optional[str] = None) -> str:
    """NCCL for CUDA devices, gloo for the CPU; ``device`` ``None`` means the
    card when there is one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Initialize the default process group; a second call does nothing.

    * explicit arguments (``coordinator_address`` is ``host:port``, the
      rank 0 process listens there): ``init_method="tcp://…"``; a failure
      raises;
    * else torchrun's environment (``RANK``, ``WORLD_SIZE``,
      ``MASTER_ADDR``, ``MASTER_PORT``): ``init_method="env://"``;
    * else a world of one process, in memory.

    ``backend``: :func:`default_backend` unless named; gloo may be named
    for ranks that share one card (NCCL refuses two ranks on a device).
    With NCCL, the rank's card (``mesh.local_rank``) becomes the current
    device."""
    if dist.is_initialized():
        return
    backend = backend or default_backend()
    explicit = (coordinator_address, num_processes, process_id)
    if any(a is not None for a in explicit):
        if any(a is None for a in explicit):
            raise ValueError("initialize: give coordinator_address, "
                             "num_processes and process_id together")
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=int(num_processes), rank=int(process_id))
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        kw = dict(init_method="env://")
    else:
        kw = dict(store=dist.HashStore(), world_size=1, rank=0)
    dist.init_process_group(backend, **kw)
    if backend == "nccl":
        torch.cuda.set_device(local_rank())


def global_mesh(devices=None) -> Mesh:
    """A mesh over every rank of every host (``devices`` as in
    :func:`mesh.make_mesh`)."""
    return make_mesh(devices=devices)


def gather_image_to_host(image: torch.Tensor,
                         mesh: Optional[Mesh] = None) -> np.ndarray:
    """The whole frame as numpy on every rank, from each rank's rows (one
    ``all_gather``; used for file output).  The rows themselves for one
    process."""
    if mesh is None:
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return image.detach().cpu().numpy()
        mesh = global_mesh(devices=image.device)
    if mesh.size == 1:
        return image.detach().cpu().numpy()
    full = all_gather(image.detach(), mesh)
    return full.reshape((-1,) + tuple(image.shape[1:])).cpu().numpy()


# ---------------------------------------------------------------------------
# Ranks spawned on this host
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, coordinator, n_ranks, rank, backend, args, results,
               threads):
    torch.set_num_threads(threads)
    try:
        initialize(coordinator, n_ranks, rank, backend=backend)
        # pickled here, whole: a tensor put on the queue as it is would
        # travel as a handle to this process's memory, gone once it exits
        out = pickle.dumps(fn(*args))
        teardown()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def run_ranks(fn, n_ranks: int, *args, device: str = "cuda",
              backend: Optional[str] = None, timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``n_ranks`` processes spawned on this host, one
    process group over ``tcp://127.0.0.1`` (``backend`` as
    :func:`initialize` picks it for ``device``); ``fn`` makes its mesh
    itself.  Returns each rank's result (picklable), in rank order.  On a
    card the kernel library is built here first, so the ranks only load
    it.  Raises when a rank fails or the ranks take longer than
    ``timeout`` seconds; every rank has ended when this returns."""
    if torch.device(device).type == "cuda":
        from ..ops.cuda import build
        build.library()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    coordinator = f"127.0.0.1:{_free_port()}"
    backend = backend or default_backend(device)
    # the ranks share this process's CPU threads (more oversubscribe the
    # cores, and the ranks' host work slows by an order of magnitude)
    threads = max(1, torch.get_num_threads() // n_ranks)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, coordinator, n_ranks, r, backend, args,
                               results, threads))
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < n_ranks:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in got]
                if dead:
                    raise RuntimeError(f"ranks exited before reporting "
                                       f"(rank, exit code): {dead}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n_ranks} ranks took more than "
                                       f"{timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = pickle.loads(out)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [got[r] for r in range(n_ranks)]
