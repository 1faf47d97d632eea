"""The fit of ``fit.py`` as the data-parallel step over the run's cards:
``parallel/mesh.py::make_train_step`` on one rank a card (NCCL on the
cards; gloo on the CPU, for the tests), each rank marching its band of
rows in ``grad_chunks`` chunks, each chunk's gradients all-reduced beside
the next chunk's backward, the SGD update inside the step.  The sharded
loss is a sum over the frame, so the learning rate is ``lr`` over the
frame's values (the same update as ``fit.py``'s mean).

This process is rank 0 and runs the harness; it spawns the other ranks,
which take the same set-up and check steps and then a step for every
step rank 0 takes: before each, rank 0 broadcasts whether to go on, over
a gloo group on the host.  A traced run traces every rank; rank 0 gathers
their busy and window seconds and memory peaks when the window closes.

Not yet proved on cards: over four NCCL cards a run stepped through its
window and then hung before its check, most likely in the teardown of
the process group (``close``); no cell uses this kind until that is
fixed and proved.
"""
from __future__ import annotations

import datetime
import importlib
import multiprocessing
import socket

import torch
import torch.distributed as dist

from benchmark import program, trace
from benchmark.traffic import fit

# seconds a rank waits for the others (set-up, a step, the end)
JOIN_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Rank(fit.Traffic):
    """One rank's state: the mesh, the step and the scene."""

    def __init__(self, run, world: int, rank: int, port: int):
        self.world, self.rank = world, rank
        backend = "nccl" if run.device.type == "cuda" else "gloo"
        wait = datetime.timedelta(seconds=JOIN_S)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank, timeout=wait)
        self.flag_group = dist.new_group(backend="gloo", timeout=wait)
        from fraytracer_tpu_torch.parallel import mesh as M
        self.mesh = M.Mesh(group=dist.group.WORLD, rank=rank, size=world,
                           device=run.device)
        c, p = run.config, run.params
        self.numel = 3 * int(c["render"]["width"]) * int(c["render"]["height"])
        self.step_fn = M.make_train_step(
            program.render_config(c["render"], c["march"]), self.mesh,
            lr=float(p["lr"]) / self.numel, grad_chunks=int(p["grad_chunks"]))
        super().__init__(run)

    def step(self) -> float:
        self.scene, loss = self.step_fn(self.scene, self.camera, self.target)
        return float(loss) / self.numel

    def go(self, on: bool) -> bool:
        """Rank 0's word, over the host group: one more step or stop."""
        flag = torch.tensor([1 if on else 0], dtype=torch.int32)
        dist.broadcast(flag, src=0, group=self.flag_group)
        return bool(flag.item())

    def close(self) -> None:
        dist.barrier(group=self.flag_group)
        dist.destroy_process_group()


def _rank_main(rank, world, port, cell, seed, trace_on, overrides, device,
               patch, queue):
    """A rank other than 0: set-up, then a step for every word of rank 0
    to go on, traced with the run; then its trace's numbers to rank 0."""
    from benchmark import harness
    if patch:
        mod, name = patch.split(":")
        getattr(importlib.import_module(mod), name)()
    run = harness.Run(cell, seed, 0.0, trace_on, overrides)
    run.device = (torch.device("cuda", rank) if device == "cuda"
                  else torch.device("cpu"))
    if run.device.type == "cuda":
        torch.cuda.set_device(run.device)
    me = Rank(run, world, rank, port)
    dist.barrier(group=me.flag_group)
    got = {}
    if trace_on:
        with trace.traced(got):
            while me.go(True):
                me.step()
                run.sync()
    else:
        while me.go(True):
            me.step()
    tr = got.get("trace")
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    queue.put((rank, None if tr is None else tr.busy_s(),
               None if tr is None else tr.window_s, int(peak)))
    me.close()


class Traffic(Rank):
    """Rank 0: spawns the others, then steps as ``fit.Traffic`` does."""

    # "module:function" each spawned rank calls before its set-up (tests)
    rank_patch = None

    def __init__(self, run):
        world = int(run.workload["chips"])
        port = _free_port()
        ctx = multiprocessing.get_context("spawn")
        self.queue = ctx.Queue()
        dev = run.device.type
        self.procs = [ctx.Process(
            target=_rank_main, args=(r, world, port, run.cell, run.seed,
                                     run.trace, run.overrides, dev,
                                     self.rank_patch, self.queue))
            for r in range(1, world)]
        for p in self.procs:
            p.start()
        if self.rank_patch:
            mod, name = self.rank_patch.split(":")
            getattr(importlib.import_module(mod), name)()
        super().__init__(run, world, 0, port)
        dist.barrier(group=self.flag_group)

    def call(self, i: int) -> None:
        self.go(True)
        self.step()

    def release(self) -> None:
        self.go(False)
        peers = [self.queue.get(timeout=JOIN_S) for _ in self.procs]
        self.run.peers = sorted(peers)
        self.close()
        for p in self.procs:
            p.join(JOIN_S)
        alive = [p.pid for p in self.procs if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        if alive or any(p.exitcode for p in self.procs):
            raise RuntimeError(f"ranks failed: exit codes "
                               f"{[p.exitcode for p in self.procs]}")
        super().release()

