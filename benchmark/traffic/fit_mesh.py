"""The data-parallel fit on one host's cards, as the configuration's
``mesh`` block lays it out: ``fit.py``'s inverse rendering through
``parallel/mesh.py::make_train_step`` on one rank a card (NCCL on the
cards; gloo on the CPU, for the tests), each rank marching its band of
rows in ``grad_chunks`` chunks, each chunk's gradients all-reduced beside
the next chunk's backward, the SGD update inside the step.  The sharded
loss is a sum over the frame, so the learning rate is ``lr`` over the
frame's values: the same update as ``fit.py``'s mean.

This process is rank 0 and runs the harness; it spawns the other ranks,
which take the same set-up and check steps, meet rank 0 at a barrier on
the host, and then step back to back, as the ranks of a training job do:
the step's collectives keep them in step on the devices, and nothing
passes between the hosts.  When the window closes rank 0 writes, in
memory the processes share, how many steps the others take in all: one
more than it took, since another rank may have launched the next step
already (its collectives wait for rank 0's), and rank 0 takes that step
too, untimed.  A traced run traces every rank over the window's
``trace_calls`` steps, its count written before the window and its
start met at a barrier, so that no rank's trace holds a collective
waiting for rank 0's profiler; rank 0 gathers their busy and window
seconds and memory peaks when the window closes.

Every wait of the protocol is bounded, so that a run completes or exits
non-zero:

* the group's collectives on the host (rendezvous, the barriers) time
  out after ``JOIN_S`` s, and so do rank 0's reads of the others'
  reports and its joins, after which it kills what is left;
* the group is closed by the port's ``mesh.teardown`` (the device's
  work, the step's graphs released, the group destroyed, each wait under
  the port's own deadline);
* each process keeps a dead man's switch: where no step or set-up phase
  has come for ``DEADMAN_S`` s, or rank 0's process is gone, it writes
  every thread's stack to standard error and exits non-zero (rank 0
  killing the others first); rank 0's process also ends at once where it
  leaves with the group still open.

A port without ``mesh.teardown`` cannot close an NCCL group whose
collectives a graph captured (its ``destroy_process_group`` waits for
ever), so such a run fails at once, before any rank starts.
"""
from __future__ import annotations

import atexit
import datetime
import faulthandler
import importlib
import multiprocessing
import os
import sys
import threading
import time

import torch
import torch.distributed as dist

from benchmark import program, trace
from benchmark.harness import log
from benchmark.traffic import fit
from benchmark.traffic.fit_sharded import _free_port

# seconds a rank waits for the others at a collective on the host
JOIN_S = 120
# seconds without progress after which a process ends itself
DEADMAN_S = 300


class Deadman:
    """A thread that ends the process, every thread's stack written to
    standard error first, where :meth:`beat` has not been called for
    ``DEADMAN_S`` s or ``parent`` (a process) has ended; ``last_words``
    runs just before."""

    def __init__(self, who: str, parent=None, last_words=None):
        self.who, self.parent, self.last_words = who, parent, last_words
        self.what, self.at = "start", time.monotonic()
        self.stopped = threading.Event()
        threading.Thread(target=self._watch, name="deadman",
                         daemon=True).start()

    def beat(self, what: str) -> None:
        self.what, self.at = what, time.monotonic()

    def stop(self) -> None:
        self.stopped.set()

    def _watch(self) -> None:
        while not self.stopped.wait(1.0):
            gone = self.parent is not None and not self.parent.is_alive()
            late = time.monotonic() - self.at > DEADMAN_S
            if gone or late:
                why = "rank 0 is gone" if gone else "no progress"
                log(f"{self.who}: {why} in {self.what} for "
                    f"{time.monotonic() - self.at:.0f} s; ending the process")
                faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
                if self.last_words is not None:
                    self.last_words()
                sys.stderr.flush()
                os._exit(3)


def _mesh_module():
    """The port's ``parallel.mesh``; a ``RuntimeError`` where it has no
    teardown (see the module docstring)."""
    program.port()
    from fraytracer_tpu_torch.parallel import mesh
    if not hasattr(mesh, "teardown"):
        raise RuntimeError("the port's parallel.mesh has no teardown: its "
                           "process group cannot be closed within a bound")
    return mesh


class Rank(fit.Traffic):
    """One rank's state: the mesh, the step and the scene."""

    def __init__(self, run, rank: int, port: int, deadman: Deadman):
        self.M = _mesh_module()
        layout = run.config["mesh"]
        self.world, self.rank, self.deadman = int(layout["ranks"]), rank, \
            deadman
        if self.world != int(run.workload["chips"]):
            raise ValueError(f"a mesh of {self.world} ranks on "
                             f"{run.workload['chips']} chips")
        backend = layout["backend"] if run.device.type == "cuda" else "gloo"
        wait = datetime.timedelta(seconds=JOIN_S)
        deadman.beat("the group's rendezvous")
        dist.init_process_group(backend,
                                init_method=f"tcp://localhost:{port}",
                                world_size=self.world, rank=rank,
                                timeout=wait)
        self.flag_group = dist.new_group(backend="gloo", timeout=wait)
        self.mesh = self.M.Mesh(group=dist.group.WORLD, rank=rank,
                                size=self.world, device=run.device)
        c = run.config
        self.numel = 3 * int(c["render"]["width"]) * int(c["render"]["height"])
        self.step_fn = self.M.make_train_step(
            program.render_config(c["render"], c["march"]), self.mesh,
            lr=float(run.params["lr"]) / self.numel,
            grad_chunks=int(layout["grad_chunks"]))
        deadman.beat("the target and the checked steps")
        super().__init__(run)

    def step(self) -> float:
        self.deadman.beat("a step")
        self.scene, loss = self.step_fn(self.scene, self.camera, self.target)
        return float(loss) / self.numel

    def close(self) -> None:
        """The ranks meet, then the port closes the group."""
        self.deadman.beat("the barrier before the teardown")
        dist.barrier(group=self.flag_group)
        self.deadman.beat("the teardown")
        self.M.teardown(self.mesh)
        log(f"rank {self.rank}: teardown {self.M.counts()}")


def _steps(me, last) -> None:
    """Steps back to back until ``last`` (shared) is set and reached."""
    n = 0
    while last.value < 0 or n < last.value:
        me.step()
        n += 1


def _rank_main(rank, port, cell, seed, trace_on, overrides, device, patch,
               queue, last):
    """A rank other than 0: set-up, then steps until the count rank 0
    sets in ``last``, traced with the run; then its trace's numbers and
    memory peak to rank 0, and the teardown."""
    from benchmark import harness
    deadman = Deadman(f"rank {rank}", multiprocessing.parent_process())
    if patch:
        mod, name = patch.split(":")
        getattr(importlib.import_module(mod), name)()
    run = harness.Run(cell, seed, 0.0, trace_on, overrides)
    run.device = (torch.device("cuda", rank) if device == "cuda"
                  else torch.device("cpu"))
    if run.device.type == "cuda":
        torch.cuda.set_device(run.device)
    me = Rank(run, rank, port, deadman)
    deadman.beat("the barrier after set-up")
    dist.barrier(group=me.flag_group)
    got = {}
    if trace_on:
        with trace.traced(got):
            dist.barrier(group=me.flag_group)
            _steps(me, last)
    else:
        _steps(me, last)
    deadman.beat("the report")
    tr = got.get("trace")
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    queue.put((rank, None if tr is None else tr.busy_s(),
               None if tr is None else tr.window_s, int(peak)))
    me.close()
    deadman.stop()


class Traffic(Rank):
    """Rank 0: spawns the others, then steps as ``fit.Traffic`` does."""

    # "module:function" each spawned rank calls before its set-up (tests)
    rank_patch = None

    def __init__(self, run):
        _mesh_module()
        self.procs = []
        deadman = Deadman("rank 0", last_words=self._kill)
        self.open = True
        atexit.register(self._leave)
        world = int(run.config["mesh"]["ranks"])
        port = _free_port()
        ctx = multiprocessing.get_context("spawn")
        self.queue = ctx.Queue()
        # the steps each rank takes after set-up; -1 until the window ends
        self.last = ctx.Value("q", -1, lock=False)
        self.taken = 0
        dev = run.device.type
        deadman.beat("spawning the ranks")
        self.procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, port, run.cell, run.seed, run.trace, run.overrides, dev,
                  self.rank_patch, self.queue, self.last))
            for r in range(1, world)]
        for p in self.procs:
            p.start()
        if self.rank_patch:
            mod, name = self.rank_patch.split(":")
            getattr(importlib.import_module(mod), name)()
        super().__init__(run, 0, port, deadman)
        if run.trace:
            self.last.value = int(run.params["trace_calls"])
        deadman.beat("the barrier after set-up")
        dist.barrier(group=self.flag_group)

    def call(self, i: int) -> None:
        if i == 0 and self.run.trace:
            dist.barrier(group=self.flag_group)
        self.step()
        self.taken += 1

    def release(self) -> None:
        if self.last.value < 0:
            self.last.value = self.taken + 1
        while self.taken < self.last.value:     # the steps the others take
            self.step()
            self.taken += 1
        self.deadman.beat("the ranks' reports")
        peers = [self.queue.get(timeout=JOIN_S) for _ in self.procs]
        self.run.peers = sorted(peers)
        self.close()
        self.open = False
        self.deadman.beat("joining the ranks")
        for p in self.procs:
            p.join(JOIN_S)
        codes = [p.exitcode for p in self.procs]
        self._kill()
        self.deadman.stop()
        peak = (torch.cuda.max_memory_allocated(self.run.device)
                if self.run.device.type == "cuda" else 0)
        peaks = [(0, int(peak))] + [(r, m) for r, _b, _w, m in self.run.peers]
        log(f"memory peaks (rank, bytes): {peaks}")
        if any(c != 0 for c in codes):
            raise RuntimeError(f"ranks failed: exit codes {codes}")
        super().release()

    def _kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)

    def _leave(self) -> None:
        """At this process's exit: with the group still open (a failure
        before the teardown) the interpreter's own teardown of NCCL could
        wait for ever, so the process ends here."""
        if self.open:
            self._kill()
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)
