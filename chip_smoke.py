"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and the exit code is not 0):

1. device  — the card's name and power limit (nvidia-smi), torch/CUDA.
2. build   — compile the kernels from fraytracer_tpu_torch/csrc (nvcc).
2b. cull   — the table build's kernels (csrc/cull.cu) against the plain
   build at the three sites of the 1024² / 1000-torus frame and a bounce
   site of the 512² spectral frame: the tables as the card tests check
   them (tests/test_torch_cull_cuda.py), one cones and one select launch
   a site, device ms of both builds beside the bytes-from-shapes bound.
   ``--cull-only`` stops after it.
2c. scatter — the row scatter's kernel (csrc/scatter.cu) on the six
   scatters of one eager 1024² step of the 1000-torus scene, their
   gradients and rows as the backward hands them over: each table against
   ``index_add_`` in float64 as the card tests check it, one launch a
   scatter on the shared-memory path, device ms of the kernel and of a
   float32 ``index_add_`` beside the bytes-from-shapes bound.
   ``--scatter-only`` runs the build and this phase alone; the full run
   runs it so, in a process of its own.
3. kernels — each kernel against its plain PyTorch version on the same
   CUDA tensors: K4 block gather (exact), dense K1/K2/K3 on small scenes,
   culled K1/K2/K3 on the 96-torus scene, a 256-sphere intersect and
   point-light rays with the converging cone; K3 in AD mode (plans with a
   smooth union) dense and culled, also against the dense autograd normal;
   K1/K2 with per-lane sign; culled K1/K2 on a plan whose pairs exceed a
   block's shared memory (staged and unstaged pairs in one launch); dense
   K1/K2/K3 on 8,002 entries, whose packed rows exceed a block's shared
   memory (read from device memory); then each kernel's time beside its
   plain version's, its bound and, where one PyTorch call computes the
   same function, that call's time, at the main path's shapes (dense K2
   on both lights' shadow batches, dense K1/K2 with their lane efficiency
   under lane refill).  Every kernel is read on the device (``ms``: an
   event pair while the device works off queued fills) with the reading
   around one host call beside it (``host_call_ms``).
   ``[sections]`` lines: the instrumented twin of K1/K2 (clock64 deltas
   per warp) gives each section's share of the culled marches' time —
   ray load, window statistics, candidate rows, early-out checks, dense
   entries + tree, stepping, store — with its own launch counter.
4. main    — the culled forward frame (the default configuration):
   render_with_stats at 1024² on the seed-19 1000-torus scene (max_steps
   192, bound_skip, relax_omega 1.4, the default cull_*) with launch
   counts read around it alone, the candidates per tile of each march,
   the material-repair tier it took, the median of 5 frames, a profiled
   frame and peak memory; a tone-mapped PNG is written under
   fraytracer_tpu_torch/_build/.
5. dense   — the same frame with cull=False, its launch counts, timing and
   profile; then, counted apart, the material-repair block tier (K4) on
   the frame's hit points with lanes marked unresolved (the dense frame
   leaves no -1 material on hit lanes, so it never takes that tier
   itself).
6. parity  — 256² frames (dense and culled) through the kernels against
   the plain versions, and the 1024² culled frame against the dense one.
7. blend   — the blended frame: the same 1000-torus scene smooth-united
   with a sphere (every hit lies on a smooth union, so the surface pass
   runs in AD mode), 1024², culled, with its launch counts, timing,
   profile and peak memory; the same frame with cull=False once; culled
   against dense; the 256² blended frame kernels against plain.
7b. graph  — ``render_with_stats`` as one captured CUDA graph a key (the
   counterpart of jax.jit, ``ops/graph.py``): (a) the culled, dense,
   blended culled and blended dense 1024² frames: the capture's time, the
   memory the graph keeps, the replay bit for bit the eager frame
   (``render_grid``, digests printed), the launches per replay equal to
   the eager frame's (1 / 1 / 2, K4 0); (b) a forced overflow (cull_m 8)
   at 256²: the flag set, the overflowed sites promoted, the promoted
   frame captured and replayed; a forced material repair at 256²: the flag
   set, one eager re-run, its launches equal to the eager frame's; each
   frame equal to the eager frame; (c) a torus moved
   in place between two replays against the eager frame of the edited
   scene; (d) the deferred frame under sync debug mode "error" (0 syncs);
   (e) graph and eager frames paired (median of 9 each), 32 chained frames
   of each, each one's profile (device ops, busy / span) and peak memory.
   Frames that the main phases time are graph frames; spied frames (their
   spies read the device) run the eager frame.
7c. step   — ``render_value_and_grad`` as one captured CUDA graph a key,
   forward and backward (the counterpart of jax.jit(jax.value_and_grad),
   ``ops/graph.py``): the culled and the dense 1024² bench steps (loss
   ``sum(render²)``): captures / replays from ``graph_counts()``, the loss
   bit for bit the eager step's and the gradients within 2e-4 of each
   leaf's largest |g| (two eager steps' difference beside), 0 syncs in a
   replay and in the deferred step under sync debug mode "error", launches
   per replay by kernel name from the profiled replay (K1 1, K3 1, K2 2, K4
   0), device ops and busy / span of a profiled replay and eager step,
   paired medians and 8 chained steps of each, the memory the pool keeps
   with the frame graphs; ``blend1000``'s step kept eager (its backward's
   certificate fails); a replay with the tori's centres x 0.05 (flagged,
   re-run, equal to the eager step); the captured 256² / 96-torus step
   against the plain route's with ``[grad]`` (a)'s masking and bound; 10
   ``cli fit`` steps at 256² / 100 tori against the eager fit (rtol 1e-5).
8. spectral — the spectral wavefront (``ops/wavefront.py``): (a) a 64²
   × 8-bin, depth-3 frame on ``spectral_csg_scene(19, 1000)`` through the
   kernels against the plain route, max |diff| < 1e-4 (its bounce rounds
   build tables of m 1000 and march inside-glass lanes); (b) the 512² ×
   8-bin, depth-4 frame on the same scene with the bench's march
   configuration:
   launch counts around it alone (4 march_culled, 4 surface_culled, 8
   occlusion_culled, 24 block_gather, plus any overflow re-run or
   block-tier repair, which the spied frame reports), active lanes and
   candidates per tile round by round, the median of 5, peak memory, a
   profiled frame; (c) K4 at the path's shapes (4,096 blocks of the queue
   in, 2,048 out), bit for bit against its plain version and
   ``index_select``, with device times and bound; (a') one bounce round
   on 32 tiles of (b)'s round-1 queue, each K1/K2/K3 call against its
   plain version on the same inputs and tables (m 1000, sign -1 lanes, the
   point light's converging cone); (e) the graph spectral frame:
   ``render_spectral_with_stats`` at the same size as one captured CUDA
   graph (``ops/graph.py``), the culled march calls whose tables overflowed
   in the key's first run promoted to full-group tables — the promoted
   sites by round and call (round 0's point light expected), the first
   call's launches (two deferred runs) and a replay's (``SPECTRAL_LAUNCHES``
   exactly, also by name from a profiled replay), the replay against the
   eager frame (max |d| <= 1e-5, two eager frames' own |d| beside it,
   n_rays equal), 0 syncs in a replay and in the deferred frame under sync
   debug mode "error", every torus moved in place between two replays
   against the edited scene's eager frame, ``capture_s``, graph and eager
   paired (medians of 9), 8 chained frames of each, a profiled replay's
   ops and idle share, the growth of the graphs' memory pool.  (a), (b)
   and (a') spy or patch kernels: they run the eager body
   (``ops/wavefront.py::_spectral_frame``), which a replay would not.
9. probe   — W (the bench warm-up kernel) and P1-P4 (the feature probes,
   csrc/probe.cu): the probe program itself with the launch counts read
   around it, then each kernel against its plain version on the TPU
   probe's own inputs, its time by CUDA events (P3/P4 with the table in
   shared memory and through __ldg), W's first launch apart from its
   steady time, and the empty kernel's launch time as the practical floor.
10. grad   — the gradient path: (a) 256² / 96 tori, culled kernels against
   the plain route, per-leaf relative L2 error of d sum(render²) with the
   lanes whose discrete outcome or t differ masked out (the unmasked
   figure printed); (b) central differences of the loss along 4 random
   parameter directions against <grad, dir> at 128² on the pixels whose
   outcomes are stable under the step; (c) forward + backward of the 1024²
   / 1000-torus culled frame: launch counts around one step, finite
   non-zero gradients, median of 5, peak memory, a profiled step, the
   share of hit lanes under the min_denom clamp, the transpose of the
   material lookup read three ways; (d) one step of the
   blended frame (the point_eval route: certificate, branch, time, peak
   memory); (e) 10 ``fit`` steps at 256² / 100 tori: the loss decreases.
11. multi  — the sharded paths (``parallel/``) on the one card, each one
   captured CUDA graph a key and rank: (a) one NCCL rank in this process
   (every collective inside the graphs) — ``render_sharded`` of the 1024²
   frame bit for bit ``render``'s with a replay's launches (1 / 1 / 2), the
   exposure max, the training step at 4 chunks and at 1 against the
   one-process step (loss rtol 1e-4, gradients within 2e-4 of each leaf's
   largest) at its capture and a replay, the rebalanced sharded 512² ×
   8-bin depth-4 spectral frame against ``render_spectral`` (mean |d| <
   2e-3) and a replay within 1e-6 of its eager frame (launches 4 / 4 / 8
   / 24), each path's graph counts (captured, then replayed), 0 syncs in a
   replay, graph and eager paired (medians of 9), a profiled replay and
   eager call (ops, idle share, where the NCCL kernels sit), the pool,
   beside the one-process time; (b) two gloo ranks spawned on the card
   (NCCL takes one rank a device; gloo's collectives follow the replays):
   the gathered frame bit for bit, each rank's launches and graph counts,
   a flag forced on rank 0 alone at a replay (both ranks run the eager
   frame again, still bit for bit) and at a key's first call (no rank
   captures), the step (the ranks' scenes equal bit for bit at its
   capture and a replay), the rebalanced spectral frame (eager on gloo,
   counted as eager frames) with each rank's live lanes a round, each
   rank's pool, times beside backend, ranks and cards.
12. tori10k — 10,000 tori at 1024² (``bench_10k.py``): the tables sized
   from the scene's candidate counts, the frame's launches (no overflow
   re-run), median of 5, the primary table build alone, peak memory, a
   profiled frame, which pairs were staged, and K1/K2/K3 against their
   plain versions on the 16 tiles with the most candidates at those
   tables, with device times beside their bounds; then the same tiles
   with tables of m 4,864, past a block's shared memory (the unstaged
   path).
13. periphery — ``validate_scene`` on the benchmark scene and a broken
   copy, ``nan_guard`` over a clean 256² frame and its backward and on an
   injected NaN, a ``march_stats`` report of the 1024² primary rays, a
   ``trace`` written.
14. bench  — ``python -m fraytracer_tpu_torch.bench`` at its defaults in a
   process of its own; its five JSON lines parsed (forward, fwd+bwd,
   spectral, ``tori_10k``, scaling, each a superset of the last), the last
   echoed, W launched once in each of its three processes, the spectral
   stage's launches the graph spectral frame's first call, 8 replays and
   8 eager frames as the spectral phase read them, the 10k frame's
   launches one frame's, the scaling report one NCCL rank on one card.
15. oracle — the kernels' frames (the default "cuda" route) against the
   port's float64 oracle (``fraytracer_tpu_torch/oracle/cpu_ref.py``)
   through one gate function, ``oracle_gate``, with the bounds of the JAX
   suite (``tests/test_benchmark_oracle.py``, ``tests/test_render_e2e.py``)
   and two departures, each printed beside JAX's reading: a shadow flip
   the frame did not march (a facing flip) is not graded as grazing, and
   ``blend1000``'s shell p99 is not gated.  (a) the benchmark gate at
   64², culled and dense (the culled frame's plain route printed); (b)
   the e2e gate on its small scene at 128²; (c) the 1024² bench frame at
   512 steps, culled and dense, read at a seeded sample: 4,096 uniform
   pixels gated as a 64² frame, the 8 blocks with the most primary
   candidates gated but for the whole-frame shares; gated at ω 1.0, the
   bench's ω 1.4 printed; (d) the same at the bench's 192 steps,
   budget-stopped rays counted apart; (e) ``blend1000`` dense, gated but
   for the shell's p99, the culled blended frame printed.  The oracle's
   rays run in a pool of processes,
   one a core.  Runs after phase 7.

Three more modes time parts alone (none is the smoke test; all need the
card):

    python3 chip_smoke.py --frame-only [--tree DIR] [--reps 9]
    python3 chip_smoke.py --kernels-only [--tree DIR]
    python3 chip_smoke.py --compare DIR [--pairs 8] [--reps 9]

``--frame-only`` times the culled torus frame and its dense form, the
graph frame and the eager frame in turns;
``--kernels-only`` prints one JSON line with the device times of K4
(kernel, plain, library), culled K1, culled K2 of both lights, culled K3
in both modes, dense K1, dense K2 of both lights and dense K3 in both
modes, the marches' lane efficiency and ray evaluations, the twin's
section shares and the output digests, then dense K1 and K2 of the
benchmark's 1,000 machined parts (their device ms, lane efficiency under
refill, the block's threads and blocks an SM, digests, and the outputs
on every 16th ray against the plain version).  ``DIR`` is a directory
inside the checkout (``_checkout/`` is ignored by git) that holds another
commit, e.g. ``git archive HEAD | tar -x -C _checkout/parent``;
``--compare`` runs the two trees in turns, a fresh process each: first
``--kernels-only`` (other, this, this, other; the digests of both trees
held against each other), then the frame pairs with the paired
differences of their medians, culled and dense.

The second-to-last line of output is the card's name and power limit, the
line before it a JSON object with each kernel's launches, error and times;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

EPS = 0.01
BENCH_N_TORI = 1000
SIZE = 1024
SRC = "fraytracer_tpu_torch/csrc"
TPU = "fraytracer_tpu/ops/pallas"

# NVIDIA H100 SXM data sheet: device memory rate, float32 rate outside the
# tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = 67e12
# operations of one distance evaluation in csrc/ft_sdf.cuh by primitive
# kind: each add, multiply, divide, square root, min/max and compare
# counted as one
PRIM_FLOPS = {"sphere": 11, "capsule": 34, "torus": 28, "triangle": 171,
              "box": 24, "cone": 64, "plane": 6}
DUAL_FACTOR = 4     # a dual-number evaluation carries three derivatives


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median device time of ``fn`` (ms) over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_timer():
    """``device_ms`` of the imported package (``ops/cuda/timing.py``): an
    event pair around a call issued while the device works off queued
    fills, so that it brackets the kernels and not the host's launch path.
    A tree from before that module keeps the function in its probe."""
    try:
        from fraytracer_tpu_torch.ops.cuda.timing import device_ms
    except ImportError:
        from fraytracer_tpu_torch.ops.cuda.probe import device_ms
    return device_ms


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def dense_flops(scene, tables=None) -> float:
    """Operations of one scene evaluation outside the culled pairs: every
    primitive that no pair's table holds."""
    in_pairs = {}
    for q in (tables.tables if tables is not None else ()):
        in_pairs[q.kind] = in_pairs.get(q.kind, 0) + q.row_hi - q.row_lo
    return float(sum((cnt - in_pairs.get(kind, 0)) * PRIM_FLOPS[kind]
                     for kind, cnt in scene.kind_counts))


def list_flops(tables, evals) -> float:
    """Operations of K3's scans of the culled pairs: each of the
    ``evals [n]`` evaluations per lane reads every candidate of the lane's
    tile (``min(count, m)`` rows per pair)."""
    from fraytracer_tpu_torch.ops.cuda.cull import TILE
    tile = torch.arange(evals.numel(), device=evals.device) // TILE
    per_tile = torch.zeros(int(tile[-1]) + 1, dtype=torch.float64,
                           device=evals.device)
    per_tile.index_add_(0, tile, evals.to(torch.float64))
    return sum(float((per_tile * q.count.clamp(max=q.m)).sum())
               * PRIM_FLOPS[q.kind] for q in tables.tables)


@contextlib.contextmanager
def window_rows(tables):
    """While a plain culled march runs: per pair, the candidate rows inside
    the windows, summed over every evaluation of every active lane.  K1/K2
    scan only the chunks ``[w_lo, w_hi)`` of the lane's warp at each step,
    not the tile's list, so this is what their bound counts.  Read by
    wrapping the plain version's window function from outside (a sum on
    the device per step and pair, no host sync); yields ``{id(pair):
    rows}`` as device scalars."""
    from fraytracer_tpu_torch.ops.cuda import march_kernel as mk
    from fraytracer_tpu_torch.ops.cuda.cull import CAND_UNROLL
    real = mk._warp_window
    rows = {id(q): torch.zeros((), dtype=torch.float64,
                               device=q.count.device) for q in tables.tables}

    def spy(q, lane, p_ax):
        out = real(q, lane, p_ax)
        inv, _tile, _phi, w_lo, w_hi = out[2]
        rows[id(q)] += (w_hi - w_lo).clamp(min=0)[inv].sum() * CAND_UNROLL
        return out

    mk._warp_window = spy
    try:
        yield rows
    finally:
        mk._warp_window = real


def log_window_rows(label, tables, win, steps_kernel, steps_plain):
    """The window rows per evaluation beside the tile's whole list, and
    the evaluations of the plain march (which the rows were counted on)
    beside the kernel's."""
    ev_k, ev_p = int(steps_kernel.sum()), int(steps_plain.sum())
    for q in tables.tables:
        rows = float(win[id(q)])
        log(f"  {label}: windows hold {rows / max(ev_p, 1):.2f} {q.kind} "
            f"rows per evaluation (tile lists: mean "
            f"{q.count.clamp(max=q.m).float().mean().item():.2f}); "
            f"{ev_p} evaluations in the plain march, {ev_k} in the kernel")
    check(abs(ev_k - ev_p) <= 1e-3 * ev_p,
          f"{label}: plain and kernel evaluation counts {ev_p}, {ev_k}")


def dual_flops(scene, hit, code) -> float:
    """Operations of the surface pass's gradients beyond the distance
    values the scan already counts: three derivatives beside a value, each
    at its own primitive's kind.  Slot mode: the winning leaf of each hit
    lane (from ``code``).  AD mode: on each hit lane every member of a
    sumexp group and one winner per min/max group, at the group's kind
    (its cheapest, were a group mixed)."""
    from fraytracer_tpu_torch.ops.cuda.cull import _build_groups
    from fraytracer_tpu_torch.ops.cuda.march_kernel import slot_surface_mode
    cost = [float(PRIM_FLOPS[kind]) for kind, cnt in scene.kind_counts
            for _ in range(cnt)]
    extra = DUAL_FACTOR - 1
    if slot_surface_mode(scene.plan):
        won = hit & (code != 0)
        slot = code[won].abs().long() - 1
        return extra * float(torch.tensor(
            cost, dtype=torch.float64, device=slot.device)[slot].sum())
    groups, _tree = _build_groups(scene.plan)
    per_lane = 0.0
    for g in groups:
        c = [cost[s] for s in g.slots]
        if c:
            per_lane += sum(c) if g.op == "sumexp" else min(c)
    return extra * int(hit.sum()) * per_lane


def scene_bytes(scene, tables=None, march=True) -> int:
    """Bytes of the scene a launch reads once: the primitive parameters
    and, for the culled form, the valid candidate rows and per-tile
    counts; K1/K2 (``march``) also read the chunk keys and each lane's
    axial coordinates, which the surface pass never touches."""
    total = nbytes(*scene.prim_params.values())
    if tables is not None:
        for q in tables.tables:
            total += int(q.count.clamp(max=q.m).sum()) * q.table.shape[-1] * 4
            total += nbytes(q.misc)
            if march:
                total += nbytes(q.keys, q.hsuf)
        if march:
            total += nbytes(tables.oa, tables.ca)
    return total


def bound(n_bytes: float, flops: float):
    """The least time (ms) the card could take: the larger of bytes over
    the memory rate and operations over the float32 rate, and which."""
    tb, tf = n_bytes / PEAK_BYTES_S, flops / PEAK_FLOPS
    return 1e3 * max(tb, tf), "bytes" if tb >= tf else "operations"


def march_bound(scene, lanes, out, tables=None, win_rows=None):
    """Bound of one K1/K2 launch from its measured per-lane evaluations
    (``out[-1]``, the steps): inputs and outputs once; each evaluation's
    primitives outside the pairs and, for the culled form, the window rows
    (``win_rows``, from :func:`window_rows` around the plain march of the
    same lanes)."""
    io = nbytes(*lanes.values(), *out) + scene_bytes(scene, tables)
    flops = float(out[-1].sum()) * dense_flops(scene, tables)
    if tables is not None:
        flops += sum(float(win_rows[id(q)]) * PRIM_FLOPS[q.kind]
                     for q in tables.tables)
    return bound(io, flops)


def surface_bound(scene, args, out, tables=None):
    """Bound of one K3 launch: 33 bytes in (origin, direction, t,
    epsilon, the hit byte) and 20 out a lane; on each hit lane one scene
    evaluation (the culled pairs' whole lists) and the gradients."""
    hit = args[4]
    io = nbytes(*args, *out) + scene_bytes(scene, tables, march=False)
    flops = int(hit.sum()) * dense_flops(scene, tables) \
        + dual_flops(scene, hit, out[2])
    if tables is not None:
        flops += list_flops(tables, hit.to(torch.int32))
    return bound(io, flops)


def timing(ms, plain_ms, err, differing, compared, bound_, library_ms=None,
           **more):
    """One kernel's row of measurements for the JSON line (``more``: the
    same call read another way, e.g. ``host_call_ms``)."""
    return dict(ms=ms, plain_ms=plain_ms, err=err, differing=differing,
                compared=compared, bound_ms=bound_[0], bound_by=bound_[1],
                library_ms=library_ms, **more)


def log_times(out):
    for name, r in out.items():
        lib = "none" if r["library_ms"] is None \
            else f"{r['library_ms']:.4f} ms"
        host = "" if "host_call_ms" not in r else \
            f" on the device ({r['host_call_ms']:.4f} ms around a host call)"
        log(f"  time {name}: kernel {r['ms']:.4f} ms{host}, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.3g} ms "
            f"({r['bound_by']}), library {lib} (err {r['err']:.3e}, "
            f"{r['differing']} of {r['compared']} outputs differ)")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


@contextlib.contextmanager
def plain_route():
    """Send the "cuda" backend's host glue to the plain versions (on CUDA
    tensors) instead of the kernels, for kernel-vs-plain comparisons."""
    from fraytracer_tpu_torch.ops.cuda import cull, gather, \
        march_kernel as mk
    saved = (mk.march_kernel, mk.surface_kernel, gather._gather_blocks,
             mk.build_pair_tables)
    mk.march_kernel = mk.march_plain
    mk.surface_kernel = mk.surface_plain
    gather._gather_blocks = gather.block_gather_plain
    mk.build_pair_tables = cull.build_pair_tables_plain
    try:
        yield
    finally:
        (mk.march_kernel, mk.surface_kernel, gather._gather_blocks,
         mk.build_pair_tables) = saved


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def scenes(dev):
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.scene import generators as G
    all_kinds = ft.Scene(root=ft.union(
        ft.sphere((0, 0, 0), 0.8, material=ft.solid(1, 0, 0)),
        ft.capsule((-2, -1, 0), (-2, 1, 0), 0.3,
                   material=ft.solid(0, 1, 0)),
        ft.torus((2, 0, 0), (0, 1, 0.3), 0.7, 0.2,
                 material=ft.solid(0, 0, 1)),
        ft.triangle((-1, 1.5, 0), (1, 1.5, 0), (0, 2.5, 0.5), 0.1),
        ft.box((0, -2, 0), (0.6, 0.4, 0.5), 0.05,
               material=ft.solid(1, 1, 0)),
        ft.cone((2, -2.5, 0), (2, -1, 0), 0.6, 0.1),
        ft.plane((0, 1, 0), -3.5, material=ft.solid(0.5, 0.5, 0.5)),
    ))
    smooth = ft.Scene(root=ft.subtract(
        ft.intersect(ft.smooth_union(0.3, ft.sphere((0, 0, 0), 1.0),
                                     ft.sphere((0.8, 0.3, 0), 0.7)),
                     ft.sphere((0, 0, 0), 1.5)),
        ft.box((0.3, 0.5, -0.7), (0.4, 0.4, 0.4), 0.05)))
    return {
        "torus96": (ft.flatten(G.torus_csg_scene(19, 96), dev), 256, 30.0),
        "all_kinds": (ft.flatten(all_kinds, dev), 256, 40.0),
        "smooth_subtract": (ft.flatten(smooth, dev), 128, 30.0),
    }


def primary_lanes(scene, size, length, dev, omega=1.4, pos=(0, 0, -10)):
    """Flat primary rays in 32x32 block order with the root-bound start and
    clamped budget, as cuda_march_raw hands them to K1."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops.march import bound_skip_start
    from fraytracer_tpu_torch.camera import to_blocks
    cam = ft.look_at(pos, (0, 0, 0), fov_degrees=60.0, device=dev)
    rays = ft.camera_rays(cam, size, size, EPS, length)
    rays = rays.map(lambda x: to_blocks(x, size, size, 32).contiguous())
    t0, miss0, t_exit = bound_skip_start(scene, rays)
    ln = torch.where(miss0, 0.0, torch.minimum(rays.length, t_exit))
    return dict(origin=rays.origin, direction=rays.direction,
                length=ln.contiguous(), epsilon=rays.epsilon,
                t0=t0.contiguous()), dict(max_steps=192, omega=omega)


def compare_march(k, p, label):
    """Kernel vs plain K1 outputs: hit masks equal on >= 99.9% of lanes;
    t within 1e-4 on lanes that both hit with the same step count (a lane
    whose d crossed epsilon one step apart differs by up to a step)."""
    tk, hk, _dk, sk = k
    tp, hp, _dp, sp = p
    agree = (hk == hp).float().mean().item()
    same = hk & hp & (sk == sp)
    n_both = int((hk & hp).sum())
    frac_same = int(same.sum()) / max(n_both, 1)
    err = (tk - tp).abs()[same].max().item() if same.any() else 0.0
    log(f"  {label}: hit agreement {agree:.6f}, both-hit lanes {n_both}, "
        f"same step count {frac_same:.6f}, max |dt| {err:.3e}")
    check(agree >= 0.999, f"{label}: hit agreement {agree}")
    check(frac_same >= 0.999, f"{label}: step-count agreement {frac_same}")
    check(err <= 1e-4, f"{label}: t error {err}")
    return err


def compare_surface(k, p, hit, label):
    """Kernel vs plain K3 on the same (t, hit) inputs: code equal on
    >= 99.9% of hit lanes; normals within 1e-4 and materials equal there."""
    nk, mk_, ck = k
    np_, mp, cp = p
    same = hit & (ck == cp)
    frac = int(same.sum()) / max(int(hit.sum()), 1)
    nerr = (nk - np_).abs()[same].max().item() if same.any() else 0.0
    mfrac = ((mk_ == mp) | ~same).float().mean().item()
    log(f"  {label}: code agreement {frac:.6f}, max |dn| {nerr:.3e}, "
        f"material agreement {mfrac:.6f}")
    check(frac >= 0.999, f"{label}: code agreement {frac}")
    check(nerr <= 1e-4, f"{label}: normal error {nerr}")
    check(mfrac >= 0.999, f"{label}: material agreement {mfrac}")
    check(bool(((~hit) | (nk.norm(dim=-1) - 1).abs().lt(1e-3)).all()),
          f"{label}: kernel normals not unit")
    return nerr


def compare_surface_ad(k, p, hit, label):
    """Kernel vs plain K3 in AD mode on the same (t, hit): normals within
    1e-4 on >= 99.9% of hit lanes (both sum the same exp weights, in
    another order and with FMA; a lane on a CSG crease may pick the other
    operand), materials equal on >= 99.9%, code 0 on every lane.  Returns
    the largest error among the lanes within the bound and the number of
    hit lanes outside it."""
    nk, mk_, ck = k
    np_, mp, cp = p
    n_hit = max(int(hit.sum()), 1)
    err = (nk - np_).abs().amax(-1)
    close = hit & (err <= 1e-4)
    frac = int(close.sum()) / n_hit
    nerr = err[close].max().item() if close.any() else 0.0
    mfrac = int((hit & (mk_ == mp)).sum()) / n_hit
    log(f"  {label}: normals within 1e-4 on {frac:.6f} of {n_hit} hit "
        f"lanes (max there {nerr:.3e}, max anywhere "
        f"{err[hit].max().item() if hit.any() else 0.0:.3e}), material "
        f"agreement {mfrac:.6f}")
    check(frac >= 0.999, f"{label}: normal agreement {frac}")
    check(mfrac >= 0.999, f"{label}: material agreement {mfrac}")
    check(not bool(ck.any()) and not bool(cp.any()), f"{label}: code != 0")
    check(torch.equal(nk[~hit], np_[~hit])
          and bool((mk_[~hit] == -1).all()), f"{label}: miss lanes")
    check(bool(((~hit) | (nk.norm(dim=-1) - 1).abs().lt(1e-3)).all()),
          f"{label}: kernel normals not unit")
    return nerr, n_hit - int(close.sum())


def blend_nodes(n_tori):
    """The torus scene smooth-united (k = 0.25) with a sphere at the
    origin, as builder nodes: every hit lies on the blended root, the
    torus union stays a culled min group, the root is a sumexp group of
    one sphere plus a sub-plan."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.scene import generators as G
    base = G.torus_csg_scene(19, n_tori)
    return ft.Scene(
        root=ft.smooth_union(0.25, base.root, ft.sphere(
            (0, 0, 0), 1.5, material=ft.solid(0.8, 0.7, 0.3))),
        background=base.background, lights=base.lights)


def blend_scene(n_tori, dev):
    """``blend_nodes(n_tori)`` flattened on ``dev``."""
    import fraytracer_tpu_torch as ft
    return ft.flatten(blend_nodes(n_tori), dev)


def smooth_scenes(dev):
    """Plans with a smooth union: name -> (scene, camera z, cull threshold
    or None).  A sumexp group under intersect and subtract; a smooth union
    of sub-plans alone; a 64-torus sumexp group; 256 spheres intersected
    (a culled max group) beside a smooth union; the 96-torus blend (a
    culled min group under the smooth union)."""
    import fraytracer_tpu_torch as ft
    g = torch.Generator().manual_seed(5)
    smooth = ft.subtract(
        ft.intersect(ft.smooth_union(
            0.3, ft.sphere((0, 0, 0), 1.0, material=ft.solid(1, 0, 0)),
            ft.sphere((0.8, 0.3, 0), 0.7, material=ft.solid(0, 1, 0))),
            ft.sphere((0, 0, 0), 1.5)),
        ft.box((0.3, 0.5, -0.7), (0.4, 0.4, 0.4), 0.05))
    subplans = ft.smooth_union(
        0.3, ft.union(ft.sphere((0, 0, 0), 1.0, material=ft.solid(1, 0, 0)),
                      ft.sphere((0, 1.2, 0), 0.5,
                                material=ft.solid(0, 0, 1))),
        ft.intersect(ft.sphere((1, 0, 0), 1.0, material=ft.solid(0, 1, 0)),
                     ft.box((1, 0, 0), (0.7, 0.7, 0.7), 0.05)))
    c = ((torch.rand(64, 3, generator=g) - 0.5) * 5.0).tolist()
    a = (torch.rand(64, 3, generator=g) - 0.5).tolist()
    sumexp64 = ft.smooth_union(0.2, *[
        ft.torus(tuple(x), tuple(y), 0.5, 0.15,
                 material=ft.solid(0.1 + 0.01 * i, 0.5, 0.5))
        for i, (x, y) in enumerate(zip(c, a))])
    c = ((torch.rand(256, 3, generator=g) - 0.5) * 0.8).tolist()
    inter = ft.union(
        ft.intersect(*[ft.sphere(tuple(x), 2.0,
                                 material=ft.solid(0.2, 0.6, 0.9))
                       for x in c]),
        ft.smooth_union(0.3, ft.sphere((2.4, 0.0, 0.0), 0.7,
                                       material=ft.solid(0.9, 0.5, 0.1)),
                        ft.sphere((2.9, 0.5, 0.0), 0.5)))
    flat = lambda root: ft.flatten(ft.Scene(root=root), dev)
    return {"smooth_subtract": (flat(smooth), -5, None),
            "subplans": (flat(subplans), -5, None),
            "sumexp64": (flat(sumexp64), -8, None),
            "intersect_blend": (flat(inter), -6, 192),
            "blend96": (blend_scene(96, dev), -10, 48)}


def phase_ad_kernels(dev):
    """K3 in AD mode against its plain version on (t, hit) from K1, dense
    and (where a group is large enough) on candidate tables; and against
    the dense autograd normal and the dense material argmin at the same
    points: normals within 1e-3 and materials equal on >= 99.9% of hit
    lanes."""
    from fraytracer_tpu_torch.ops import sdf
    from fraytracer_tpu_torch.ops.cuda import march_kernel as mk
    for name, (scene, z, threshold) in smooth_scenes(dev).items():
        check(not mk.slot_surface_mode(scene.plan), f"{name}: slot mode")
        lanes, kw = primary_lanes(scene, 128, 30.0, dev, pos=(0, 0, z))
        forms = [("dense", None)]
        if threshold is not None:
            forms.append(("culled", culled_tables(scene, lanes, threshold,
                                                  512)))
        for form, tables in forms:
            k = mk.march_kernel(scene, **lanes, **kw, cull=tables)
            p = mk.march_plain(scene, **lanes, **kw, cull=tables)
            compare_march(k, p, f"K1 {form} {name} 128^2")
            hit = k[1]
            check(int(hit.sum()) > 100, f"{name}: {int(hit.sum())} hits")
            args = (lanes["origin"], lanes["direction"], k[0],
                    lanes["epsilon"], hit)
            nk, mk_, ck = mk.surface_kernel(scene, *args, cull=tables)
            compare_surface_ad(
                (nk, mk_, ck), mk.surface_plain(scene, *args, cull=tables),
                hit, f"K3 AD {form} {name}")
            pos = (args[0] + (args[2] - args[3])[:, None] * args[1])[hit]
            close = (nk[hit] - sdf.scene_normal(scene, pos)).abs() \
                .amax(-1) <= 1e-3
            mfrac = (mk_[hit] == sdf.material_index_at(scene, pos)) \
                .float().mean().item()
            log(f"  K3 AD {form} {name} vs dense autograd: normals within "
                f"1e-3 on {close.float().mean().item():.6f}, material "
                f"agreement {mfrac:.6f}")
            check(close.float().mean().item() >= 0.999,
                  f"K3 AD {form} {name}: dense normal")
            if len(scene.visible_material_slots()):
                check(mfrac >= 0.999, f"K3 AD {form} {name}: dense material")
    torch.cuda.synchronize()


def phase_sign_kernels(dev):
    """K1/K2 with a per-lane sign against the plain version: three rays
    starting inside a sphere (hit masks equal, t within 1e-4, the exit
    distances known), and a mixed-sign batch on the 96-torus scene, dense
    and culled (the K1 bounds; sign +1 lanes equal to the unsigned march,
    bit for bit in the dense form)."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops.cuda import march_kernel as mk
    from fraytracer_tpu_torch.scene import generators as G
    scene = ft.flatten(ft.Scene(root=ft.union(
        ft.sphere((0, 0, 0), 1.0, material=ft.solid(1, 1, 1)),
        ft.sphere((3, 0, 0), 0.5))), dev)
    lanes = dict(
        origin=torch.tensor([[0.0, 0, 0], [0.2, 0.1, -0.5], [0.0, 0, 0.9]],
                            device=dev),
        direction=torch.tensor([[0.0, 0, 1]] * 3, device=dev),
        length=torch.full((3,), 100.0, device=dev),
        epsilon=torch.full((3,), 1e-3, device=dev),
        t0=torch.zeros(3, device=dev))
    kw = dict(max_steps=128, omega=1.0, sign=-torch.ones(3, device=dev))
    k = mk.march_kernel(scene, **lanes, **kw)
    p = mk.march_plain(scene, **lanes, **kw)
    want = torch.tensor([1.0, 0.95 ** 0.5 + 0.5, 0.1], device=dev)
    err = (k[0] - p[0]).abs().max().item()
    log(f"  K1 sign=-1 inside rays: hits {k[1].tolist()}, t "
        f"{[round(x, 5) for x in k[0].tolist()]}, max |dt| vs plain "
        f"{err:.3e}")
    check(bool(k[1].all()) and torch.equal(k[1], p[1]), "sign: hit masks")
    check(err <= 1e-4, f"sign: t error {err}")
    check((k[0] - want).abs().max().item() <= 2e-3, "sign: exit distance")
    occ = mk.march_kernel(scene, **lanes, **kw, occlusion=True)
    check(torch.equal(occ[0], k[1]), "sign: K2 != K1")

    torus = ft.flatten(G.torus_csg_scene(19, 96), dev)
    lanes, kw = primary_lanes(torus, 256, 30.0, dev)
    g = torch.Generator().manual_seed(3)
    sign = torch.where(torch.rand(lanes["origin"].shape[0], generator=g)
                       < 0.5, -1.0, 1.0).to(dev)
    for form, tables in (("dense", None),
                         ("culled", culled_tables(torus, lanes, 48, 256))):
        skw = dict(kw, cull=tables, sign=sign)
        k = mk.march_kernel(torus, **lanes, **skw)
        compare_march(k, mk.march_plain(torus, **lanes, **skw),
                      f"K1 mixed sign {form} torus96 256^2")
        occ = mk.march_kernel(torus, **lanes, **skw, occlusion=True)
        check(torch.equal(occ[0], k[1]), f"sign {form}: K2 != K1")
        u = mk.march_kernel(torus, **lanes, **kw, cull=tables)
        # dense: bit for bit; culled: a warp's window follows its active
        # lanes, so the +1 lanes step otherwise and land within 3 eps
        out = (sign > 0) & u[1]
        check(torch.equal(k[1][sign > 0], u[1][sign > 0]),
              f"sign {form}: +1 lanes' hits differ from the unsigned march")
        dt = (k[0] - u[0]).abs()[out].max().item()
        check(dt <= (3 * EPS if tables is not None else 0.0),
              f"sign {form}: +1 lanes' t differ by {dt}")
    torch.cuda.synchronize()


def culled_tables(scene, lanes, threshold, m, apex=None):
    """The candidate tables cuda_march_raw builds for these lanes."""
    from fraytracer_tpu_torch.ops.cuda import cull
    pairs = cull._cull_pairs(scene.kind_counts, scene.plan, threshold)
    check(bool(pairs), "no culled pair")
    return cull.build_pair_tables(
        scene, lanes["origin"], lanes["direction"], lanes["t0"],
        lanes["length"], lanes["epsilon"], pairs, m, 0.125, apex)


def intersect_scene(dev):
    """256 fat spheres in one intersect: a culled max group."""
    import fraytracer_tpu_torch as ft
    g = torch.Generator().manual_seed(11)
    c = (torch.rand(256, 3, generator=g) - 0.5).tolist()
    mats = torch.rand(256, 3, generator=g).tolist()
    return ft.flatten(ft.Scene(root=ft.intersect(
        *[ft.sphere(tuple(x), 2.0, material=ft.solid(*m))
          for x, m in zip(c, mats)]), background=(0.1, 0.1, 0.1)),
        device=dev)


def phase_overbudget_pairs(dev, groups=5, per_group=1024):
    """Culled K1/K2 on a plan whose pairs exceed a block's shared memory
    (``groups`` intersections of ``per_group`` spheres, united: as many
    pairs of 50,688 bytes at 1024 rows): the wrapper stages the pairs that
    fit, in program order, the kernel reads the rest from device memory,
    in one launch; held against the plain version."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops.cuda import cull, march_kernel as mk
    g = torch.Generator().manual_seed(23)
    parts = []
    for i in range(groups):
        cx = (i - (groups - 1) / 2) * 2.0
        c = (torch.rand(per_group, 3, generator=g) - 0.5) * 0.4
        parts.append(ft.intersect(*[
            ft.sphere((cx + float(x), float(y), float(z)), 0.9,
                      material=ft.solid(0.2 + 0.1 * i, 0.5, 0.5))
            for x, y, z in c.tolist()]))
    scene = ft.flatten(ft.Scene(root=ft.union(*parts)), device=dev)
    lanes, kw = primary_lanes(scene, 64, 30.0, dev)
    tables = culled_tables(scene, lanes, per_group // 2, per_group)
    prog = mk.lower_program(scene, dev, tables.pairs)
    plan = mk.march_stage_plan(prog, tables)
    log(f"  [stage] {len(tables.tables)} pairs of m "
        f"{[q.m for q in tables.tables]}: {cull.pair_stage_bytes(per_group)}"
        f" bytes a pair, limit {cull.SMEM_LIMIT}: staged {plan.staged}, "
        f"{plan.bytes} bytes of shared memory a block (above 48 KB: the "
        "opt-in), the rest read from device memory")
    check(any(plan.staged) and not all(plan.staged),
          f"the plan does not split: {plan.staged}")
    k = mk.march_kernel(scene, **lanes, **kw, cull=tables)
    check(int(k[1].sum()) > 100, f"overbudget: {int(k[1].sum())} hits")
    compare_march(k, mk.march_plain(scene, **lanes, **kw, cull=tables),
                  f"K1 culled, staged + unstaged pairs {plan.staged}")
    occ = mk.march_kernel(scene, **lanes, **kw, cull=tables, occlusion=True)
    check(torch.equal(occ[0], k[1]), "overbudget: K2 != K1")
    torch.cuda.synchronize()


def phase_dense_unstaged(dev, n_tori=8000, size=64):
    """Dense K1/K2/K3 on a scene whose packed rows exceed a block's shared
    memory (``n_tori`` tori: 32 bytes a row): the plan reads them from
    device memory through the same code (K3 still stages each entry's
    material and slot); against the plain versions."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops.cuda import cull, march_kernel as mk
    from fraytracer_tpu_torch.scene import generators as G
    scene = ft.flatten(G.torus_csg_scene(19, n_tori), device=dev)
    prog = mk.lower_program(scene, dev)
    plan = mk.march_stage_plan(prog, None)
    splan = mk.surface_stage_plan(prog, None)
    log(f"  [stage] dense {scene.num_prims} entries: packed rows "
        f"{plan.rows_bytes} bytes, limit {cull.SMEM_LIMIT}: staged "
        f"{plan.staged} (K1/K2 {plan.bytes} bytes a block, K3 "
        f"{splan.bytes} with (material, slot) staged {splan.ms_off >= 0})")
    check(not plan.staged and not splan.staged,
          f"{scene.num_prims} dense entries staged")
    lanes, kw = primary_lanes(scene, size, 30.0, dev)
    k = mk.march_kernel(scene, **lanes, **kw)
    check(int(k[1].sum()) > 500, f"unstaged: {int(k[1].sum())} hits")
    compare_march(k, mk.march_plain(scene, **lanes, **kw),
                  f"K1 dense, {scene.num_prims} entries unstaged {size}^2")
    occ = mk.march_kernel(scene, **lanes, **kw, occlusion=True)
    check(torch.equal(occ[0], k[1]), "unstaged: K2 != K1")
    args = (lanes["origin"], lanes["direction"], k[0], lanes["epsilon"],
            k[1])
    compare_surface(mk.surface_kernel(scene, *args),
                    mk.surface_plain(scene, *args), k[1],
                    f"K3 dense, {scene.num_prims} entries unstaged")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# [cull]: the table build's kernels (csrc/cull.cu) against the plain build
# ---------------------------------------------------------------------------

def load_test(name):
    """The module ``tests/<name>.py`` loaded by path (for the checks the
    card tests share with this script)."""
    import importlib.util
    path = Path(__file__).resolve().parent / "tests" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_sites(fn):
    """The arguments of each culled site's table build in ``fn()``, in
    order (a spy on the march's ``build_pair_tables``)."""
    from fraytracer_tpu_torch.ops.cuda import march_kernel as mk
    real, sites = mk.build_pair_tables, []

    def spy(*args):
        sites.append(args)
        return real(*args)
    mk.build_pair_tables = spy
    try:
        fn()
    finally:
        mk.build_pair_tables = real
    return sites


def table_bytes(args, tables) -> int:
    """Bytes a site's table build has to move: each lane's origin,
    direction, t0, length and epsilon read once, its oa / ca and the cones
    written; each pair's rows read once and its tables written."""
    from fraytracer_tpu_torch.ops.cuda import cull_kernel as ck
    from fraytracer_tpu_torch.scene.flatten import PARAM_WIDTH
    grid = -(-args[1].shape[0] // 1024)
    b = nbytes(*args[1:6], tables.oa, tables.ca) + grid * ck.CONES \
        * ck.CONE_W * 4
    for q in tables.tables:
        b += (q.row_hi - q.row_lo) * (PARAM_WIDTH[q.kind] + 2) * 4
        b += nbytes(q.idx, q.count, q.table, q.keys, q.misc, q.hsuf)
    return b


def phase_cull(dev):
    """The table build at the three sites of the 1024² / 1000-torus frame
    (primary rays, the directional and the point light's shadow rays) and
    at a bounce site of the 512² spectral frame (m 1000, ``sign`` lanes):
    the kernels' tables checked against the plain build's as the card
    tests check them, one cones and one select launch a site, device ms
    of the kernels (the cones launch alone beside them), of the plain
    build, and the bytes-from-shapes bound."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops import cuda as ops_cuda
    from fraytracer_tpu_torch.ops.cuda import cull, cull_kernel as ck
    from fraytracer_tpu_torch.ops.wavefront import _spectral_frame
    from fraytracer_tpu_torch.scene.generators import spectral_csg_scene, \
        torus_csg_scene
    tt = load_test("test_torch_cull_cuda")
    device_ms = device_timer()
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    scene = ft.flatten(torus_csg_scene(19, BENCH_N_TORI), device=dev)
    frame = build_sites(lambda: eager_frame(scene, cam, bench_config(SIZE)))
    check(len(frame) == 3, f"[cull] {len(frame)} sites in the frame")
    sscene = ft.flatten(spectral_csg_scene(19, BENCH_N_TORI), device=dev)
    spectral = build_sites(lambda: _spectral_frame(
        sscene, cam, SPECTRAL_SIZE, SPECTRAL_SIZE, spectral_config()))
    bounce = spectral[1 + sscene.num_lights]    # round 1's march
    sites = list(zip(("primary", "light0", "light1"), frame)) + \
        [("spectral_bounce", bounce)]
    out = {}
    for label, args in sites:
        ops_cuda.reset_launch_counts()
        got = cull.build_pair_tables(*args)
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops_cuda.launch_counts().items() if v}
        check(counts == {"cull_cones": 1, "cull_select": 1},
              f"[cull] {label}: launches {counts}")
        # the cones within 1e-5 of the plain build's, the tables exactly
        # the plain build's on the kernel's cones (the lane sums' order
        # moves a member lying on its test's boundary), and the members
        # the plain cones move counted
        try:
            cones = tt.assert_cones_close(args[1:6], args[9])
            tt.assert_tables_match(args[0], args[1:6], args[9], got,
                                   tt.plain_tables(args, cones))
        except AssertionError as e:
            check(False, f"[cull] {label}: tables differ from the plain "
                  f"build's: {e!r}")
        want = cull.build_pair_tables_plain(*args)
        moved = sum(int((q.count - w.count).abs().sum())
                    for q, w in zip(got.tables, want.tables))
        moved_tiles = sum(int((q.count != w.count).sum())
                          for q, w in zip(got.tables, want.tables))
        ms = device_ms(lambda: cull.build_pair_tables(*args))
        cones_ms = device_ms(lambda: ck.tile_cones(*args[1:6], args[9]))
        plain_ms = device_ms(lambda: cull.build_pair_tables_plain(*args),
                             reps=10)
        b = table_bytes(args, got)
        q = got.tables[0]
        counts_f = q.count.float()
        r = {"ms": ms, "cones_ms": cones_ms, "plain_ms": plain_ms,
             "bound_ms": b / PEAK_BYTES_S * 1e3, "bytes": b,
             "lanes": args[1].shape[0], "m": [t.m for t in got.tables],
             "group": [t.row_hi - t.row_lo for t in got.tables],
             "candidates_max": int(q.count.max()),
             "candidates_mean": float(counts_f.mean()),
             "overflow": None if got.overflow is None
             else bool(got.overflow),
             "moved_by_plain_cones": moved, "tiles_moved": moved_tiles,
             "tests": 4 * sum(t.count.numel() * (t.row_hi - t.row_lo)
                              for t in got.tables)}
        out[label] = r
        log(f"  [cull] {label}: {r['lanes']} lanes, m {r['m']} of "
            f"{r['group']}, candidates max {r['candidates_max']} mean "
            f"{r['candidates_mean']:.1f}: kernels {ms:.4f} ms (cones "
            f"{cones_ms:.4f}), plain {plain_ms:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({b} bytes, "
            f"{100 * r['bound_ms'] / ms:.1f} % of the roofline); tables "
            "the plain build's on the kernel's cones; the plain cones move "
            f"{moved} members' candidacy in {moved_tiles} tiles "
            f"({r['tests']} tests)")
    frame_ms = sum(out[k]["ms"] for k in ("primary", "light0", "light1"))
    frame_plain = sum(out[k]["plain_ms"] for k in ("primary", "light0",
                                                    "light1"))
    log(f"  [cull] the frame's three sites: kernels {frame_ms:.4f} ms, "
        f"plain {frame_plain:.3f} ms ({nvidia_smi()})")
    return out



# ---------------------------------------------------------------------------
# [scatter]: the row scatter's kernel (csrc/scatter.cu) against index_add_
# ---------------------------------------------------------------------------

def step_scatters(fn):
    """The gradient, rows, axis and table shape of each row scatter that
    ``fn()``'s backward runs, in order (a spy on ``scatter.scatter_rows``,
    which ``scatter._ScatterRows`` calls)."""
    from fraytracer_tpu_torch.ops.cuda import scatter
    real, calls = scatter.scatter_rows, []

    def spy(grad, idx, dim, shape):
        calls.append((grad.detach().clone(), idx.clone(), dim, tuple(shape)))
        return real(grad, idx, dim, shape)
    scatter.scatter_rows = spy
    try:
        fn()
    finally:
        scatter.scatter_rows = real
    return calls


def phase_scatter(dev):
    """The row scatters of one eager 1024² step of the 1000-torus scene
    (the bench's loss), their gradients and rows taken as the backward
    hands them over: each checked on the kernel against ``index_add_`` on
    the gradient in float64 as the card tests check it, within 1e-5 of the
    table's largest entry with its one launch counted on the path its
    table's bytes give (``tests/test_torch_scatter_cuda.py::_check``);
    device ms of the kernel, of the plain version (a float32
    ``index_add_``) and the bytes-from-shapes bound; both sums' distance
    from the float64 one."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops.cuda import scatter
    from fraytracer_tpu_torch.scene.generators import torus_csg_scene
    tt = load_test("test_torch_scatter_cuda")
    device_ms = device_timer()
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    scene = ft.flatten(torus_csg_scene(19, BENCH_N_TORI), device=dev)
    calls = step_scatters(lambda: eager_step(scene, cam, bench_config(SIZE)))
    check(len(calls) == STEP_SCATTERS["culled"],
          f"[scatter] {len(calls)} scatters in the step, want "
          f"{STEP_SCATTERS['culled']}")
    out = {}
    for i, (g, idx, dim, shape) in enumerate(calls):
        label = f"{i}:" + "x".join(map(str, shape))
        path = scatter.scatter_path(shape)
        check(path == "smem", f"[scatter] {label}: path {path}")
        try:
            got, _want = tt._check(g, idx, dim, shape, path)
        except AssertionError as e:
            check(False, f"[scatter] {label}: the kernel's table against "
                  f"index_add_ in float64: {e!r}")
        want = torch.zeros(shape, dtype=torch.float64, device=dev) \
            .index_add_(dim, idx, g.double())
        scale = float(want.abs().max())
        plain = scatter.scatter_rows_plain(g, idx, dim, shape)
        live = g.movedim(dim, 0).reshape(idx.shape[0], -1).ne(0).any(1)
        ms = device_ms(lambda: scatter.scatter_rows(g, idx, dim, shape))
        plain_ms = device_ms(
            lambda: scatter.scatter_rows_plain(g, idx, dim, shape), reps=10)
        b = nbytes(g, idx) + 4 * torch.Size(shape).numel()
        r = {"shape": list(shape), "dim": dim, "lanes": idx.shape[0],
             "live_lanes": int(live.sum()),
             "rows": int(idx[live].unique().numel()), "path": path,
             "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b / PEAK_BYTES_S * 1e3, "bytes": b,
             "err": float((got.double() - want).abs().max()) / scale,
             "plain_err": float((plain.double() - want).abs().max())
             / scale}
        out[label] = r
        log(f"  [scatter] {label} along {dim}: {r['lanes']} lanes, "
            f"{r['live_lanes']} with a gradient on {r['rows']} rows, path "
            f"{path}: kernel {ms:.4f} ms, index_add_ {plain_ms:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({b} bytes, "
            f"{100 * r['bound_ms'] / ms:.1f} % of the roofline); from the "
            f"float64 sum, of the largest entry: kernel {r['err']:.2e}, "
            f"index_add_ {r['plain_err']:.2e}")
    step = {k: sum(r[k] for r in out.values())
            for k in ("ms", "plain_ms", "bound_ms")}
    out["step"] = step
    log(f"  [scatter] the step's {len(calls)} scatters: kernel "
        f"{step['ms']:.4f} ms, index_add_ {step['plain_ms']:.3f} ms, bound "
        f"{step['bound_ms']:.4f} ms ({nvidia_smi()})")
    return out


def scatter_process():
    """The ``[scatter]`` phase in a process of its own (``--scatter-only``),
    its lines echoed and its readings returned.  Run in this process
    before ``[graph]``, it was followed there by profiled frames short of
    device records (the profiler returned 162 and 218 of 316 and 338 ops,
    in two runs on the H100, and none short without it); the phases after
    it see nothing of a process of its own."""
    here = Path(__file__).resolve()
    proc = subprocess.run([sys.executable, str(here), "--scatter-only"],
                          capture_output=True, text=True, timeout=600,
                          cwd=str(here.parent))
    for line in proc.stdout.splitlines():
        if line.startswith("  [scatter]"):
            log(line)
    check(proc.returncode == 0, f"[scatter] exited {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    lines = [l for l in proc.stdout.splitlines()
             if l.startswith('{"scatter"')]
    check(len(lines) == 1, f"[scatter] printed {len(lines)} JSON lines")
    return json.loads(lines[0])["scatter"]

def phase_culled_kernels(dev):
    """Culled K1/K2/K3 against their plain versions on the same tables."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops.cuda import march_kernel as mk
    from fraytracer_tpu_torch.scene import generators as G
    torus = ft.flatten(G.torus_csg_scene(19, 96), dev)
    inter = intersect_scene(dev)
    cases = []
    lanes, kw = primary_lanes(torus, 256, 30.0, dev)
    cases.append(("torus96 256^2", torus, lanes, culled_tables(
        torus, lanes, 48, 256), True))
    # the scene's point light (light 1) from the primary hits
    plan, apex, _f = shadow_lanes(torus, lanes,
                                  mk.march_kernel(torus, **lanes, **kw), 1)
    cases.append(("torus96 point light", torus, plan, culled_tables(
        torus, plan, 48, 512, apex), False))
    lanes, kw = primary_lanes(inter, 256, 30.0, dev, pos=(0, 0, -6))
    cases.append(("intersect256 256^2", inter, lanes, culled_tables(
        inter, lanes, 192, 512), True))
    for label, scene, lanes, tables, surface in cases:
        counts = [int(q.count.max()) for q in tables.tables]
        for eo in (False, True):
            tables.early_out = eo
            k = mk.march_kernel(scene, **lanes, **kw, cull=tables)
            p = mk.march_plain(scene, **lanes, **kw, cull=tables)
            compare_march(k, p, f"K1 culled {label} (max count {counts}, "
                          f"early-out {eo})")
        tables.early_out = False
        ok_ = mk.march_kernel(scene, **lanes, **kw, occlusion=True,
                              cull=tables)
        op_ = mk.march_plain(scene, **lanes, **kw, occlusion=True,
                             cull=tables)
        agree = (ok_[0] == op_[0]).float().mean().item()
        log(f"  K2 culled {label}: hit agreement {agree:.6f}, occlusion "
            f"== march {bool(torch.equal(ok_[0], k[1]))}")
        check(agree >= 0.999, f"K2 culled {label}: {agree}")
        check(torch.equal(ok_[0], k[1]), f"K2 culled {label}: != march")
        if surface:
            args = (lanes["origin"], lanes["direction"], k[0],
                    lanes["epsilon"], k[1])
            compare_surface(mk.surface_kernel(scene, *args, cull=tables),
                            mk.surface_plain(scene, *args, cull=tables),
                            k[1], f"K3 culled {label}")
    torch.cuda.synchronize()


def phase_kernels(dev):
    from fraytracer_tpu_torch.ops.cuda import march_kernel as mk
    from fraytracer_tpu_torch.ops.cuda.gather import (
        BLOCK, block_gather, block_gather_plain, flat_block_gather)

    # K4: exact on random blocks, repeats and a different output count
    g = torch.Generator(device="cpu").manual_seed(0)
    xf = torch.randn(16, 8, 128, generator=g).to(dev)
    xi = torch.randint(-1000, 1000, (16, 8, 128), generator=g,
                       dtype=torch.int32).to(dev)
    for idx in ([3, 3, 0, 15, 7], list(range(15, -1, -1)) + [2, 2, 9]):
        it = torch.tensor(idx, dtype=torch.int32, device=dev)
        for x in (xf, xi):
            check(torch.equal(block_gather(x, it),
                              block_gather_plain(x, it)), "K4 mismatch")
    pay = torch.randn(4 * BLOCK, 3, generator=g).to(dev)
    it = torch.tensor([2, 0, 1], dtype=torch.int32, device=dev)
    check(torch.equal(flat_block_gather(pay, it, 3),
                      pay.reshape(4, -1)[it.long()].reshape(-1, 3)),
          "K4 [N, 3] mismatch")
    # blocks that are not whole 256-word thread blocks (25 and 275
    # 16-byte words), out-of-range indices (zeros), and 4096 blocks
    from fraytracer_tpu_torch.ops.cuda.gather import _gather_blocks
    for floats, nb in ((100, 7), (1100, 7), (1024, 4096)):
        x = torch.randn(nb, floats, generator=g).to(dev)
        it = torch.randint(-2, nb + 2, (nb + 3,), generator=g,
                           dtype=torch.int32).to(dev)
        check(torch.equal(_gather_blocks(x, it), block_gather_plain(x, it)),
              f"K4 mismatch at blocks of {floats} floats x {nb}")
    log("  K4 block gather: exact on float32/int32, repeats, Bo != B, "
        "[N,3], ragged words, out-of-range indices, 4096 blocks")

    for name, (scene, size, length) in scenes(dev).items():
        lanes, kw = primary_lanes(scene, size, length, dev)
        k = mk.march_kernel(scene, **lanes, **kw)
        p = mk.march_plain(scene, **lanes, **kw)
        compare_march(k, p, f"K1 {name} {size}^2")
        ok_ = mk.march_kernel(scene, **lanes, **kw, occlusion=True)
        op_ = mk.march_plain(scene, **lanes, **kw, occlusion=True)
        agree = (ok_[0] == op_[0]).float().mean().item()
        log(f"  K2 {name}: hit agreement {agree:.6f}, occlusion == march "
            f"{bool(torch.equal(ok_[0], k[1]))}")
        check(agree >= 0.999, f"K2 {name}: {agree}")
        check(torch.equal(ok_[0], k[1]), f"K2 {name}: occlusion != march")
        args = (lanes["origin"], lanes["direction"], k[0],
                lanes["epsilon"], k[1])
        compare = compare_surface if mk.slot_surface_mode(scene.plan) \
            else compare_surface_ad
        compare(mk.surface_kernel(scene, *args),
                mk.surface_plain(scene, *args), k[1], f"K3 {name}")
    torch.cuda.synchronize()


def lane_efficiency(steps):
    """Useful ray evaluations over the evaluations the warps issue: a warp
    of 32 consecutive lanes steps as long as its slowest lane."""
    per_warp = steps[: steps.numel() // 32 * 32].view(-1, 32)
    issued = 32 * int(per_warp.amax(1).sum())
    return int(per_warp.sum()) / max(issued, 1)


def surface_lanes_stats(hit):
    """How K3's lanes fall into blocks of 128 (the kernel's block, FT_BLOCK):
    the hit count, the blocks holding a hit, and two lane efficiencies —
    hits over the lanes of the warps that hold a hit (a grid of one thread
    a lane, as before the compaction) and over the lanes of the ceil(hits
    / 32) warps a block runs once it lists its hits."""
    n = hit.numel()
    h = torch.nn.functional.pad(hit.to(torch.int64), (0, (-n) % 128))
    per_warp = h.view(-1, 32).sum(1)
    per_block = h.view(-1, 128).sum(1)
    hits = int(per_block.sum())
    return {"hits": hits, "blocks_with_hit": int((per_block > 0).sum()),
            "blocks": per_block.numel(),
            "lane_efficiency_grid": hits / max(32 * int((per_warp > 0).sum()),
                                               1),
            "lane_efficiency_compacted": hits / max(
                32 * int(((per_block + 31) // 32).sum()), 1)}


def digest(*tensors) -> str:
    """A hash of the tensors' bytes: equal outputs of two trees."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def surface_yardstick(name, scene, lanes, kw, tabs, device_ms, dump,
                      dense=False):
    """K3 culled (or, ``dense``, the dense form) on the culled K1's hits of
    ``lanes`` — inputs both trees of a ``--compare`` compute bit for bit
    alike: its device time, how its lanes fall into blocks
    (:func:`surface_lanes_stats`) and a digest of (normal, material,
    code), for ``--kernels-only``; the outputs go into ``dump[name]``."""
    from fraytracer_tpu_torch.ops.cuda import march_kernel as mk
    k = mk.march_kernel(scene, **lanes, **kw, cull=tabs)
    args = (lanes["origin"], lanes["direction"], k[0], lanes["epsilon"],
            k[1])
    cull = None if dense else tabs
    out = mk.surface_kernel(scene, *args, cull=cull)
    dump[name] = [x.cpu() for x in out]
    rec = {f"{name}_ms": device_ms(
        lambda: mk.surface_kernel(scene, *args, cull=cull))}
    rec.update({f"{name}_{key}": v
                for key, v in surface_lanes_stats(k[1]).items()})
    rec[f"{name}_march_digest"] = digest(k[0], k[1])
    rec[f"{name}_digest"] = digest(*out)
    return rec


def gather_bench_inputs(pos, dev):
    """K4 at the block tier's shape: 16 blocks of the frame's ``[N, 3]``
    points ``pos`` (12 KB each); returns the block view, the int32 block
    indices and their int64 form for the library's ``x[idx]``."""
    from fraytracer_tpu_torch.ops.cuda.gather import BLOCK
    xb = pos.contiguous().reshape(-1, BLOCK * 3)
    bidx = torch.arange(0, 16 * 37, 37, dtype=torch.int32, device=dev)
    return xb, bidx, bidx.long()


def dense_lane_stats(mk, scene, lanes, kw, steps):
    """Ray evaluations and lane efficiency of a dense K1/K2 launch: the
    evaluations over the evaluations its warps issued (32 a warp
    iteration, the kernel's own count under lane refill, read in a launch
    of its own); for a tree whose dense kernel does not count them (fixed
    lanes, before refill) the 32-consecutive-lanes formula."""
    import inspect
    evals = int(steps.sum())
    rec = {"ray_evaluations": evals, "issued_evaluations": None}
    if "issued" in inspect.signature(mk.march_kernel).parameters:
        buf = torch.zeros(1, dtype=torch.int64, device=steps.device)
        mk.march_kernel(scene, **lanes, **kw, issued=buf)
        rec["issued_evaluations"] = 32 * int(buf)
        rec["lane_efficiency"] = evals / max(rec["issued_evaluations"], 1)
    else:
        rec["lane_efficiency"] = lane_efficiency(steps)
    return rec


def dense_shadow_lanes(scene, lanes, k):
    """The dense frame's shadow batches of K1's hits ``k``: one
    ``(lanes, facing)`` a light, each after the root-bound skip (the
    dense form takes no cone apex)."""
    return [shadow_lanes(scene, lanes, k, light)[::2]
            for light in range(scene.num_lights)]


def phase_kernel_times(dev, bench_scene):
    """Each kernel beside its plain version at the main path's shapes
    (1024² primary rays on the 1000-torus scene): dense K1, dense K2 of
    both lights on the dense frame's shadow batches, dense K3 on K1's
    hits, each read on the device (``device_ms``) with the reading around
    one host call beside it; then K4."""
    from fraytracer_tpu_torch.ops.cuda import march_kernel as mk
    from fraytracer_tpu_torch.ops.cuda.gather import (
        _gather_blocks, block_gather_plain)
    out = {}
    device_ms = device_timer()
    lanes, kw = primary_lanes(bench_scene, SIZE, 30.0, dev)
    plan = mk.march_stage_plan(mk.lower_program(bench_scene, dev), None)
    log(f"  [stage] dense K1/K2 bench: {plan.bytes} bytes of shared memory "
        f"a block, packed rows {plan.rows_bytes} bytes staged "
        f"{plan.staged}; K3: "
        f"{mk.surface_stage_plan(mk.lower_program(bench_scene, dev), None)}")
    k = mk.march_kernel(bench_scene, **lanes, **kw)
    call = lambda: mk.march_kernel(bench_scene, **lanes, **kw)
    ms, host_call = device_ms(call, reps=10), cuda_ms(call)
    p, plain_ms = host_ms(lambda: mk.march_plain(bench_scene, **lanes,
                                                 **kw))
    err = compare_march(k, p, f"K1 bench {SIZE}^2")
    stats = dense_lane_stats(mk, bench_scene, lanes, kw, k[3])
    out["march"] = timing(ms, plain_ms, err, int((k[1] != p[1]).sum()),
                          k[1].numel(), march_bound(bench_scene, lanes, k),
                          host_call_ms=host_call, **stats)
    log(f"  K1 bench: {stats['ray_evaluations']} ray evaluations "
        f"({stats['ray_evaluations'] / k[3].numel():.2f} per ray), "
        f"{stats['ray_evaluations'] * bench_scene.num_prims / (ms * 1e-3):.4g}"
        f" primitive evaluations/s, lane efficiency "
        f"{stats['lane_efficiency']:.4f} ({stats['issued_evaluations']} "
        f"issued; fixed lanes would read {lane_efficiency(k[3]):.4f})")

    # K2 on the frame's shadow batches (facing lanes), both lights
    hitk = k[1]
    pos = lanes["origin"] + (k[0] - lanes["epsilon"])[:, None] \
        * lanes["direction"]
    for light, (slanes, facing) in enumerate(
            dense_shadow_lanes(bench_scene, lanes, k)):
        okw = dict(kw, occlusion=True)
        ok_ = mk.march_kernel(bench_scene, **slanes, **okw)
        call = lambda: mk.march_kernel(bench_scene, **slanes, **okw)
        ms, host_call = device_ms(call, reps=10), cuda_ms(call)
        op_, plain_ms = host_ms(lambda: mk.march_plain(bench_scene,
                                                       **slanes, **okw))
        flips = int((ok_[0] != op_[0]).sum())
        agree = 1.0 - flips / ok_[0].numel()
        stats = dense_lane_stats(mk, bench_scene, slanes, okw, ok_[1])
        log(f"  K2 bench light {light}: {int(facing.sum())} facing, "
            f"{flips} flips ({agree:.6f} agreement), "
            f"{stats['ray_evaluations']} ray evaluations, lane efficiency "
            f"{stats['lane_efficiency']:.4f} (fixed lanes "
            f"{lane_efficiency(ok_[1]):.4f}), {ms:.4f} ms on the device "
            f"({host_call:.4f} around a host call)")
        check(agree >= 0.999, f"K2 bench light {light} agreement {agree}")
        if light == 0:
            # max |hit_kernel - hit_plain| over the boolean output
            out["occlusion"] = timing(ms, plain_ms, float(flips > 0), flips,
                                      ok_[0].numel(),
                                      march_bound(bench_scene, slanes, ok_),
                                      host_call_ms=host_call, **stats)
        else:
            b = march_bound(bench_scene, slanes, ok_)
            out["occlusion"].update({
                f"ms_light{light}": ms,
                f"host_call_ms_light{light}": host_call,
                f"plain_ms_light{light}": plain_ms,
                f"bound_ms_light{light}": b[0],
                f"lane_efficiency_light{light}": stats["lane_efficiency"],
                f"ray_evaluations_light{light}": stats["ray_evaluations"]})

    # K3 on the frame's primary hits (same inputs to both)
    args = (lanes["origin"], lanes["direction"], k[0], lanes["epsilon"], hitk)
    kk = mk.surface_kernel(bench_scene, *args)
    call = lambda: mk.surface_kernel(bench_scene, *args)
    ms, host_call = device_ms(call), cuda_ms(call)
    pp, plain_ms = host_ms(lambda: mk.surface_plain(bench_scene, *args))
    err = compare_surface(kk, pp, hitk, f"K3 bench {SIZE}^2")
    out["surface"] = timing(ms, plain_ms, err,
                            int((hitk & (kk[2] != pp[2])).sum()),
                            int(hitk.sum()),
                            surface_bound(bench_scene, args, kk),
                            host_call_ms=host_call)

    # K4 at the block tier's shape: 16 blocks of the frame's [N, 3] points.
    # "ms", "plain_ms", "library_ms": device times (device_ms); the
    # *host_call_ms beside them: an event pair around one host call, which
    # at 192 KB reads the host's launch path
    xb, bidx, lidx = gather_bench_inputs(pos, dev)
    gk = _gather_blocks(xb, bidx)
    gp = block_gather_plain(xb, bidx)
    err = (gk - gp).abs().max().item()
    check(err == 0.0, "K4 bench mismatch")
    # the one PyTorch call that computes the same function: an
    # advanced-index gather of the same blocks (timed here, used nowhere)
    check(torch.equal(xb[lidx], gk), "K4 library gather mismatch")
    calls = {"": lambda: _gather_blocks(xb, bidx),
             "plain_": lambda: block_gather_plain(xb, bidx),
             "library_": lambda: xb[lidx]}
    dev_ms = {k: device_ms(fn) for k, fn in calls.items()}
    out["block_gather"] = timing(
        dev_ms[""], dev_ms["plain_"], err, int((gk != gp).sum()), gk.numel(),
        bound(2 * nbytes(gk) + nbytes(bidx), 0.0), dev_ms["library_"],
        **{k + "host_call_ms": cuda_ms(fn, reps=20)
           for k, fn in calls.items()})
    r = out["block_gather"]
    log(f"  K4 device ms / ms around a host call: kernel {r['ms']:.5f} / "
        f"{r['host_call_ms']:.5f}, plain {r['plain_ms']:.5f} / "
        f"{r['plain_host_call_ms']:.5f}, library x[idx] "
        f"{r['library_ms']:.5f} / {r['library_host_call_ms']:.5f}")
    log_times(out)
    return out


def parts_scene(dev, seed=19):
    """The benchmark's 1,000 machined parts
    (``benchmark/configs/parts1000.json``, ``benchmark/parts.py``) in
    ``seed``'s order."""
    from benchmark import parts
    spec = json.loads((Path(__file__).resolve().parent / "benchmark"
                       / "configs" / "parts1000.json").read_text())
    return parts.port_scene(parts.draw(spec, seed), dev)


def parts_dense_times(dev):
    """Dense K1 on the 1024² primary rays of the 1,000 machined parts and
    dense K2 of both lights on its shadow batches (the program the
    ``parts1000.frame`` cell marches): device ms (CUDA events around a
    launch, median of 3 after one: a launch runs for hundreds of ms), lane
    efficiency under refill, the block's threads and blocks an SM as
    ``dense_counts()`` reads them after the launch (None where the tree
    keeps no such count; else one block of 768 threads an SM, which the
    176 KB stage leaves room for), output digests; then each launch's
    outputs on every 16th ray against the plain version (K1 as
    :func:`compare_march`, K2's hit flags on >= 99.9% of the rays)."""
    from fraytracer_tpu_torch.ops import cuda as ops_cuda
    from fraytracer_tpu_torch.ops.cuda import march_kernel as mk
    scene = parts_scene(dev)
    lanes, kw = primary_lanes(scene, SIZE, 30.0, dev)
    plan = mk.march_stage_plan(mk.lower_program(scene, dev), None)
    out = {"parts_leaves": scene.num_prims, "parts_stage_bytes": plan.bytes,
           "parts_rows_staged": plan.staged}
    k = mk.march_kernel(scene, **lanes, **kw)
    okw = dict(kw, occlusion=True)
    batches = [("march_dense_parts", lanes, kw, k)] + [
        (f"occlusion_dense_parts_light{light}", sl, okw,
         mk.march_kernel(scene, **sl, **okw))
        for light, (sl, _f) in enumerate(dense_shadow_lanes(scene, lanes,
                                                            k))]
    for name, ln, lkw, o in batches:
        out[name + "_ms"] = cuda_ms(
            lambda: mk.march_kernel(scene, **ln, **lkw), reps=3)
        counts = ops_cuda.dense_counts()
        out[name + "_threads"] = counts.get("march_threads")
        out[name + "_blocks_per_sm"] = counts.get("march_blocks_per_sm")
        if out[name + "_threads"] is not None:
            check((out[name + "_threads"], out[name + "_blocks_per_sm"])
                  == (768, 1), f"{name}: dense K1/K2 launched "
                  f"{out[name + '_threads']} threads x "
                  f"{out[name + '_blocks_per_sm']} blocks an SM")
        out.update({f"{name}_{key}": v for key, v in dense_lane_stats(
            mk, scene, ln, lkw, o[-1]).items()})
        out[name + "_digest"] = digest(*o)
        log(f"  [parts] {name}: {out[name + '_ms']:.3f} ms, "
            f"{out[name + '_threads']} threads x "
            f"{out[name + '_blocks_per_sm']} blocks an SM, lane efficiency "
            f"{out[name + '_lane_efficiency']:.4f}")
    out["parts_dense_ms"] = sum(out[b[0] + "_ms"] for b in batches)
    every = slice(None, None, 16)
    for name, ln, lkw, o in batches:
        p = mk.march_plain(scene, **{a: v[every].contiguous()
                                     for a, v in ln.items()}, **lkw)
        o = tuple(x[every] for x in o)
        if lkw.get("occlusion"):
            agree = (o[0] == p[0]).float().mean().item()
            log(f"  [parts] {name} every 16th ray: hit agreement "
                f"{agree:.6f} with the plain version")
            check(agree >= 0.999, f"{name}: hit agreement {agree}")
            out[name + "_plain_agreement"] = agree
        else:
            out[name + "_plain_t_error"] = compare_march(
                o, p, f"[parts] {name} every 16th ray")
    return out


def host_ms(fn):
    """One host-timed call of ``fn`` (ms), ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def shadow_lanes(scene, lanes, k, light):
    """The frame's shadow batch of light ``light`` from K1's hits (facing
    lanes only), after the root-bound skip; and the light's cone apex."""
    from fraytracer_tpu_torch.ops import shade
    from fraytracer_tpu_torch.ops.cuda import march_kernel as mk
    from fraytracer_tpu_torch.ops.march import bound_skip_start
    from fraytracer_tpu_torch.scene.nodes import LIGHT_POINT
    from fraytracer_tpu_torch.types import Rays
    pos = lanes["origin"] + (k[0] - lanes["epsilon"])[:, None] \
        * lanes["direction"]
    normal, _m, _c = mk.surface_kernel(scene, lanes["origin"],
                                       lanes["direction"], k[0],
                                       lanes["epsilon"], k[1])
    ldir, budget, _s = shade.light_dir_and_dist(scene, light, pos)
    facing = k[1] & ((normal * ldir).sum(-1) > 0)
    srays = Rays(origin=pos.contiguous(), direction=ldir.contiguous(),
                 length=torch.where(facing, budget, 0.0),
                 epsilon=lanes["epsilon"])
    st0, smiss, sexit = bound_skip_start(scene, srays)
    apex = scene.light_vec[light] \
        if scene.light_kind[light] == LIGHT_POINT else None
    return dict(origin=srays.origin, direction=srays.direction,
                length=torch.where(smiss, 0.0, torch.minimum(
                    srays.length, sexit)).contiguous(),
                epsilon=srays.epsilon, t0=st0.contiguous()), apex, facing


def log_sections(label, scene, lanes, kw, want):
    """Run the instrumented twin of K1/K2 on ``lanes`` (its own launch
    counter, no kernel row's), hold its outputs against the kernel's
    ``want`` (hit masks and step counts equal: the same code around clock
    reads) and print each section's share of the warps' summed clock
    cycles.  Returns ``{"shares": ..., "counts": ...}``."""
    from fraytracer_tpu_torch.ops.cuda import march_kernel as mk
    n0 = dict(mk.LAUNCHES)
    got, clocks, counts = mk.march_sections(scene, **lanes, **kw)
    check(dict(mk.LAUNCHES) == n0, "the twin moved a kernel row's counter")
    check(mk.SECTION_LAUNCHES["march_sections"] >= 1, "twin not counted")
    # hit mask and steps: the last two outputs of K1, the two of K2
    hit_at = 1 if len(got) == 4 else 0
    same = (got[-1] == want[-1]) & (got[hit_at] == want[hit_at])
    check(same.float().mean().item() >= 0.9999,
          f"[sections] {label}: the twin's outputs differ from the kernel's")
    total = max(sum(clocks.values()), 1)
    shares = {k: v / total for k, v in clocks.items()}
    log(f"[sections] {label}: " + ", ".join(
        f"{k} {v:.4f}" for k, v in shares.items())
        + f"; {total / max(counts['warp_steps'], 1):.0f} clocks a warp step"
        f", counts {counts}")
    return {"shares": shares, "counts": counts,
            "clocks_per_warp_step": total / max(counts["warp_steps"], 1)}


def phase_culled_times(dev, bench_scene):
    """Culled K1/K2/K3 beside their plain versions at the main path's
    shapes: 1024² primary rays (tables at cull_m 256), each light's shadow
    batch (cull_m_shadow 512; the point light with its apex), K3 on the
    primary hits."""
    from fraytracer_tpu_torch.ops.cuda import march_kernel as mk
    out = {}
    device_ms = device_timer()
    lanes, kw = primary_lanes(bench_scene, SIZE, 30.0, dev)
    tabs = culled_tables(bench_scene, lanes, 48, 256)
    kw = dict(kw, cull=tabs)
    plan = mk.march_stage_plan(
        mk.lower_program(bench_scene, dev, tabs.pairs), tabs)
    log(f"  [stage] K1 culled bench, m {[q.m for q in tabs.tables]}: "
        f"{plan.bytes} bytes of shared memory a block ({plan.bulk_bytes} by "
        f"bulk copies), pairs staged {plan.staged}, dense entries staged "
        f"{plan.ents}")
    k = mk.march_kernel(bench_scene, **lanes, **kw)
    ms = device_ms(lambda: mk.march_kernel(bench_scene, **lanes, **kw))
    host_call = cuda_ms(lambda: mk.march_kernel(bench_scene, **lanes, **kw))
    with window_rows(tabs) as win:
        p, plain_ms = host_ms(lambda: mk.march_plain(bench_scene, **lanes,
                                                     **kw))
    err = compare_march(k, p, f"K1 culled bench {SIZE}^2")
    out["march_culled"] = timing(
        ms, plain_ms, err, int((k[1] != p[1]).sum()), k[1].numel(),
        march_bound(bench_scene, lanes, k, tabs, win),
        host_call_ms=host_call,
        lane_efficiency=lane_efficiency(k[3]),
        ray_evaluations=int(k[3].sum()))
    log_window_rows("K1 culled bench", tabs, win, k[3], p[3])
    sections = {"K1 culled": log_sections(
        "K1 culled", bench_scene, lanes, kw, k)}
    evals = int(k[3].sum())
    log(f"  K1 culled bench: {evals} ray evaluations, candidates per tile "
        f"max {int(tabs.tables[0].count.max())} mean "
        f"{tabs.tables[0].count.float().mean().item():.2f}, SIMT lane "
        f"efficiency {lane_efficiency(k[3]):.4f}")
    for light in range(bench_scene.num_lights):
        sl, apex, facing = shadow_lanes(bench_scene, lanes, k, light)
        st = culled_tables(bench_scene, sl, 48, 512, apex)
        skw = dict(max_steps=192, omega=1.4, cull=st, occlusion=True)
        plan = mk.march_stage_plan(
            mk.lower_program(bench_scene, dev, st.pairs), st)
        log(f"  [stage] K2 culled bench light {light}, m "
            f"{[q.m for q in st.tables]}: {plan.bytes} bytes of shared "
            f"memory a block, pairs staged {plan.staged}")
        ok_ = mk.march_kernel(bench_scene, **sl, **skw)
        ms = device_ms(lambda: mk.march_kernel(bench_scene, **sl, **skw))
        host_call = cuda_ms(lambda: mk.march_kernel(bench_scene, **sl, **skw))
        with window_rows(st) as win:
            op_, plain_ms = host_ms(lambda: mk.march_plain(bench_scene, **sl,
                                                           **skw))
        flips = int((ok_[0] != op_[0]).sum())
        agree = 1.0 - flips / ok_[0].numel()
        log(f"  K2 culled bench light {light} "
            f"({'point, converging cone' if apex is not None else 'directional'}"
            f"): {int(facing.sum())} facing, candidates per tile max "
            f"{int(st.tables[0].count.max())} mean "
            f"{st.tables[0].count.float().mean().item():.2f}, kernel "
            f"{ms:.3f} ms on the device ({host_call:.3f} ms around a host "
            f"call), plain {plain_ms:.3f} ms, {flips} flips "
            f"({agree:.6f} agreement), {int(ok_[1].sum())} ray evaluations, "
            f"SIMT lane efficiency {lane_efficiency(ok_[1]):.4f}")
        check(agree >= 0.999, f"K2 culled bench agreement {agree}")
        sections[f"K2 culled light {light}"] = log_sections(
            f"K2 culled light {light}", bench_scene, sl, skw, ok_)
        if light == 0:
            out["occlusion_culled"] = timing(
                ms, plain_ms, float(flips > 0), flips, ok_[0].numel(),
                march_bound(bench_scene, sl, ok_, st, win),
                host_call_ms=host_call,
                lane_efficiency=lane_efficiency(ok_[1]),
                ray_evaluations=int(ok_[1].sum()))
            log_window_rows("K2 culled bench light 0", st, win, ok_[1],
                            op_[1])
        else:
            out["occlusion_culled"].update(
                {f"ms_light{light}": ms,
                 f"host_call_ms_light{light}": host_call})
    args = (lanes["origin"], lanes["direction"], k[0], lanes["epsilon"],
            k[1])
    kk = mk.surface_kernel(bench_scene, *args, cull=tabs)
    ms = device_ms(lambda: mk.surface_kernel(bench_scene, *args, cull=tabs))
    host_call = cuda_ms(lambda: mk.surface_kernel(bench_scene, *args,
                                                  cull=tabs))
    pp, plain_ms = host_ms(lambda: mk.surface_plain(bench_scene, *args,
                                                    cull=tabs))
    err = compare_surface(kk, pp, k[1], f"K3 culled bench {SIZE}^2")
    out["surface_culled"] = timing(
        ms, plain_ms, err, int((k[1] & (kk[2] != pp[2])).sum()),
        int(k[1].sum()), surface_bound(bench_scene, args, kk, tabs),
        host_call_ms=host_call)
    out["march_culled"]["sections"] = sections["K1 culled"]
    out["occlusion_culled"]["sections"] = sections["K2 culled light 0"]
    log_times(out)
    return out


def phase_blend_times(dev, scene):
    """K3 in AD mode beside its plain version at the blended frame's shape
    (1024² primary rays, tables at cull_m 256): the culled form on the
    culled K1's hits and the dense form on the dense K1's, each read on
    the device (``ms``) with the reading around one host call beside it
    (``host_call_ms``)."""
    from fraytracer_tpu_torch.ops.cuda import march_kernel as mk
    out = {}
    device_ms = device_timer()
    lanes, kw = primary_lanes(scene, SIZE, 30.0, dev)
    tabs = culled_tables(scene, lanes, 48, 256)
    for name, tables in (("surface_ad_culled", tabs), ("surface_ad", None)):
        k = mk.march_kernel(scene, **lanes, **kw, cull=tables)
        k1_ms = cuda_ms(lambda: mk.march_kernel(scene, **lanes, **kw,
                                                cull=tables), reps=3)
        args = (lanes["origin"], lanes["direction"], k[0],
                lanes["epsilon"], k[1])
        kk = mk.surface_kernel(scene, *args, cull=tables)
        call = lambda: mk.surface_kernel(scene, *args, cull=tables)
        more = {}
        ms, more["host_call_ms"] = device_ms(call), cuda_ms(call)
        pp, plain_ms = host_ms(lambda: mk.surface_plain(scene, *args,
                                                        cull=tables))
        err, differing = compare_surface_ad(kk, pp, k[1],
                                            f"K3 AD {name} blend {SIZE}^2")
        out[name] = timing(ms, plain_ms, err, differing, int(k[1].sum()),
                           surface_bound(scene, args, kk, tables), **more)
        eff = lane_efficiency(k[3]) if tables is not None else \
            dense_lane_stats(mk, scene, lanes, kw, k[3])["lane_efficiency"]
        log(f"  K1 before {name}: {k1_ms:.3f} ms, "
            f"{int(k[3].sum())} ray evaluations, "
            f"{int(k[1].sum())} hits, lane efficiency {eff:.4f}")
    log_times(out)
    return out


# ---------------------------------------------------------------------------
# phase 4/5/7: the forward frame
# ---------------------------------------------------------------------------

def bench_config(size, cull=True, backend="cuda"):
    """The JAX bench's frame (bench.py:80-89): the default cull_* unless
    ``cull=False`` (the dense frame)."""
    import fraytracer_tpu_torch as ft
    return ft.RenderConfig(width=size, height=size, epsilon=EPS, length=30.0,
                           march=ft.MarchConfig(max_steps=192,
                                                bound_skip=True,
                                                backend=backend, cull=cull,
                                                relax_omega=1.4))


def eager_frame(scene, cam, cfg):
    """The eager frame (``render_grid`` of the camera's rays): what
    ``render_with_stats`` ran before the graph frame, and what a flagged
    replay runs again.  Spied frames run it: the spies read the device."""
    import fraytracer_tpu_torch as ft
    rays = ft.camera_rays(cam, cfg.width, cfg.height, cfg.epsilon,
                          cfg.length)
    return ft.render_grid(scene, rays, cfg)


@contextlib.contextmanager
def frame_spies():
    """For one frame: each culled march's candidates per tile (from its
    tables) and the material repair's bad hit lanes, recorded by wrapping
    the two functions from outside (their extra reductions sync the host,
    so timed frames run without the spies)."""
    from fraytracer_tpu_torch.ops import shade
    from fraytracer_tpu_torch.ops.cuda import march_kernel as mk
    from fraytracer_tpu_torch.ops.cuda.gather import BLOCK
    rec = {"tables": [], "counts": [], "repair": []}
    real_tables, real_repair = mk.build_pair_tables, shade.resolve_material

    def tables(*a, **k):
        out = real_tables(*a, **k)
        rec["tables"].append([(int(q.count.max()),
                               q.count.float().mean().item(), q.m)
                              for q in out.tables])
        # candidates per tile summed over the pairs
        rec["counts"].append(sum(q.count.long() for q in out.tables)
                             .tolist())
        return out

    def repair(scene, pos, hit, midx, backend="cuda"):
        bad = (hit & (midx < 0)).reshape(-1)
        nb = bad.numel() // BLOCK
        blocks = int(bad[:nb * BLOCK].reshape(nb, BLOCK).any(1).sum())
        rec["repair"].append((int(bad.sum()), blocks, bad.numel()))
        return real_repair(scene, pos, hit, midx, backend=backend)

    mk.build_pair_tables, shade.resolve_material = tables, repair
    try:
        yield rec
    finally:
        mk.build_pair_tables, shade.resolve_material = real_tables, \
            real_repair


def repair_tier(nbad, blocks, n):
    """The tier resolve_material takes for these counts (ops/shade.py)."""
    from fraytracer_tpu_torch.ops import shade
    from fraytracer_tpu_torch.ops.cuda.gather import BLOCK
    if nbad == 0:
        return "none"
    if n % BLOCK == 0 and blocks <= min(shade.BCAP_MAX, n // BLOCK):
        return "block (K4)"
    return "lane" if nbad <= min(shade.CAP_MAX, n) else "dense"


def phase_frame(dev, scene, build_dir, cull, tag=None, ad=False, reps=5):
    """One configuration of the 1024² frame: launch counts around the
    frame alone, the median of ``reps`` frames, a profiled frame, peak
    memory.  The culled frame also reports candidates per tile and the
    repair tier (from a spied frame after the counted one).  ``ad`` names
    the surface pass the scene must take: AD mode (a plan with a smooth
    union) or slot mode."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.image.io import save_image
    from fraytracer_tpu_torch.ops import cuda as ops_cuda
    tag = tag or ("culled" if cull else "dense")
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    cfg = bench_config(SIZE, cull)

    ops_cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, n_rays = ft.render_with_stats(scene, cam, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = ops_cuda.launch_counts()
    log(f"  launches in the {tag} frame (its first call: the eager run "
        f"before the capture): {counts}")
    sfx = "_culled" if cull else ""
    other = "" if cull else "_culled"
    surf, other_surf = ("surface_ad", "surface") if ad \
        else ("surface", "surface_ad")
    check(counts["march" + sfx] >= 1, f"K1 ({tag}) not launched")
    check(counts[surf + sfx] >= 1, f"K3 ({tag}) not launched")
    check(counts["occlusion" + sfx] >= scene.num_lights,
          f"K2 ({tag}) launched {counts['occlusion' + sfx]} times, want "
          f">= {scene.num_lights}")
    check(counts["march" + other] == counts[surf + other]
          == counts["occlusion" + other] == 0,
          f"the {tag} frame launched the other form")
    check(counts[other_surf] == counts[other_surf + "_culled"] == 0,
          f"the {tag} frame launched the other surface mode")
    check(bool(torch.isfinite(img).all()), "non-finite pixels")
    check(img.shape == (SIZE, SIZE, 3), f"image shape {tuple(img.shape)}")
    bg = scene.background
    share = (img - bg).abs().amax(-1).gt(1e-6).float().mean().item()
    log(f"  {tag} frame {SIZE}^2: n_rays {int(n_rays)}, non-background "
        f"share {share:.4f}, first frame {first_s * 1e3:.1f} ms")
    check(0.25 <= share <= 0.45, f"non-background share {share}")

    stats = {}
    if cull:
        with frame_spies() as rec:
            eager_frame(scene, cam, cfg)
        names = ["primary"] + [
            f"light {i} ({'point' if scene.light_kind[i] else 'directional'})"
            for i in range(scene.num_lights)]
        for name, tabs in zip(names, rec["tables"]):
            log(f"  candidates per tile, {name}: " + ", ".join(
                f"max {mx} mean {mean:.2f} (table m {m})"
                for mx, mean, m in tabs))
        stats["candidates"] = {name: tabs[0][:2] for name, tabs
                               in zip(names, rec["tables"])}
        nbad, blocks, n = rec["repair"][0]
        stats["repair"] = (repair_tier(nbad, blocks, n), nbad, blocks)
        log(f"  material repair: tier {stats['repair'][0]}, {nbad} bad hit "
            f"lanes in {blocks} blocks of 1024")

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, n_rays = ft.render_with_stats(scene, cam, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"  {tag} frame {SIZE}^2: median of {reps} {med * 1e3:.2f} ms "
        f"({[round(t * 1e3, 2) for t in times]}), "
        f"{int(n_rays) / med:.4g} rays/s")
    torch.cuda.reset_peak_memory_stats()
    eager_frame(scene, cam, cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"  {tag} frame peak device memory {peak / 2**20:.1f} MiB (the "
        "eager frame; the graph's own memory: [graph])")
    stats["idle"] = profile_frame(
        scene, cam, cfg, build_dir / f"chip_smoke_{tag}_frame_trace.json")
    gen = torch.Generator(device=dev).manual_seed(19)
    png = build_dir / f"chip_smoke_{tag}_frame.png"
    save_image(str(png), ft.tonemap(img, gen, cfg.gamma).cpu().numpy())
    log(f"  wrote {png}")
    stats.update(counts=counts, n_rays=int(n_rays), first_s=first_s,
                 med=med, peak=peak, cfg=cfg, cam=cam)
    return stats


def forced_repair(scene, cam, cfg):
    """The material-repair block tier (K4) on the frame's own hit points.
    The dense surface pass leaves no -1 material on hit lanes, so the
    frame never takes this tier; here the hit lanes of 5 blocks are marked
    unresolved and repaired.  Returns the launch counts of the repair
    call alone."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops import cuda as ops_cuda, sdf, shade
    from fraytracer_tpu_torch.ops.cuda.gather import BLOCK
    from fraytracer_tpu_torch.camera import to_blocks
    rays = ft.camera_rays(cam, SIZE, SIZE, EPS, cfg.length).map(
        lambda x: to_blocks(x, SIZE, SIZE, 32).contiguous())
    h = shade.surface_hit(scene, rays, cfg.march)
    nb = h.hit.numel() // BLOCK
    hit_blocks = torch.nonzero(h.hit.reshape(nb, BLOCK).any(1)).squeeze(1)
    pick = hit_blocks[torch.linspace(0, hit_blocks.numel() - 1, 5,
                                     device=hit_blocks.device).long()]
    lane = torch.arange(BLOCK, device=h.hit.device)
    marked = torch.zeros(nb, BLOCK, dtype=torch.bool, device=h.hit.device)
    marked[pick] = (lane % 5 == 0)[None, :]
    bad = marked.reshape(-1) & h.hit
    midx = torch.where(bad, -1, h.material)
    ops_cuda.reset_launch_counts()
    fixed = shade.resolve_material(scene, h.position, h.hit, midx,
                                   backend="cuda")
    counts = ops_cuda.launch_counts()
    want = sdf.material_index_at(scene, h.position[bad])
    same_k3 = (fixed[bad] == h.material[bad]).float().mean().item()
    log(f"  forced repair: {int(bad.sum())} hit lanes of blocks "
        f"{pick.tolist()} marked -1; launches {counts}; repaired material "
        f"equal to K3's on {same_k3:.6f} of them")
    check(counts["block_gather"] == 1, "K4 not launched by the repair")
    check(torch.equal(fixed[bad], want)
          and torch.equal(fixed[~bad], midx[~bad]),
          "block-tier repair disagrees with the dense argmin")
    return counts


def profile_frame(scene, cam, cfg, trace_path, fn=None, ops=0, record=None,
                  events=False):
    """One frame (or one call of ``fn``) under torch.profiler: device time
    by kernel and the device's idle share between the first and last
    kernel; with ``ops`` the ``ops`` host operators whose kernels took the
    most device time, with their call counts.  The Chrome trace goes to
    ``trace_path``; ``record`` (a dict) gets the port's kernels in launch
    order with their device ms under ``"kernels"``, and with ``events``
    every device op as ``(name, start µs, end µs)`` under ``"events"``."""
    import fraytracer_tpu_torch as ft
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if fn is None:
        fn = lambda: ft.render_with_stats(scene, cam, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    prof.export_chrome_trace(str(trace_path))
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        log("  profile: no device events (device breakdown not measured)")
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    by_name = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"  profile: {len(evs)} device ops, busy {busy / 1e3:.3f} ms of a "
        f"{span / 1e3:.3f} ms device span (idle share "
        f"{1 - busy / span:.4f}); host wall {wall_us / 1e3:.3f} ms "
        "under the profiler")
    for name, us in top:
        log(f"    {us / 1e3:9.3f} ms  {name[:70]}")
    # a template instantiation is named "void march_kernel<...>(...)"
    port = ("march_kernel", "surface_kernel", "surface_ad_kernel",
            "block_gather_kernel", "march_dense_kernel",
            "surface_dense_kernel", "surface_ad_dense_kernel",
            "cull_cones_kernel", "cull_select_kernel", "rows_scatter_kernel")
    ours = [e for e in sorted(evs, key=lambda e: e.time_range.start)
            if any(k in e.name.split("(")[0] for k in port)]
    log("  profile, port kernels in launch order: " + ", ".join(
        f"{e.name.split('(')[0].replace('void ', '')} "
        f"{e.time_range.elapsed_us() / 1e3:.3f} ms" for e in ours))
    if record is not None:
        record["kernels"] = [(e.name.split("(")[0].replace("void ", ""),
                              e.time_range.elapsed_us() / 1e3) for e in ours]
        if events:
            record["events"] = sorted(
                ((e.name, e.time_range.start, e.time_range.end)
                 for e in evs), key=lambda x: x[1])
        record.update(busy_ms=busy / 1e3, span_ms=span / 1e3, ops=len(evs),
                      host_ms=wall_us / 1e3)
    if ops:
        def dev_us(a):
            return getattr(a, "self_device_time_total",
                           getattr(a, "self_cuda_time_total", 0.0))
        top_ops = sorted(prof.key_averages(), key=lambda a: -dev_us(a))
        for a in top_ops[:ops]:
            log(f"    op {dev_us(a) / 1e3:9.3f} ms in {a.count:5d} calls  "
                f"{a.key[:60]}")
    return 1 - busy / span


def frame_and_masks(scene, cam, cfg):
    """Render + the discrete outcomes per pixel — primary hit, winning
    material, per-light facing and occlusion — where two frames may
    legitimately differ (marched in
    the frame's block order, the point light with its converging cone, as
    the frame runs them), and the primary hit t."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops import shade
    from fraytracer_tpu_torch.ops.march import march_occlusion
    from fraytracer_tpu_torch.camera import (auto_block, from_blocks,
                                             to_blocks)
    from fraytracer_tpu_torch.scene.nodes import LIGHT_POINT
    img = ft.render(scene, cam, cfg)
    # in the frame's 32x32 block order: the culled tiles are blocks
    hh, ww = cfg.height, cfg.width
    b = auto_block(hh, ww)
    rays = ft.camera_rays(cam, ww, hh, cfg.epsilon, cfg.length).map(
        lambda x: to_blocks(x, hh, ww, b))
    h = shade.surface_hit(scene, rays, cfg.march)
    masks = [h.hit, h.material]
    for i in range(scene.num_lights):
        ldir, budget, _s = shade.light_dir_and_dist(scene, i, h.position)
        facing = h.hit & ((h.normal * ldir).sum(-1) > 0)
        sr = ft.Rays(origin=h.position, direction=ldir,
                     length=torch.where(facing, budget, 0.0),
                     epsilon=rays.epsilon)
        apex = scene.light_vec[i] \
            if scene.light_kind[i] == LIGHT_POINT else None
        masks += [facing, march_occlusion(scene, sr, cfg.march,
                                          cone_apex=apex)]
    back = lambda x: from_blocks(x, hh, ww, b)
    return img, [back(m) for m in masks], back(h.t)


def compare_frames(a, b, label, shell_t=False):
    """Two frames' images off the pixels whose primary hit, material,
    facing or occlusion outcome flipped (≤ 0.5%): max |Δ| < 2e-3, median
    < 1e-5.  With ``shell_t`` pixels whose primary hit landed at another
    point of the ε-shell (|Δt| > 1e-3; two step sequences, e.g. culled
    against dense) may exceed 2e-3 if they are ≤ 0.5% of the frame and
    below 3e-2."""
    (ia, ma, ta), (ib, mb, tb) = a, b
    flipped = torch.zeros_like(ma[0])
    log(f"  {label}: flips per outcome (hit, material, then facing and "
        f"occlusion per light): {[int((x != y).sum()) for x, y in zip(ma, mb)]}")
    for x, y in zip(ma, mb):
        flipped |= x != y
    diff = (ia - ib).abs().amax(-1)
    shell = ~flipped & ma[0] & ((ta - tb).abs() > 1e-3) if shell_t \
        else torch.zeros_like(flipped)
    mx = diff[~flipped & ~shell].max().item()
    med = diff.median().item()
    off = shell & (diff >= 2e-3)
    log(f"  {label}: {int(flipped.sum())} flipped pixels "
        f"({flipped.float().mean().item():.6f}), max |diff| elsewhere "
        f"{mx:.3e}, median {med:.3e}" + (
            f"; {int(shell.sum())} shell pixels (|dt| > 1e-3), "
            f"{int(off.sum())} of them at |diff| >= 2e-3, max "
            f"{diff[shell].max().item() if shell.any() else 0.0:.3e}"
            if shell_t else ""))
    check(flipped.float().mean().item() <= 0.005, "too many flipped pixels")
    check(mx < 2e-3, f"{label}: max diff {mx}")
    check(med < 1e-5, f"{label}: median diff {med}")
    check(off.float().mean().item() <= 0.005, f"{label}: shell pixels")
    if off.any():
        check(diff[off].max().item() < 3e-2, f"{label}: shell diff")
    return int(flipped.sum()), mx, med


def phase_parity(dev, scene, culled_cfg, tag="frame"):
    """256² frames (dense and culled) kernels against plain, then the
    1024² culled frame against the dense one (t within 3ε on >= 99.5% of
    the lanes both hit)."""
    import fraytracer_tpu_torch as ft
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    for cull in (False, True):
        cfg = bench_config(256, cull)
        k = frame_and_masks(scene, cam, cfg)
        with plain_route():
            p = frame_and_masks(scene, cam, cfg)
        compare_frames(k, p, f"{tag} 256^2 {'culled' if cull else 'dense'}"
                       " kernels vs plain")
    culled = frame_and_masks(scene, cam, culled_cfg)
    dense = frame_and_masks(scene, cam, bench_config(SIZE, cull=False))
    both = culled[1][0] & dense[1][0]
    dt = (culled[2] - dense[2]).abs()[both]
    near = (dt <= 3 * EPS).float().mean().item()
    log(f"  {tag} {SIZE}^2 culled vs dense: t within 3 eps on {near:.6f} of "
        f"{int(both.sum())} lanes both hit (max |dt| {dt.max().item():.3e}: "
        "a grazing lane may hit one surface in one frame and pass to the "
        "next in the other)")
    check(near >= 0.995, f"{tag}: culled t within 3 eps on {near}")
    return compare_frames(culled, dense, f"{tag} {SIZE}^2 culled vs dense",
                          shell_t=True)


# ---------------------------------------------------------------------------
# [graph]: the graph frame (ops/graph.py), the counterpart of jax.jit
# ---------------------------------------------------------------------------

GRAPH_REPS = 9        # paired graph / eager frames, median of each
GRAPH_CHAIN = 32      # chained frames of the sustained time (JAX's K)
# one frame's launches, per replay and in the eager frame, by form
GRAPH_LAUNCHES = {
    "culled": {"march_culled": 1, "surface_culled": 1,
               "occlusion_culled": 2, "cull_cones": 3, "cull_select": 3},
    "dense": {"march": 1, "surface": 1, "occlusion": 2},
    "blend": {"march_culled": 1, "surface_ad_culled": 1,
              "occlusion_culled": 2, "cull_cones": 3, "cull_select": 3},
    "blend_dense": {"march": 1, "surface_ad": 1, "occlusion": 2}}
# a step's row scatters (ops/cuda/scatter.py) beside its frame's launches:
# the backward of the leaf rows of the sphere and torus tables, read twice
# (the hit distance and the normal), and of the albedo and emission rows;
# a blended step differentiates its leaves through point_eval and scatters
# only the material rows
STEP_SCATTERS = {"culled": 6, "dense": 6, "blend": 2}


def step_launches(tag):
    """The launches of one step of ``tag``: its frame's and its scatters'
    (every table of the torus scene fits the shared-memory path)."""
    return {**GRAPH_LAUNCHES[tag], "rows_scatter_smem": STEP_SCATTERS[tag]}


# a launch count's kernel as a trace names it (K1 and K2 are one kernel)
TRACE_NAMES = {"march_culled": "march_kernel",
               "occlusion_culled": "march_kernel",
               "surface_culled": "surface_kernel",
               "surface_ad_culled": "surface_ad_kernel",
               "march": "march_dense_kernel", "occlusion": "march_dense_kernel",
               "surface": "surface_dense_kernel",
               "surface_ad": "surface_ad_dense_kernel",
               "block_gather": "block_gather_kernel",
               "cull_cones": "cull_cones_kernel",
               "cull_select": "cull_select_kernel",
               "rows_scatter_smem": "rows_scatter_kernel",
               "rows_scatter_global": "rows_scatter_kernel"}
NO_GRAPH = {"captures": 0, "replays": 0, "eager_reruns": 0, "eager_frames": 0}


def traced_launches(record):
    """The port's kernels in a profiled frame (``profile_frame``'s
    ``record``), counted by name as the card ran them."""
    return collections.Counter(name.split("<")[0]
                               for name, _ms in record.get("kernels", ()))


def paired_ms(fns, reps=GRAPH_REPS, barrier=None):
    """``reps`` synchronized calls of each function in turns (each between
    barriers of the ranks, when given): the times in ms, one list a
    function."""
    out = [[] for _ in fns]
    for _ in range(reps):
        for fn, ms in zip(fns, out):
            torch.cuda.synchronize()
            if barrier:
                barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if barrier:
                barrier()
            ms.append(1e3 * (time.perf_counter() - t0))
    return out


def render_module():
    """``fraytracer_tpu_torch/render.py`` (the package's ``render`` is the
    function of that name)."""
    import fraytracer_tpu_torch  # noqa: F401
    return sys.modules["fraytracer_tpu_torch.render"]


def graph_layer():
    """``fraytracer_tpu_torch/ops/graph.py``: the captured calls' keys,
    graphs and memory pools."""
    from fraytracer_tpu_torch.ops import graph
    return graph


def launched(counts):
    """The kernels that launched, by name."""
    return {k: v for k, v in counts.items() if v}


def graph_frame_case(dev, tag, scene, cam, cfg, build_dir):
    """One 1024² frame as a graph: (a) its capture (time, the device
    memory it added, the peak during the capture), the replay bit for bit
    the eager frame, the launches per replay equal to the eager frame's,
    counted by the wrappers and read from the profiled replay; (d)
    the deferred frame run eagerly under sync debug mode "error"; (e) the
    graph and the eager frame paired, median of ``GRAPH_REPS`` each, then
    ``GRAPH_CHAIN`` chained frames of each between two synchronizes, each
    one's profile (device ops, busy / span) and the eager frame's peak."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops import cuda as ops_cuda, deferred
    R = render_module()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    ops_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    first = ft.render_with_stats(scene, cam, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    capture_peak = torch.cuda.max_memory_allocated()
    fg = R.frame_graph(scene, cam, cfg)
    check(fg is not None and fg.graph is not None
          and ops_cuda.graph_counts() == dict(NO_GRAPH, captures=1),
          f"[graph] {tag}: capture {ops_cuda.graph_counts()}")
    first_counts = launched(ops_cuda.launch_counts())
    del first
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() - reserved0

    ops_cuda.reset_launch_counts()
    img, n_rays = ft.render_with_stats(scene, cam, cfg)
    replay = launched(ops_cuda.launch_counts())
    check(ops_cuda.graph_counts() == dict(NO_GRAPH, replays=1),
          f"[graph] {tag}: replay {ops_cuda.graph_counts()}")
    ops_cuda.reset_launch_counts()
    eimg, en = eager_frame(scene, cam, cfg)
    eager = launched(ops_cuda.launch_counts())
    check(replay == eager == first_counts == launched(fg.launches)
          == GRAPH_LAUNCHES[tag],
          f"[graph] {tag}: launches per replay {replay}, recorded "
          f"{launched(fg.launches)}, eager {eager}, first call "
          f"{first_counts}, want {GRAPH_LAUNCHES[tag]}")
    same = torch.equal(img, eimg) and int(n_rays) == int(en)
    log(f"  {tag}: graph frame digest {digest(img, n_rays)}, eager "
        f"{digest(eimg, en)}, bit for bit: {same}; launches per replay "
        f"{replay} (eager {eager}); capture (eager run + capture) "
        f"{fg.capture_s * 1e3:.1f} ms of a first call of "
        f"{first_s * 1e3:.1f} ms; the capture added {held / 2**20:.1f} MiB "
        f"of device memory (graphs share one pool), peak during the capture "
        f"{capture_peak / 2**20:.1f} MiB")
    check(same, f"[graph] {tag}: the graph frame is not the eager frame")

    frame = deferred.Frame(dev)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad(), deferred.deferring(frame):
            dimg, _n = R._frame(scene, cam, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    check(torch.equal(dimg, eimg) and not bool(frame.flag),
          f"[graph] {tag}: the deferred frame")
    log(f"  {tag}: the deferred frame under sync debug mode \"error\": "
        "0 syncs, bit for bit the eager frame, flag clear")

    g_ms, e_ms = paired_ms((lambda: ft.render_with_stats(scene, cam, cfg),
                            lambda: eager_frame(scene, cam, cfg)))
    chain = {}
    for name, fn in (("graph", lambda: ft.render_with_stats(scene, cam, cfg)),
                     ("eager", lambda: eager_frame(scene, cam, cfg))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GRAPH_CHAIN):
            fn()
        torch.cuda.synchronize()
        chain[name] = 1e3 * (time.perf_counter() - t0) / GRAPH_CHAIN
    # after 1 + GRAPH_REPS + GRAPH_CHAIN replays: still the eager frame
    # (the dense form's ray counter is zeroed by a captured memset)
    check(torch.equal(ft.render_with_stats(scene, cam, cfg)[0], eimg),
          f"[graph] {tag}: a later replay is not the eager frame")
    torch.cuda.reset_peak_memory_stats()
    eager_frame(scene, cam, cfg)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated()
    prof = {}
    for name, fn in (("graph", lambda: ft.render_with_stats(scene, cam, cfg)),
                     ("eager", lambda: eager_frame(scene, cam, cfg))):
        rec = {}
        profile_frame(scene, cam, cfg,
                      build_dir / f"chip_smoke_graph_{tag}_{name}_trace.json",
                      fn=fn, record=rec)
        prof[name] = rec
    # the launches of a replay as the card ran them (the counts above add
    # what the capture recorded)
    want = collections.Counter()
    for k, v in GRAPH_LAUNCHES[tag].items():
        want[TRACE_NAMES[k]] += v
    traced = {name: traced_launches(rec) for name, rec in prof.items()}
    log(f"  {tag}: the port's kernels in the profiled replay "
        f"{dict(traced['graph'])}, in the eager frame "
        f"{dict(traced['eager'])}, want {dict(want)}")
    check(traced["graph"] == traced["eager"] == want,
          f"[graph] {tag}: traced launches {traced}, want {dict(want)}")
    res = {"digest": digest(eimg, en),"graph_ms": statistics.median(g_ms), "eager_ms":
           statistics.median(e_ms), "graph_times_ms": g_ms,
           "eager_times_ms": e_ms, "paired_diff_ms": statistics.median(
               [a - b for a, b in zip(g_ms, e_ms)]),
           "sustained_graph_ms": chain["graph"],
           "sustained_eager_ms": chain["eager"],
           "capture_ms": 1e3 * fg.capture_s, "first_call_ms": 1e3 * first_s,
           "graph_mib": held / 2**20, "capture_peak_mib":
           capture_peak / 2**20, "eager_peak_mib": eager_peak / 2**20,
           "launches": replay,
           **{f"{name}_{k}": v for name, rec in prof.items()
              for k, v in rec.items() if k != "kernels"}}
    log(f"  {tag}: graph {res['graph_ms']:.3f} ms ({min(g_ms):.3f}–"
        f"{max(g_ms):.3f}) / eager {res['eager_ms']:.3f} ms "
        f"({min(e_ms):.3f}–{max(e_ms):.3f}) (medians of {GRAPH_REPS}, paired; "
        f"median paired difference {res['paired_diff_ms']:.3f} ms), "
        f"sustained over {GRAPH_CHAIN} chained frames: graph "
        f"{chain['graph']:.3f} ms, eager {chain['eager']:.3f} ms; profile "
        + "; ".join(f"{name} {rec.get('ops')} device ops, busy "
                    f"{rec.get('busy_ms', float('nan')):.3f} of "
                    f"{rec.get('span_ms', float('nan')):.3f} ms"
                    for name, rec in prof.items())
        + f"; eager frame peak {eager_peak / 2**20:.1f} MiB ({nvidia_smi()})")
    return res


def graph_eager_key_case(dev, scene, cam, cfg, label, patch=None,
                         captured=False):
    """A key whose first frame raises the flag.  ``captured`` (an
    overflow): that call promotes the overflowed sites to full-group
    tables, runs once more and captures that frame, and the key's later
    calls replay it; else (a material repair, forced in every frame by
    ``patch``) that call runs the eager frame again and captures nothing,
    and the key's later calls run the eager frame.  Each call equal to the
    eager frame bit for bit, a later call with the replay's recorded
    launches or the eager frame's.  Then its calls against the eager
    frame's, paired."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops import cuda as ops_cuda
    R, G = render_module(), graph_layer()
    with patch() if patch else contextlib.nullcontext():
        ops_cuda.reset_launch_counts()
        img0, n0 = ft.render_with_stats(scene, cam, cfg)
        first = ops_cuda.graph_counts()
        fg = R.frame_graph(scene, cam, cfg)
        ops_cuda.reset_launch_counts()
        img, n = ft.render_with_stats(scene, cam, cfg)
        counts, gc = ops_cuda.launch_counts(), ops_cuda.graph_counts()
        ops_cuda.reset_launch_counts()
        eimg, en = eager_frame(scene, cam, cfg)
        eager = ops_cuda.launch_counts()
        k_ms, e_ms = paired_ms((lambda: ft.render_with_stats(scene, cam, cfg),
                                lambda: eager_frame(scene, cam, cfg)))
    G._graphs.pop(G.key("frame", scene, cam, cfg))
    promoted = sorted(fg.frame.promoted)
    if captured:
        check(first == dict(NO_GRAPH, captures=1) and fg.graph is not None
              and promoted, f"[graph] {label}: first call {first}, graph "
              f"{fg.graph}, promoted sites {promoted}")
        check(gc == dict(NO_GRAPH, replays=1), f"[graph] {label}: {gc}")
        want = fg.launches
    else:
        check(first == dict(NO_GRAPH, eager_reruns=1) and fg.graph is None,
              f"[graph] {label}: first call {first}, graph {fg.graph}")
        check(gc == dict(NO_GRAPH, eager_frames=1), f"[graph] {label}: {gc}")
        want = eager
    check(counts == want, f"[graph] {label}: launches {launched(counts)}, "
          f"want {launched(want)}")
    check(all(torch.equal(x, eimg) for x in (img0, img))
          and int(n0) == int(n) == int(en),
          f"[graph] {label}: the key's frames are not the eager frame")
    res = {"launches": launched(counts), "key_ms": statistics.median(k_ms),
           "eager_ms": statistics.median(e_ms), "key_times_ms": k_ms,
           "eager_times_ms": e_ms, "promoted": promoted}
    log(f"  {label}: the first frame raised the flag (first call {first}, "
        f"sites promoted {promoted}, "
        f"{'captured' if captured else 'no graph'}); a later call {gc}, "
        f"launches {launched(counts)} (the eager frame's "
        f"{launched(eager)}); equal to the eager frame bit for bit (digest "
        f"{digest(img, n)}); the key's frame {res['key_ms']:.3f} ms, eager "
        f"{res['eager_ms']:.3f} ms (medians of {GRAPH_REPS}, paired; "
        f"{nvidia_smi()})")
    return res


def graph_flagged_replay_case(dev, scene, cam, cfg, label):
    """A captured key whose replay raises the flag: the tori's centres
    pulled toward the origin (x 0.05) in place, so that a tile's
    candidates overflow its table.  The replay runs the eager frame again,
    equal to the edited scene's eager frame bit for bit, its launches the
    replay's recorded ones plus the re-run's; then such calls against the
    eager frame's, paired (what a key whose every replay flags would pay);
    undone, the replay is the first frame again."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops import cuda as ops_cuda
    R = render_module()
    before = ft.render_with_stats(scene, cam, cfg)
    fg = R.frame_graph(scene, cam, cfg)
    check(fg is not None and fg.graph is not None,
          f"[graph] {label}: the key has no graph")
    tori = scene.prim_params["torus"]
    old = tori.clone()
    with torch.no_grad():
        tori[:, 0:3] *= 0.05
    try:
        ops_cuda.reset_launch_counts()
        img, n = ft.render_with_stats(scene, cam, cfg)
        counts, gc = ops_cuda.launch_counts(), ops_cuda.graph_counts()
        ops_cuda.reset_launch_counts()
        eimg, en = eager_frame(scene, cam, cfg)
        eager = ops_cuda.launch_counts()
        f_ms, e_ms = paired_ms((lambda: ft.render_with_stats(scene, cam, cfg),
                                lambda: eager_frame(scene, cam, cfg)))
    finally:
        with torch.no_grad():
            tori.copy_(old)
    want = {k: fg.launches[k] + eager[k] for k in eager}
    check(gc == dict(NO_GRAPH, replays=1, eager_reruns=1),
          f"[graph] {label}: {gc}")
    check(counts == want, f"[graph] {label}: launches {launched(counts)}, "
          f"want {launched(want)}")
    check(torch.equal(img, eimg) and int(n) == int(en),
          f"[graph] {label}: the re-run is not the eager frame")
    again = ft.render_with_stats(scene, cam, cfg)
    check(torch.equal(again[0], before[0]),
          f"[graph] {label}: the replay after the edit was undone")
    res = {"launches": launched(counts), "flagged_ms": statistics.median(f_ms),
           "eager_ms": statistics.median(e_ms), "flagged_times_ms": f_ms,
           "eager_times_ms": e_ms}
    log(f"  {label}: flag set, {gc}; launches {launched(counts)} = the "
        f"replay's {launched(fg.launches)} + the eager re-run's "
        f"{launched(eager)}; equal to the eager frame bit for bit (digest "
        f"{digest(img, n)}); replay + re-run {res['flagged_ms']:.3f} ms "
        f"against eager {res['eager_ms']:.3f} ms (medians of {GRAPH_REPS}, "
        f"paired; {nvidia_smi()}); undone, the replay is the first frame")
    return res


@contextlib.contextmanager
def forced_repair_frames():
    """Every frame's surface pass marks a fifth of the lanes of every
    seventh block of 1024 unresolved (material -1), as ``forced_repair``
    does on one frame's hit points: device ops alone, so the graph
    captures them, and the frame needs a material repair."""
    from fraytracer_tpu_torch.ops.cuda import march_kernel as mk
    from fraytracer_tpu_torch.ops.cuda.gather import BLOCK
    real = mk.surface_kernel

    def marked(*a, **k):
        normal, midx, code = real(*a, **k)
        lane = torch.arange(midx.shape[0], device=midx.device)
        mark = (lane // BLOCK % 7 == 3) & (lane % 5 == 0)
        return normal, torch.where(mark, -1, midx), code
    mk.surface_kernel = marked
    try:
        yield
    finally:
        mk.surface_kernel = real


def phase_graph(dev, scene, blend, build_dir):
    """[graph]: ``render_with_stats`` as a captured CUDA graph
    (``ops/graph.py``) on the culled, dense, ``blend1000`` culled and
    ``blend1000`` dense 1024² frames (:func:`graph_frame_case`: (a), (d),
    (e)), the four graphs in one memory pool, replayed again in reverse
    order; (b) a forced overflow (cull_m 8) at 256², its sites promoted
    and captured, a forced material repair at 256², its key kept eager,
    and a replay that overflows; (c) one torus moved in place
    between two replays against the eager frame of the edited scene."""
    import fraytracer_tpu_torch as ft
    graph_layer()._graphs.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    out = {}
    cases = (("culled", scene, True), ("dense", scene, False),
             ("blend", blend, True), ("blend_dense", blend, False))
    for tag, sc, cull in cases:
        out[tag] = graph_frame_case(dev, tag, sc, cam, bench_config(SIZE,
                                                                    cull),
                                    build_dir)
    # the graphs share one pool: each replay writes what it reads
    for tag, sc, cull in reversed(cases):
        img, n = ft.render_with_stats(sc, cam, bench_config(SIZE, cull))
        check(digest(img, n) == out[tag]["digest"],
              f"[graph] {tag}: a replay after the other keys' captures")
    del img, n
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["graphs_mib"] = (torch.cuda.memory_reserved() - reserved0) / 2**20
    log(f"  the four graphs, replayed again in reverse order: each its eager "
        f"frame bit for bit; together they keep {out['graphs_mib']:.1f} MiB "
        f"of device memory (one pool; each capture's own growth: "
        + ", ".join(f"{tag} {out[tag]['graph_mib']:.1f}" for tag, *_ in cases)
        + f" MiB; {nvidia_smi()})")
    small = bench_config(256)
    out["overflow"] = graph_eager_key_case(
        dev, scene, cam, dataclasses.replace(small, march=dataclasses.replace(
            small.march, cull_m=8, cull_m_shadow=8)), "forced overflow "
        "(256^2, cull_m 8)", captured=True)
    out["repair"] = graph_eager_key_case(
        dev, scene, cam, small, "forced repair (256^2, lanes of every "
        "seventh block marked -1)", patch=forced_repair_frames)
    check(out["repair"]["launches"].get("block_gather", 0) >= 1,
          "[graph] the forced repair's re-run launched no K4")
    cfg = bench_config(SIZE)
    out["flagged_replay"] = graph_flagged_replay_case(
        dev, scene, cam, cfg, f"a replay that overflows ({SIZE}^2, the "
        "tori's centres x 0.05)")

    # (c) one torus moved in place between two replays: torus 0 to the
    # front of the blob (inside the bounding sphere, outside the cut one)
    before = ft.render_with_stats(scene, cam, cfg)[0]
    tori = scene.prim_params["torus"]
    old = tori[0, 0:3].clone()
    with torch.no_grad():
        tori[0, 0:3] = torch.tensor([1.2, -1.2, -2.6], device=dev)
    try:
        moved, n = ft.render_with_stats(scene, cam, cfg)
        want, wn = eager_frame(scene, cam, cfg)
    finally:
        with torch.no_grad():
            tori[0, 0:3] = old
    changed = int((moved != before).any(-1).sum())
    check(torch.equal(moved, want) and int(n) == int(wn) and changed > 0,
          f"[graph] the replay after an edit: {changed} pixels changed, "
          f"equal to the edited scene's eager frame: "
          f"{torch.equal(moved, want)}")
    check(torch.equal(ft.render_with_stats(scene, cam, cfg)[0], before),
          "[graph] the replay after the edit was undone")
    log(f"  torus 0 moved in place to (1.2, -1.2, -2.6) between two "
        f"replays: {changed} pixels changed, the replay bit for bit the "
        f"eager frame of the edited scene; undone, the replay is the first "
        f"frame again")
    return out


# [step]: the graph step (render.py::render_value_and_grad through
# ops/graph.py), the counterpart of jax.jit(jax.value_and_grad(...))
# ---------------------------------------------------------------------------

STEP_REPS = 9         # paired graph / eager steps, median of each
STEP_CHAIN = 8        # chained steps of the sustained time (JAX's KB)


def step_loss(img):
    """The bench's fwd+bwd loss: the L2 of the image against zero."""
    return (img ** 2).sum()


def masked_step_loss(img, mask):
    """``masked_loss_grads``' loss: the L2 of the masked image, in f64."""
    return (img * mask[..., None]).double().pow(2).sum()


def eager_step_out(scene, cam, cfg):
    """The eager step (``ops/graph.py::eager`` of ``render.py::_step``):
    what a flagged replay and a key kept eager run; ``(loss, *grads)``."""
    return graph_layer().eager(functools.partial(render_module()._step,
                                                 step_loss),
                               scene, cam, cfg, grad=True)


def eager_step(scene, cam, cfg):
    """:func:`eager_step_out` as ``(loss, grads by leaf)``."""
    out = eager_step_out(scene, cam, cfg)
    return out[0], dict(zip(scene.tensors(), out[1:]))


def pool_mib(pool):
    """Device memory the segments of one graph memory pool hold (MiB)."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) == tuple(pool)) / 2**20


def graph_step_case(dev, tag, scene, cam, cfg, build_dir):
    """One 1024² step as a graph: its capture (time, the device memory it
    added), the replay's loss bit for bit the eager step's and its
    gradients within ``GRAD_REL`` of each leaf's largest |g| (two eager
    steps' difference printed beside), the launches per replay equal to
    the eager step's, counted by the wrappers and read from the profiled
    replay; 0 syncs inside a replay and in the deferred step under sync
    debug mode "error"; graph and eager steps paired (median of
    ``STEP_REPS`` each), ``STEP_CHAIN`` chained steps of each, each one's
    profile (device ops, busy / span) and the eager step's peak."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops import cuda as ops_cuda, deferred
    R = render_module()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    ops_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    first = ft.render_value_and_grad(step_loss, scene, cam, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    sg = R.step_graph(step_loss, scene, cam, cfg)
    check(sg is not None and sg.graph is not None
          and ops_cuda.graph_counts() == dict(NO_GRAPH, captures=1),
          f"[step] {tag}: capture {ops_cuda.graph_counts()}")
    first_counts = launched(ops_cuda.launch_counts())
    del first
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() - reserved0

    ops_cuda.reset_launch_counts()
    loss, grads = ft.render_value_and_grad(step_loss, scene, cam, cfg)
    replay = launched(ops_cuda.launch_counts())
    check(ops_cuda.graph_counts() == dict(NO_GRAPH, replays=1),
          f"[step] {tag}: replay {ops_cuda.graph_counts()}")
    ops_cuda.reset_launch_counts()
    eloss, egrads = eager_step(scene, cam, cfg)
    eager = launched(ops_cuda.launch_counts())
    eloss2, egrads2 = eager_step(scene, cam, cfg)
    check(replay == eager == first_counts == launched(sg.launches)
          == step_launches(tag),
          f"[step] {tag}: launches per replay {replay}, recorded "
          f"{launched(sg.launches)}, eager {eager}, first call "
          f"{first_counts}, want {step_launches(tag)}")
    err = compare_grads(grads, egrads, f"[step] {tag}: the graph step's "
                        "gradients against the eager step's")
    err2 = compare_grads(egrads2, egrads, f"[step] {tag}: two eager steps' "
                         "gradients")
    same = torch.equal(loss, eloss) and torch.equal(eloss2, eloss)
    log(f"  {tag}: loss {float(loss)!r} (eager {float(eloss)!r}), bit for "
        f"bit: {same}; launches per replay {replay} (eager {eager}); "
        f"capture (eager run + capture) {sg.capture_s * 1e3:.1f} ms of a "
        f"first call of {first_s * 1e3:.1f} ms; the capture added "
        f"{held / 2**20:.1f} MiB of device memory (one pool with the "
        "frame graphs)")
    check(same, f"[step] {tag}: the graph step's loss is not the eager "
          "step's")
    check(all(bool(torch.isfinite(g).all()) for g in grads.values())
          and float(grads["prim_params/torus"].abs().sum()) > 0,
          f"[step] {tag}: gradients not finite or zero")

    # 0 syncs inside the replay and in the deferred step
    with torch.no_grad():
        for dst, src in zip(sg.inputs, graph_layer()._inputs(scene, cam)):
            dst.copy_(src)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    frame = deferred.Frame(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        sg.graph.replay()
        with deferred.deferring(frame):
            dout = eager_step_out(scene, cam, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    check(torch.equal(dout[0], eloss) and not bool(frame.flag),
          f"[step] {tag}: the deferred step")
    log(f"  {tag}: a replay and the deferred step under sync debug mode "
        "\"error\": 0 syncs; the deferred step's loss bit for bit, flag "
        "clear")

    def graph_fn():
        return ft.render_value_and_grad(step_loss, scene, cam, cfg)

    def eager_fn():
        return eager_step_out(scene, cam, cfg)

    g_ms, e_ms = paired_ms((graph_fn, eager_fn), reps=STEP_REPS)
    chain = {}
    for name, fn in (("graph", graph_fn), ("eager", eager_fn)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEP_CHAIN):
            fn()
        torch.cuda.synchronize()
        chain[name] = 1e3 * (time.perf_counter() - t0) / STEP_CHAIN
    check(torch.equal(graph_fn()[0], eloss),
          f"[step] {tag}: a later replay's loss is not the eager step's")
    torch.cuda.reset_peak_memory_stats()
    eager_fn()
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated()
    prof = {}
    for name, fn in (("graph", graph_fn), ("eager", eager_fn)):
        rec = {}
        profile_frame(scene, cam, cfg,
                      build_dir / f"chip_smoke_step_{tag}_{name}_trace.json",
                      fn=fn, ops=6 if name == "graph" else 0, record=rec)
        prof[name] = rec
    want = collections.Counter()
    for k, v in step_launches(tag).items():
        want[TRACE_NAMES[k]] += v
    traced = {name: traced_launches(rec) for name, rec in prof.items()}
    log(f"  {tag}: the port's kernels in the profiled replay "
        f"{dict(traced['graph'])}, in the eager step "
        f"{dict(traced['eager'])}, want {dict(want)}")
    check(traced["graph"] == traced["eager"] == want,
          f"[step] {tag}: traced launches {traced}, want {dict(want)}")
    res = {"graph_ms": statistics.median(g_ms),
           "eager_ms": statistics.median(e_ms), "graph_times_ms": g_ms,
           "eager_times_ms": e_ms, "paired_diff_ms": statistics.median(
               [a - b for a, b in zip(g_ms, e_ms)]),
           "sustained_graph_ms": chain["graph"],
           "sustained_eager_ms": chain["eager"],
           "capture_ms": 1e3 * sg.capture_s, "first_call_ms": 1e3 * first_s,
           "graph_mib": held / 2**20, "eager_peak_mib": eager_peak / 2**20,
           "grad_error": err, "eager_grad_error": err2, "launches": replay,
           **{f"{name}_{k}": v for name, rec in prof.items()
              for k, v in rec.items() if k != "kernels"}}
    log(f"  {tag}: graph step {res['graph_ms']:.3f} ms ({min(g_ms):.3f}–"
        f"{max(g_ms):.3f}) / eager {res['eager_ms']:.3f} ms "
        f"({min(e_ms):.3f}–{max(e_ms):.3f}) (medians of {STEP_REPS}, "
        f"paired; median paired difference {res['paired_diff_ms']:.3f} ms), "
        f"sustained over {STEP_CHAIN} chained steps: graph "
        f"{chain['graph']:.3f} ms, eager {chain['eager']:.3f} ms; profile "
        + "; ".join(f"{name} {rec.get('ops')} device ops, busy "
                    f"{rec.get('busy_ms', float('nan')):.3f} of "
                    f"{rec.get('span_ms', float('nan')):.3f} ms"
                    for name, rec in prof.items())
        + f"; eager step peak {eager_peak / 2**20:.1f} MiB ({nvidia_smi()})")
    return res


def step_kept_eager_case(dev, scene, cam, cfg, label):
    """The ``blend1000`` step: its deferred first run raises the flag (the
    backward's certificate fails on the overlapping tori), so that call
    runs the eager step again and captures nothing, and the key's later
    steps run eagerly (taking the dense branch); each equal to the eager
    step."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops import cuda as ops_cuda, deferred
    from fraytracer_tpu_torch.ops import point_eval
    R = render_module()
    frame = deferred.Frame(dev)
    stats0 = dict(point_eval.STATS)
    with deferred.deferring(frame):
        eager_step_out(scene, cam, cfg)
    check(bool(frame.flag) and point_eval.STATS == stats0,
          f"[step] {label}: the deferred step's flag {bool(frame.flag)}, "
          f"certificate reads {point_eval.STATS} against {stats0}")
    # the flag's cause: the forward alone raises none
    fwd = deferred.Frame(dev)
    with torch.no_grad(), deferred.deferring(fwd):
        R._frame(scene, cam, cfg)
    check(not bool(fwd.flag), f"[step] {label}: the forward raised the flag")
    ops_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    l0, g0 = ft.render_value_and_grad(step_loss, scene, cam, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first = ops_cuda.graph_counts()
    sg = R.step_graph(step_loss, scene, cam, cfg)
    stats1 = dict(point_eval.STATS)
    ops_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    l1, g1 = ft.render_value_and_grad(step_loss, scene, cam, cfg)
    torch.cuda.synchronize()
    later_s = time.perf_counter() - t0
    counts, gc = launched(ops_cuda.launch_counts()), ops_cuda.graph_counts()
    route = {k: point_eval.STATS[k] - stats1[k] for k in stats1}
    el, eg = eager_step(scene, cam, cfg)
    check(first == dict(NO_GRAPH, eager_reruns=1) and sg.graph is None,
          f"[step] {label}: first call {first}, graph {sg.graph}")
    check(gc == dict(NO_GRAPH, eager_frames=1), f"[step] {label}: {gc}")
    check(route == {"certificate_reads": 1, "culled": 0, "dense": 1},
          f"[step] {label}: the eager step's route {route}")
    check(counts == step_launches("blend"),
          f"[step] {label}: launches {counts}")
    errs = [compare_grads(g, eg, f"[step] {label}: call {i} against the "
                          "eager step") for i, g in enumerate((g0, g1))]
    check(torch.equal(l0, el) and torch.equal(l1, el),
          f"[step] {label}: the key's losses are not the eager step's: "
          f"{float(l0)} {float(l1)} {float(el)}")
    graph_layer()._graphs.pop(graph_layer().key("step", scene, cam, cfg,
                                                extra=(step_loss,)))
    log(f"  {label}: kept eager — the deferred step raised the flag (the "
        "backward's certificate fails on the overlapping tori; the forward "
        f"raises none); first call {first}, {first_s:.3f} s; a later call "
        f"{gc}, point_eval {route} (the dense branch), {later_s:.3f} s, "
        f"launches {counts}; loss bit for bit the eager step's, gradients "
        f"within {max(errs):.3e} ({nvidia_smi()})")
    return {"first_s": first_s, "later_s": later_s, "launches": counts}


def step_flagged_replay_case(dev, scene, cam, cfg, label):
    """A captured step whose replay raises the flag: the tori's centres
    pulled toward the origin (x 0.05) in place, so that a tile's
    candidates overflow its table.  The replay runs the eager step again,
    equal to the edited scene's eager step, its launches the replay's
    recorded ones plus the re-run's; undone, the replay is the first step
    again."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops import cuda as ops_cuda
    R = render_module()
    before = ft.render_value_and_grad(step_loss, scene, cam, cfg)
    sg = R.step_graph(step_loss, scene, cam, cfg)
    check(sg is not None and sg.graph is not None,
          f"[step] {label}: the key has no graph")
    tori = scene.prim_params["torus"]
    old = tori.clone()
    with torch.no_grad():
        tori[:, 0:3] *= 0.05
    try:
        ops_cuda.reset_launch_counts()
        loss, grads = ft.render_value_and_grad(step_loss, scene, cam, cfg)
        counts, gc = ops_cuda.launch_counts(), ops_cuda.graph_counts()
        ops_cuda.reset_launch_counts()
        eloss, egrads = eager_step(scene, cam, cfg)
        eager = ops_cuda.launch_counts()
        f_ms, e_ms = paired_ms((
            lambda: ft.render_value_and_grad(step_loss, scene, cam, cfg),
            lambda: eager_step(scene, cam, cfg)), reps=3)
    finally:
        with torch.no_grad():
            tori.copy_(old)
    want = {k: sg.launches[k] + eager[k] for k in eager}
    err = compare_grads(grads, egrads, f"[step] {label}: the re-run against "
                        "the eager step")
    check(gc == dict(NO_GRAPH, replays=1, eager_reruns=1),
          f"[step] {label}: {gc}")
    check(counts == want, f"[step] {label}: launches {launched(counts)}, "
          f"want {launched(want)}")
    check(torch.equal(loss, eloss),
          f"[step] {label}: the re-run's loss is not the eager step's")
    again = ft.render_value_and_grad(step_loss, scene, cam, cfg)
    check(torch.equal(again[0], before[0]),
          f"[step] {label}: the replay after the edit was undone")
    log(f"  {label}: flag set, {gc}; launches {launched(counts)} = the "
        f"replay's {launched(sg.launches)} + the eager re-run's "
        f"{launched(eager)}; loss bit for bit the edited scene's eager "
        f"step, gradients within {err:.3e}; replay + re-run "
        f"{statistics.median(f_ms):.3f} ms against eager "
        f"{statistics.median(e_ms):.3f} ms (medians of 3, paired; "
        f"{nvidia_smi()}); undone, the replay is the first step")
    return {"flagged_ms": statistics.median(f_ms),
            "eager_ms": statistics.median(e_ms)}


def step_kernel_vs_plain(dev):
    """256² / 96 tori: the captured step's gradients against the plain
    route's step, with ``[grad]`` (a)'s masking and bound."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops import cuda as ops_cuda
    from fraytracer_tpu_torch.scene.generators import torus_csg_scene
    scene = ft.flatten(torus_csg_scene(19, 96), device=dev)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    cfg = bench_config(256)
    mk_, tk, _ck, _nk = outcome_masks(scene, cam, cfg)
    with plain_route():
        mp_, tp, _cp, _np = outcome_masks(scene, cam, cfg)
    same = same_outcomes(mk_, mp_) & ((tk - tp).abs() <= 1e-4)
    ops_cuda.reset_launch_counts()
    for _ in range(2):
        loss, gk = ft.render_value_and_grad(masked_step_loss, scene, cam,
                                            cfg, same)
    check(ops_cuda.graph_counts() == dict(NO_GRAPH, captures=1, replays=1),
          f"[step] 256^2: {ops_cuda.graph_counts()}")
    with plain_route():
        gp, lp = masked_loss_grads(scene, cam, cfg, same)
    worst = worst_leaf_error({k: v.double() for k, v in gk.items()}, gp,
                             "(step) 256^2 / 96 tori, the captured step vs "
                             "the plain route's step, masked")
    log(f"  256^2 / 96 tori: masked loss {float(loss):.9g} (plain "
        f"{lp:.9g}), lanes masked out {1 - float(same.float().mean()):.6f}"
        f"; worst leaf {worst:.2e} (bound 1e-3)")
    check(worst <= 1e-3, f"[step] 256^2 masked error {worst}")
    return worst


def step_fit_vs_eager(build_dir):
    """10 ``cli fit`` steps at 256² / 100 tori through the graph step
    against the same fit with every step eager: the losses within rtol
    1e-5."""
    from fraytracer_tpu_torch import cli
    G = graph_layer()
    reports = {}
    for name in ("graph", "eager"):
        report = build_dir / f"chip_smoke_step_fit_{name}.json"
        real = G.capturable
        if name == "eager":
            G.capturable = lambda *a: False
        try:
            rc = cli.main(["fit", "--size", "256", "--tori", "100",
                           "--steps", "10", "--out-report", str(report)])
        finally:
            G.capturable = real
        check(rc == 0, f"[step] fit ({name}) returned {rc}")
        reports[name] = json.loads(report.read_text())
    g, e = reports["graph"]["losses"], reports["eager"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(g, e))
    log(f"  fit, 10 steps at 256^2 / 100 tori: graph losses "
        f"{[round(x, 9) for x in g]} in {reports['graph']['wall_s']} s, "
        f"eager in {reports['eager']['wall_s']} s; largest relative "
        f"difference {rel:.3e} (bound 1e-5)")
    check(rel <= 1e-5, f"[step] fit losses differ by {rel}")
    return {"rel": rel, "graph_wall_s": reports["graph"]["wall_s"],
            "eager_wall_s": reports["eager"]["wall_s"]}


def phase_step(dev, scene, blend, build_dir):
    """[step]: ``render_value_and_grad`` as one captured CUDA graph a key
    (ops/graph.py): the culled and the dense 1024² bench steps
    (:func:`graph_step_case`), the graph memory pool with the frame graphs
    of ``[graph]`` and these steps, ``blend1000``'s step kept eager, a
    replay that overflows, the captured 256² step against the plain route,
    and ``cli fit`` against the eager fit."""
    import fraytracer_tpu_torch as ft
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    out = {}
    for tag, cull in (("culled", True), ("dense", False)):
        out[tag] = graph_step_case(dev, tag, scene, cam,
                                   bench_config(SIZE, cull), build_dir)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    G = graph_layer()
    out["pool_mib"] = pool_mib(G._pools[dev.index])
    frames = sum(1 for k in G._graphs if k[0] != "step")
    log(f"  the graph memory pool holds {out['pool_mib']} MiB with "
        f"{frames} frame graphs and the two step graphs (each step "
        "capture's own growth: " + ", ".join(
            f"{tag} {out[tag]['graph_mib']:.1f}" for tag in ("culled",
                                                             "dense"))
        + f" MiB; {nvidia_smi()})")
    out["blend"] = step_kept_eager_case(
        dev, blend, cam, bench_config(SIZE), f"blend1000 step ({SIZE}^2)")
    out["flagged_replay"] = step_flagged_replay_case(
        dev, scene, cam, bench_config(SIZE), f"a replay that overflows "
        f"({SIZE}^2, the tori's centres x 0.05)")
    out["plain"] = step_kernel_vs_plain(dev)
    out["fit"] = step_fit_vs_eager(build_dir)
    return out


# ---------------------------------------------------------------------------
# phase 8: the spectral wavefront
# ---------------------------------------------------------------------------

SPECTRAL_SIZE = 512
# one frame at depth 4 when no march overflows its tables: K1 and K3 once a
# round, K2 once a light a round, K4 once a field (8) a compaction (3)
SPECTRAL_LAUNCHES = {"march_culled": 4, "surface_culled": 4,
                     "occlusion_culled": 8, "block_gather": 24,
                     # a table build (cones, select) at each culled site
                     "cull_cones": 12, "cull_select": 12}
# (a)'s bound, kernels vs plain route on one card and the same inputs: the
# readings were max |diff| 2.06e-6 (96 tori) and 4.53e-6 (1000 tori), two
# runs of one route differ by up to 6e-8 (index_add_'s atomic order); one
# flipped hit or occlusion outcome moves a pixel by far more
SPECTRAL_PLAIN_MAX = 1e-4


def spectral_config(depth=4):
    """The JAX bench's spectral section (bench.py:341-344): 8 bins, depth
    4, the bench frame's march configuration."""
    import fraytracer_tpu_torch as ft
    return ft.WavefrontConfig(depth=depth, epsilon=EPS, length=30.0,
                              march=bench_config(SIZE).march)


@contextlib.contextmanager
def spectral_spies():
    """For one spectral frame, round by round: the queue's active and
    inside-glass lanes (and round 1's queue itself), each culled march's
    tables (rows ``m``, lanes with a budget, candidates
    per tile max / mean, overflow — an overflowed call runs again with
    whole-group tables, a table build of its own) and the material
    repair's tier; and the first compaction's inputs of K4 (a scalar and a
    vec3 field with the kept block indices).  Recorded by wrapping the
    functions from outside; their reductions sync the host, so timed
    frames run without the spies."""
    from fraytracer_tpu_torch.ops import wavefront as tw
    from fraytracer_tpu_torch.ops.cuda import gather, march_kernel as mk
    from fraytracer_tpu_torch.ops.cuda.gather import BLOCK
    rec = {"rounds": [{"active": None, "tables": [], "repair": []}],
           "k4": {}}
    real = (mk.build_pair_tables, tw.resolve_material, tw._bounce,
            gather.flat_block_gather)

    def tables(scene, origin, direction, t0, length, *a, **k):
        out = real[0](scene, origin, direction, t0, length, *a, **k)
        q = out.tables[0]
        rec["rounds"][-1]["tables"].append(dict(
            m=q.m, lanes=int((length > 0).sum()), max=int(q.count.max()),
            mean=q.count.float().mean().item(),
            overflow=out.overflow is not None and bool(out.overflow)))
        return out

    def repair(scene, pos, hit, midx, backend="cuda"):
        bad = (hit & (midx < 0)).reshape(-1)
        nb = bad.numel() // BLOCK
        blocks = int(bad[:nb * BLOCK].reshape(nb, BLOCK).any(1).sum())
        rec["rounds"][-1]["repair"].append(
            repair_tier(int(bad.sum()), blocks, bad.numel()))
        return real[1](scene, pos, hit, midx, backend=backend)

    def bounce(scene, q, *a, **k):
        fields = [getattr(q, f.name) for f in dataclasses.fields(q)]
        rec["rounds"].append({"active": int(q.active.sum()), "tables": [],
                              "repair": [], "queue_bytes": nbytes(*fields),
                              "inside": int((q.active & q.inside).sum())})
        if len(rec["rounds"]) == 2:
            rec["queue1"] = q
        return real[2](scene, q, *a, **k)

    def gather_spy(x, idx, n):
        # a compaction halves its queue (the repair's tier gathers 16)
        name = "vec3" if x.ndim == 2 else "scalar"
        if 2 * n * BLOCK == x.shape[0] and name not in rec["k4"]:
            rec["k4"][name] = (x, idx)
        return real[3](x, idx, n)

    (mk.build_pair_tables, tw.resolve_material, tw._bounce,
     gather.flat_block_gather) = tables, repair, bounce, gather_spy
    try:
        yield rec
    finally:
        (mk.build_pair_tables, tw.resolve_material, tw._bounce,
         gather.flat_block_gather) = real


def spectral_rounds(rec):
    """Label each round's table builds (the march, then one shadow march
    a light, a re-run right after the call that overflowed) and count the
    re-runs of marches and of shadow marches; log a line a round."""
    reruns = {"march": 0, "occlusion": 0}
    out = []
    for r, rnd in enumerate(rec["rounds"]):
        names, prev = [], None
        for tab in rnd["tables"]:
            if prev is not None and prev["overflow"]:
                name = f"re-run of {names[-1]}"
                reruns["march" if names[-1] == "march" else "occlusion"] += 1
            else:
                calls = [n for n in names if not n.startswith("re-run")]
                name = "march" if not calls else f"light {len(calls) - 1}"
            names.append(name)
            prev = tab
        log(f"  round {r}: {rnd['active'] if r else 'primary'} active lanes"
            + (f" ({rnd['inside']} inside glass) in a queue of "
               f"{rnd['queue_bytes']} bytes; " if r else "; ")
            + "; ".join(f"{n}: m {t['m']}, {t['lanes']} lanes with a budget,"
                        f" candidates per tile max {t['max']} mean "
                        f"{t['mean']:.2f}{', OVERFLOW' if t['overflow'] else ''}"
                        for n, t in zip(names, rnd["tables"]))
            + f"; repair {rnd['repair']}")
        out.append(dict(active=rnd["active"], repair=rnd["repair"],
                        queue_bytes=rnd.get("queue_bytes"),
                        inside=rnd.get("inside"),
                        tables=dict(zip(names, rnd["tables"]))))
    return out, reruns


def spectral_k4_times(rec):
    """K4 at the spectral path's shapes (the first compaction: 4,096 blocks
    of the 2C queue in, 2,048 out): bit for bit against its plain version
    and the library's ``index_select`` of the same blocks; device ms of
    each beside the bound (bytes read and written once)."""
    from fraytracer_tpu_torch.ops.cuda.gather import (
        BLOCK, _gather_blocks, block_gather_plain)
    device_ms = device_timer()
    out = {}
    for name in ("scalar", "vec3"):
        x, idx = rec["k4"][name]
        xb = x.contiguous().reshape(x.shape[0] // BLOCK, -1)
        lidx = idx.long()
        gk = _gather_blocks(xb, idx)
        gp = block_gather_plain(xb, idx)
        lib = xb.index_select(0, lidx)
        same = lambda a, b: torch.equal(a.view(torch.int32),
                                        b.view(torch.int32))
        check(same(gk, gp), f"K4 spectral {name}: kernel differs from plain")
        check(same(gk, lib), f"K4 spectral {name}: kernel differs from "
              "index_select")
        out[name] = dict(
            blocks_in=xb.shape[0], blocks_out=idx.numel(),
            block_bytes=xb.shape[1] * 4,
            ms=device_ms(lambda: _gather_blocks(xb, idx)),
            plain_ms=device_ms(lambda: block_gather_plain(xb, idx)),
            library_ms=device_ms(lambda: xb.index_select(0, lidx)),
            bound_ms=bound(2 * nbytes(gk) + nbytes(idx), 0.0)[0])
        r = out[name]
        log(f"  K4 spectral {name} field ({r['blocks_in']} blocks of "
            f"{r['block_bytes']} bytes in, {r['blocks_out']} out): kernel "
            f"{r['ms']:.5f} ms on the device, plain {r['plain_ms']:.5f}, "
            f"index_select {r['library_ms']:.5f}, bound {r['bound_ms']:.5f} "
            "(bytes); bit for bit equal to both")
    return out


def spectral_path_kernels(scene, q, cfg, tiles=32):
    """K1/K2/K3 against their plain versions at the spectral path's shapes:
    one bounce round (``_bounce``) of the 512² frame's round-1 queue ``q``
    on ``tiles`` of its 1024-lane tiles — half those with the most
    inside-glass lanes, half the busiest of the rest — with every kernel
    call recorded and run again through its plain version on the same
    inputs and tables.  The tiles keep their lanes, so their tables are
    the frame's: m 1000 (staged above the 48 KB opt-in, keys and suffix
    minima copied by the threads), sign = -1 lanes, the point light's
    converging cone from scattered secondary hits."""
    from fraytracer_tpu_torch.ops import wavefront as tw
    from fraytracer_tpu_torch.ops.cuda import cull, march_kernel as mk
    from fraytracer_tpu_torch.ops.cuda.gather import BLOCK
    nt = q.active.numel() // BLOCK
    per_tile = lambda x: x.view(nt, BLOCK).sum(1)
    inside = per_tile((q.active & q.inside).int())
    busy = per_tile(q.active.int())
    pick = torch.topk(inside, tiles // 2).indices
    busy[pick] = -1
    pick = torch.cat([pick, torch.topk(busy, tiles - tiles // 2).indices])
    pick = pick.sort().values
    sub = q.map(lambda x: x.view((nt, BLOCK) + tuple(x.shape[1:]))[pick]
                .reshape((-1,) + tuple(x.shape[1:])))
    log(f"  (a') one bounce round on {tiles} of the {nt} tiles of the "
        f"{SPECTRAL_SIZE}^2 frame's round-1 queue: {int(sub.active.sum())} active lanes, "
        f"{int((sub.active & sub.inside).sum())} inside glass")
    calls = []
    real = (mk.march_kernel, mk.surface_kernel)

    def march_rec(scene, *a, **k):
        out = real[0](scene, *a, **k)
        calls.append(("K2" if k.get("occlusion") else "K1", a, k, out))
        return out

    def surface_rec(scene, *a, **k):
        out = real[1](scene, *a, **k)
        calls.append(("K3", a, k, out))
        return out
    mk.march_kernel, mk.surface_kernel = march_rec, surface_rec
    try:
        npix = SPECTRAL_SIZE * SPECTRAL_SIZE
        tw._bounce(scene, sub, torch.zeros((npix, 3), device=q.pixel.device),
                   cfg, is_last=False)
    finally:
        mk.march_kernel, mk.surface_kernel = real
    labels = iter(["march"] + [f"light {i}" for i in range(scene.num_lights)])
    names = [c[0] + ("" if c[0] == "K3" else f" ({next(labels)})")
             for c in calls]
    check([c[0] for c in calls] == ["K1", "K3"] + ["K2"] * scene.num_lights,
          f"(a') kernel calls {names}: an overflow re-run or a missing call")
    for name, (kind, a, k, out) in zip(names, calls):
        tab = k["cull"]
        check(tab is not None, f"(a') {name}: not culled")
        ms = [t.m for t in tab.tables]
        want_m = [cull._pair_m(cfg.bounce_cull_m, r1 - r0)
                  for (_g, _k, _ki, r0, r1) in tab.pairs]
        check(ms == want_m and 1000 in ms, f"(a') {name}: tables of m {ms}")
        plan = mk.march_stage_plan(mk.lower_program(scene, a[0].device,
                                                    tab.pairs), tab)
        lanes = a[4] if kind == "K3" else a[2] > 0
        # K3 marches nothing: its hit lanes' sign is the march's
        sign = calls[0][2].get("sign") if kind != "K2" else None
        neg = "" if sign is None \
            else f", {int((lanes & (sign < 0)).sum())} of them sign -1"
        label = (f"{name} culled, path tiles (m {ms}, candidates per tile "
                 f"max {[int(t.count.max()) for t in tab.tables]}, "
                 f"{plan.bytes} bytes staged a block, bulk copies "
                 f"{[cull.bulk_slices(m) for m in ms]}, {int(lanes.sum())} "
                 f"{'hit lanes' if kind == 'K3' else 'lanes with a budget'}"
                 f"{neg})")
        if kind == "K1":
            check(plan.bytes > 48 * 1024
                  and bool((lanes & (sign < 0)).any()),
                  f"(a') {label}: not the shapes this phase is for")
            compare_march(out, mk.march_plain(scene, *a, **k), label)
        elif kind == "K2":
            p = mk.march_plain(scene, *a, **k)
            agree = (out[0] == p[0]).float().mean().item()
            log(f"  {label}: hit agreement {agree:.6f}")
            check(agree >= 0.999, f"{label}: {agree}")
        else:
            compare_surface(out, mk.surface_plain(scene, *a, **k), a[4],
                            label)
    torch.cuda.synchronize()


# (e)'s bound, the graph spectral frame against the eager frame: each sums
# its image with index_add_, whose atomic adds land in another order from
# run to run, so two eager frames differ in the last bits too (printed)
SPECTRAL_GRAPH_MAX = 1e-5
SPECTRAL_CHAIN = 8    # chained spectral frames of the sustained time


def spectral_sites(scene, sites):
    """Name a spectral frame's culled march calls (its sites, numbered in
    call order): each round's march, then its shadow march of each
    light."""
    per = 1 + scene.num_lights
    return [f"round {i // per} "
            + ("march" if i % per == 0 else f"light {i % per - 1}")
            for i in sorted(sites)]


def spectral_graph_case(dev, scene, cam, cfg, build_dir, eager_peak,
                        eager_prof):
    """(e) the graph spectral frame: ``render_spectral_with_stats`` at the
    full width, one captured CUDA graph (``ops/graph.py``; the sites whose
    tables overflowed in the key's first run promoted to full-group
    tables): the promoted sites by round and call; the first call's
    launches (two deferred runs) and a replay's, counted by the wrappers
    and read by name from a profiled replay (``SPECTRAL_LAUNCHES``); the
    replay against the eager frame within ``SPECTRAL_GRAPH_MAX``, two eager
    frames' own difference beside it, ``n_rays`` equal; 0 syncs in a replay
    and in the deferred frame under sync debug mode "error"; every torus
    moved in place between two replays against the edited scene's eager
    frame; ``capture_s``, graph and eager frames paired (median of
    ``GRAPH_REPS``), ``SPECTRAL_CHAIN`` chained frames of each, a profile of
    a replay and the growth of the graphs' memory pool."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops import cuda as ops_cuda, deferred
    from fraytracer_tpu_torch.ops import wavefront as tw
    from fraytracer_tpu_torch.scene.nodes import LIGHT_POINT
    S = SPECTRAL_SIZE
    graph = lambda: ft.render_spectral_with_stats(scene, cam, S, S, cfg)
    eager = lambda: tw._spectral_frame(scene, cam, S, S, cfg)

    def pool_now():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        pool = graph_layer()._pools.get(dev.index)
        return 0.0 if pool is None else pool_mib(pool)
    pool0 = pool_now()
    ops_cuda.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = graph()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    capture_peak = torch.cuda.max_memory_allocated()
    sg = tw.spectral_graph(scene, cam, S, S, cfg)
    gc = ops_cuda.graph_counts()
    check(sg is not None and sg.graph is not None
          and gc == dict(NO_GRAPH, captures=1),
          f"(e) the spectral key's first call: {gc}, graph "
          f"{None if sg is None else sg.graph}")
    first_counts = launched(ops_cuda.launch_counts())
    promoted = sorted(sg.frame.promoted)
    per = 1 + scene.num_lights
    point = 1 + scene.light_kind.index(LIGHT_POINT)
    log(f"  (e) promoted sites (culled march calls in call order, {per} a "
        f"round): {promoted} = {spectral_sites(scene, promoted)}")
    check(point in promoted and max(promoted) < per,
          f"(e) promoted sites {promoted}: want round 0's point light "
          f"(site {point}), none in a bounce round")
    runs = 1 + bool(promoted)
    want_first = {k: runs * v for k, v in SPECTRAL_LAUNCHES.items()}
    check(first_counts == want_first,
          f"(e) the first call's launches {first_counts}, want {want_first} "
          f"({runs} deferred runs)")
    del first
    pool_growth = pool_now() - pool0

    ops_cuda.reset_launch_counts()
    img, n_rays = graph()
    replay = launched(ops_cuda.launch_counts())
    gc = ops_cuda.graph_counts()
    check(gc == dict(NO_GRAPH, replays=1), f"(e) replay {gc}")
    check(replay == launched(sg.launches) == SPECTRAL_LAUNCHES,
          f"(e) launches per replay {replay}, recorded "
          f"{launched(sg.launches)}, want {SPECTRAL_LAUNCHES}")
    e1, en1 = eager()
    e2, en2 = eager()
    d = (img - e1).abs().max().item()
    d_eager = (e2 - e1).abs().max().item()
    log(f"  (e) graph frame vs eager frame: max |d| {d:.3e} (two eager "
        f"frames: {d_eager:.3e}; bound {SPECTRAL_GRAPH_MAX}), n_rays "
        f"{int(n_rays)} vs {int(en1)} / {int(en2)}; launches per replay "
        f"{replay}; first call (two deferred runs, the capture) "
        f"{first_s * 1e3:.1f} ms, capture_s {sg.capture_s * 1e3:.1f} ms, "
        f"launches {first_counts}")
    check(img.shape == (S, S, 3) and bool(torch.isfinite(img).all()),
          "(e) graph spectral image")
    check(d <= SPECTRAL_GRAPH_MAX and int(n_rays) == int(en1) == int(en2),
          f"(e) the graph spectral frame against the eager frame: {d}, "
          f"n_rays {int(n_rays)} / {int(en1)} / {int(en2)}")

    # 0 syncs inside a replay and in the deferred frame (promoted sites)
    with torch.no_grad():
        for dst, src in zip(sg.inputs, graph_layer()._inputs(scene, cam)):
            dst.copy_(src)
    torch.cuda.synchronize()
    frame = deferred.Frame(dev)
    frame.promoted = sg.frame.promoted
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sg.graph.replay()
        with deferred.deferring(frame):
            dimg, dn = tw._spectral_frame(scene, cam, S, S, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    dd = (dimg - e1).abs().max().item()
    check(not bool(frame.flag) and dd <= SPECTRAL_GRAPH_MAX
          and int(dn) == int(en1), f"(e) the deferred frame: flag "
          f"{bool(frame.flag)}, max |d| {dd}")
    log("  (e) a replay and the deferred frame (sites promoted) under sync "
        f"debug mode \"error\": 0 syncs; the deferred frame's flag clear, "
        f"max |d| {dd:.3e} against the eager frame")

    # every torus moved in place between two replays
    tori = scene.prim_params["torus"]
    old = tori.clone()
    with torch.no_grad():
        tori[:, 0:3] += 0.05
    try:
        ops_cuda.reset_launch_counts()
        mimg, mn = graph()
        mcounts, mgc = launched(ops_cuda.launch_counts()), \
            ops_cuda.graph_counts()
        wimg, wn = eager()
    finally:
        with torch.no_grad():
            tori.copy_(old)
    dm = (mimg - wimg).abs().max().item()
    changed = int(((mimg - img).abs().amax(-1) > 1e-3).sum())
    log(f"  (e) every torus moved by (0.05, 0.05, 0.05) in place between "
        f"two replays: {changed} pixels changed; {mgc} (flag "
        f"{'set: eager re-run' if mgc['eager_reruns'] else 'clear'}), "
        f"launches {mcounts}; max |d| {dm:.3e} against the edited scene's "
        f"eager frame, n_rays {int(mn)} vs {int(wn)}")
    check(dm <= SPECTRAL_GRAPH_MAX and int(mn) == int(wn) and changed > 0,
          f"(e) the replay after an edit: {dm}, {changed} pixels changed")
    again = graph()[0]
    check((again - e1).abs().max().item() <= SPECTRAL_GRAPH_MAX,
          "(e) the replay after the edit was undone")

    g_ms, e_ms = paired_ms((graph, eager))
    chain = {}
    for name, fn in (("graph", graph), ("eager", eager)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SPECTRAL_CHAIN):
            fn()
        torch.cuda.synchronize()
        chain[name] = 1e3 * (time.perf_counter() - t0) / SPECTRAL_CHAIN
    rec = {}
    profile_frame(scene, cam, None,
                  build_dir / "chip_smoke_spectral_graph_trace.json",
                  fn=graph, ops=8, record=rec)
    want = collections.Counter()
    for k, v in SPECTRAL_LAUNCHES.items():
        want[TRACE_NAMES[k]] += v
    traced = traced_launches(rec)
    log(f"  (e) the port's kernels in the profiled replay {dict(traced)}, "
        f"want {dict(want)}")
    check(traced == want, f"(e) traced launches {dict(traced)}, want "
          f"{dict(want)}")
    res = {"promoted": spectral_sites(scene, promoted), "launches": replay,
           "first_launches": first_counts, "max_abs_diff": d,
           "eager_max_abs_diff": d_eager, "edit_max_abs_diff": dm,
           "edit_graph_counts": mgc, "capture_ms": 1e3 * sg.capture_s,
           "first_call_ms": 1e3 * first_s, "graph_ms": statistics.median(g_ms),
           "eager_ms": statistics.median(e_ms), "graph_times_ms": g_ms,
           "eager_times_ms": e_ms, "paired_diff_ms": statistics.median(
               [a - b for a, b in zip(g_ms, e_ms)]),
           "sustained_graph_ms": chain["graph"],
           "sustained_eager_ms": chain["eager"], "pool_growth_mib":
           pool_growth, "pool_mib": pool0 + pool_growth,
           "capture_peak_mib": capture_peak / 2**20,
           "eager_peak_mib": eager_peak / 2**20,
           **{f"graph_{k}": v for k, v in rec.items() if k != "kernels"},
           **{f"eager_{k}": v for k, v in eager_prof.items()
              if k != "kernels"}}
    idle = {name: 1 - p["busy_ms"] / p["span_ms"] if "busy_ms" in p
            else None for name, p in (("graph", rec), ("eager", eager_prof))}
    res.update(graph_idle=idle["graph"], eager_idle=idle["eager"])
    log(f"  (e) graph {res['graph_ms']:.3f} ms ({min(g_ms):.3f}–"
        f"{max(g_ms):.3f}) / eager {res['eager_ms']:.3f} ms "
        f"({min(e_ms):.3f}–{max(e_ms):.3f}) (medians of {GRAPH_REPS}, "
        f"paired; median paired difference {res['paired_diff_ms']:.3f} ms), "
        f"sustained over {SPECTRAL_CHAIN} chained frames: graph "
        f"{chain['graph']:.3f} ms, eager {chain['eager']:.3f} ms; profile: "
        f"graph {rec.get('ops')} device ops, busy "
        f"{rec.get('busy_ms', float('nan')):.3f} of "
        f"{rec.get('span_ms', float('nan')):.3f} ms (idle {idle['graph']}), "
        f"eager {eager_prof.get('ops')} ops, busy "
        f"{eager_prof.get('busy_ms', float('nan')):.3f} of "
        f"{eager_prof.get('span_ms', float('nan')):.3f} ms (idle "
        f"{idle['eager']}); the pool grew {pool_growth:.1f} MiB to "
        f"{pool0 + pool_growth:.1f} MiB (peak during the first call "
        f"{capture_peak / 2**20:.1f} MiB, the eager frame's "
        f"{eager_peak / 2**20:.1f}; {nvidia_smi()})")
    return res


def phase_spectral(dev, build_dir, reps=5):
    """(a) the 64² × 8-bin, depth-3 frame on ``spectral_csg_scene(19,
    1000)`` through the kernels against the plain route (its bounce rounds
    build tables of m 1000 and march inside-glass lanes); (b) the
    full-width frame (512² × 8 bins, depth 4, the same scene, the bench's
    march configuration): launch counts around the first call checked
    against ``SPECTRAL_LAUNCHES`` plus the re-runs the spied frame shows,
    active lanes and candidates per tile round by round, the median of
    ``reps``, peak memory, a profiled frame; (c) K4 at the path's shapes;
    (a') K1/K2/K3 against their plain versions on tiles of (b)'s round-1
    queue; (e) the graph spectral frame (:func:`spectral_graph_case`).
    (a), (b) and (a') run the eager body, ``_spectral_frame``: their spies
    and patched kernels would not run in a replay."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.image.io import save_image
    from fraytracer_tpu_torch.ops import cuda as ops_cuda
    from fraytracer_tpu_torch.ops import wavefront as tw
    from fraytracer_tpu_torch.scene.generators import spectral_csg_scene
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)

    scene = ft.flatten(spectral_csg_scene(19, BENCH_N_TORI), device=dev)
    scfg = spectral_config(depth=3)
    # the eager body: a replay would run neither the spies nor the plain
    # route's kernels
    ops_cuda.reset_launch_counts()
    with spectral_spies() as srec:
        ik, nk = tw._spectral_frame(scene, cam, 64, 64, scfg)
    small_counts = ops_cuda.launch_counts()
    with plain_route():
        ip, np_ = tw._spectral_frame(scene, cam, 64, 64, scfg)
    check(ops_cuda.launch_counts() == small_counts,
          "the plain route launched a kernel")
    d = (ik - ip).abs()
    bounce_m = sorted({t["m"] for rnd in srec["rounds"][1:]
                       for t in rnd["tables"]})
    inside = [rnd["inside"] for rnd in srec["rounds"][1:]]
    log(f"  (a) 64^2 x 8 bins, depth 3, {BENCH_N_TORI} tori, kernels vs "
        f"plain route: max |diff| {d.max().item():.3e}, mean "
        f"{d.mean().item():.3e}, pixels off by > 1e-4 "
        f"{int((d.amax(-1) > 1e-4).sum())}; n_rays {int(nk)} vs {int(np_)}; "
        f"bounce tables of m {bounce_m}, inside-glass lanes a bounce round "
        f"{inside}; kernel launches {small_counts}")
    check(bool(torch.isfinite(ik).all()), "(a) non-finite pixels")
    check(d.max().item() < SPECTRAL_PLAIN_MAX,
          "(a) spectral frame kernels vs plain route")
    check(abs(int(nk) - int(np_)) <= 5e-3 * int(np_), "(a) n_rays")
    check(small_counts["block_gather"] >= 16
          and small_counts["march_culled"] >= 3, "(a) kernels not launched")
    check(bounce_m == [1000] and min(inside) > 0,
          f"(a) bounce tables of m {bounce_m}, inside lanes {inside}")

    cfg = spectral_config()
    # (b) times the eager frame (spied and counted); (e) the graph frame
    render = lambda: tw._spectral_frame(scene, cam, SPECTRAL_SIZE,
                                        SPECTRAL_SIZE, cfg)
    ops_cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, n_rays = render()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = ops_cuda.launch_counts()
    log(f"  (b) launches in the spectral frame: {counts}")
    with spectral_spies() as rec:
        render()
    rounds, reruns = spectral_rounds(rec)
    block_repairs = sum(t == "block (K4)" for rnd in rounds
                        for t in rnd["repair"])
    want = dict(SPECTRAL_LAUNCHES)
    want["march_culled"] += reruns["march"]
    want["surface_culled"] += reruns["march"]
    want["occlusion_culled"] += reruns["occlusion"]
    want["block_gather"] += block_repairs
    for k in ("cull_cones", "cull_select"):
        want[k] += reruns["march"] + reruns["occlusion"]
    got = {k: v for k, v in counts.items() if v}
    log(f"  (b) expected launches {want} (re-runs {reruns}, block-tier "
        f"repairs {block_repairs})")
    check(got == want, f"(b) spectral frame launches {got}, want {want}")
    check(len(rounds) == 4, f"(b) {len(rounds)} rounds")
    check(img.shape == (SPECTRAL_SIZE, SPECTRAL_SIZE, 3)
          and bool(torch.isfinite(img).all()) and img.min().item() >= 0.0,
          "(b) spectral image")
    n_primary = SPECTRAL_SIZE * SPECTRAL_SIZE
    check(int(n_rays) > n_primary * 1.05, f"(b) n_rays {int(n_rays)}")

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, n_rays = render()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"  (b) spectral frame {SPECTRAL_SIZE}^2 x 8 bins, depth 4: first "
        f"{first_s * 1e3:.1f} ms, median of {reps} {med * 1e3:.2f} ms "
        f"({[round(t * 1e3, 2) for t in times]}), n_rays {int(n_rays)}, "
        f"{int(n_rays) / med:.4g} rays/s")
    torch.cuda.reset_peak_memory_stats()
    render()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"  (b) spectral frame peak device memory {peak / 2**20:.1f} MiB")
    eager_prof = {}
    idle = profile_frame(scene, cam, None,
                         build_dir / "chip_smoke_spectral_frame_trace.json",
                         fn=render, ops=16, record=eager_prof)
    gen = torch.Generator(device=dev).manual_seed(19)
    png = build_dir / "chip_smoke_spectral_frame.png"
    save_image(str(png), ft.tonemap(img, gen, 2.2).cpu().numpy())
    log(f"  wrote {png}")
    k4 = spectral_k4_times(rec)
    spectral_path_kernels(scene, rec["queue1"], cfg)
    graph = spectral_graph_case(dev, scene, cam, cfg, build_dir, peak,
                                eager_prof)
    return dict(counts=counts, want=want, reruns=reruns, rounds=rounds,
                n_rays=int(n_rays), first_s=first_s, med=med, peak=peak,
                idle=idle, k4=k4, small_err=d.max().item(), graph=graph)


# ---------------------------------------------------------------------------
# phase 9: W and P1-P4
# ---------------------------------------------------------------------------

PROBE_SRC = f"{SRC}/probe.cu"
PROBE_TOOL = "tools/probe_pallas_features.py"


def phase_probe(dev, warm_first_ms):
    """The probe program (the path of P1-P4) with the launch counts around
    it, then W and P1-P4 against their plain versions with their times.
    ``ms``, ``plain_ms`` and ``library_ms`` are device times
    (``probe.device_ms``: an event pair around each call while the device
    still works off a plug, median of 50 calls; the empty kernel's reading
    by the same method is the events' own cost); ``back_to_back_ms`` is
    the mean of 200 launches in a row.  All five
    are launch-bound: the bound is bytes over the memory rate, and the
    practical floor of a call is the empty kernel's back-to-back launch
    time of this run."""
    from fraytracer_tpu_torch.ops import cuda as ops_cuda
    from fraytracer_tpu_torch.ops.cuda import probe
    ops_cuda.reset_launch_counts()
    rc = probe.main()
    counts = ops_cuda.launch_counts()
    check(rc == 0, f"the probe program returned {rc}")
    log(f"  launches in the probe program: "
        f"{ {k: counts[k] for k in probe.LAUNCHES} }")
    for k in ("smem_block", "smem_block_2d", "dyn_loop", "while_loop"):
        check(counts[k] >= 1, f"the probe program never launched {k}")

    inp = probe.probe_inputs(dev)
    empty = lambda: probe.empty_launch(dev)
    empty_ms = probe.back_to_back_ms(empty)
    empty_dev_ms = probe.device_ms(empty)
    log(f"  empty kernel: {empty_ms:.5f} ms a launch back to back (the "
        f"host's launch rate, the floor of every call below), "
        f"{empty_dev_ms:.5f} ms on the device (the floor of every device "
        "time below)")
    x = torch.ones((8, 128), dtype=torch.float32, device=dev)
    tile_b = 8 * 128 * 4
    table_b = probe.G * probe.M * probe.P * 4
    tiles_b = 2 * probe.G * tile_b            # x read, out written
    keys_b = probe.G * probe.M * 4

    def exact(a, b):
        return float((a - b).abs().max()), int((a != b).sum())

    def row(kernel, plain, library, n_bytes, cmp):
        out_k, out_p = kernel(), plain()
        torch.cuda.synchronize()
        err, differing, compared = cmp(out_k, out_p)
        lib_ms = None if library is None else probe.device_ms(library)
        r = timing(probe.device_ms(kernel), probe.device_ms(plain), err,
                   differing, compared, bound(n_bytes, 0.0), lib_ms)
        r["back_to_back_ms"] = probe.back_to_back_ms(kernel)
        return r

    def cmp_exact(a, b):
        err, differing = exact(a, b)
        check(differing == 0, f"kernel and plain differ on {differing}")
        return err, differing, a.numel()

    def cmp_p3(a, b):
        check(bool(torch.allclose(a, b, rtol=1e-6, atol=0.0)),
              "P3 kernel vs plain beyond rtol 1e-6")
        return float((a - b).abs().max()), int((a != b).sum()), a.numel()

    def cmp_p4(a, b):
        (t, trips), (tp, trips_p) = a, b
        check(torch.equal(trips, trips_p), f"P4 trips {trips.tolist()} vs "
              f"plain {trips_p.tolist()}")
        check(float(t.min()) > 9.9, f"P4 t {float(t.min())} <= 9.9")
        err = float((t - tp).abs().max())
        check(err <= 1e-5, f"P4 kernel vs plain {err}")
        return err, int((trips != trips_p).sum()), t.numel()

    out = {}
    out["warm"] = row(lambda: probe.warm(x), lambda: probe.warm_plain(x),
                      lambda: x * 2.0, 2 * tile_b, cmp_exact)
    s1 = inp["ramp3"][:, 0, 3].repeat_interleave(8)[:, None].contiguous()
    s2 = inp["ramp3"][:, 3, 1].repeat_interleave(8)[:, None].contiguous()
    out["smem_block"] = row(
        lambda: probe.smem_block(inp["ones"], inp["ramp3"]),
        lambda: probe.smem_scalar_plain(inp["ones"], inp["ramp3"], probe.M,
                                        probe.P, 0, 3),
        lambda: inp["ones"] * s1, tiles_b + table_b, cmp_exact)
    out["smem_block_2d"] = row(
        lambda: probe.smem_block_2d(inp["ones"], inp["ramp2"]),
        lambda: probe.smem_scalar_plain(inp["ones"], inp["ramp2"], probe.M,
                                        probe.P, 3, 1),
        lambda: inp["ones"] * s2, tiles_b + table_b, cmp_exact)
    for table in ("smem", "ldg"):
        sfx = "" if table == "smem" else "_ldg"
        out["dyn_loop" + sfx] = row(
            lambda: probe.dyn_loop(inp["x3"], inp["cand3"], inp["keys3"],
                                   table=table),
            lambda: probe.dyn_loop_plain(inp["x3"], inp["cand3"],
                                         inp["keys3"]),
            None, tiles_b + table_b + keys_b, cmp_p3)
        out["while_loop" + sfx] = row(
            lambda: probe.while_loop(inp["zeros"], inp["cand4"],
                                     table=table),
            lambda: probe.while_loop_plain(inp["zeros"], inp["cand4"]),
            None, tiles_b + table_b + 4 * probe.G, cmp_p4)
    log_times(out)
    log("  back to back, ms a launch: " + ", ".join(
        f"{k} {v['back_to_back_ms']:.5f}" for k, v in out.items()))
    log(f"  W first launch of the process (CUDA context, library build or "
        f"load, launch) {warm_first_ms:.1f} ms; steady "
        f"{out['warm']['ms']:.5f} ms on the device")
    log(f"  table in shared memory vs __ldg, device ms: P3 "
        f"{out['dyn_loop']['ms']:.5f} / {out['dyn_loop_ldg']['ms']:.5f}, P4 "
        f"{out['while_loop']['ms']:.5f} / {out['while_loop_ldg']['ms']:.5f}")
    return out, counts, (empty_ms, empty_dev_ms)


# ---------------------------------------------------------------------------
# phase 10: the gradient path
# ---------------------------------------------------------------------------

def outcome_masks(scene, cam, cfg):
    """Per pixel of a frame, without a graph: the discrete outcomes (hit,
    material, per-light facing and occlusion), the hit t, and whether the
    hit lies under the backward's min_denom clamp (|n·d| < min_denom: the
    scene distance has unit gradient, so n·d is the implicit
    denominator)."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops import shade
    from fraytracer_tpu_torch.ops.march import march_occlusion
    from fraytracer_tpu_torch.camera import (auto_block, from_blocks,
                                             to_blocks)
    from fraytracer_tpu_torch.scene.nodes import LIGHT_POINT
    hh, ww = cfg.height, cfg.width
    b = auto_block(hh, ww)
    with torch.no_grad():
        rays = ft.camera_rays(cam, ww, hh, cfg.epsilon, cfg.length).map(
            lambda x: to_blocks(x, hh, ww, b))
        h = shade.surface_hit(scene, rays, cfg.march)
        masks = [h.hit, h.material]
        for i in range(scene.num_lights):
            ldir, budget, _s = shade.light_dir_and_dist(scene, i, h.position)
            facing = h.hit & ((h.normal * ldir).sum(-1) > 0)
            sr = ft.Rays(origin=h.position, direction=ldir,
                         length=torch.where(facing, budget, 0.0),
                         epsilon=rays.epsilon)
            apex = scene.light_vec[i] \
                if scene.light_kind[i] == LIGHT_POINT else None
            masks += [facing, march_occlusion(scene, sr, cfg.march,
                                              cone_apex=apex)]
        den = (h.normal * rays.direction).sum(-1).abs()
        clamped = h.hit & (den < cfg.march.min_denom)
    back = lambda x: from_blocks(x, hh, ww, b)
    return [back(m) for m in masks], back(h.t), back(clamped), \
        back(h.normal)


def masked_loss_grads(scene, cam, cfg, mask=None):
    """Gradients of ``sum((render·mask)²)`` w.r.t. every floating leaf, as
    a dict of float64 tensors (zeros where autograd reached no leaf)."""
    import fraytracer_tpu_torch as ft
    s = scene.with_tensors({k: v.detach().clone().requires_grad_(True)
                            for k, v in scene.tensors().items()})
    img = ft.render(s, cam, cfg)
    if mask is not None:
        img = img * mask[..., None]
    loss = img.double().pow(2).sum()
    loss.backward()
    return {k: (torch.zeros_like(v) if v.grad is None else v.grad).double()
            for k, v in s.tensors().items()}, float(loss.detach())


def same_outcomes(a, b):
    """Pixels on which two frames' discrete outcomes all agree."""
    same = torch.ones_like(a[0], dtype=torch.bool)
    for x, y in zip(a, b):
        same &= x == y
    return same


def grad_kernel_vs_plain(dev):
    """(a) 256² / 96 tori: the culled kernels against the plain route."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.scene.generators import torus_csg_scene
    scene = ft.flatten(torus_csg_scene(19, 96), device=dev)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    cfg = bench_config(256)
    mk_, tk, _ck, _nk = outcome_masks(scene, cam, cfg)
    with plain_route():
        mp_, tp, _cp, _np = outcome_masks(scene, cam, cfg)
    same = same_outcomes(mk_, mp_) & ((tk - tp).abs() <= 1e-4)
    flipped = 1.0 - same.float().mean().item()
    worst = {}
    for label, mask in (("masked", same), ("unmasked", None)):
        gk, _ = masked_loss_grads(scene, cam, cfg, mask)
        with plain_route():
            gp, _ = masked_loss_grads(scene, cam, cfg, mask)
        worst[label] = worst_leaf_error(
            gk, gp, f"(a) 256^2 / 96 tori, kernels vs plain route, {label}")
    log(f"  (a) lanes whose outcome or t (> 1e-4) differ between the two "
        f"routes: {flipped:.6f} of the frame; worst leaf masked "
        f"{worst['masked']:.2e}, unmasked {worst['unmasked']:.2e}")
    check(flipped <= 0.005, f"(a) {flipped} of the lanes differ")
    # a lane both routes land within 1e-4 moves its gradient by
    # ~|dt|·curvature: 1e-3 of a leaf's norm leaves room for that
    check(worst["masked"] <= 1e-3, f"(a) masked error {worst['masked']}")
    return flipped, worst


def lattice_scene(dev, side=10, blend=False, spacing=1.1):
    """``side²`` small tori on a square lattice in the plane z = 0, far
    enough apart that a tile of nearby hit points certifies a short
    candidate list (the benchmark's overlapping tori never do: their
    bounding spheres all contain the hit points); ``blend`` smooth-unites
    them with a shallow sphere cap just behind, so that hits off the tori
    stay close to one."""
    import numpy as np

    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.scene import nodes as N
    from fraytracer_tpu_torch.scene.generators import torus_csg_scene
    rng = np.random.default_rng(3)
    base = torus_csg_scene(19, 2)
    tori = []
    for i in range(side):
        for j in range(side):
            c = ((i - (side - 1) / 2) * spacing,
                 (j - (side - 1) / 2) * spacing, 0.0)
            nrm = rng.normal(size=3) + np.array([0.0, 0.0, -2.0])
            tori.append(N.torus(c, nrm, 0.3, 0.1,
                                material=N.solid(*rng.uniform(0.2, 0.9, 3))))
    root = N.union(*tori)
    if blend:
        root = N.smooth_union(0.1, root, N.sphere(
            (0, 0, 10.15), 10.0, material=N.solid(0.8, 0.7, 0.3)))
    return ft.flatten(N.Scene(root=root, background=base.background,
                              lights=base.lights), device=dev)


def grads_and_route(scene, cam, cfg):
    """``masked_loss_grads`` with the ``point_eval`` branches it took."""
    from fraytracer_tpu_torch.ops import point_eval
    stats0 = dict(point_eval.STATS)
    g, loss = masked_loss_grads(scene, cam, cfg)
    return g, loss, {k: point_eval.STATS[k] - stats0[k] for k in stats0}


def worst_leaf_error(got, want, label):
    errs = {k: float((got[k] - want[k]).norm()
                     / want[k].norm().clamp_min(1e-30))
            for k in want if float(want[k].norm()) > 0}
    log(f"  {label}: relative L2 error per leaf " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()))
    check(all(bool(torch.isfinite(v).all()) for v in got.values()),
          f"{label}: non-finite gradient")
    return max(errs.values())


def grad_culled_point_eval(dev, size=256):
    """(d') ``point_eval``'s culled branch on the card, on a scene whose
    tiles certify (100 lattice tori): (i) a smooth-union step whose
    backward reads candidate lists of 16 of 100 against the same step sent
    down the dense branch (``bwd_cull_m=1`` can certify nothing; the
    forward is the same); (ii) ``culled_surface_eval`` with lists of 16
    against the dense normals and materials at the kernel's hit points;
    (iii) a step through ``surface_hit``'s non-fused branch against the
    fused one."""
    import dataclasses

    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops import point_eval, sdf
    from fraytracer_tpu_torch.ops.march import march
    from fraytracer_tpu_torch.camera import auto_block, to_blocks
    # a narrow view of the lattice's middle: the hits stay near the tori
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=20.0, device=dev)
    cfg = bench_config(size)

    def with_march(**kw):
        return dataclasses.replace(
            cfg, march=dataclasses.replace(cfg.march, **kw))

    blend = lattice_scene(dev, blend=True)
    g_c, loss_c, route_c = grads_and_route(blend, cam,
                                           with_march(bwd_cull_m=16))
    g_d, loss_d, route_d = grads_and_route(blend, cam,
                                           with_march(bwd_cull_m=1))
    log(f"  (d') blended lattice {size}^2, lists of 16 of 100: point_eval "
        f"{route_c}; lists of 1: {route_d}; losses {loss_c:.6g} / "
        f"{loss_d:.6g}")
    check(route_c == {"certificate_reads": 1, "culled": 1, "dense": 0},
          f"(d') the culled branch did not run: {route_c}")
    check(route_d == {"certificate_reads": 1, "culled": 0, "dense": 1},
          f"(d') the dense branch did not run: {route_d}")
    check(loss_c == loss_d, "(d') the two steps' forwards differ")
    check(float(g_d["prim_params/torus"].abs().sum()) > 0,
          "(d') zero torus gradient")
    # the same residuals through 16 candidates or all 101 primitives: the
    # smooth union's far terms (exp(-d/k), d > 1, k = 0.1) are below
    # float32 resolution, what is left is summation order
    err_bwd = worst_leaf_error(g_c, g_d, "(d') culled vs dense backward")
    check(err_bwd <= 1e-4, f"(d') culled vs dense backward {err_bwd}")

    union = lattice_scene(dev)
    b = auto_block(size, size)
    with torch.no_grad():
        rays = ft.camera_rays(cam, size, size, cfg.epsilon, cfg.length).map(
            lambda x: to_blocks(x, size, size, b))
        res = march(union, rays, cfg.march)
        pos = rays.at(res.t - rays.epsilon)
        stats0 = dict(point_eval.STATS)
        n_c, m_c, _a = point_eval.culled_surface_eval(
            union, pos, res.hit, m=16, threshold=cfg.march.cull_threshold)
        route = {k: point_eval.STATS[k] - stats0[k] for k in stats0}
        n_d = torch.cat([sdf.scene_normal(union, pos[s:s + 16384])
                         for s in range(0, pos.shape[0], 16384)])
        m_d = torch.cat([sdf.material_index_at(union, pos[s:s + 16384])
                         for s in range(0, pos.shape[0], 16384)])
    hit = res.hit
    dn = float((n_c - n_d)[hit].abs().max())
    dm = int((m_c != m_d)[hit].sum())
    log(f"  (d') culled_surface_eval, lists of 16 of 100, {int(hit.sum())} "
        f"hit points: point_eval {route}, max |dn| vs dense {dn:.3e}, "
        f"{dm} materials differ")
    check(route == {"certificate_reads": 1, "culled": 1, "dense": 0},
          f"(d') culled_surface_eval took {route}")
    check(dn <= 1e-5 and dm == 0, f"(d') culled_surface_eval: dn {dn}, "
          f"{dm} materials")

    g_f, _l, route_f = grads_and_route(union, cam, cfg)
    g_n, _l, route_n = grads_and_route(union, cam,
                                       with_march(fuse_surface=False))
    log(f"  (d') union lattice, fused step point_eval {route_f}, non-fused "
        f"{route_n}")
    check(route_f == {"certificate_reads": 0, "culled": 0, "dense": 0},
          f"(d') the fused slot-mode step read a certificate: {route_f}")
    # one read in the forward (``culled_surface_eval``), one in the
    # backward of the plain ``march`` (its hit distance's candidate lists)
    check(route_n == {"certificate_reads": 2, "culled": 2, "dense": 0},
          f"(d') the non-fused step took {route_n}")
    # two forwards (the kernel's normal against autograd's) and two
    # backwards (one leaf a lane against a fold over the candidates)
    err_nf = worst_leaf_error(g_n, g_f, "(d') non-fused vs fused step")
    check(err_nf <= 1e-3, f"(d') non-fused vs fused step {err_nf}")
    return dict(bwd=err_bwd, dn=dn, nonfused=err_nf)


def grad_finite_differences(dev, n_tori=96, size=128, h=1e-2):
    """(b) central differences of the loss along 4 random parameter
    directions against <grad, dir>, 128² / 96 tori, on the pixels whose
    discrete outcomes are the same at both ends of the step and which lie
    outside the min_denom clamp, leaving out hits that jump to another
    surface (the analytic gradient holds the outcomes fixed and saturates
    under the clamp; the share left out is printed)."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.scene.generators import torus_csg_scene
    scene = ft.flatten(torus_csg_scene(19, n_tori), device=dev)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    # a thin hit shell: the march stops anywhere inside it, and where it
    # stops is no smooth function of the parameters — at the frame's ε of
    # 0.01 that jitter would drown a central difference
    cfg = ft.RenderConfig(width=size, height=size, epsilon=1e-4, length=30.0,
                          march=ft.MarchConfig(max_steps=512,
                                               relax_omega=1.4))
    gen = torch.Generator(device=dev).manual_seed(5)
    base = scene.tensors()
    groups = [("geometry", [k for k in base if k.startswith("prim_params")]),
              ("geometry", [k for k in base if k.startswith("prim_params")]),
              ("materials + lights", ["mat_albedo", "light_color",
                                      "light_vec", "background"]),
              ("all leaves", ["prim_params/torus", "prim_params/sphere",
                              "mat_albedo", "light_color", "light_vec",
                              "background"])]
    m0, _t0, clamp0, _n0 = outcome_masks(scene, cam, cfg)
    # h: along a unit direction over ~10³ parameters each moves by ~3e-4,
    # the loss by ~1e-2·|<grad, dir>|
    worst = 0.0
    for i, (label, keys) in enumerate(groups):
        u = {k: torch.zeros_like(v) for k, v in base.items()}
        for k in keys:
            u[k] = torch.randn(base[k].shape, generator=gen, device=dev)
        norm = sum(float(v.pow(2).sum()) for v in u.values()) ** 0.5
        u = {k: v / norm for k, v in u.items()}
        ends = []
        for sgn in (+1.0, -1.0):
            s = scene.with_tensors({k: v + sgn * h * u[k]
                                    for k, v in base.items()})
            m, t, clamp, nrm = outcome_masks(s, cam, cfg)
            with torch.no_grad():
                ends.append((ft.render(s, cam, cfg), m, clamp, t, nrm))
        # a pixel may also pass from one primitive to another of the same
        # material behind it: the hit jumps in t or turns its normal, far
        # beyond what a step of ~3e-4 per parameter moves a surface
        jump = ends[0][1][0] & (
            ((ends[0][3] - ends[1][3]).abs() > 0.02)
            | ((ends[0][4] - ends[1][4]).abs().amax(-1) > 0.05))
        stable = (same_outcomes(ends[0][1], ends[1][1])
                  & same_outcomes(ends[0][1], m0) & ~jump
                  & ~clamp0 & ~ends[0][2] & ~ends[1][2])
        lp, lm = (float((e[0] * stable[..., None]).double().pow(2).sum())
                  for e in ends)
        fd = (lp - lm) / (2 * h)
        g, _ = masked_loss_grads(scene, cam, cfg, stable)
        an = sum(float((g[k] * u[k].double()).sum()) for k in g)
        rel = abs(fd - an) / max(abs(an), 1e-30)
        worst = max(worst, rel)
        log(f"  (b) direction {i} ({label}): central difference {fd:.6g}, "
            f"<grad, dir> {an:.6g}, relative error {rel:.3e}; pixels left "
            f"out (outcome flips or hit jumps under the step, the clamp) "
            f"{1 - stable.float().mean().item():.6f}")
        check(rel <= 0.05, f"(b) direction {i}: FD {fd} vs {an}")
    return worst


def grad_full_width(dev, scene, build_dir, fwd_med, tag="grad",
                    expect=None, reps=5):
    """(c)/(d) forward + backward of the 1024² culled frame: launch counts
    around one step, the gradients, the median of ``reps`` steps, peak
    memory and a profiled step."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops import cuda as ops_cuda, point_eval
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    cfg = bench_config(SIZE)
    s = scene.with_tensors({k: v.detach().clone().requires_grad_(True)
                            for k, v in scene.tensors().items()})

    def step():
        s.zero_grad()
        loss = torch.sum(ft.render(s, cam, cfg) ** 2)
        loss.backward()
        return loss

    stats0 = dict(point_eval.STATS)
    ops_cuda.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = float(step().detach())
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = ops_cuda.launch_counts()
    route = {k: point_eval.STATS[k] - stats0[k] for k in stats0}
    log(f"  {tag}: launches in one fwd+bwd step {counts}")
    log(f"  {tag}: point_eval in that step {route}; loss {loss:.6g}; first "
        f"step {first_s * 1e3:.1f} ms; peak device memory "
        f"{peak / 2**20:.1f} MiB")
    if expect is not None:
        got = {k: counts[k] for k in expect}
        check(got == expect, f"{tag}: launches {got}, want {expect} (the "
              "backward launches no march kernel)")
    check(counts["block_gather"] == 0, f"{tag}: K4 on the gradient path")
    grads = {k: v.grad for k, v in s.tensors().items()}
    for k in ("prim_params/torus", "mat_albedo", "light_color",
              "background"):
        g = grads[k]
        check(g is not None and bool(torch.isfinite(g).all()),
              f"{tag}: gradient of {k} missing or not finite")
        check(float(g.abs().sum()) > 0, f"{tag}: gradient of {k} is zero")
    check(all(g is None or bool(torch.isfinite(g).all())
              for g in grads.values()), f"{tag}: a non-finite gradient")
    log(f"  {tag}: |grad| sums " + ", ".join(
        f"{k} {float(g.abs().sum()):.5g}" for k, g in grads.items()
        if g is not None and float(g.abs().sum()) > 0))
    out = dict(counts=counts, first_s=first_s, peak=peak, route=route)
    if reps:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        log(f"  {tag}: fwd+bwd median of {reps} {med * 1e3:.2f} ms "
            f"({[round(t * 1e3, 2) for t in times]}); forward alone in "
            f"this process {fwd_med * 1e3:.2f} ms: fwd+bwd over fwd "
            f"{med / fwd_med:.2f}, the backward's share of the step "
            f"{1 - fwd_med / med:.3f}")
        out["idle"] = profile_frame(
            s, cam, cfg, build_dir / f"chip_smoke_{tag}_step_trace.json",
            fn=step)
        out["med"] = med
    return out


def gather_transpose_times(table, idx):
    """Device ms of the transpose (the backward) of three ways to read
    ``table[idx]``: advanced indexing (a sort of all the lanes),
    ``index_select`` (``index_add_``: an atomic add a lane and column) and
    the port's ``sdf.take_rows`` (``rows_scatter_kernel``); every miss
    lane names row 0."""
    from fraytracer_tpu_torch.ops import sdf
    ct = torch.randn(tuple(idx.shape) + tuple(table.shape[1:]),
                     device=table.device)
    out = {}
    for name, read in (("advanced indexing", lambda t: t[idx]),
                       ("index_select (index_add_)",
                        lambda t: t.index_select(0, idx)),
                       ("take_rows (rows_scatter_kernel)",
                        lambda t: sdf.take_rows(t, idx))):
        t = table.detach().clone().requires_grad_(True)
        y = read(t)
        out[name] = cuda_ms(lambda: torch.autograd.grad(
            y, t, ct, retain_graph=True))
    return out


def phase_grad(dev, scene, blend, build_dir, fwd_med, blend_fwd_med):
    import json as _json

    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch import cli
    flipped, worst = grad_kernel_vs_plain(dev)
    fd_worst = grad_finite_differences(dev)
    log(f"  (c) forward + backward, culled frame {SIZE}^2, "
        f"{BENCH_N_TORI} tori")
    full = grad_full_width(
        dev, scene, build_dir, fwd_med, tag="grad",
        expect={"march_culled": 1, "surface_culled": 1,
                "occlusion_culled": 2, "march": 0, "surface": 0,
                "occlusion": 0})
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    masks, _t, clamped, _n = outcome_masks(scene, cam, bench_config(SIZE))
    share = float(clamped.sum()) / float(masks[0].sum())
    log(f"  (c) hit lanes under the min_denom clamp: {int(clamped.sum())} "
        f"of {int(masks[0].sum())} ({share:.6f})")
    check(share < 0.02, f"(c) clamped share {share}")
    midx = masks[1].reshape(-1).clamp_min(0).long()
    tt = gather_transpose_times(scene.mat_albedo, midx)
    log(f"  (c) transpose of the material lookup mat_albedo"
        f"{list(scene.mat_albedo.shape)}[{midx.numel()} lanes] (two such "
        "lookups a step): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in tt.items()))
    # the forward-only frame after a backward: no graph, the same launches
    from fraytracer_tpu_torch.ops import cuda as ops_cuda
    ops_cuda.reset_launch_counts()
    img = ft.render(scene, cam, bench_config(SIZE))
    counts = ops_cuda.launch_counts()
    check(img.grad_fn is None and not img.requires_grad,
          "a forward-only frame built a graph")
    check((counts["march_culled"], counts["surface_culled"],
           counts["occlusion_culled"], counts["block_gather"])
          == (1, 1, 2, 0), f"forward-only launches {counts}")
    log("  (d) one fwd+bwd step of the blended frame (the point_eval route)")
    bl = grad_full_width(
        dev, blend, build_dir, blend_fwd_med, tag="grad_blend",
        expect={"march_culled": 1, "surface_ad_culled": 1,
                "occlusion_culled": 2}, reps=0)
    check(bl["route"]["certificate_reads"] == 1,
          f"(d) certificate read {bl['route']['certificate_reads']} times")
    branch = "ok: the culled" if bl["route"]["culled"] \
        else "failed: the dense"
    log(f"  (d) certificate {branch} branch ran; step "
        f"{bl['first_s']:.3f} s, peak "
        f"{bl['peak'] / 2**20:.1f} MiB")
    culled_pe = grad_culled_point_eval(dev)
    report = build_dir / "chip_smoke_fit.json"
    rc = cli.main(["fit", "--size", "256", "--tori", "100", "--steps", "10",
                   "--checkpoint", str(build_dir / "chip_smoke_fit.npz"),
                   "--out-report", str(report)])
    check(rc == 0, f"(e) fit returned {rc}")
    rep = _json.loads(report.read_text())
    log(f"  (e) fit, 10 steps at 256^2 / 100 tori: loss "
        f"{rep['loss_first']:.6g} -> {rep['loss_last']:.6g} in "
        f"{rep['wall_s']} s, losses {[round(x, 6) for x in rep['losses']]}")
    check(all(x == x and abs(x) != float("inf") for x in rep["losses"]),
          "(e) a non-finite loss")
    check(rep["loss_last"] < rep["loss_first"], "(e) the loss did not fall")
    # the same entry point at the full width, a few steps
    rc = cli.main(["fit", "--size", str(SIZE), "--tori", str(BENCH_N_TORI),
                   "--steps", "4", "--out-report", str(report)])
    check(rc == 0, f"(e) fit at the full width returned {rc}")
    wide = _json.loads(report.read_text())
    log(f"  (e) fit, 4 steps at {SIZE}^2 / {BENCH_N_TORI} tori: losses "
        f"{wide['losses']} in {wide['wall_s']} s")
    check(all(x == x and abs(x) != float("inf") for x in wide["losses"]),
          "(e) a non-finite loss at the full width")
    check(wide["loss_last"] < wide["loss_first"],
          "(e) the loss did not fall at the full width")
    return dict(flipped=flipped, worst=worst, fd=fd_worst, full=full,
                blend=bl, clamp_share=share, fit=rep, fit_wide=wide,
                culled_point_eval=culled_pe)


# ---------------------------------------------------------------------------
# phase 11: the sharded paths (parallel/mesh.py, parallel/multihost.py)
# ---------------------------------------------------------------------------

FRAME_LAUNCHES = {"march_culled": 1, "surface_culled": 1,
                  "occlusion_culled": 2, "cull_cones": 3, "cull_select": 3}
# the culled spectral bound's mean (tests/test_torch_wavefront_culled.py):
# the sharded queue marches a lane a bin in round 0 where render_spectral
# marches one a pixel, and rebalancing reorders lanes, so culled hits land
# elsewhere in the ε shell (tests/test_torch_sharding_spectral.py)
SHARDED_SPECTRAL_MEAN = 2e-3
# gradients of the same frame and lanes summed in another order, as a
# share of each leaf's largest |g|: the backward's row scatters sum ~1M
# lane terms a leaf in float32 atomics in no fixed order (√N · 2⁻²⁴ ≈ 6e-5 of
# the terms' scale), and the chunks and ranks add their sums in another
# order again; read 7.7e-6–3.6e-5 over five runs on the H100.  A missing,
# doubled or foreign chunk moves a leaf by 1e-1 or more.
GRAD_REL = 2e-4
MULTI_RANKS = 2


def check_frame_launches(counts, label):
    """One culled torus frame's launches and no dense or AD-mode form."""
    got = {k: counts[k] for k in FRAME_LAUNCHES}
    others = {k: counts[k] for k in ("march", "occlusion", "surface",
                                     "surface_ad", "surface_ad_culled")}
    check(got == FRAME_LAUNCHES and not any(others.values()),
          f"{label}: launches {counts}")


def median_ms(fn, reps, barrier=None):
    """Median and all of ``reps`` host-clock times (ms) of ``fn``, each
    between device synchronizations (and barriers, when given)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        if barrier:
            barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if barrier:
            barrier()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), times


# the learning rate of the steps that recover their gradients: a power of
# two, so lr·g and the division by it are exact, and large, so that the
# step's rounding is one of lr·g, not of the parameter
GRAD_LR = 2.0 ** 20


def leaf_grads(scene, new_scene):
    """The summed gradients of a sharded step taken at lr = GRAD_LR."""
    new = new_scene.tensors()
    return {k: ((v.detach() - new[k]) / GRAD_LR).cpu() for k, v in
            scene.tensors().items()}


def one_process_step(scene, cam, cfg, target):
    """The one-process step: loss and gradients of sum((render -
    target)²) w.r.t. every floating leaf."""
    import fraytracer_tpu_torch as ft
    s = scene.with_tensors({k: v.detach().clone().requires_grad_(True)
                            for k, v in scene.tensors().items()})
    loss = torch.sum((ft.render(s, cam, cfg) - target) ** 2)
    loss.backward()
    return loss.item(), {k: (torch.zeros_like(v) if v.grad is None
                             else v.grad).detach().cpu()
                         for k, v in s.tensors().items()}


def compare_grads(got, want, label):
    """Each leaf's largest |difference| over its largest |gradient|."""
    worst = (-1.0, "")
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-30)
        err = float((got[k] - w).abs().max()) / scale
        worst = max(worst, (err, k))
    log(f"  {label}: worst leaf {worst[1]} at {worst[0]:.3e} of its "
        f"largest |g|")
    check(worst[0] <= GRAD_REL, f"{label}: gradient error {worst}")
    return worst[0]


def phase_multi_world1(dev, scene, sscene, build_dir):
    """(a) NCCL at world size 1, in this process, each sharded function one
    captured CUDA graph a key and rank (every collective inside): the
    sharded 1024² frame against ``render`` bit for bit, with a replay's
    launches; the exposure max; the sharded training step at 4 chunks and
    at 1 against the one-process step; the rebalanced sharded spectral
    frame (512² × 8 bins, depth 4) against ``render_spectral`` and its
    eager frame.  Each path: ``graph_counts()`` at the capture and at a
    replay (a replay, never an eager frame), 0 syncs in a replay under sync
    debug mode "error", graph and eager paired (:func:`multi_paths`), a
    profiled replay and eager call (ops, idle share, where the NCCL
    kernels sit), the growth of the graphs' pool; beside the one-process
    time."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops import cuda as ops_cuda
    from fraytracer_tpu_torch.parallel import mesh as pm
    from fraytracer_tpu_torch.parallel import multihost
    G = graph_layer()
    multihost.initialize()
    mesh = pm.make_mesh()
    check((mesh.size, mesh.backend, mesh.device) == (1, "nccl", dev),
          f"world-1 mesh {mesh}")
    tag = f"1 rank, nccl, 1 card ({nvidia_smi()})"
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    cfg = bench_config(SIZE)
    single = ft.render(scene, cam, cfg)
    paths = multi_paths(mesh, scene, sscene, cam, cfg)
    out = {"cam": cam, "single": single, "pool0_mib": graph_pool_mib(dev)}

    frame = paths["frame"]
    counts, rows, fg = capture_and_replay(frame, "[multi] a frame",
                                          lambda: G._graphs[frame["key"]])
    check_frame_launches(counts, "[multi] a sharded frame")
    check(torch.equal(rows, single), "[multi] a: the sharded frame is not "
          "render's bit for bit")
    sync_free_replay(fg, "[multi] a frame")
    check(torch.equal(fg.outputs[0], single), "[multi] a: the replay under "
          "sync debug mode")
    out["frame"] = graph_and_eager(frame, f"sharded {SIZE}^2 frame [{tag}]",
                                   build_dir / "chip_smoke_multi_frame")
    out["frame"]["pool_mib"] = graph_pool_mib(dev)
    one_med, one_t = median_ms(lambda: ft.render(scene, cam, cfg), 5)
    log(f"  sharded {SIZE}^2 frame [{tag}]: bit for bit render's, launches "
        f"a replay { {k: counts[k] for k in FRAME_LAUNCHES} }, graph median "
        f"{out['frame']['graph_ms']:.3f} ms against render's {one_med:.3f} "
        f"ms ({[round(t, 3) for t in one_t]})")
    emax = float(pm.exposure_max_sharded(rows, mesh))
    check(emax == float(single.amax()), f"exposure max {emax}")
    out.update(frame_ms=out["frame"]["graph_ms"], single_ms=one_med,
               counts=counts)

    target = paths["target"]
    loss1, want = one_process_step(scene, cam, cfg, target)
    out.update(target=target, step_grads=want, step_loss=loss1,
               step_counts={})
    for chunks in (4, 1):
        path = paths[f"step{chunks}"]
        step = path["step"]
        launches = {k: chunks * v for k, v in FRAME_LAUNCHES.items()}
        launches["rows_scatter_smem"] = chunks * STEP_SCATTERS["culled"]
        for call in ("capture", "replay"):
            ops_cuda.reset_launch_counts()
            s1, loss = step(scene, cam, target)
            torch.cuda.synchronize()
            got = ops_cuda.graph_counts()
            check(got == dict(NO_GRAPH, **{call + "s": 1}),
                  f"[multi] a step {chunks} {call}: {got}")
            check(abs(loss.item() - loss1) <= 1e-4 * abs(loss1),
                  f"[multi] a step loss {loss.item()} against {loss1}")
            err = compare_grads(leaf_grads(scene, s1), want,
                                f"train step, {chunks} chunk(s), {call} "
                                f"[{tag}]")
        counts_s = launched(ops_cuda.launch_counts())
        check({k: counts_s.get(k, 0) for k in launches} == launches
              and sum(counts_s.values()) == sum(launches.values()),
              f"[multi] a step {chunks}: launches a replay {counts_s}")
        out["step_counts"][chunks] = ops_cuda.launch_counts()
        sync_free_replay(next(iter(step.graphs.values())),
                         f"[multi] a step {chunks}")
        res = graph_and_eager(path, f"train step, {chunks} chunk(s) [{tag}]",
                              build_dir / f"chip_smoke_multi_step{chunks}",
                              reps=STEP_REPS)
        res["grad_err"] = err
        out[f"step{chunks}"] = res
        out[f"step{chunks}_ms"], out[f"step{chunks}_err"] = \
            res["graph_ms"], err
    out["step_pool_mib"] = graph_pool_mib(dev)
    sone, _t = median_ms(lambda: one_process_step(scene, cam, cfg, target),
                         3)
    log(f"  train step graph medians: 4 chunks {out['step4_ms']:.3f} ms, 1 "
        f"chunk {out['step1_ms']:.3f} ms, one-process fwd+bwd (eager) "
        f"{sone:.3f} ms [{tag}]")
    out["single_step_ms"] = sone

    path = paths["spectral"]
    wcfg = path["wcfg"]
    want_s = ft.render_spectral(sscene, cam, SPECTRAL_SIZE, SPECTRAL_SIZE,
                                wcfg)
    torch.cuda.synchronize()
    ops_cuda.reset_launch_counts()
    path["graph"]()
    torch.cuda.synchronize()
    first = ops_cuda.launch_counts()
    check(ops_cuda.graph_counts() == dict(NO_GRAPH, captures=1),
          f"[multi] a spectral capture {ops_cuda.graph_counts()}")
    check(first["march_culled"] >= 4 and first["surface_culled"] >= 4
          and first["occlusion_culled"] >= 8 and first["block_gather"] >= 24,
          f"[multi] a spectral launches {first}")
    sg = G._graphs[path["key"]]
    ops_cuda.reset_launch_counts()
    img, scounts = path["graph"]()
    torch.cuda.synchronize()
    spec = ops_cuda.launch_counts()
    check(ops_cuda.graph_counts() == dict(NO_GRAPH, replays=1)
          and launched(spec) == SPECTRAL_LAUNCHES,
          f"[multi] a spectral replay {ops_cuda.graph_counts()} launches "
          f"{launched(spec)}, want {SPECTRAL_LAUNCHES}")
    eimg, ecounts = path["eager"]()
    d_eager = float((img - eimg).abs().max())
    d = (img - want_s).abs()
    promoted = spectral_sites(sscene, sg.frame.promoted)
    log(f"  rebalanced sharded spectral frame {SPECTRAL_SIZE}^2 x 8 bins, "
        f"depth 4 [{tag}]: a replay against render_spectral mean |d| "
        f"{d.mean().item():.3e}, max {d.max().item():.3e}; against its eager "
        f"frame max |d| {d_eager:.3e}; live lanes by round "
        f"{scounts.tolist()}; promoted sites {promoted}; launches, first "
        f"call {launched(first)}, a replay {launched(spec)}")
    check(bool(torch.isfinite(img).all()) and d.mean().item()
          < SHARDED_SPECTRAL_MEAN, "[multi] a sharded spectral frame")
    check(d_eager <= SHARDED_GRAPH_MAX and torch.equal(scounts, ecounts),
          f"[multi] a: the spectral replay against its eager frame "
          f"{d_eager}")
    check(tuple(scounts.shape) == (1, 4) and int(scounts[0, 0])
          == SPECTRAL_SIZE ** 2 * 8, f"spectral counts {scounts}")
    sync_free_replay(sg, "[multi] a spectral frame")
    res = graph_and_eager(path, f"rebalanced sharded spectral frame "
                          f"[{tag}]", build_dir / "chip_smoke_multi_spectral")
    one_s, _t = median_ms(lambda: ft.render_spectral(
        sscene, cam, SPECTRAL_SIZE, SPECTRAL_SIZE, wcfg), 3)
    log(f"  sharded spectral graph median {res['graph_ms']:.3f} ms against "
        f"render_spectral's {one_s:.3f} ms [{tag}]")
    res.update(promoted=promoted, max_abs_diff=d_eager,
               first_launches=launched(first))
    out.update(spectral=res, spectral_counts=spec, spectral_ms=
               res["graph_ms"], single_spectral_ms=one_s,
               want_spectral=want_s, pool_mib=graph_pool_mib(dev))
    log(f"  the graphs' pool [{tag}]: {out['pool0_mib']:.1f} MiB before "
        f"[multi], {out['frame']['pool_mib']:.1f} after the frame's capture, "
        f"{out['step_pool_mib']:.1f} after the steps', {out['pool_mib']:.1f} "
        "after the spectral frame's")
    return out


# paired graph / eager calls of a sharded path, median of each
MULTI_REPS = 9
# a sharded graph's replay against its eager form: the frame and the step's
# loss are equal bit for bit; the spectral frame's index_add_ sums in
# another atomic order (two eager spectral frames read 1.192e-7 apart on
# the H100)
SHARDED_GRAPH_MAX = 1e-6


def multi_paths(mesh, scene, sscene, cam, cfg):
    """The three sharded paths of one mesh, each as ``{"graph": the call a
    user makes (a replay once captured), "eager": its eager form, "key":
    its graph's key}``: the frame, the steps (4 chunks and 1) at
    ``GRAD_LR`` on the bench's target, the rebalanced spectral frame."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.parallel import mesh as pm
    G = graph_layer()
    S = SPECTRAL_SIZE
    target = torch.full((SIZE, SIZE, 3), 0.05, device=mesh.device)
    wcfg = spectral_config()
    paths = {"target": target, "frame": {
        "graph": lambda: pm.render_sharded(scene, cam, cfg, mesh),
        "eager": lambda: pm._band_frame(mesh, scene, cam, cfg),
        "key": G.key("frame", scene, cam, cfg,
                     extra=("sharded", mesh.rank, mesh.size))}}
    for chunks in (4, 1):
        step = pm.make_train_step(cfg, mesh, lr=GRAD_LR, grad_chunks=chunks)

        def eager(chunks=chunks):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in scene.tensors().items()}
            return pm._step_overlapped(mesh, GRAD_LR, chunks,
                                       scene.with_tensors(leaves), cam, cfg,
                                       target)
        paths[f"step{chunks}"] = {
            "step": step, "eager": eager,
            "graph": lambda step=step: step(scene, cam, target)}
    paths["spectral"] = {
        "wcfg": wcfg,
        "graph": lambda: pm.render_spectral_sharded(
            sscene, cam, S, S, wcfg, mesh, rebalance=True),
        "eager": lambda: pm._spectral_band(mesh, S, S, True, sscene, cam,
                                           wcfg),
        "key": G.key("spectral", sscene, cam, wcfg,
                     extra=(S, S, "sharded", mesh.rank, mesh.size, True))}
    return paths


def graph_pool_mib(dev):
    """Device memory the graphs' pool of ``dev`` holds (MiB; 0 before the
    device's first capture)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pool = graph_layer()._pools.get(dev.index)
    return 0.0 if pool is None else pool_mib(pool)


def capture_and_replay(path, label, graph_of):
    """A path's first call (the capture) and a replay, the counts set to 0
    before each: ``(launches of the replay, its first output, the
    graph)``."""
    from fraytracer_tpu_torch.ops import cuda as ops_cuda
    for call in ("captures", "replays"):
        ops_cuda.reset_launch_counts()
        out = path["graph"]()
        torch.cuda.synchronize()
        check(ops_cuda.graph_counts() == dict(NO_GRAPH, **{call: 1}),
              f"{label}: {call} {ops_cuda.graph_counts()}")
    fg = graph_of()
    check(fg is not None and fg.graph is not None, f"{label}: no graph")
    return ops_cuda.launch_counts(), out, fg


def sync_free_replay(fg, label):
    """One replay of a captured graph (on the inputs its last call copied
    in) under sync debug mode "error", which raises at a host sync."""
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fg.graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    check(not bool(fg.frame.flag), f"{label}: the replay raised its flag")
    log(f"  {label}: a replay under sync debug mode \"error\": 0 syncs, "
        "flag clear")


def nccl_placement(events):
    """Where a profiled call's NCCL ops sit (device ops whose name says
    NCCL): for each, its start and end in ms from the first device op, the
    march kernels (K1 and K2: three a frame or a step's chunk, three a
    spectral round) that started before it, and the ms of it during which
    other device ops ran beside it."""
    if not events:
        return []
    t0 = events[0][1]
    others = [(a, b) for name, a, b in events if "nccl" not in name.lower()]
    out = []
    for name, a, b in events:
        if "nccl" not in name.lower():
            continue
        marches = sum(1 for n, s, _e in events if s < a and n.split(
            "(")[0].split("<")[0].endswith(" march_kernel"))
        beside = sum(max(0.0, min(b, y) - max(a, x)) for x, y in others)
        out.append({"name": name.split("(")[0][:48],
                    "start_ms": (a - t0) / 1e3, "end_ms": (b - t0) / 1e3,
                    "after_marches": marches, "beside_ms": beside / 1e3})
    return out


def graph_and_eager(path, label, trace_prefix, reps=MULTI_REPS, barrier=None):
    """A path's graph and eager calls paired (``reps`` each, median and
    spread, the median paired difference, between barriers when given),
    then, with a ``trace_prefix``, one profiled call of each (device ops,
    busy / span → idle, the NCCL kernels' places)."""
    g_ms, e_ms = paired_ms((path["graph"], path["eager"]), reps=reps,
                           barrier=barrier)
    res = {"graph_ms": statistics.median(g_ms),
           "eager_ms": statistics.median(e_ms), "graph_times_ms": g_ms,
           "eager_times_ms": e_ms, "paired_diff_ms": statistics.median(
               [a - b for a, b in zip(g_ms, e_ms)])}
    for name in ("graph", "eager") if trace_prefix else ():
        rec = {}
        profile_frame(None, None, None, f"{trace_prefix}_{name}_trace.json",
                      fn=path[name], record=rec, events=True)
        if "busy_ms" in rec:
            res[f"{name}_ops"] = rec["ops"]
            res[f"{name}_idle"] = 1 - rec["busy_ms"] / rec["span_ms"]
            res[f"{name}_nccl"] = nccl_placement(rec["events"])
    log(f"  {label}: graph {res['graph_ms']:.3f} ms ({min(g_ms):.3f}–"
        f"{max(g_ms):.3f}) / eager {res['eager_ms']:.3f} ms ({min(e_ms):.3f}"
        f"–{max(e_ms):.3f}) (medians of {reps}, paired; median paired "
        f"difference {res['paired_diff_ms']:.3f} ms); profile: graph "
        f"{res.get('graph_ops')} ops, idle {res.get('graph_idle')}, eager "
        f"{res.get('eager_ops')} ops, idle {res.get('eager_idle')}")
    for name in ("graph", "eager"):
        if f"{name}_nccl" in res:
            log(f"    {name}: {len(res[name + '_nccl'])} device ops named "
                "NCCL")
        for k in res.get(f"{name}_nccl", []):
            log(f"    {name} NCCL op {k['name']} at {k['start_ms']:.3f}–"
                f"{k['end_ms']:.3f} ms, after {k['after_marches']} march "
                f"kernels, {k['beside_ms']:.3f} ms of it beside other "
                "device ops")
    return res


class ForcedFlag:
    """A captured graph whose replay raises its frame's flag after it (the
    flag a rank's replay would raise on an overflow): a test double around
    the real graph."""

    def __init__(self, graph, frame):
        self.graph, self.frame = graph, frame

    def replay(self):
        self.graph.replay()
        self.frame.flag.fill_(True)


def _multi_rank():
    """One of the gloo ranks sharing the card, each path one captured CUDA
    graph a key and rank (gloo's collectives after the replay): its rows
    of the 1024² frame with a replay's launches, a forced flag on rank 0
    alone at a 256² key's first call (no rank captures) and at a replay of
    the 1024² key (every rank runs the eager frame again), a training step
    (at GRAD_LR: the summed gradients) at its capture and a replay, the
    rebalanced spectral frame (eager on gloo, counted as eager frames)
    with its live lanes per round; graph and eager paired between
    barriers, the graph counts of each path, the rank's pool."""
    import torch.distributed as dist

    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops import cuda as ops_cuda
    from fraytracer_tpu_torch.parallel import mesh as pm
    from fraytracer_tpu_torch.scene.generators import (spectral_csg_scene,
                                                       torus_csg_scene)
    G = graph_layer()
    mesh = pm.make_mesh()
    dev = mesh.device

    def barrier():
        dist.barrier(group=mesh.group)
    scene = ft.flatten(torus_csg_scene(19, BENCH_N_TORI), device=dev)
    sscene = ft.flatten(spectral_csg_scene(19, BENCH_N_TORI), device=dev)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    cfg = bench_config(SIZE)
    paths = multi_paths(mesh, scene, sscene, cam, cfg)
    out = {"rank": mesh.rank, "backend": mesh.backend, "device": str(dev)}
    barrier()
    counts, rows, fg = capture_and_replay(paths["frame"], "[multi] b frame",
                                          lambda: G._graphs[
                                              paths["frame"]["key"]])
    out.update(rows=rows.cpu(), counts=counts)
    out["frame"] = graph_and_eager(paths["frame"], f"rank {mesh.rank} "
                                   "frame", None, barrier=barrier)
    out["frame_ms"] = (out["frame"]["graph_ms"],
                       out["frame"]["graph_times_ms"])
    # a flag forced on rank 0 alone after a real replay: every rank runs
    # the eager frame again
    real = fg.graph
    if mesh.rank == 0:
        fg.graph = ForcedFlag(real, fg.frame)
    ops_cuda.reset_launch_counts()
    try:
        forced = paths["frame"]["graph"]()
        torch.cuda.synchronize()
    finally:
        fg.graph = real
    out["forced_replay"] = (forced.cpu(), ops_cuda.graph_counts())
    # a flag forced on rank 0 alone at a key's first call
    small = bench_config(256)
    want_small = pm._band_frame(mesh, scene, cam, small)[0]
    with forced_repair_frames() if mesh.rank == 0 else \
            contextlib.nullcontext():
        forced_small = pm._band_frame(mesh, scene, cam, small)[0]
    ops_cuda.reset_launch_counts()
    with forced_repair_frames() if mesh.rank == 0 else \
            contextlib.nullcontext():
        first = pm.render_sharded(scene, cam, small, mesh)
    later = pm.render_sharded(scene, cam, small, mesh)
    out["forced_first"] = (
        torch.equal(first, forced_small) and torch.equal(later, want_small),
        ops_cuda.graph_counts(), G._graphs[G.key(
            "frame", scene, cam, small, extra=("sharded", mesh.rank,
                                               mesh.size))].graph is None)

    path = paths["step4"]
    barrier()
    steps = {}
    for call in ("capture", "replay"):
        ops_cuda.reset_launch_counts()
        s1, loss = path["graph"]()
        torch.cuda.synchronize()
        steps[call] = (loss.item(), leaf_grads(scene, s1),
                       {k: v.cpu() for k, v in s1.tensors().items()},
                       ops_cuda.graph_counts())
    out["step_counts"] = ops_cuda.launch_counts()
    out.update(loss=steps["capture"][0], grads=steps["capture"][1],
               leaves=steps["capture"][2], steps=steps)
    out["step"] = graph_and_eager(path, f"rank {mesh.rank} train step, 4 "
                                  "chunks", None, reps=3, barrier=barrier)
    out["step_ms"] = (out["step"]["graph_ms"], out["step"]["graph_times_ms"])
    out["pool_mib"] = graph_pool_mib(dev)

    # gloo's rebalanced spectral frame (a collective in every round):
    # eager, counted as an eager frame
    path = paths["spectral"]
    torch.cuda.synchronize()
    barrier()
    ops_cuda.reset_launch_counts()
    img, scounts = path["graph"]()
    torch.cuda.synchronize()
    spec = ops_cuda.launch_counts()
    spec_graph_counts = ops_cuda.graph_counts()
    spec_ms = median_ms(path["graph"], 3, barrier)
    out.update(spectral=img.cpu(), spectral_counts=scounts.cpu(),
               spectral_launches=spec, spectral_ms=spec_ms,
               spectral_graph_counts=spec_graph_counts)
    return out


def phase_multi_gloo(world1):
    """(b) two gloo ranks spawned on the one card (NCCL refuses two ranks
    on a device), each path one captured CUDA graph a key and rank on each
    rank: the gathered 1024² frame equal to ``render``'s (its 512-row bands
    are whole block rows), each rank's launches and graph counts; a flag
    forced on one rank at a replay (both run the eager frame again, still
    ``render``'s bit for bit) and at a key's first call (no rank captures);
    the training step (replicated bit for bit at its capture and at a
    replay, against the one-process step); the rebalanced spectral frame
    (eager on gloo) with each rank's live lanes per round; each rank's
    pool.  The gloo collectives take the CUDA tensors as they are."""
    from fraytracer_tpu_torch.parallel.multihost import run_ranks
    t0 = time.perf_counter()
    ranks = run_ranks(_multi_rank, MULTI_RANKS, device="cuda",
                      backend="gloo", timeout=600)
    wall = time.perf_counter() - t0
    tag = (f"{MULTI_RANKS} ranks, gloo, {torch.cuda.device_count()} card "
           f"({nvidia_smi()})")
    check({r["backend"] for r in ranks} == {"gloo"}
          and {r["device"] for r in ranks} == {"cuda:0"},
          f"[multi] b ranks {[(r['backend'], r['device']) for r in ranks]}")
    single = world1["single"].cpu()
    full = torch.cat([r["rows"] for r in ranks])
    check(torch.equal(full, single),
          "[multi] b: the gathered frame is not render's bit for bit")
    forced = torch.cat([r["forced_replay"][0] for r in ranks])
    rerun = dict(NO_GRAPH, replays=1, eager_reruns=1)
    check(torch.equal(forced, single) and all(
        r["forced_replay"][1] == rerun for r in ranks),
          f"[multi] b: a flag forced on rank 0 at a replay: "
          f"{[r['forced_replay'][1] for r in ranks]}, frame "
          f"{torch.equal(forced, single)}")
    kept = dict(NO_GRAPH, eager_reruns=1, eager_frames=1)
    check(all(r["forced_first"] == (True, kept, True) for r in ranks),
          f"[multi] b: a flag forced on rank 0 at a key's first call: "
          f"{[r['forced_first'] for r in ranks]}")
    log(f"  a flag forced on rank 0 alone [{tag}]: at a replay of the "
        f"{SIZE}^2 key both ranks ran the eager frame again (counts "
        f"{[r['forced_replay'][1] for r in ranks]}), the gathered frame "
        f"still render's bit for bit; at the 256^2 key's first call no rank "
        f"captured and both ran the eager frame at it and the next (counts "
        f"{[r['forced_first'][1] for r in ranks]})")
    for r in ranks:
        check_frame_launches(r["counts"], f"[multi] b rank {r['rank']}")
        cap, rep = (r["steps"][c][3] for c in ("capture", "replay"))
        check(cap == dict(NO_GRAPH, captures=1)
              and rep == dict(NO_GRAPH, replays=1),
              f"[multi] b rank {r['rank']} step counts {cap}, {rep}")
        step_launches = {k: 4 * v for k, v in FRAME_LAUNCHES.items()}
        check({k: r["step_counts"][k] for k in step_launches}
              == step_launches, f"[multi] b rank {r['rank']} step launches "
              f"{launched(r['step_counts'])}")
        check(r["spectral_graph_counts"] == dict(NO_GRAPH, eager_frames=1),
              f"[multi] b rank {r['rank']}: the rebalanced spectral frame "
              f"on gloo {r['spectral_graph_counts']}")
        log(f"  rank {r['rank']} [{tag}]: launches a replay "
            f"{ {k: r['counts'][k] for k in FRAME_LAUNCHES} }, band of "
            f"{r['rows'].shape[0]} rows, frame graph median "
            f"{r['frame']['graph_ms']:.3f} ms against eager "
            f"{r['frame']['eager_ms']:.3f} (paired), train step graph "
            f"median {r['step']['graph_ms']:.3f} ms against eager "
            f"{r['step']['eager_ms']:.3f}, step launches a replay "
            f"{launched(r['step_counts'])}, pool {r['pool_mib']:.1f} MiB; "
            f"spectral frame (eager) median {r['spectral_ms'][0]:.2f} ms, "
            f"graph counts {r['spectral_graph_counts']}, spectral live "
            f"lanes by round {r['spectral_counts'][r['rank']].tolist()}, "
            f"spectral launches {launched(r['spectral_launches'])}")
    r0, r1 = ranks
    for call in ("capture", "replay"):
        a, b = r0["steps"][call], r1["steps"][call]
        check(a[0] == b[0] and all(torch.equal(a[2][k], b[2][k])
                                   for k in a[2]),
              f"[multi] b: the ranks' scenes differ after the step's {call}")
        check(abs(a[0] - world1["step_loss"])
              <= 1e-4 * abs(world1["step_loss"]), f"[multi] b loss {a[0]}")
        err = compare_grads(a[1], world1["step_grads"],
                            f"train step ({call}) over {tag}")
    img = torch.cat([r["spectral"] for r in ranks])
    d = (img - world1["want_spectral"].cpu()).abs()
    counts = r0["spectral_counts"]
    log(f"  rebalanced spectral frame [{tag}]: against render_spectral mean "
        f"|d| {d.mean().item():.3e}, max {d.max().item():.3e}; live lanes "
        f"[rank, round] {counts.tolist()}")
    check(all(torch.equal(r["spectral_counts"], counts) for r in ranks)
          and tuple(counts.shape) == (MULTI_RANKS, 4),
          "[multi] b spectral counts")
    check(d.mean().item() < SHARDED_SPECTRAL_MEAN, "[multi] b spectral")
    log(f"  [multi] b took {wall:.1f} s (spawn, CUDA contexts, library "
        f"load, the work)")
    return {"ranks": ranks, "step_err": err, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 12: 10,000 tori (bench_10k.py)
# ---------------------------------------------------------------------------

TORI_10K = 10000
SAMPLE_TILES_10K = 16
# table rows past a block's shared memory (cull.pair_stage_bytes(4864) =
# 233,472 > SMEM_LIMIT): the sample tiles again with tables this long
# drive the unstaged path (tables read from device memory) at the 10k scene
UNSTAGED_M_10K = 4864


@contextlib.contextmanager
def kernel_recorder():
    """Every K1/K2/K3 call made in the scope, with its arguments and
    outputs (the wrappers are wrapped from outside)."""
    from fraytracer_tpu_torch.ops.cuda import march_kernel as mk
    calls = []
    real = (mk.march_kernel, mk.surface_kernel)

    def march_rec(scene, *a, **k):
        out = real[0](scene, *a, **k)
        calls.append(("K2" if k.get("occlusion") else "K1", a, k, out))
        return out

    def surface_rec(scene, *a, **k):
        out = real[1](scene, *a, **k)
        calls.append(("K3", a, k, out))
        return out
    mk.march_kernel, mk.surface_kernel = march_rec, surface_rec
    try:
        yield calls
    finally:
        mk.march_kernel, mk.surface_kernel = real


def tori10k_sample_tiles(scene, flat, mcfg, tables, staged):
    """K1/K2/K3 against their plain versions at the 10k tables: one frame's
    trace (``shade.trace_with_stats``) of the ``SAMPLE_TILES_10K`` tiles
    with the most primary candidates (from ``tables``), every kernel call
    recorded and run again through its plain version on the same inputs
    and tables (the tiles keep their lanes, so at the frame's ``mcfg``
    their tables are the frame's); each call's device time beside its
    bound (window rows counted on the plain march).  ``staged``: whether
    every pair must be staged in shared memory, or none."""
    from fraytracer_tpu_torch.ops import shade
    from fraytracer_tpu_torch.ops.cuda import cull, march_kernel as mk
    device_ms = device_timer()
    nt = flat.origin.shape[0] // cull.TILE
    pick = torch.topk(tables.tables[0].count, SAMPLE_TILES_10K).indices \
        .sort().values
    sub = flat.map(lambda x: x.view((nt, cull.TILE) + tuple(x.shape[1:]))
                   [pick].reshape((-1,) + tuple(x.shape[1:])).contiguous())
    with kernel_recorder() as calls:
        shade.trace_with_stats(scene, sub, mcfg)
    names = [c[0] for c in calls]
    check(names == ["K1", "K3"] + ["K2"] * scene.num_lights,
          f"[tori10k] sample tiles: kernel calls {names}")
    out, light = {}, 0
    for kind, a, k, res in calls:
        tab = k["cull"]
        ms_ = [q.m for q in tab.tables]
        # shadow marches take max(cull_m, cull_m_shadow) (ops/march.py)
        want_m = max(mcfg.cull_m, mcfg.cull_m_shadow) if kind == "K2" \
            else mcfg.cull_m
        check(ms_ == [cull._pair_m(want_m, r1 - r0) for (_g, _k, _ki, r0, r1)
                      in tab.pairs], f"[tori10k] {kind} tables of m {ms_}")
        prog = mk.lower_program(scene, a[0].device, tab.pairs)
        plan = mk.surface_stage_plan(prog, tab) if kind == "K3" \
            else mk.march_stage_plan(prog, tab)
        check(all(x == staged for x in plan.staged),
              f"[tori10k] {kind} pairs staged {plan.staged}, want {staged}")
        label = (f"{kind}{'' if kind != 'K2' else f' light {light}'} at the "
                 f"10k tables, {SAMPLE_TILES_10K} tiles (m {ms_}, candidates "
                 f"per tile max {[int(q.count.max()) for q in tab.tables]}, "
                 f"pairs staged {plan.staged}, {plan.bytes} bytes of shared "
                 f"memory a block)")
        if kind == "K3":
            kk = mk.surface_kernel(scene, *a, **k)
            pp, plain_ms = host_ms(lambda: mk.surface_plain(scene, *a, **k))
            err = compare_surface(kk, pp, a[4], label)
            bnd = surface_bound(scene, a, kk, tab)
            ms = device_ms(lambda: mk.surface_kernel(scene, *a, **k))
            name = "surface_culled"
        else:
            lanes = dict(zip(("origin", "direction", "length", "epsilon",
                              "t0"), a))
            with window_rows(tab) as win:
                p, plain_ms = host_ms(lambda: mk.march_plain(scene, *a, **k))
            if kind == "K1":
                err = compare_march(res, p, label)
                name = "march_culled"
            else:
                agree = (res[0] == p[0]).float().mean().item()
                log(f"  {label}: hit agreement {agree:.6f}")
                check(agree >= 0.999, f"{label}: {agree}")
                err = float(agree < 1.0)
                name = "occlusion_culled"
            bnd = march_bound(scene, lanes, res, tab, win)
            ms = device_ms(lambda: mk.march_kernel(scene, *a, **k), reps=20)
        log(f"  {label}: kernel {ms:.4f} ms on the device, plain "
            f"{plain_ms:.2f} ms, bound {bnd[0]:.4g} ms ({bnd[1]})")
        row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
               "bound_by": bnd[1], "err": err, "staged": plan.staged,
               "m": ms_}
        if kind == "K2":
            row = {f"{key}_light{light}" if light else key: v
                   for key, v in row.items()}
            light += 1
        out.setdefault(name, {}).update(row)
    return out


def phase_tori10k(dev, build_dir):
    """The 10,000-torus 1024² frame (``bench_10k.py``): the table sizing
    from the scene's own candidate counts, the frame's launches (no
    overflow re-run), its median time, the table build's time alone, peak
    memory, a profiled frame, which pairs were staged, and K1/K2/K3
    against their plain versions on sample tiles at those tables."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch import bench_10k
    from fraytracer_tpu_torch.ops import cuda as ops_cuda
    scene, cam, base, flat = bench_10k.setup(SIZE, TORI_10K, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sizes = bench_10k.table_sizes(scene, base, flat)
    torch.cuda.synchronize()
    sizing_s = time.perf_counter() - t0
    sizing_peak = torch.cuda.max_memory_allocated()
    log(f"  sizing ({sizing_s:.2f} s, peak {sizing_peak / 2**20:.1f} MiB): "
        f"{sizes}")
    mcfg = dataclasses.replace(base, cull_m=sizes["cull_m"],
                               cull_m_shadow=sizes["cull_m_shadow"])
    cfg = ft.RenderConfig(width=SIZE, height=SIZE, epsilon=EPS, length=30.0,
                          march=mcfg)
    ops_cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, n_rays = ft.render_with_stats(scene, cam, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = ops_cuda.launch_counts()
    check_frame_launches(counts, "[tori10k] frame")
    check(bool(torch.isfinite(img).all()), "[tori10k] non-finite pixels")
    share = (img - scene.background).abs().amax(-1).gt(1e-6).float() \
        .mean().item()
    log(f"  10k frame {SIZE}^2: launches "
        f"{ {k: counts[k] for k in FRAME_LAUNCHES} }, n_rays {int(n_rays)}, "
        f"non-background share {share:.4f}, first {first_s * 1e3:.1f} ms")
    with frame_spies() as rec:
        eager_frame(scene, cam, cfg)
    for name, tabs in zip(["primary"] + [f"light {i}" for i in
                                         range(scene.num_lights)],
                          rec["tables"]):
        log(f"  candidates per tile, {name}: " + ", ".join(
            f"max {mx} mean {mean:.2f} (table m {m})"
            for mx, mean, m in tabs))
    med, times = median_ms(lambda: ft.render_with_stats(scene, cam, cfg), 5)
    torch.cuda.reset_peak_memory_stats()
    eager_frame(scene, cam, cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        tables = bench_10k.primary_tables(scene, mcfg, flat)
        build, _t = median_ms(lambda: bench_10k.primary_tables(
            scene, mcfg, flat), 5)
    table_bytes = sum(nbytes(q.table, q.keys, q.hsuf, q.misc, q.idx)
                      for q in tables.tables)
    log(f"  10k frame median {med:.2f} ms ({[round(t, 2) for t in times]}), "
        f"{int(n_rays) / med * 1e3:.4g} rays/s, peak {peak / 2**20:.1f} MiB; "
        f"primary table build alone {build:.2f} ms, {table_bytes} bytes of "
        f"tables and indices")
    prof = {}
    idle = profile_frame(scene, cam, cfg,
                         build_dir / "chip_smoke_tori10k_frame_trace.json",
                         record=prof)
    sample = tori10k_sample_tiles(scene, flat, mcfg, tables, staged=True)
    log(f"  the same tiles with tables of m {UNSTAGED_M_10K}, past a "
        f"block's shared memory (read from device memory)")
    unstaged = tori10k_sample_tiles(
        scene, flat, dataclasses.replace(mcfg, cull_m=UNSTAGED_M_10K,
                                         cull_m_shadow=UNSTAGED_M_10K),
        tables, staged=False)
    for name, row in unstaged.items():
        sample[name].update({"unstaged_" + k: v for k, v in row.items()})
    return {"sizes": sizes, "counts": counts, "med": med, "first_s": first_s,
            "peak": peak, "sizing_peak": sizing_peak, "build_ms": build,
            "table_bytes": table_bytes, "idle": idle, "n_rays": int(n_rays),
            "profile": prof.get("kernels", []), "sample": sample}


# ---------------------------------------------------------------------------
# phase 13: the periphery (utils/debug.py, utils/profiling.py)
# ---------------------------------------------------------------------------

def phase_periphery(dev, scene, build_dir):
    """``validate_scene`` on the benchmark scene and on a broken copy;
    ``nan_guard`` silent over a clean 256² frame and its backward on the
    card, raising on a NaN put in the scene; a ``march_stats`` report of
    the 1024² primary rays; a ``trace`` file written."""
    import shutil

    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.camera import to_blocks
    from fraytracer_tpu_torch.utils import debug, profiling
    check(debug.validate_scene(scene) == [], "validate_scene: problems on "
          "the benchmark scene")
    leaves = {k: v.clone() for k, v in scene.tensors().items()}
    leaves["prim_params/torus"][0, 0] = float("nan")
    bad = scene.with_tensors(leaves)
    problems = debug.validate_scene(bad)
    check(problems == ["torus: non-finite parameters"], f"{problems}")
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    small = bench_config(256)
    live = scene.with_tensors({k: v.detach().clone().requires_grad_(True)
                               for k, v in scene.tensors().items()})
    with debug.nan_guard():
        (ft.render(live, cam, small) ** 2).sum().backward()
    try:
        with debug.nan_guard():
            ft.render(bad, cam, small)
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    check(raised is not None, "nan_guard let the injected NaN through")
    log(f"  validate_scene: [] on the benchmark scene, {problems} with a "
        f"NaN put in; nan_guard silent over a clean 256^2 frame and its "
        f"backward, raised on the NaN: {raised}")
    flat = ft.camera_rays(cam, SIZE, SIZE, EPS, 30.0).map(
        lambda x: to_blocks(x, SIZE, SIZE, 32))
    stats = profiling.march_stats(scene, flat, bench_config(SIZE).march)
    log(f"  march_stats {SIZE}^2 primary rays: {stats.to_json()}")
    check(stats.n_rays == SIZE * SIZE and 0.0 < stats.hit_fraction < 1.0
          and stats.steps_max <= 192
          and sum(stats.steps_histogram.values()) == SIZE * SIZE,
          "march_stats report")
    out_dir = build_dir / "periphery_trace"
    shutil.rmtree(out_dir, ignore_errors=True)
    with profiling.trace(str(out_dir)):
        ft.render(scene, cam, bench_config(SIZE))
        torch.cuda.synchronize()
    files = list(out_dir.iterdir())
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = sorted({e["name"].split("(")[0].replace("void ", "")
                      for e in events if e.get("cat") == "kernel"
                      and "_kernel" in e.get("name", "")})
    check(len(files) == 1 and any("march_kernel" in k for k in kernels),
          f"trace: {files}, kernels {kernels}")
    log(f"  trace: {files[0].name}, {len(events)} events, port kernels "
        f"{[k for k in kernels if k.split('<')[0] in ('march_kernel', 'surface_kernel')]}")
    return stats


# ---------------------------------------------------------------------------
# phase 14: the bench entry point
# ---------------------------------------------------------------------------

def phase_bench(spectral):
    """``python -m fraytracer_tpu_torch.bench`` at its defaults (the full
    width: 1024², 1000 tori, forward, forward + backward, the 512² spectral
    frame, the 10,000-torus frame, the scaling report) in a process of its
    own (its warm-up is a process's first launch); every JSON line parsed,
    the last one echoed.  ``spectral``: the spectral phase's readings of
    the frame the bench runs — the graph frame's first call and a replay
    ((e)), the eager frame ((b))."""
    cmd = [sys.executable, "-m", "fraytracer_tpu_torch.bench"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=str(Path(__file__).resolve().parent))
    check(proc.returncode == 0, f"bench exited {proc.returncode}:\n"
          f"{proc.stderr[-2000:]}")
    lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
    check(len(lines) == 5, f"bench printed {len(lines)} JSON lines, want 5")
    first, second, third, tenk, last = (json.loads(l) for l in lines)
    check(set(first) < set(second) < set(third) < set(tenk) < set(last),
          "bench stages are not supersets")
    check("fwd_bwd_time_s" not in first and first["value"] == last["value"],
          "bench: the forward stage's line")
    check("spectral_time_s" not in second
          and second["fwd_bwd_time_s"] == last["fwd_bwd_time_s"],
          "bench: the fwd+bwd stage's line")
    check("tori_10k" not in third and set(tenk) - set(third) == {"tori_10k"}
          and not any(k.startswith("scaling_") for k in tenk),
          "bench: the 10k stage's line")
    log(f"  bench: {lines[-1]}")
    for k in ("value", "n_rays", "fwd_time_s", "backend_warmup_s",
              "capture_s", "fwd_time_sustained_s", "fwd_time_eager_s",
              "fwd_bwd_time_s", "fwd_bwd_over_fwd", "fwd_bwd_capture_s",
              "fwd_bwd_time_eager_s", "fwd_bwd_time_sustained_s", "device",
              "kernel_launches", "spectral_time_s", "spectral_size",
              "spectral_rays_marched", "spectral_rays_per_sec",
              "spectral_time_eager_s", "spectral_capture_s",
              "spectral_method"):
        check(k in last, f"bench line lacks {k}")
    check(not any("compile" in k for k in last)
          and not any("compile" in k for k in last["tori_10k"]),
          "bench: a compile field")
    check((last["image_size"], last["n_tori"]) == (SIZE, BENCH_N_TORI),
          f"bench ran {last['image_size']}^2 / {last['n_tori']} tori")
    check(last["n_rays_primary"] == SIZE * SIZE <= last["n_rays"],
          "bench ray counts")
    check(last["spectral_size"] == SPECTRAL_SIZE
          and last["spectral_rays_marched"] > SPECTRAL_SIZE ** 2
          and last["spectral_time_s"] > 0
          and last["spectral_time_eager_s"] > 0
          and last["spectral_capture_s"] > 0, "bench spectral fields")
    # the forward stage's counts: W once, then the 1 + 15 culled frames
    # of fwd_time_s and 32 + 32 chained ones (the graph frame's and the
    # eager frame's sustained times)
    kl = first["kernel_launches"]
    frames = 16 + 2 * GRAPH_CHAIN
    check(first["capture_s"] > 0 and first["fwd_time_sustained_s"] > 0
          and first["fwd_time_eager_s"] > 0,
          f"bench: capture_s {first['capture_s']}, sustained "
          f"{first['fwd_time_sustained_s']}, eager "
          f"{first['fwd_time_eager_s']}")
    check(kl["warm"] == 1, f"bench launched W {kl['warm']} times")
    check((kl["march_culled"], kl["surface_culled"], kl["occlusion_culled"],
           kl["block_gather"]) == (frames, frames, 2 * frames, 0),
          f"bench forward launches {kl}")
    check(second["fwd_bwd_time_s"] > 0
          and second["grad_abs_sum_prim_params"] > 0
          and second["fwd_bwd_capture_s"] > 0
          and second["fwd_bwd_time_eager_s"] > 0
          and second["fwd_bwd_time_sustained_s"] > 0, "bench fwd+bwd")
    # 1 + 9 graph steps, 9 eager steps and 8 chained graph steps more, each
    # one frame's launches (the backward launches no kernel of the port)
    kl, frames = second["kernel_launches"], \
        frames + 1 + 2 * second["fwd_bwd_steps"] + STEP_CHAIN
    check((kl["warm"], kl["march_culled"], kl["surface_culled"],
           kl["occlusion_culled"], kl["block_gather"])
          == (1, frames, frames, 2 * frames, 0),
          f"bench launches after fwd+bwd {kl}")
    # then the graph spectral frame's first call (its deferred runs), 8
    # replays and 8 eager frames, each as the spectral phase read them
    spec = {k: v - kl[k] for k, v in third["kernel_launches"].items()}
    g = spectral["graph"]
    want = {k: g["first_launches"].get(k, 0) + 8 * g["launches"].get(k, 0)
            + 8 * v for k, v in spectral["counts"].items()}
    check(spec == want, f"bench spectral launches {spec}, want {want}")
    # the 10k frame's process: W once, its first frame one culled frame
    t = last["tori_10k"]
    check((t["tori10k_n_tori"], t["tori10k_image_size"]) == (10000, SIZE)
          and t["tori10k_warm_launches"] == 1
          and all(t["tori10k_frame_launches"][k] == v
                  for k, v in FRAME_LAUNCHES.items())
          and t["tori10k_fwd_time_s"] > 0 and t["tori10k_prep_ms_primary"] > 0
          and t["tori10k_cull_m"] > 0, f"bench tori_10k {t}")
    # the scaling report's process: one NCCL rank on the card, W once
    check((last["scaling_ranks"], last["scaling_backend"],
           last["scaling_cards"], last["scaling_image_size"],
           last["scaling_n_tori"]) == (1, "nccl", 1, 256, 100)
          and last["scaling_kernel_launches"]["warm"] == 1
          and last["scaling_max_abs_diff"] == 0.0,
          f"bench scaling {[(k, v) for k, v in last.items() if k.startswith('scaling_')]}")
    return last


# ---------------------------------------------------------------------------
# phase 15: the float64 oracle gate
# ---------------------------------------------------------------------------

# The JAX suite's f64-oracle gates: "bench" is
# tests/test_benchmark_oracle.py:59-117, "e2e" tests/test_render_e2e.py:79-137
# (no shell-divergent ray, every occlusion flip grazing, facing flips too,
# and the whole frame within 3e-2 in place of the shell's 99th percentile);
# "oracle_hit" is the share of rays the oracle must see hit (the bench
# gate's "oracle sees the torus blob")
ORACLE_GATES = {
    "bench": dict(oracle_hit=0.25, flips=0.02, graze=5e-3, divergent=0.02,
                  occ=0.03, occ_all_graze=False, clean=0.6, clean_max=1e-4,
                  shell_p99=3e-2, max_diff=None, median=1e-5),
    "e2e": dict(oracle_hit=None, flips=0.01, graze=2e-3, divergent=None,
                occ=0.02, occ_all_graze=True, clean=0.9, clean_max=1e-5,
                shell_p99=None, max_diff=3e-2, median=1e-5),
}
# the 1024² sample: uniform pixels from the seed, plus the whole 32x32
# blocks whose primary tables hold the most candidates
ORACLE_SEED = 19
ORACLE_UNIFORM = 4096
ORACLE_BLOCKS = 8


def oracle_gate(label, frame, oracle, gate="bench", keep=None,
                enforce=True, ungated=(), oracle_hit=None):
    """The JAX suite's f64-oracle gate ``ORACLE_GATES[gate]`` on N rays,
    all numpy: ``frame`` = (colors [N, 3], primary hit [N], t [N], facing
    bit per light [L][N], occlusion bit per light [L][N]) as
    ``frame_outcomes`` gives them, ``oracle`` = (colors [N, 3], aux dict
    per ray) as ``oracle_sample`` gives them.  ``keep`` (a mask over the
    N rays) gates those rays only.  Every ray falls in one class: a hit
    flip (grazing only), shell-divergent (both hit, |Δt| > 3ε), an
    occlusion flip on the rest (the shadow march grazing), clean (|Δt| ≤
    2e-6·(1 + t), within ``clean_max``) or a same-surface shell ray.

    One departure from JAX's bench gate: it spares a shadow flip from the
    grazing test where the oracle did not march it (cos ≤ 0 there); this
    gate also spares it where the frame did not (its facing bit false).
    Either is a facing flip from a near-perpendicular normal: the side
    that marched found the ray occluded, so the light reaches the pixel on
    neither side (``shade``'s 1[facing ∧ unoccluded]).  It is counted in
    the occlusion flips, not graded.  ``occ_graze_jax`` is the largest
    |smin − ε| under JAX's own rule, printed beside; the e2e gate grades
    every flip, as JAX's does.

    ``ungated`` names bounds printed, not checked: "clean" and "median"
    (shares of a whole frame, most of it background, which a sample of
    hit-dense blocks is not), "shell_p99".  ``oracle_hit`` replaces the
    gate's least share of rays the oracle sees hit, for a scene other than
    the one the gate was set on.  Prints one ``[oracle]`` line, applies
    ``check`` to each bound unless ``enforce`` is false, returns the
    readings."""
    import numpy as np
    b = ORACLE_GATES[gate]
    img, hit, t, facing, occ = frame
    want, aux = oracle[:2]
    idx = np.arange(len(aux)) if keep is None else np.flatnonzero(keep)
    if keep is not None:
        img, want, hit, t = img[idx], want[idx], hit[idx], t[idx]
        facing, occ = [f[idx] for f in facing], [o[idx] for o in occ]
        aux = [aux[i] for i in idx]
    hit_o = np.array([a["hit"] for a in aux])
    t_o = np.array([a["t"] for a in aux])
    min_o = np.array([a["min_d"] for a in aux])

    def worst(mask, x):
        return float(np.abs(x[mask] - EPS).max()) if mask.any() else 0.0

    flips = hit != hit_o
    both = hit & hit_o
    dt = np.abs(t - t_o)
    divergent = both & (dt > 3 * EPS)
    agree = both & ~divergent
    occ_flip = np.zeros(len(aux), bool)
    occ_graze, occ_graze_jax, facing_rays = 0.0, 0.0, []
    for i, (facing_j, occ_j) in enumerate(zip(facing, occ)):
        occ_o = np.array([bool(a["occluded"][i]) if len(a["occluded"]) > i
                          else False for a in aux])
        smin_o = np.array([a["shadow_min_d"][i]
                           if len(a["shadow_min_d"]) > i else np.inf
                           for a in aux])
        f = agree & (occ_j != occ_o)
        occ_flip |= f
        # smin == inf: the oracle never marched this shadow ray; ~facing_j:
        # the frame never did
        jax_rule = f if b["occ_all_graze"] else f & np.isfinite(smin_o)
        graded = f if b["occ_all_graze"] else jax_rule & facing_j
        occ_graze = max(occ_graze, worst(graded, smin_o))
        occ_graze_jax = max(occ_graze_jax, worst(jax_rule, smin_o))
        facing_rays += [(int(idx[k]), i, float(smin_o[k]))
                        for k in np.flatnonzero(f & ~(np.isfinite(smin_o)
                                                      & facing_j))]
    diff = np.abs(img - want).max(axis=-1)
    clean = ~flips & ~occ_flip & ~divergent \
        & (~both | (dt <= 2e-6 * (1 + t_o)))
    shell = agree & ~flips & ~occ_flip & ~clean
    r = {"rays": len(aux), "oracle_hit": float(hit_o.mean()),
         "flips": int(flips.sum()), "flip_share": float(flips.mean()),
         "flip_graze": worst(flips, min_o),
         "divergent": int(divergent.sum()),
         "divergent_share": float(divergent.mean()),
         "agree_dt": float(dt[agree].max()) if agree.any() else 0.0,
         "occ_flips": int(occ_flip.sum()),
         "occ_share": float(occ_flip.mean()), "occ_graze": occ_graze,
         "occ_graze_jax": occ_graze_jax, "facing_rays": facing_rays,
         "clean_share": float(clean.mean()),
         "clean_max": float(diff[clean].max()) if clean.any() else 0.0,
         "shell": int(shell.sum()),
         "shell_p99": float(np.percentile(diff[shell], 99))
         if shell.any() else 0.0,
         "max_diff": float(diff.max()), "median": float(np.median(diff))}
    spared = ", ".join(f"{k} light {i} smin {s:.3e}"
                       for k, i, s in facing_rays[:6])
    log(f"[oracle] {label}: {r['rays']} rays (oracle hits "
        f"{r['oracle_hit']:.4f}); hit flips {r['flips']} "
        f"({r['flip_share']:.6f}, max |min_d - eps| {r['flip_graze']:.3e}); "
        f"divergent {r['divergent']} ({r['divergent_share']:.6f}; max |dt| "
        f"of the rest {r['agree_dt']:.3e}); occlusion flips {r['occ_flips']}"
        f" ({r['occ_share']:.6f}, {len(facing_rays)} of them facing flips"
        + (f" [{spared}]" if spared else "")
        + f", max |smin - eps| graded {r['occ_graze']:.3e}, under JAX's "
        f"rule {r['occ_graze_jax']:.3e}); clean "
        f"{r['clean_share']:.6f}, max |d| {r['clean_max']:.3e}; shell "
        f"{r['shell']}, p99 {r['shell_p99']:.3e}; max |d| "
        f"{r['max_diff']:.3e}; median |d| "
        f"{r['median']:.3e}" + ("" if enforce else " (not gated)")
        + (f" (not gated: {', '.join(ungated)})"
           if ungated and enforce else ""))
    if not enforce:
        return r
    least = b["oracle_hit"] if oracle_hit is None else oracle_hit
    if least is not None:
        check(r["oracle_hit"] > least,
              f"{label}: the oracle hits {r['oracle_hit']}")
    check(r["flip_share"] < b["flips"], f"{label}: {r['flip_share']} flips")
    check(r["flip_graze"] < b["graze"],
          f"{label}: a hit flip that was not a grazing ray")
    if b["divergent"] is None:
        check(r["divergent"] == 0, f"{label}: {r['divergent']} rays hit "
              "beyond 3 eps of the oracle's t")
    else:
        check(r["divergent_share"] < b["divergent"],
              f"{label}: {r['divergent_share']} divergent")
    check(r["agree_dt"] < 3 * EPS, f"{label}: agreeing t {r['agree_dt']}")
    check(r["occ_graze"] < b["graze"],
          f"{label}: an occlusion flip that was not a grazing shadow ray")
    check(r["occ_share"] < b["occ"],
          f"{label}: {r['occ_share']} occlusion flips")
    if "clean" not in ungated:
        check(r["clean_share"] > b["clean"],
              f"{label}: only {r['clean_share']} clean")
    check(r["clean_max"] < b["clean_max"],
          f"{label}: clean-pixel error {r['clean_max']}")
    if b["shell_p99"] is not None and "shell_p99" not in ungated:
        check(r["shell_p99"] < b["shell_p99"],
              f"{label}: shell p99 {r['shell_p99']}")
    if b["max_diff"] is not None:
        check(r["max_diff"] < b["max_diff"], f"{label}: max {r['max_diff']}")
    if "median" not in ungated:
        check(r["median"] < b["median"], f"{label}: median {r['median']}")
    return r


def oracle_rays(cam_pos, width, height, pixels):
    """The float64 rays (origin, direction) of the flat pixels ``y·width +
    x`` seen from ``cam_pos`` towards the origin, fov 60, computed as
    ``Oracle.render`` computes them."""
    import math
    import numpy as np

    def unit(v):
        return v / float(math.sqrt(float(v @ v)))
    pos = np.asarray(cam_pos, np.float64)
    fwd = unit(np.zeros(3) - pos)
    right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
    right /= float(math.sqrt(float(right @ right)))
    true_up = np.cross(fwd, right)
    half = math.tan(math.radians(60.0) * 0.5)
    m = float(max(width, height))
    rays = []
    for p in pixels:
        yy, xx = divmod(int(p), width)
        v = 2.0 * (((height - 1 - yy) + 0.5) / m - 0.5 * height / m)
        u = 2.0 * ((xx + 0.5) / m - 0.5 * width / m)
        rays.append((pos, unit(fwd + (u * right * half
                                      + v * true_up * half))))
    return rays


def oracle_shade(task):
    """One chunk of rays through the port's float64 oracle: (colors
    [n, 3], aux dicts).  A module-level function: the pool's workers
    import it."""
    import numpy as np
    from fraytracer_tpu_torch.oracle.cpu_ref import Oracle
    scene, rays = task
    oracle = Oracle(scene)
    colors, auxs = [], []
    for o, d in rays:
        aux = {}
        colors.append(oracle.shade_ray(o, d, EPS, 30.0, aux=aux))
        auxs.append(aux)
    return np.array(colors).reshape(-1, 3), auxs


def oracle_sample(scene, cam_pos, width, height, pixels, workers=None):
    """The oracle's colors [N, 3] and aux dicts at the flat ``pixels`` of
    the builder ``scene`` seen from ``cam_pos`` (towards the origin, fov
    60), split over ``workers`` processes (default: every core; 1: this
    process), and its wall-clock seconds."""
    import multiprocessing
    import os
    import numpy as np
    workers = workers or os.cpu_count() or 1
    rays = oracle_rays(cam_pos, width, height, pixels)
    n = max(1, min(len(rays), 8 * workers))
    step = -(-len(rays) // n)
    tasks = [(scene, rays[i:i + step])
             for i in range(0, len(rays), step)]
    t0 = time.perf_counter()
    if workers == 1:
        parts = [oracle_shade(task) for task in tasks]
    else:
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            parts = pool.map(oracle_shade, tasks)
    secs = time.perf_counter() - t0
    return (np.concatenate([c for c, _a in parts]),
            [a for _c, aux in parts for a in aux], secs)


def frame_outcomes(scene, cam, cfg, pixels=None):
    """``frame_and_masks`` as numpy at the flat ``pixels`` (all if None):
    colors [N, 3], primary hit [N], t [N], then the facing and the
    occlusion bit per light, [L][N] each."""
    img, masks, t = frame_and_masks(scene, cam, cfg)
    flat = [img.reshape(-1, 3), masks[0].reshape(-1), t.reshape(-1)] \
        + [m.reshape(-1) for m in masks[2:]]
    if pixels is not None:
        idx = torch.as_tensor(pixels, device=img.device)
        flat = [x[idx] for x in flat]
    img, hit, t, *lights = (x.cpu().numpy() for x in flat)
    return img, hit, t, lights[0::2], lights[1::2]


def primary_steps(scene, cam, cfg, pixels):
    """The primary march's steps at the flat ``pixels``, marched in the
    frame's block order (so the culled tables are the frame's)."""
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops.march import march
    from fraytracer_tpu_torch.camera import (auto_block, from_blocks,
                                             to_blocks)
    hh, ww = cfg.height, cfg.width
    b = auto_block(hh, ww)
    rays = ft.camera_rays(cam, ww, hh, cfg.epsilon, cfg.length).map(
        lambda x: to_blocks(x, hh, ww, b))
    steps = from_blocks(march(scene, rays, cfg.march).steps, hh, ww, b)
    idx = torch.as_tensor(pixels, device=steps.device)
    return steps.reshape(-1)[idx].cpu().numpy()


def oracle_pixels(scene, cam, cfg):
    """The 1024² sample: ``ORACLE_UNIFORM`` pixels drawn by
    ``np.random.default_rng(ORACLE_SEED)`` (a 64²-sized uniform sample of
    the frame) and the ``ORACLE_BLOCKS`` whole 32x32 blocks whose primary
    tables (the culled frame's first table build) hold the most
    candidates.  Returns a dict: ``pixels`` (flat ``y·width + x``,
    sorted), the masks ``uniform`` and ``blocks`` over them, ``top``
    [(block, candidates)]."""
    import numpy as np
    import fraytracer_tpu_torch as ft
    with frame_spies() as rec:
        eager_frame(scene, cam, cfg)
    counts = rec["counts"][0]
    top = sorted(range(len(counts)), key=lambda i: (-counts[i], i))
    top = top[:ORACLE_BLOCKS]
    size = cfg.width
    rng = np.random.default_rng(ORACLE_SEED)
    uniform = rng.choice(size * cfg.height, ORACLE_UNIFORM, replace=False)
    iy, ix = np.mgrid[0:32, 0:32]
    blocks = np.concatenate([
        ((blk // (size // 32) * 32 + iy) * size
         + blk % (size // 32) * 32 + ix).ravel() for blk in top])
    pixels = np.union1d(uniform, blocks)
    return {"pixels": pixels, "uniform": np.isin(pixels, uniform),
            "blocks": np.isin(pixels, blocks),
            "top": [(blk, counts[blk]) for blk in top]}


def e2e_nodes():
    """``tests/test_render_e2e.py::small_scene`` in the port's builders:
    union, intersect and subtract, three materials, a directional and a
    point light."""
    import fraytracer_tpu_torch as ft
    return ft.Scene(
        root=ft.subtract(
            ft.intersect(
                ft.union(
                    ft.sphere((0, 0, 0), 1.0,
                              material=ft.solid(0.8, 0.2, 0.2)),
                    ft.torus((0.7, 0.2, 0), (0.3, 1, 0), 0.8, 0.25,
                             material=ft.solid(0.2, 0.7, 0.3)),
                    ft.box((-0.8, -0.4, 0.3), (0.4, 0.4, 0.4), 0.1,
                           material=ft.solid(0.2, 0.3, 0.9)),
                ),
                ft.sphere((0, 0, 0), 1.6),
            ),
            ft.sphere((0.4, 0.6, -0.9), 0.6),
        ),
        background=(0.1, 0.1, 0.1),
        lights=(
            ft.directional_light((-0.5, -1, 1), (0.5, 0.5, 0.5)),
            ft.point_light((-0.5, 0, -2), (10.0, 0.0, 0.0)),
        ),
    )


def with_march(cfg, **kw):
    """``cfg`` with these ``MarchConfig`` fields replaced."""
    return dataclasses.replace(cfg, march=dataclasses.replace(cfg.march,
                                                              **kw))


def phase_oracle(dev, scene, blend):
    """The kernels' frames (the default "cuda" route) against the port's
    float64 oracle, each case through ``oracle_gate``:

    (a) the JAX suite's benchmark gate: 64², ω 1.0, 512 steps, culled and
        dense; the culled frame through the plain route too, printed (a
        second witness of its facing flips);
    (b) its e2e gate: ``e2e_nodes`` at 128² from (0, 0.6, -2.6), no bound
        skip;
    (c) the bench frame (``bench_config(SIZE)``) at 512 steps, culled and
        dense, rendered whole and read at the ``oracle_pixels`` sample, its
        uniform pixels gated as a 64² frame and its blocks apart (not on
        the whole-frame shares).  Gated at ω 1.0; the bench's ω 1.4, which
        breaks the occlusion bounds here as the plain route does, printed;
    (d) the same sample at the bench's own 192 steps: the rays the kernel
        stops on its budget where the oracle hits (at ω 1.4 and 1.0),
        counted apart, left out of the gate at ω 1.0;
    (e) ``blend`` (the ``blend_nodes`` scene) dense on the sample, gated as
        (c) but for the shell's p99, which the plain route breaks as much:
        the bright point-lit blend moves colors farther across the ε shell
        than the torus scene the bound was set on; the culled blended
        frame printed (the JAX package's culling excludes members within
        a blend's reach).

    The oracle's rays are computed once a scene and camera.  Returns every
    case's readings."""
    import numpy as np
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.scene.generators import torus_csg_scene
    t_phase = time.perf_counter()
    size, n_tori, small = SIZE, BENCH_N_TORI, 64
    pos = (0.0, 0.0, -10.0)
    cam = ft.look_at(pos, (0, 0, 0), fov_degrees=60.0, device=dev)
    out = {}

    def case(key, label, sc, camera, cfg, oracle, sample=None, keep=None,
             plain=False, ungated=(), **kw):
        """Render one case (through the plain route if ``plain``) and gate
        it: the whole frame, or the sample's uniform pixels and its blocks
        apart (rays in ``keep`` only)."""
        label += f"; oracle {oracle[2]:.1f} s"
        with plain_route() if plain else contextlib.nullcontext():
            frame = frame_outcomes(sc, camera, cfg, None if sample is None
                                   else sample["pixels"])
        if sample is None:
            out[key] = oracle_gate(label, frame, oracle, ungated=ungated,
                                   **kw)
            return
        out[key] = {part: oracle_gate(
            f"{label}; {part} ({int(sample[part].sum())} pixels)", frame,
            oracle, keep=sample[part] & (True if keep is None else keep),
            ungated=ungated + (("clean", "median") if part == "blocks"
                               else ()), **kw)
            for part in ("uniform", "blocks")}

    nodes = torus_csg_scene(19, n_tori)
    oracle = oracle_sample(nodes, pos, small, small, range(small * small))
    for cull, plain in ((True, False), (False, False), (True, True)):
        form = "culled" if cull else "dense"
        case(f"a_{form}" + ("_plain" if plain else ""),
             f"(a) benchmark gate, {n_tori} tori {small}^2, {form}, "
             + ("plain route, " if plain else "") + "omega 1.0, 512 steps",
             scene, cam,
             ft.RenderConfig(width=small, height=small, epsilon=EPS,
                             length=30.0, march=ft.MarchConfig(
                                 bound_skip=True, max_steps=512, cull=cull)),
             oracle, plain=plain, enforce=not plain)

    e2e = e2e_nodes()
    e2e_pos = (0.0, 0.6, -2.6)
    oracle = oracle_sample(e2e, e2e_pos, 128, 128, range(128 * 128))
    case("b", "(b) e2e gate, small scene 128^2, no bound skip, 512 steps",
         ft.flatten(e2e, dev),
         ft.look_at(e2e_pos, (0, 0, 0), fov_degrees=60.0, device=dev),
         ft.RenderConfig(width=128, height=128, epsilon=EPS, length=30.0,
                         march=ft.MarchConfig(bound_skip=False,
                                              max_steps=512)),
         oracle, gate="e2e")

    sample = oracle_pixels(scene, cam, bench_config(size))
    log(f"  the {size}^2 sample: {len(sample['pixels'])} pixels: "
        f"{ORACLE_UNIFORM} uniform (seed {ORACLE_SEED}) and the "
        f"{ORACLE_BLOCKS} blocks with the most primary candidates (block, "
        f"candidates) {sample['top']}")
    oracle = oracle_sample(nodes, pos, size, size, sample["pixels"])
    for cull, omega in ((True, 1.0), (False, 1.0), (True, 1.4)):
        form = "culled" if cull else "dense"
        case(f"c_{form}_{omega}", f"(c) bench frame {size}^2 sample, "
             f"{form}, omega {omega}, 512 steps", scene, cam,
             with_march(bench_config(size, cull), max_steps=512,
                        relax_omega=omega), oracle, sample,
             enforce=omega == 1.0)

    hit_o = np.array([a["hit"] for a in oracle[1]])
    for omega in (1.4, 1.0):
        cfg = with_march(bench_config(size), relax_omega=omega)
        steps = primary_steps(scene, cam, cfg, sample["pixels"])
        hit = frame_outcomes(scene, cam, cfg, sample["pixels"])[1]
        budget = (steps == cfg.march.max_steps) & ~hit & hit_o
        log(f"  (d) omega {omega}: the kernel stops {int(budget.sum())} of "
            f"{len(sample['pixels'])} rays ({budget.mean():.6f}) on its "
            f"budget of {cfg.march.max_steps} steps where the oracle hits: "
            "the configuration's budget, counted apart, left out of the gate")
        out[f"d_budget_stopped_{omega}"] = int(budget.sum())
    case("d", f"(d) bench frame {size}^2 sample, culled, omega 1.0, "
         f"{cfg.march.max_steps} steps, {int(budget.sum())} budget-stopped "
         "rays left out", scene, cam, cfg, oracle, sample, keep=~budget)

    oracle = oracle_sample(blend_nodes(n_tori), pos, size, size,
                           sample["pixels"])
    case("e_dense", f"(e) blend{n_tori} {size}^2 sample, dense, omega 1.0, "
         "512 steps", blend, cam,
         with_march(bench_config(size, False), max_steps=512,
                    relax_omega=1.0), oracle, sample,
         ungated=("shell_p99",))
    case("e_culled", f"(e) blend{n_tori} {size}^2 sample, culled, omega "
         "1.0, 512 steps, a measurement: culling under a smooth union "
         "excludes members within the blend's reach (the JAX package's "
         "rule, pinned by tests/test_torch_surface_ad.py::"
         "test_culled_blend_excludes_members_within_its_reach)", blend, cam,
         with_march(bench_config(size), max_steps=512, relax_omega=1.0),
         oracle, sample, enforce=False)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  [oracle] phase {out['seconds']:.1f} s")
    return out


def frame_only(tree, reps) -> int:
    """The culled torus frame ([main]'s configuration) and its dense form
    ([dense]'s) alone: for each, 3 untimed frames, then ``reps`` timed
    ones of ``render_with_stats`` (the graph frame where the tree has one)
    and, in turns with them, of the eager frame (``render_grid``), as one
    JSON line.  ``tree`` names a directory inside the checkout that holds
    another commit of the repo (unpacked there with ``git archive``, e.g.
    under ``_checkout/``); its package is imported instead of this
    checkout's."""
    if tree:
        sys.path.insert(0, str(Path(tree).resolve()))
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.render import render_grid
    from fraytracer_tpu_torch.scene.generators import torus_csg_scene
    dev = torch.device("cuda", 0)
    scene = ft.flatten(torus_csg_scene(19, BENCH_N_TORI), device=dev)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0, device=dev)
    rec = {"tree": tree or ".", "package": str(Path(ft.__file__).parent)}
    for form, cull in (("", True), ("dense_", False)):
        cfg = bench_config(SIZE, cull)
        rays = ft.camera_rays(cam, SIZE, SIZE, cfg.epsilon, cfg.length)
        times = {"": [], "eager_": []}
        for i in range(3 + reps):
            for kind, fn in (
                    ("", lambda: ft.render_with_stats(scene, cam, cfg)),
                    ("eager_", lambda: render_grid(scene, rays, cfg))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if i >= 3:
                    times[kind].append(1e3 * (time.perf_counter() - t0))
        for kind, ts in times.items():
            rec[form + kind + "median_ms"] = statistics.median(ts)
            rec[form + kind + "times_ms"] = ts
    print(json.dumps(rec))
    return 0


def kernels_only(tree, dump=None) -> int:
    """Device times (``device_ms``: no host launch path in them) of the
    redesigns' yardsticks at the main path's shapes, as one JSON line: K4
    with its plain and library forms, culled K1, culled K2 of both lights,
    culled K3 in slot mode (the torus frame) and in AD mode (the blended
    frame, ``blend_scene``) with their hit and block counts, lane
    efficiencies and output digests, the culled K1/K2 lane efficiency and
    ray evaluations and, where the tree has the instrumented twin, its
    section shares; then the dense form: K3 in both modes, K1, K2 of both
    lights, each with its lane efficiency (K1/K2), block width and output
    digest; then the machined parts' dense K1/K2 (:func:`parts_dense_times`).
    ``tree`` as in :func:`frame_only`; ``dump``: a file to save the K3
    outputs in."""
    if tree:
        sys.path.insert(0, str(Path(tree).resolve()))
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops import cuda as ops_cuda
    from fraytracer_tpu_torch.ops.cuda import march_kernel as mk
    from fraytracer_tpu_torch.ops.cuda.gather import (
        _gather_blocks, block_gather_plain)
    from fraytracer_tpu_torch.scene.generators import torus_csg_scene
    device_ms = device_timer()
    dev = torch.device("cuda", 0)
    scene = ft.flatten(torus_csg_scene(19, BENCH_N_TORI), device=dev)
    lanes, kw = primary_lanes(scene, SIZE, 30.0, dev)
    tabs = culled_tables(scene, lanes, 48, 256)
    ckw = dict(kw, cull=tabs)
    k = mk.march_kernel(scene, **lanes, **ckw)
    out = {"tree": tree or ".", "package": str(Path(ft.__file__).parent),
           "march_culled_ms": device_ms(
               lambda: mk.march_kernel(scene, **lanes, **ckw)),
           "march_culled_lane_efficiency": lane_efficiency(k[3]),
           "march_culled_max_steps": int(k[3].max()),
           "march_culled_warps_over_96_steps": int(
               (k[3].view(-1, 32).amax(1) >= 96).sum()),
           "march_culled_ray_evaluations": int(k[3].sum()),
           "march_culled_hits": int(k[1].sum())}
    twin = getattr(mk, "march_sections", None)
    if twin is not None:
        out["march_culled_sections"] = log_sections(
            "K1 culled", scene, lanes, ckw, k)
    for light in range(scene.num_lights):
        sl, apex, _f = shadow_lanes(scene, lanes, k, light)
        st = culled_tables(scene, sl, 48, 512, apex)
        skw = dict(kw, cull=st, occlusion=True)
        o = mk.march_kernel(scene, **sl, **skw)
        name = f"occlusion_culled_light{light}"
        out[name + "_ms"] = device_ms(
            lambda: mk.march_kernel(scene, **sl, **skw))
        out[name + "_lane_efficiency"] = lane_efficiency(o[1])
        out[name + "_ray_evaluations"] = int(o[1].sum())
        out[name + "_occluded"] = int(o[0].sum())
        if twin is not None:
            out[name + "_sections"] = log_sections(
                f"K2 culled light {light}", scene, sl, skw, o)
    outputs = {}
    out.update(surface_yardstick("surface_culled", scene, lanes, kw, tabs,
                                 device_ms, outputs))
    blend = blend_scene(BENCH_N_TORI, dev)
    blanes, bkw = primary_lanes(blend, SIZE, 30.0, dev)
    btabs = culled_tables(blend, blanes, 48, 256)
    out.update(surface_yardstick("surface_ad_culled", blend, blanes, bkw,
                                 btabs, device_ms, outputs))
    # the dense form: K1 on the primary rays, K2 on each light's shadow
    # batch of the culled K1's hits, K3 on those hits (slot mode; AD mode
    # on the blended scene): inputs both trees compute alike
    out.update(surface_yardstick("surface_dense", scene, lanes, kw, tabs,
                                 device_ms, outputs, dense=True))
    out.update(surface_yardstick("surface_ad_dense", blend, blanes, bkw,
                                 btabs, device_ms, outputs, dense=True))
    if dump:
        torch.save(outputs, dump)
    kd = mk.march_kernel(scene, **lanes, **kw)
    out["march_dense_ms"] = device_ms(
        lambda: mk.march_kernel(scene, **lanes, **kw), reps=10)
    out.update({"march_dense_" + key: v for key, v in dense_lane_stats(
        mk, scene, lanes, kw, kd[3]).items()})
    out["march_dense_digest"] = digest(*kd)
    counts = ops_cuda.dense_counts()
    out["march_dense_threads"] = counts.get("march_threads")
    out["march_dense_blocks_per_sm"] = counts.get("march_blocks_per_sm")
    if out["march_dense_threads"] is not None:
        # the tori's 32 KB stage fits six blocks an SM: 128 threads each
        check((out["march_dense_threads"], out["march_dense_blocks_per_sm"])
              == (128, 6), "dense K1 of the tori launched "
              f"{out['march_dense_threads']} threads x "
              f"{out['march_dense_blocks_per_sm']} blocks an SM")
    okw = dict(kw, occlusion=True)
    for light, (sl, _f) in enumerate(dense_shadow_lanes(scene, lanes, k)):
        name = f"occlusion_dense_light{light}"
        o = mk.march_kernel(scene, **sl, **okw)
        out[name + "_ms"] = device_ms(
            lambda: mk.march_kernel(scene, **sl, **okw), reps=10)
        out.update({f"{name}_{key}": v for key, v in dense_lane_stats(
            mk, scene, sl, okw, o[1]).items()})
        out[name + "_digest"] = digest(*o)
    pos = lanes["origin"] + (k[0] - lanes["epsilon"])[:, None] \
        * lanes["direction"]
    xb, bidx, lidx = gather_bench_inputs(pos, dev)
    check(torch.equal(_gather_blocks(xb, bidx), xb[lidx]), "K4 mismatch")
    out["block_gather_ms"] = device_ms(lambda: _gather_blocks(xb, bidx))
    out["block_gather_plain_ms"] = device_ms(
        lambda: block_gather_plain(xb, bidx))
    out["block_gather_library_ms"] = device_ms(lambda: xb[lidx])
    out["block_gather_host_call_ms"] = cuda_ms(
        lambda: _gather_blocks(xb, bidx), reps=20)
    out["block_gather_library_host_call_ms"] = cuda_ms(lambda: xb[lidx],
                                                       reps=20)
    out.update(parts_dense_times(dev))
    from fraytracer_tpu_torch.ops.cuda import build
    out["ptxas"] = [l.strip() for l in build.BuildInfo.log.splitlines()
                    if "registers" in l or "Compiling entry" in l
                    or "spill" in l]
    out["card"] = nvidia_smi()
    print(json.dumps(out))
    return 0


def compare_outputs(a, b) -> dict:
    """K3's outputs of two trees (:func:`kernels_only`'s dumps): per
    output, the largest normal difference and the lanes whose material or
    code differ."""
    out = {}
    for name in a:
        (na, ma, ca), (nb, mb, cb) = a[name], b[name]
        out[name] = {"max_abs_normal_diff": (na - nb).abs().max().item(),
                     "lanes_normal_differs": int((na != nb).any(-1).sum()),
                     "lanes_material_differs": int((ma != mb).sum()),
                     "lanes_code_differs": int((ca != cb).sum())}
        log(f"  {name} outputs, this vs other: {out[name]}")
    return out


def compare_kernels(tree) -> dict:
    """``--kernels-only`` for this checkout and the commit unpacked in
    ``tree``, fresh processes in the order other, this, this, other; each
    JSON line echoed, K3's outputs of the first two held against each
    other.  Returns ``{"this": [...], "other": [...], ...}``."""
    from fraytracer_tpu_torch.ops.cuda import build
    runs = {"this": [], "other": []}
    dumps = {}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for i, t in enumerate((tree, None, None, tree)):
        cmd = [sys.executable, str(Path(__file__).resolve()),
               "--kernels-only"] + (["--tree", t] if t else [])
        if i < 2:
            dumps["other" if t else "this"] = build.BUILD_DIR / \
                f"k3_outputs_{'other' if t else 'this'}.pt"
            cmd += ["--dump", str(dumps["other" if t else "this"])]
        out = subprocess.run(cmd, capture_output=True, text=True, check=True,
                             timeout=900)
        line = out.stdout.strip().splitlines()[-1]
        log(f"  kernels {'other' if t else 'this'}: {line}")
        rec = json.loads(line)
        rec.pop("ptxas", None)
        runs["other" if t else "this"].append(rec)
    keys = [k for k in runs["this"][0] if k.endswith("_ms")]
    for k in keys:
        log(f"  {k}: this {[round(r[k], 5) for r in runs['this']]}, other "
            f"{[round(r.get(k, float('nan')), 5) for r in runs['other']]}")
    runs["digests_equal"] = {}
    for k in (k for k in runs["this"][0] if k.endswith("_digest")):
        seen = {r.get(k) for r in runs["this"] + runs["other"]}
        runs["digests_equal"][k] = len(seen) == 1
        log(f"  {k}: {'equal in both trees' if len(seen) == 1 else 'DIFFER'}"
            f" {sorted(map(str, seen))}")
    runs["outputs"] = compare_outputs(torch.load(dumps["this"]),
                                      torch.load(dumps["other"]))
    for f in dumps.values():
        f.unlink()
    return runs


def compare(tree, pairs, reps) -> int:
    """This checkout against the commit unpacked in ``tree`` on the culled
    torus frame and its dense form: ``pairs`` pairs of fresh
    ``--frame-only`` processes, one per tree, the order swapped from pair
    to pair; prints each median, the paired differences (this - other) of
    each form and the card.  Before them, the kernels' device times and
    output digests of both trees (:func:`compare_kernels`)."""
    kernels = compare_kernels(tree)
    runs = []
    for i in range(pairs):
        pair = {}
        for t in ((tree, None) if i % 2 == 0 else (None, tree)):
            cmd = [sys.executable, str(Path(__file__).resolve()),
                   "--frame-only", "--reps", str(reps)]
            out = subprocess.run(cmd + (["--tree", t] if t else []),
                                 capture_output=True, text=True, check=True,
                                 timeout=600)
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            log(f"  pair {i} {rec['package']}: culled median "
                f"{rec['median_ms']:.2f} ms of "
                f"{[round(x, 2) for x in rec['times_ms']]} (eager frame "
                f"{rec['eager_median_ms']:.2f}); dense median "
                f"{rec['dense_median_ms']:.2f} ms of "
                f"{[round(x, 2) for x in rec['dense_times_ms']]} (eager "
                f"{rec['dense_eager_median_ms']:.2f})")
            side = "other" if t else "this"
            for form in ("", "dense_", "eager_", "dense_eager_"):
                pair[form + side] = rec[form + "median_ms"]
        runs.append(pair)
    res = {"kernels": kernels, "pairs": runs}
    for form in ("", "dense_", "eager_", "dense_eager_"):
        diffs = [r[form + "this"] - r[form + "other"] for r in runs]
        res.update({
            form + "paired_diff_ms": diffs,
            form + "median_diff_ms": statistics.median(diffs),
            form + "min_diff_ms": min(diffs),
            form + "max_diff_ms": max(diffs),
            form + "this_slower_in": sum(d > 0 for d in diffs),
            form + "median_this_ms": statistics.median(
                r[form + "this"] for r in runs),
            form + "median_other_ms": statistics.median(
                r[form + "other"] for r in runs)})
    print(json.dumps(res))
    print(nvidia_smi())
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frame-only", action="store_true",
                    help="time the culled torus frame alone")
    ap.add_argument("--kernels-only", action="store_true",
                    help="device times of K4, culled K1/K2 and dense K1")
    ap.add_argument("--cull-only", action="store_true",
                    help="the build, then the [cull] phase alone")
    ap.add_argument("--scatter-only", action="store_true",
                    help="the build, then the [scatter] phase alone")
    ap.add_argument("--tree", help="with --frame-only or --kernels-only: "
                    "import the package of the commit unpacked in this "
                    "directory")
    ap.add_argument("--compare", metavar="TREE", help="paired frame times "
                    "of this checkout and the commit unpacked in TREE")
    ap.add_argument("--dump", help="with --kernels-only: save K3's "
                    "outputs in this file")
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args()
    if args.compare:
        return compare(args.compare, args.pairs, args.reps)
    if args.frame_only:
        return frame_only(args.tree, args.reps)
    if args.kernels_only:
        return kernels_only(args.tree, args.dump)
    import fraytracer_tpu_torch as ft
    from fraytracer_tpu_torch.ops.cuda import build
    from fraytracer_tpu_torch.scene.generators import torus_csg_scene

    smi = nvidia_smi()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | {kind} | torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    build.library()
    log(f"[build] {build.BuildInfo.path.name} built={build.BuildInfo.built} "
        f"in {time.perf_counter() - t0:.2f} s")
    # W as a bench process meets it: the first launch of this process
    from fraytracer_tpu_torch.ops.cuda import probe
    t0 = time.perf_counter()
    w = probe.warm(torch.ones((8, 128), dtype=torch.float32, device=dev))
    check(float(w.sum()) == 2048.0, "W returned the wrong sum")
    warm_first_ms = 1e3 * (time.perf_counter() - t0)
    for line in build.BuildInfo.log.splitlines():
        if "entry function" in line or "registers" in line \
                or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    only = {}
    if not args.scatter_only:
        log("[cull] the table build's kernels against the plain build: "
            f"the {SIZE}^2 frame's three sites and a spectral bounce site")
        only["cull"] = cull_times = phase_cull(dev)
    if not args.cull_only:
        log(f"[scatter] the row scatter's kernel against index_add_: the "
            f"scatters of one eager {SIZE}^2 step")
        only["scatter"] = scatter_times = phase_scatter(dev) \
            if args.scatter_only else scatter_process()
    if args.cull_only or args.scatter_only:
        print(json.dumps(only))
        print(nvidia_smi())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    log("[kernels] kernel vs plain on the card")
    phase_kernels(dev)
    phase_culled_kernels(dev)
    phase_overbudget_pairs(dev)
    phase_dense_unstaged(dev)
    phase_ad_kernels(dev)
    phase_sign_kernels(dev)
    scene = ft.flatten(torus_csg_scene(19, BENCH_N_TORI), device=dev)
    blend = blend_scene(BENCH_N_TORI, dev)
    times = phase_kernel_times(dev, scene)
    times.update(phase_culled_times(dev, scene))
    times.update(phase_blend_times(dev, blend))

    log(f"[main] culled forward frame {SIZE}^2, {BENCH_N_TORI} tori")
    culled = phase_frame(dev, scene, build.BUILD_DIR, cull=True)
    log(f"[dense] dense forward frame {SIZE}^2 (cull=False)")
    dense = phase_frame(dev, scene, build.BUILD_DIR, cull=False)
    repair = forced_repair(scene, dense["cam"], dense["cfg"])

    log("[parity] frames, kernels vs plain and culled vs dense on the card")
    phase_parity(dev, scene, culled["cfg"])

    log(f"[blend] blended forward frame {SIZE}^2, {BENCH_N_TORI} tori "
        "smooth-united with a sphere (K3 in AD mode)")
    blend_culled = phase_frame(dev, blend, build.BUILD_DIR, cull=True,
                               tag="blend", ad=True)
    check((blend_culled["counts"]["march_culled"],
           blend_culled["counts"]["surface_ad_culled"],
           blend_culled["counts"]["occlusion_culled"]) == (1, 1, 2),
          f"blend frame launches {blend_culled['counts']}")
    blend_dense = phase_frame(dev, blend, build.BUILD_DIR, cull=False,
                              tag="blend_dense", ad=True, reps=1)
    phase_parity(dev, blend, blend_culled["cfg"], tag="blend")

    log(f"[graph] render_with_stats as one captured CUDA graph a key: the "
        f"culled, dense and blended {SIZE}^2 frames, forced flags, an edit "
        "between replays, timings")
    graph = phase_graph(dev, scene, blend, build.BUILD_DIR)
    log(f"[step] render_value_and_grad as one captured CUDA graph a key: "
        f"the culled and dense {SIZE}^2 bench steps, blend1000's step kept "
        "eager, a replay that overflows, 256^2 against the plain route, "
        "cli fit against the eager fit")
    step = phase_step(dev, scene, blend, build.BUILD_DIR)

    log("[oracle] the kernels' frames against the port's float64 oracle "
        "(the JAX suite's gates and bounds; not graded: facing flips the "
        "frame did not march; not gated: blend1000's shell p99)")
    oracle = phase_oracle(dev, scene, blend)

    log(f"[spectral] the spectral wavefront: kernels vs plain route at 64^2, "
        f"the {SPECTRAL_SIZE}^2 x 8-bin depth-4 frame, K4 at its shapes, "
        "the graph spectral frame")
    spectral = phase_spectral(dev, build.BUILD_DIR)

    log("[probe] W and P1-P4: the probe program, kernel vs plain, times")
    probe_times, probe_counts, empty_ms = phase_probe(dev, warm_first_ms)
    times.update(probe_times)
    log("[grad] the gradient path")
    grad = phase_grad(dev, scene, blend, build.BUILD_DIR, culled["med"],
                      blend_culled["med"])
    log(f"[multi] a: the sharded paths over one NCCL rank on the card "
        f"({SIZE}^2 frame, train step, {SPECTRAL_SIZE}^2 rebalanced "
        f"spectral frame)")
    from fraytracer_tpu_torch.scene.generators import spectral_csg_scene
    sscene = ft.flatten(spectral_csg_scene(19, BENCH_N_TORI), device=dev)
    multi = phase_multi_world1(dev, scene, sscene, build.BUILD_DIR)
    log(f"[multi] b: {MULTI_RANKS} gloo ranks spawned on the one card")
    multi_b = phase_multi_gloo(multi)
    log(f"[tori10k] {TORI_10K} tori at {SIZE}^2")
    tenk = phase_tori10k(dev, build.BUILD_DIR)
    log("[periphery] validate_scene, nan_guard, march_stats, trace")
    phase_periphery(dev, scene, build.BUILD_DIR)
    log("[bench] the bench entry point in a process of its own")
    bench = phase_bench(spectral)

    mk = f"{TPU}/march_kernel.py"
    rows = [("march", f"{SRC}/march.cu", f"{mk}:1637", dense),
            ("occlusion", f"{SRC}/march.cu", f"{mk}:1637", dense),
            ("surface", f"{SRC}/march.cu", f"{mk}:1606", dense),
            ("block_gather", f"{SRC}/gather.cu", f"{TPU}/gather.py:37",
             dense),
            ("march_culled", f"{SRC}/march.cu", f"{mk}:877", culled),
            ("occlusion_culled", f"{SRC}/march.cu", f"{mk}:877", culled),
            ("surface_culled", f"{SRC}/march.cu", f"{mk}:1051", culled),
            ("surface_ad", f"{SRC}/march.cu", f"{mk}:1304", blend_dense),
            ("surface_ad_culled", f"{SRC}/march.cu", f"{mk}:1359",
             blend_culled)]
    # "launches": the run of the kernel's own path, counts reset just
    # before it (the dense frame for the dense K1-K4, the culled frame —
    # the main path — for the culled K1-K3); "culled_frame_launches" and
    # "forced_repair_launches" read the block gather in the culled frame
    # and in the forced block-tier repair; the AD-mode K3 rows read the
    # blended frame (culled, the slice's main path) and its dense form.
    # "differing": discrete outputs (hit bit, leaf code, gathered element;
    # for AD mode hit lanes whose normal is beyond 1e-4) where kernel and
    # plain version disagree, out of "compared".  "bound_ms" is computed
    # from this run's inputs against the H100 SXM peaks (PEAK_BYTES_S,
    # PEAK_FLOPS); "library_ms" is null where no single PyTorch call
    # computes the kernel's function
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": path["counts"][name],
                "max_abs_err": times[name]["err"], "ms": times[name]["ms"],
                "plain_ms": times[name]["plain_ms"],
                "bound_ms": times[name]["bound_ms"],
                "bound_by": times[name]["bound_by"],
                "library_ms": times[name]["library_ms"],
                "differing": times[name]["differing"],
                "compared": times[name]["compared"],
                # the same calls read another way (an event pair around a
                # host call), K2's second light, lane efficiency, ray
                # evaluations and section shares, where the phase took them
                **{k: v for k, v in times[name].items()
                   if k.endswith("host_call_ms") or "_light" in k
                   or k.startswith("ms_light")
                   or k in ("lane_efficiency", "ray_evaluations",
                            "issued_evaluations", "sections")}}
               for name, src, rep, path in rows]
    kernels[3]["forced_repair_launches"] = repair["block_gather"]
    kernels[3]["culled_frame_launches"] = culled["counts"]["block_gather"]
    # K4 at the spectral path's shapes: the vec3 field (origin) of the
    # first compaction, the scalar field (pixel) beside it
    for prefix, field in (("spectral_", "vec3"), ("spectral_scalar_",
                                                   "scalar")):
        r = spectral["k4"][field]
        kernels[3].update({prefix + "ms": r["ms"],
                           prefix + "plain_ms": r["plain_ms"],
                           prefix + "bound_ms": r["bound_ms"],
                           prefix + "library_ms": r["library_ms"]})
    # W's path is a bench process (its launch count comes from that
    # process's own counter, in its JSON line), P1-P4's the probe program;
    # "ms", "plain_ms" and "library_ms" are device times between a pair
    # of events ("device_floor_ms": the empty kernel's reading by the same
    # method); all five are launch-bound: "back_to_back_ms" is
    # the kernel's and "launch_floor_ms" the empty kernel's time a launch
    # when launched in a row, and "ms_ldg" is P3/P4 with the table read
    # from device memory instead of shared memory
    probe_rows = [("warm", "bench.py:100", bench["kernel_launches"]["warm"]),
                  ("smem_block", f"{PROBE_TOOL}:34",
                   probe_counts["smem_block"]),
                  ("smem_block_2d", f"{PROBE_TOOL}:57",
                   probe_counts["smem_block_2d"]),
                  ("dyn_loop", f"{PROBE_TOOL}:81", probe_counts["dyn_loop"]),
                  ("while_loop", f"{PROBE_TOOL}:138",
                   probe_counts["while_loop"])]
    for name, rep, launches in probe_rows:
        check(launches >= 1, f"{name} was launched no time on its path")
        r = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": PROBE_SRC,
            "replaces": rep, "launches": launches, "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "differing": r["differing"],
            "compared": r["compared"],
            "back_to_back_ms": r["back_to_back_ms"],
            "launch_floor_ms": empty_ms[0],
            "device_floor_ms": empty_ms[1],
            "launches_per_main_path_frame": 0})
        if name + "_ldg" in times:
            kernels[-1]["ms_ldg"] = times[name + "_ldg"]["ms"]
    kernels[-5]["first_launch_ms"] = warm_first_ms
    # launches in one spectral frame (512², 8 bins, depth 4) of each row,
    # in the 10,000-torus frame, in the sharded frame (one NCCL rank; each
    # of two gloo ranks) and in the rebalanced sharded spectral frame (one
    # NCCL rank); the culled K1/K2/K3 at the 10k tables: device time on the
    # sample tiles with its bound and plain time, and the profiled 10k
    # frame's launches (K1, then K2 a light; K3)
    by_kernel = {}
    for kname, ms in tenk["profile"]:
        by_kernel.setdefault(kname.split("<")[0], []).append(ms)
    marches = by_kernel.get("march_kernel", [])
    profiled = {"march_culled": marches[:1], "occlusion_culled": marches[1:],
                "surface_culled": by_kernel.get("surface_kernel", [])}
    for row in kernels:
        name = row["name"]
        row["spectral_frame_launches"] = spectral["counts"][name]
        # a replay of the graph spectral frame ((e): its promoted site
        # re-runs nothing)
        row["spectral_graph_replay_launches"] = \
            spectral["graph"]["launches"].get(name, 0)
        row["tori10k_frame_launches"] = tenk["counts"][name]
        # a replay of each sharded graph (counts set to 0 just before it):
        # the frame (one NCCL rank; each of two gloo ranks), the step at 4
        # and 1 chunks (NCCL) and at 4 (each gloo rank), the rebalanced
        # spectral frame (NCCL)
        row["sharded_frame_launches"] = multi["counts"][name]
        row["sharded_frame_launches_per_gloo_rank"] = [
            r["counts"][name] for r in multi_b["ranks"]]
        row["sharded_step_replay_launches"] = {
            str(c): multi["step_counts"][c][name] for c in (4, 1)}
        row["sharded_step_replay_launches_per_gloo_rank"] = [
            r["step_counts"][name] for r in multi_b["ranks"]]
        row["sharded_spectral_frame_launches"] = \
            multi["spectral_counts"][name]
        # launches per replay of the captured culled and dense 1024² steps
        # (render_value_and_grad; counts set to 0 just before the replay)
        row["step_replay_launches"] = {
            tag: step[tag]["launches"].get(name, 0)
            for tag in ("culled", "dense")}
        for k, v in tenk["sample"].get(name, {}).items():
            row["tori10k_" + k] = v
        if name in profiled:
            row["tori10k_frame_profile_ms"] = profiled[name]
    for tag, st in (("culled", culled), ("dense", dense),
                    ("blend", blend_culled), ("blend_dense", blend_dense)):
        log(f"[summary] {tag} frame first {st['first_s'] * 1e3:.1f} ms, "
            f"median {st['med'] * 1e3:.2f} ms, n_rays {st['n_rays']}, "
            f"peak {st['peak'] / 2**20:.1f} MiB, idle share "
            f"{st['idle'] if st['idle'] is None else round(st['idle'], 4)}")
    for tag, st in (("culled", culled), ("blend", blend_culled)):
        log(f"[summary] {tag} frame: repair tier {st['repair'][0]}, "
            f"candidates per tile (max, mean) {st['candidates']}")
    log(f"[summary] spectral frame {SPECTRAL_SIZE}^2 x 8 bins, depth 4: "
        f"first {spectral['first_s'] * 1e3:.1f} ms, median "
        f"{spectral['med'] * 1e3:.2f} ms, n_rays {spectral['n_rays']}, "
        f"{spectral['n_rays'] / spectral['med']:.4g} rays/s, peak "
        f"{spectral['peak'] / 2**20:.1f} MiB, idle share "
        f"{spectral['idle'] if spectral['idle'] is None else round(spectral['idle'], 4)}"
        f", launches {spectral['want']} (re-runs {spectral['reruns']}), "
        f"active lanes by round "
        f"{[r['active'] for r in spectral['rounds']]}")
    g = spectral["graph"]
    log(f"[summary] graph spectral frame: {g['graph_ms']:.3f} ms against "
        f"eager {g['eager_ms']:.3f} ms (paired medians of {GRAPH_REPS}), "
        f"sustained {g['sustained_graph_ms']:.3f} / "
        f"{g['sustained_eager_ms']:.3f} ms, capture {g['capture_ms']:.1f} ms"
        f", promoted {g['promoted']}, launches per replay {g['launches']}, "
        f"idle share graph {g['graph_idle']} / eager {g['eager_idle']}, "
        f"the pool grew {g['pool_growth_mib']:.1f} MiB to "
        f"{g['pool_mib']:.1f} MiB; max |d| against eager "
        f"{g['max_abs_diff']:.3e} (eager twice {g['eager_max_abs_diff']:.3e})"
        f"; bench spectral {bench['spectral_time_s'] * 1e3:.2f} ms, eager "
        f"{bench['spectral_time_eager_s'] * 1e3:.2f} ms, capture "
        f"{bench['spectral_capture_s']:.3f} s")
    log(f"[summary] sharded paths: one NCCL rank frame median "
        f"{multi['frame_ms']:.2f} ms against render's "
        f"{multi['single_ms']:.2f} ms, train step (4 chunks) "
        f"{multi['step4_ms']:.2f} ms against one-process fwd+bwd "
        f"{multi['single_step_ms']:.2f} ms, rebalanced spectral "
        f"{multi['spectral_ms']:.2f} ms against "
        f"{multi['single_spectral_ms']:.2f} ms; {MULTI_RANKS} gloo ranks on "
        f"one card: frame medians "
        f"{[round(r['frame_ms'][0], 2) for r in multi_b['ranks']]} ms, step "
        f"{[round(r['step_ms'][0], 2) for r in multi_b['ranks']]} ms, "
        f"spectral {[round(r['spectral_ms'][0], 2) for r in multi_b['ranks']]}"
        f" ms ({nvidia_smi()})")
    for name in ("frame", "step4", "step1", "spectral"):
        g = multi[name]
        log(f"[summary] sharded graph, one NCCL rank, {name}: "
            f"{g['graph_ms']:.3f} ms against eager {g['eager_ms']:.3f} ms "
            f"(paired medians of {len(g['graph_times_ms'])}), idle share "
            f"graph {g.get('graph_idle')} / eager {g.get('eager_idle')}, "
            f"device ops {g.get('graph_ops')} / {g.get('eager_ops')}")
    log(f"[summary] sharded graphs' pool: {multi['pool0_mib']:.1f} MiB "
        f"before [multi] a, {multi['pool_mib']:.1f} after it (one NCCL "
        f"rank); each gloo rank's pool "
        f"{[round(r['pool_mib'], 1) for r in multi_b['ranks']]} MiB; gloo "
        f"graph / eager medians: frame "
        f"{[(round(r['frame']['graph_ms'], 3), round(r['frame']['eager_ms'], 3)) for r in multi_b['ranks']]}"
        f" ms, step {[(round(r['step']['graph_ms'], 3), round(r['step']['eager_ms'], 3)) for r in multi_b['ranks']]}"
        f" ms ({nvidia_smi()})")
    log(f"[summary] 10k frame: tables {tenk['sizes']}, median "
        f"{tenk['med']:.2f} ms, first {tenk['first_s'] * 1e3:.1f} ms, peak "
        f"{tenk['peak'] / 2**20:.1f} MiB (sizing "
        f"{tenk['sizing_peak'] / 2**20:.1f} MiB), primary table build "
        f"{tenk['build_ms']:.2f} ms, {tenk['table_bytes']} bytes of primary "
        f"tables, idle share {tenk['idle']}")
    full = grad["full"]
    log(f"[summary] fwd+bwd culled frame: median {full['med'] * 1e3:.2f} ms "
        f"({full['med'] / culled['med']:.2f} x the forward), peak "
        f"{full['peak'] / 2**20:.1f} MiB, idle share "
        f"{full['idle'] if full['idle'] is None else round(full['idle'], 4)}"
        f", clamped hit lanes {grad['clamp_share']:.6f}; blended step "
        f"{grad['blend']['first_s']:.3f} s, peak "
        f"{grad['blend']['peak'] / 2**20:.1f} MiB, point_eval "
        f"{grad['blend']['route']}; bench (its own process, {SIZE}^2 / "
        f"{BENCH_N_TORI} tori) fwd "
        f"{bench['fwd_time_s'] * 1e3:.2f} ms (sustained "
        f"{bench['fwd_time_sustained_s'] * 1e3:.2f}, eager "
        f"{bench['fwd_time_eager_s'] * 1e3:.2f}, capture "
        f"{bench['capture_s']:.3f} s), fwd+bwd "
        f"{bench['fwd_bwd_time_s'] * 1e3:.2f} ms (sustained "
        f"{bench['fwd_bwd_time_sustained_s'] * 1e3:.2f}, eager "
        f"{bench['fwd_bwd_time_eager_s'] * 1e3:.2f}, capture "
        f"{bench['fwd_bwd_capture_s']:.3f} s), warm-up "
        f"{bench['backend_warmup_s']} s")
    for tag in ("culled", "dense", "blend", "blend_dense"):
        g = graph[tag]
        log(f"[summary] graph frame, {tag}: {g['graph_ms']:.3f} ms against "
            f"eager {g['eager_ms']:.3f} ms (paired medians of {GRAPH_REPS}), "
            f"sustained {g['sustained_graph_ms']:.3f} / "
            f"{g['sustained_eager_ms']:.3f} ms, capture "
            f"{g['capture_ms']:.1f} ms, memory the capture added "
            f"{g['graph_mib']:.1f} MiB, idle share graph "
            f"{1 - g['graph_busy_ms'] / g['graph_span_ms'] if 'graph_busy_ms' in g else None}"
            f" / eager "
            f"{1 - g['eager_busy_ms'] / g['eager_span_ms'] if 'eager_busy_ms' in g else None}")
    log(f"[summary] graph frames: the four graphs keep "
        f"{graph['graphs_mib']:.1f} MiB in one pool; a forced overflow's "
        f"key (its sites promoted, captured) "
        f"{graph['overflow']['key_ms']:.3f} ms against eager "
        f"{graph['overflow']['eager_ms']:.3f} ms; a forced repair's key "
        f"(kept eager) {graph['repair']['key_ms']:.3f} ms against eager "
        f"{graph['repair']['eager_ms']:.3f} ms; a replay that "
        f"overflows + its re-run {graph['flagged_replay']['flagged_ms']:.3f} "
        f"ms against eager {graph['flagged_replay']['eager_ms']:.3f} ms")
    for tag in ("culled", "dense"):
        g = step[tag]
        log(f"[summary] graph step, {tag}: {g['graph_ms']:.3f} ms against "
            f"eager {g['eager_ms']:.3f} ms (paired medians of {STEP_REPS}), "
            f"sustained {g['sustained_graph_ms']:.3f} / "
            f"{g['sustained_eager_ms']:.3f} ms, capture "
            f"{g['capture_ms']:.1f} ms, memory the capture added "
            f"{g['graph_mib']:.1f} MiB, eager peak {g['eager_peak_mib']:.1f} "
            f"MiB, idle share graph "
            f"{1 - g['graph_busy_ms'] / g['graph_span_ms'] if 'graph_busy_ms' in g else None}"
            f" / eager "
            f"{1 - g['eager_busy_ms'] / g['eager_span_ms'] if 'eager_busy_ms' in g else None}"
            f", gradients within {g['grad_error']:.3e} (eager twice "
            f"{g['eager_grad_error']:.3e})")
    log(f"[summary] graph steps: the pool with the frame graphs keeps "
        f"{step['pool_mib']} MiB; blend1000's step kept eager "
        f"({step['blend']['later_s']:.3f} s); a replay that overflows + its "
        f"re-run {step['flagged_replay']['flagged_ms']:.3f} ms against "
        f"eager {step['flagged_replay']['eager_ms']:.3f} ms; 256^2 against "
        f"the plain route {step['plain']:.2e}; fit losses within "
        f"{step['fit']['rel']:.3e} of the eager fit's")
    log(f"[summary] oracle gate: {oracle['seconds']:.1f} s, (d) "
        f"{oracle['d_budget_stopped_1.4']} rays of the sample stopped on the "
        "budget where the oracle hits (omega 1.4, 192 steps)")
    print(json.dumps({"kernels": kernels, "cull": cull_times,
                      "scatter": scatter_times}))
    print(nvidia_smi())
    from fraytracer_tpu_torch.parallel.mesh import teardown
    teardown()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
