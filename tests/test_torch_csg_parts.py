"""Machined CSG parts (``benchmark/configs/parts1000.json``): each part
``(box ∩ sphere) − (three cone drills)``, a union of many of them inside
the clip and cut spheres.

The lowering (``ops/cuda/march_kernel.py::_lower_static``) folds a union
or intersect of more than two operands left, one two-operand combine
after each operand past the first, so a union of subtrees keeps the value
stack shallow; a small postfix interpreter over the lowered program is
held to ``sdf.combine`` exactly (min, max and the subtract's negation
round nowhere, and a smooth union stays n-ary, summed in the same order),
and the benchmark's two other configurations lower op for op as the
n-ary lowering did.  The port's plain route renders the scene within the
benchmark cell's own limits of the plain float64 reference
(``benchmark/reference/parts.py``); on the card (marker ``cuda``) the
kernels' frame does.  The dense K1/K2's lane-step counter is the sum of
the steps their lanes report."""
import json
from pathlib import Path

import pytest
import torch

import fraytracer_tpu_torch as ft
from fraytracer_tpu_torch.ops import cuda as ops_cuda, sdf
from fraytracer_tpu_torch.ops.cuda import march_kernel as MK
from fraytracer_tpu_torch.ops.cuda.cull import _build_groups

from benchmark import harness, parts, program, scenes

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "benchmark" / "configs"
CELL = "parts1000.frame"


def spec(n_parts: int) -> dict:
    s = json.loads((CONFIGS / "parts1000.json").read_text())
    s["scene"]["n_parts"] = n_parts
    return s


def parts_scene(n_parts: int, seed: int = 2 ** 33 + 7):
    return parts.port_scene(parts.draw(spec(n_parts), seed), "cpu")


def mixed_scene(smooth: bool = False):
    """Wide unions and intersects of subtrees, subtracts nested below the
    top and, with ``smooth``, a smooth union of two subtrees and a box and
    a torus (three operands: the leaves reduce as one group)."""
    s = ft.sphere
    blob = (ft.smooth_union if smooth else lambda _k, *n: ft.union(*n))(
        0.2, s((0, 0, 0), 0.5) - s((0.3, 0, 0), 0.2),
        s((0.6, 0, 0), 0.3) & s((0.7, 0.1, 0), 0.3),
        ft.box((0, 0.5, 0), (0.2, 0.2, 0.2), 0.02),
        ft.torus((0, -0.5, 0), (0, 1, 0), 0.3, 0.1))
    arms = [ft.cone((i, 0, 0), (i, 1, 0), 0.3, 0.1) - s((i, 0.5, 0), 0.2)
            for i in range(-3, 4)]
    root = ft.union(blob, *arms, ft.intersect(
        *[s((0, 0, 0.1 * i), 1.0) - s((0, 0, 0.1 * i + 0.8), 0.3)
          for i in range(5)]))
    return ft.flatten(ft.Scene(root=root), device="cpu")


def run_postfix(prog, d: torch.Tensor) -> torch.Tensor:
    """The lowered program folded over the leaf distances ``d [n, K]``
    (global slot order) as ``ft_sdf.cuh::march_distance`` folds it."""
    stack = []
    slots = prog.ent_slot.long()
    for (op, arg), k in zip(prog.ops.tolist(), prog.op_k.tolist()):
        if op == 0:
            e0, e1, gop = prog.groups[arg].tolist()
            v = d[:, slots[e0:e1]]
            k_g = float(prog.group_k[arg])
            stack.append(v.amin(1) if gop == 0 else v.amax(1) if gop == 1
                         else -k_g * torch.log(torch.clamp_min(
                             torch.exp(-v / k_g).sum(1), 1e-30)))
            continue
        args = stack[len(stack) - arg:]
        del stack[len(stack) - arg:]
        if op == 3:
            stack.append(torch.maximum(args[0], -args[1]))
        elif op == 4:
            stack.append(-k * torch.log(torch.clamp_min(
                sum(torch.exp(-v / k) for v in args), 1e-30)))
        else:
            out = args[0]
            for v in args[1:]:
                out = torch.minimum(out, v) if op == 1 \
                    else torch.maximum(out, v)
            stack.append(out)
    assert len(stack) == 1
    return stack[0]


def nary_postfix(tree) -> list:
    """The lowering's ops as the n-ary emission gave them: every operand,
    then one combine of them all."""
    if tree[0] == "g":
        return [[0, tree[1]]]
    op, _k, kids = tree
    out = [o for kid in kids for o in nary_postfix(kid)]
    return out + [[MK._OPCODE[op], len(kids)]]


@pytest.mark.parametrize("n_parts", [20, 250])
def test_wide_unions_of_parts_lower_within_the_stack(n_parts):
    scene = parts_scene(n_parts)
    prog = MK.lower_program(scene, "cpu")
    # a part: two groups (box ∩ sphere, the drills) and its subtract; the
    # union's n - 1 combines; the clip and cut groups and their combines
    assert prog.ops.shape[0] == 3 * n_parts + (n_parts - 1) + 4
    assert prog.runs.shape[0] == 3 * n_parts + 2
    assert 1 <= prog.stack <= MK.MAX_STACK
    assert prog.stack == 3
    assert all(a == 2 for op, a in prog.ops.tolist() if op)


def postfix_and_plan(scene):
    prog = MK.lower_program(scene, "cpu")
    g = torch.Generator().manual_seed(3)
    p = (torch.rand((512, 3), generator=g) * 9.0 - 4.5)
    d = sdf.prim_distances(scene, p)
    return prog, run_postfix(prog, d), sdf.combine(scene.plan, d)


@pytest.mark.parametrize("name", ["parts20", "mixed"])
def test_postfix_program_equals_the_plan(name):
    scene = parts_scene(20) if name == "parts20" else mixed_scene()
    _prog, got, want = postfix_and_plan(scene)
    # min, max and negation are exact: equal to the bit
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_a_smooth_union_stays_n_ary():
    prog, got, want = postfix_and_plan(mixed_scene(smooth=True))
    assert [a for op, a in prog.ops.tolist() if op == 4] == [3]
    # the program sums the exponentials where sdf.combine takes torch's
    # logsumexp over the same operands: float32 rounding apart
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("config", ["tori1000", "spectral1000"])
def test_benchmark_programs_lower_as_before(config):
    c = json.loads((CONFIGS / f"{config}.json").read_text())
    scene = program.scene(scenes.draw(c, 5), "cpu")
    prog = MK.lower_program(scene, "cpu")
    _groups, tree = _build_groups(scene.plan)
    assert prog.ops.tolist() == nary_postfix(tree)
    assert prog.ops.tolist() == [[0, 0], [0, 1], [2, 2], [0, 2], [3, 2]]


def test_dense_lane_steps_count_the_lanes_steps():
    scene = parts_scene(24)
    cam = ft.look_at((0, 0, -10), (0, 0, 0), device="cpu")
    rays = ft.camera_rays(cam, 24, 24, 0.01, 30.0).map(
        lambda x: x.reshape((24 * 24,) + tuple(x.shape[2:])))
    t0, miss0, length, cull = MK.march_tables(
        scene, rays, ft.MarchConfig(backend="cuda", cull=False))
    assert cull is None
    ops_cuda.reset_launch_counts()
    _t, _hit, _d, steps = MK.march_kernel(
        scene, rays.origin, rays.direction, length, rays.epsilon, t0,
        max_steps=192, omega=1.4)
    got = ops_cuda.dense_counts()["lane_steps"]
    # lanes the bound skip spares (zero budget) make no step
    assert bool((steps[miss0] == 0).all())
    assert got == int(steps.sum()) > 0
    ops_cuda.reset_launch_counts()
    assert ops_cuda.dense_counts()["lane_steps"] == 0


def check_frame(device, n_parts, size, seed):
    """One frame of the benchmark cell's traffic at ``n_parts`` parts and
    ``size``², checked as the cell checks it (its sampled pixels, its
    limits) against the plain float64 reference: ``{number: (value,
    limit)}``."""
    over = {"config": {"scene": {"n_parts": n_parts},
                       "render": {"width": size, "height": size}},
            "params": {"pixels": min(1024, size * size), "warm_calls": 1}}
    run = harness.Run(CELL, seed, 0.0, False, over)
    run.device = torch.device(device)
    traffic = harness.load_module("traffic",
                                  run.workload["traffic"]).Traffic(run)
    traffic.call(0)
    run.sync()
    traffic.release()
    judged, failed = traffic.check()
    assert failed == 0, judged
    return judged


def test_plain_route_matches_the_reference():
    # the cell's own limits (bad_share: pixels off by more than bad_at,
    # hits and shadows that flipped; median_err: float32 rounding and the
    # epsilon shell over the hits), here at 24 parts, 48²
    judged = check_frame("cpu", 24, 48, 2 ** 31 + 99)
    assert all(v <= lim for v, lim in judged.values()), judged


@pytest.mark.cuda
def test_kernel_frame_matches_the_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the kernels' graph frame at 64 parts, 128², within the cell's limits
    ops_cuda.reset_launch_counts()
    judged = check_frame("cuda", 64, 128, 2 ** 32 + 5)
    assert all(v <= lim for v, lim in judged.values()), judged
    assert ops_cuda.launch_counts()["march"] >= 1
    counts = ops_cuda.dense_counts()
    assert counts["stack"] == 3 and counts["lane_steps"] > 0
