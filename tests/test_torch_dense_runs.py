"""The dense form's lowering (``ops/cuda/march_kernel.py``): each group's
dense entries as runs of one kind, and their rows packed at the kind's
width rounded up to 16 bytes, as ``csrc/ft_sdf.cuh`` reads them
(``FtProgram::runs``, ``group_runs``, ``packed``; ``ft_kind_width``).  No
kernel runs here: the runs and the packed rows are read back in plain
torch and held against the scene's own parameters and ``ops/sdf``'s scene
distance, and the shared-memory plan of a dense block against its
limits."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import fraytracer_tpu_torch as ft
from fraytracer_tpu_torch.ops import sdf
from fraytracer_tpu_torch.ops.cuda import cull as TC
from fraytracer_tpu_torch.ops.cuda import march_kernel as MK
from fraytracer_tpu_torch.ops.march import sphere_trace
from fraytracer_tpu_torch.scene.flatten import KINDS, PARAM_WIDTH
from fraytracer_tpu_torch.scene.generators import csg_demo_scene, \
    spectral_csg_scene, torus_csg_scene

HEADER = (Path(MK.__file__).resolve().parents[2] / "csrc"
          / "ft_sdf.cuh").read_text()


def blended(n_tori=96):
    """The torus scene smooth-united with a sphere: a sumexp group beside
    the torus scene's min and max groups."""
    base = torus_csg_scene(19, n_tori)
    return ft.Scene(root=ft.smooth_union(0.25, base.root, ft.sphere(
        (0, 0, 0), 1.5, material=ft.solid(0.8, 0.7, 0.3))),
        background=base.background, lights=base.lights)


SCENES = {
    "torus96": lambda: torus_csg_scene(19, 96),
    "csg_demo": csg_demo_scene,
    "spectral64": lambda: spectral_csg_scene(19, 64),
    "blend96": blended,
}
MIN_MAX = ("torus96", "csg_demo", "spectral64")


def lowered(name):
    scene = ft.flatten(SCENES[name](), device="cpu")
    return scene, MK.lower_program(scene, "cpu")


def header_kind_widths():
    """``ft_kind_width`` of the header, parsed: kind name -> floats."""
    body = re.search(r"constexpr int ft_kind_width\(int kind\) \{(.*?)\}",
                     HEADER, re.S).group(1)
    widths = {}
    for kinds, w in re.findall(r"((?:kind == K_\w+\s*(?:\|\|\s*)?)+)\?\s*"
                               r"(\d+)", body):
        for k in re.findall(r"K_(\w+)", kinds):
            widths[k.lower()] = int(w)
    default = int(re.search(r":\s*(\d+);", body).group(1))
    return {k: widths.get(k, default) for k in KINDS}


@pytest.mark.parametrize("name", SCENES)
def test_kind_runs_cover_each_group_once_in_slot_order(name):
    """Each group's dense entries, exactly once, in ascending slot; a run
    holds one kind and its rows follow the previous run's in the packed
    buffer."""
    scene, prog = lowered(name)
    groups = prog.groups.tolist()
    runs = prog.runs.tolist()
    group_runs = prog.group_runs.tolist()
    kind = prog.ent_kind.tolist()
    slot = prog.ent_slot.tolist()
    assert prog.n_dense == prog.ent_kind.shape[0] == scene.num_prims
    assert len(group_runs) == len(groups)
    word = 0
    for (e0, e1, _op), (r0, r1) in zip(groups, group_runs):
        covered = []
        for a, b, k, w in runs[r0:r1]:
            assert a < b and {kind[e] for e in range(a, b)} == {k}
            assert w == word
            word += (b - a) * MK.row_words(k)
            covered += range(a, b)
        assert covered == list(range(e0, e1))
        assert [slot[e] for e in covered] == sorted(slot[e] for e in covered)
        # one run a kind: the group's kinds ascend with its slots
        kinds = [k for _a, _b, k, _w in runs[r0:r1]]
        assert kinds == sorted(set(kinds))
    assert [r for g in group_runs for r in range(*g)] == list(range(len(runs)))
    assert 16 * word == 4 * prog.packed.numel()


@pytest.mark.parametrize("name", SCENES)
def test_packed_rows_at_the_header_kind_widths(name):
    """Each packed row holds its entry's parameters (torus axes unit, as
    the kernels read them) at ``ft_kind_width`` floats, zero to the next
    16 bytes; the widths are the flattener's."""
    widths = header_kind_widths()
    assert widths == dict(PARAM_WIDTH)
    scene, prog = lowered(name)
    rows = MK.slot_param_rows(scene)
    packed = prog.packed.view(-1, 4)
    for a, b, k, w in prog.runs.tolist():
        kind = KINDS[k]
        words = MK.row_words(k)
        assert words == -(-widths[kind] // 4)
        got = packed[w:w + (b - a) * words].reshape(b - a, 4 * words)
        want = rows[prog.ent_slot[a:b].long()]
        width = widths[kind]
        assert torch.equal(got[:, :width], want[:, :width])
        assert not got[:, width:].any()


def runs_distance(scene, prog, p):
    """The scene distance at ``p [n, 3]`` folded as the dense kernels fold
    it: the program's postfix ops over its groups, a min/max group reduced
    run after run (each run's entries by ``ops/sdf``'s distance of the
    run's kind, on the scene's parameters at the entries' slots)."""
    offsets, off = {}, 0
    for kind, cnt in scene.kind_counts:
        offsets[kind] = off
        off += cnt
    runs, group_runs = prog.runs.tolist(), prog.group_runs.tolist()
    stack = []
    for (op, arg), k in zip(prog.ops.tolist(), prog.op_k.tolist()):
        if op == 0:
            _e0, _e1, gop = prog.groups[arg].tolist()
            assert gop in (0, 1), "min/max plans only"
            f = torch.minimum if gop == 0 else torch.maximum
            acc = torch.full(p.shape[:1], 3.0e38 if gop == 0 else -3.0e38)
            for a, b, kind, _w in runs[slice(*group_runs[arg])]:
                name = KINDS[kind]
                idx = prog.ent_slot[a:b].long() - offsets[name]
                d = sdf.DIST_FNS[name](scene.prim_params[name][idx], p)
                acc = f(acc, d.amin(-1) if gop == 0 else d.amax(-1))
            stack.append(acc)
        elif op == 3:
            b_ = stack.pop()
            stack.append(torch.maximum(stack.pop(), -b_))
        else:
            assert op in (1, 2), "min/max plans only"
            vals = stack[len(stack) - arg:]
            del stack[len(stack) - arg:]
            out = vals[0]
            for v in vals[1:]:
                out = torch.minimum(out, v) if op == 1 \
                    else torch.maximum(out, v)
            stack.append(out)
    assert len(stack) == 1
    return stack[0]


@pytest.mark.parametrize("name", MIN_MAX)
def test_packed_runs_give_the_plain_scene_distance(name):
    """Read run by run, the dense entries give ``sdf.scene_distance`` bit
    for bit at seeded points; as the distance of the plain march, the same
    march as ``march_plain`` bit for bit."""
    scene, prog = lowered(name)
    rng = np.random.default_rng(9)
    p = torch.as_tensor(rng.uniform(-4, 4, (2048, 3)), dtype=torch.float32)
    assert torch.equal(runs_distance(scene, prog, p),
                       sdf.scene_distance(scene, p))
    cam = ft.look_at((0, 0, -10), (0, 0, 0), device="cpu")
    rays = ft.camera_rays(cam, 24, 24, 0.01, 30.0).map(
        lambda x: x.reshape((24 * 24,) + tuple(x.shape[2:])))
    n = rays.origin.shape[0]
    args = (rays.origin, rays.direction, rays.length, rays.epsilon,
            torch.zeros(n))
    want = MK.march_plain(scene, *args, max_steps=96, omega=1.4)
    got = sphere_trace(scene, *args, 96, 1.4,
                       dist=lambda _i, q, _t: runs_distance(scene, prog, q))
    assert int(want[1].sum()) > 20
    for g, w in zip(got[:4], want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name,n_tori,staged", [
    ("bench_1002_entries", 1000, True),
    ("oversized_8002_entries", 8000, False),
])
def test_dense_stage_plan_of_the_torus_scenes(name, n_tori, staged):
    """The dense plan of ``torus_csg_scene``'s lowering: 32 bytes a torus,
    16 a sphere; 1002 entries (32,032 bytes) staged, 8002 (256,032)
    beyond a block's shared memory and read from device memory; K3's plan
    adds each entry's (material, slot) and the hit-lane list."""
    scene = ft.flatten(torus_csg_scene(19, n_tori), device="cpu")
    prog = MK.lower_program(scene, "cpu")
    plan = MK.march_stage_plan(prog, None)
    assert plan.rows_bytes == 32 * n_tori + 2 * 16
    assert plan.staged == staged and plan.ms_off == -1
    surf = MK.surface_stage_plan(prog, None)
    assert surf.ms_off == plan.runs_off + TC.STAGE_RUN_BYTES * 3
    assert surf.staged == staged
    assert surf.bytes <= TC.SMEM_LIMIT
    if staged:
        assert plan.bytes == plan.rows_off + plan.rows_bytes
        assert surf.rows_off == surf.ms_off + 8 * (n_tori + 2)
        assert surf.bytes == surf.rows_off + surf.rows_bytes \
            + TC.SURF_LIST_BYTES
    struct = MK._dense_stage_struct(plan)
    assert (struct.bytes, struct.rows_off, struct.rows_bytes) \
        == (plan.bytes, plan.rows_off, plan.rows_bytes)
