"""The compiled frame's glue on the CPU: ``render.py``'s graph frame is a
captured CUDA graph on the card; here the frame it captures runs eagerly
with its host reads deferred (``ops/deferred.py``), the counterpart of the
JAX frame's ``lax.cond``s.

* (a) The deferred frame reads nothing on the host: a dispatch mode raises
  on ``aten._local_scalar_dense``, ``nonzero``, ``unique*`` and
  ``masked_select``, and on a tensor of more than one element made from
  host data (a copy to the card that syncs the host), everywhere but
  inside the kernels' plain versions, which the card does not run (32²
  frames); a frame that raises no flag is the eager frame bit for bit.
* (b) ``plan_bound`` / ``root_bound`` pick on the device, bit for bit the
  old host-indexed pick, within 1e-6 of JAX's ``root_bound``.
* (c) ``resolve_material``: the eager tiers equal the dense repair at 0, 1,
  16 and 17 bad blocks and on lane- and dense-tier cases; the deferred
  frame's flag is set exactly where a tier beyond "none" is needed.
* (d) An overflowing frame sets the flag; its eager re-run is today's
  frame bit for bit (the frame on full-group tables) and JAX's
  ``pallas_interpret`` frame, which takes its ``lax.cond`` fallback,
  within the culled frame's bounds (``tests/test_torch_render.py``).
* (e) ``ops/graph.py::key`` of a frame: a parameter's value is not in
  it; a static field, a shape and the config are.
* ``render_with_stats`` routed as on the card (``ops/graph.py``, taken on
  the CPU): a key whose first frame overflows promotes the overflowed
  sites and runs once more, and captures that frame unless it raises the
  flag too (a later site overflows once the promoted site's hits are
  exact); a key whose first frame needs a material repair captures
  nothing.  Every call is the eager frame bit for bit.
* The device constants a deferred frame reads live with the frame: its
  second run takes every one from the frame, none from the caches.

Sizes: 64² frames, at most 96 tori."""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import fraytracer_tpu as jft
import fraytracer_tpu_torch as tft
from fraytracer_tpu.ops import sdf as jsdf
from fraytracer_tpu.ops.march import MarchConfig as JMC
from fraytracer_tpu_torch.ops import deferred, graph, sdf as tsdf
from fraytracer_tpu_torch.ops import shade as tshade
from fraytracer_tpu_torch.ops.cuda import gather, march_kernel as mk
from fraytracer_tpu_torch.ops.march import MarchConfig as TMC
from test_torch_render import jax_masks, port_camera, port_masks
from test_torch_scene import scene_pair, smooth_materials
from torch_deferred import (PLAIN_VERSIONS, NoHostRead, forced_repair,
                            recorded_capture, suspended)
from fraytracer_tpu.scene import generators as JG, nodes as JN
from fraytracer_tpu_torch.scene import generators as TG, nodes as TN

# the module (the package's ``render`` is the function)
trender = importlib.import_module("fraytracer_tpu_torch.render")
SIZE = 64
CULL = dict(cull=True, cull_threshold=64, cull_m=128, cull_m_shadow=128,
            relax_omega=1.4)


@pytest.fixture
def no_host_read(monkeypatch):
    """The mode (``torch_deferred.NoHostRead``), taken off inside the
    kernels' plain versions."""
    for mod, name in PLAIN_VERSIONS:
        monkeypatch.setattr(mod, name, suspended(getattr(mod, name)))
    return NoHostRead()


def deferred_frame(scene, cfg, camera):
    """The frame the card captures, run eagerly: ``(image, n_rays,
    frame)``; its flag is ``frame.flag``."""
    frame = deferred.Frame("cpu")
    with deferred.deferring(frame):
        img, n = trender._frame(scene, camera, cfg)
    return img, n, frame


def blend_pair():
    def build(N, G):
        base = G.torus_csg_scene(seed=19, n_tori=96)
        return N.Scene(root=N.smooth_union(
            0.25, base.root, N.sphere((0, 0, 0), 1.5,
                                      material=N.solid(0.8, 0.7, 0.3))),
            background=base.background, lights=base.lights)
    return (jft.flatten(build(JN, JG)),
            tft.flatten(build(TN, TG), device="cpu"))


@pytest.mark.parametrize("name,march", [
    ("torus96", CULL),
    ("torus96", dict(cull=False, relax_omega=1.4)),
    ("torus96", dict(CULL, cull_m=8, cull_m_shadow=8)),
    ("blend96", CULL),
    ("smooth_materials", dict(cull=False)),
], ids=["culled", "dense", "overflow", "blend", "procedural"])
def test_deferred_frame_reads_nothing_on_the_host(no_host_read, name,
                                                  march):
    if name == "blend96":
        ts = blend_pair()[1]
    elif name == "smooth_materials":
        ts = tft.flatten(smooth_materials(TN, TG), device="cpu")
    else:
        ts = scene_pair(name)[1]
    # 32²: one culled tile, as many ops a step as at 64²
    cfg = tft.RenderConfig(width=32, height=32,
                           march=TMC(backend="cuda", **march))
    cam = port_camera()
    # the eager frame fills the caches of device constants, as the graph
    # frame's first call does before its capture
    eager = tft.render_with_stats(ts, cam, cfg)
    with no_host_read:
        img, n, frame = deferred_frame(ts, cfg, cam)
    flagged = bool(frame.flag)
    assert flagged == (march.get("cull_m") == 8)
    if not flagged:
        # a frame that raises no flag is the eager frame bit for bit
        assert torch.equal(img, eager[0]) and int(n) == int(eager[1])


def _old_plan_bound(plan, pb):
    """``plan_bound`` as it was: the intersect's smallest direct child
    picked by indexing with a 0-d tensor (a host read)."""
    if plan.op == "prim":
        return pb[plan.prim_slots[0]]
    if plan.op == "subtract":
        return _old_plan_bound(plan.children[0], pb)
    bounds = [_old_plan_bound(c, pb) for c in plan.children]
    slots = torch.as_tensor(np.asarray(plan.prim_slots, np.int64))
    if plan.op == "intersect":
        rows = list(bounds)
        if plan.prim_slots:
            sub = pb[slots]
            rows.append(sub[torch.argmin(sub[:, 3])])
        out = rows[0]
        for bnd in rows[1:]:
            out = torch.where(out[3] <= bnd[3], out, bnd)
        return out
    rows = [b[None, :] for b in bounds]
    if plan.prim_slots:
        rows.append(pb[slots])
    out = tsdf._bound_union_many(torch.cat(rows, dim=0))
    if plan.op == "smooth_union":
        n = len(plan.children) + len(plan.prim_slots)
        out = out.clone()
        out[3] += np.float32(plan.k * np.log(max(n, 2)))
    return out


def _intersect_prims(N, G):
    """An intersect with direct primitive children (and a sub-plan)."""
    return N.Scene(root=N.intersect(
        N.sphere((0, 0, 0), 1.4), N.sphere((0.3, 0.1, 0), 0.9),
        N.box((0, 0, 0), (0.8, 0.8, 0.8), 0.05),
        N.union(N.sphere((2, 0, 0), 0.5), N.sphere((0, 2, 0), 0.4))))


@pytest.mark.parametrize("name", ["torus1000", "intersect_prims", "blend96"])
def test_root_bound_on_the_device(name, no_host_read):
    if name == "intersect_prims":
        js = jft.flatten(_intersect_prims(JN, JG))
        ts = tft.flatten(_intersect_prims(TN, TG), device="cpu")
    elif name == "blend96":
        js, ts = blend_pair()
    else:
        js, ts = scene_pair(name)
    want = _old_plan_bound(ts.plan, tsdf.prim_bounds(ts))
    tsdf.root_bound(ts)                     # the slot tensors' first copy
    with no_host_read:
        got = tsdf.root_bound(ts)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsdf.root_bound(js)),
                               rtol=0, atol=1e-6)


def _repair_case(ts, blocks, lanes_per_block, nb=32, seed=3):
    """Hit points on the scene's tori, every lane a hit, with
    ``lanes_per_block`` lanes of each of the first ``blocks`` blocks marked
    unresolved (-1)."""
    g = torch.Generator().manual_seed(seed)
    n = nb * gather.BLOCK
    pos = torch.rand(n, 3, generator=g) * 8.0 - 4.0
    hit = torch.ones(n, dtype=torch.bool)
    truth = tsdf.material_index_at(ts, pos)
    bad = torch.zeros(nb, gather.BLOCK, dtype=torch.bool)
    bad[:blocks, :lanes_per_block] = True
    bad = bad.reshape(-1)
    return pos, hit, torch.where(bad, -1, truth), truth, bad


@pytest.mark.parametrize("blocks,lanes,tier", [
    (0, 0, "none"), (1, 300, "block"), (16, 40, "block"),
    (17, 40, "lane"), (17, 400, "dense")])
def test_resolve_material_tiers_and_the_flag(blocks, lanes, tier,
                                             no_host_read):
    ts = scene_pair("torus96")[1]
    pos, hit, midx, truth, bad = _repair_case(ts, blocks, lanes)
    nbad = int(bad.sum())
    assert tier == ("none" if nbad == 0 else "block" if blocks <= 16
                    else "lane" if nbad <= tshade.CAP_MAX else "dense")
    got = tshade.resolve_material(ts, pos, hit, midx, backend="cuda")
    assert torch.equal(got, torch.where(bad, truth, midx))
    frame = deferred.Frame("cpu")
    with no_host_read, deferred.deferring(frame):
        out = tshade.resolve_material(ts, pos, hit, midx, backend="cuda")
    assert bool(frame.flag) == (tier != "none")
    assert torch.equal(out, midx)


def test_overflowing_frame_flags_and_reruns_exactly():
    js, ts = scene_pair("torus96")
    small = dict(CULL, cull_m=8, cull_m_shadow=8)
    cfg = tft.RenderConfig(width=SIZE, height=SIZE,
                           march=TMC(backend="cuda", **small))
    assert bool(deferred_frame(ts, cfg, port_camera())[2].flag)
    # the eager re-run: today's frame (render_with_stats on the CPU), whose
    # overflowing calls run again on full-group tables
    rerun = tft.render_with_stats(ts, port_camera(), cfg)
    big = dict(CULL, cull_m=96, cull_m_shadow=96)
    full = tft.render_with_stats(ts, port_camera(), dataclasses.replace(
        cfg, march=TMC(backend="cuda", **big)))
    assert torch.equal(rerun[0], full[0]) and int(rerun[1]) == int(full[1])
    # JAX's culled frame overflows m 8 too and takes its lax.cond fallback,
    # which marches on full-group tables: the outcomes are those tables'
    jimg = np.asarray(jft.render(
        js, jft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0),
        jft.RenderConfig(width=SIZE, height=SIZE,
                         march=JMC(backend="pallas_interpret", **small))))
    timg = rerun[0].numpy()
    (jm, jt), (tm, tt) = (
        jax_masks(js, JMC(backend="pallas_interpret", **big), SIZE, SIZE,
                  with_t=True),
        port_masks(ts, TMC(backend="cuda", **big), SIZE, SIZE, with_t=True))
    flipped = np.zeros((SIZE, SIZE), bool)
    for a, b in zip(jm, tm):
        flipped |= a != b
    assert flipped.mean() <= 0.005
    shell = ~flipped & tm[0] & (np.abs(jt - tt) > 1e-3)
    diff = np.abs(timg - jimg).max(-1)
    assert diff[~flipped & ~shell].max() < 2e-3
    off = shell & (diff >= 2e-3)
    assert off.mean() <= 0.005
    if off.any():
        assert diff[off].max() < 3e-2
    assert float(np.median(diff)) < 1e-5


def frame_key(scene, camera, cfg):
    """The key ``render_with_stats`` keeps a frame under."""
    return graph.key("frame", scene, camera, cfg)


def test_frame_key_is_what_jit_keys_on():
    ts = scene_pair("torus96")[1]
    cam = port_camera()
    cfg = tft.RenderConfig(width=SIZE, height=SIZE)
    key = frame_key(ts, cam, cfg)
    # parameter values and the scene object are not in the key
    moved = {k: v + 0.25 for k, v in ts.tensors().items()}
    assert frame_key(ts.with_tensors(moved), cam, cfg) == key
    assert frame_key(ts, port_camera(fov=30.0), cfg) == key
    # static fields, shapes, the camera's projection and the config are
    other = scene_pair("torus48")[1]
    assert frame_key(other, cam, cfg) != key
    lights = dataclasses.replace(ts, light_kind=ts.light_kind[::-1])
    assert frame_key(lights, cam, cfg) != key
    mats = dataclasses.replace(ts, prim_material=(0,) * len(
        ts.prim_material))
    assert frame_key(mats, cam, cfg) != key
    wide = dict(ts.tensors(), background=torch.zeros(4))
    assert frame_key(ts.with_tensors(wide), cam, cfg) != key
    ortho = dataclasses.replace(cam, ortho_scale=2.0)
    assert frame_key(ts, ortho, cfg) != key
    assert frame_key(ts, cam, dataclasses.replace(cfg, width=32)) != key
    assert frame_key(ts, cam, dataclasses.replace(
        cfg, march=TMC(cull_m=64))) != key
    # the CPU, and a frame autograd must see, stay eager
    assert not graph.capturable(ts, cam, cfg)


def test_deferred_frame_lowers_its_own_program():
    """A deferred frame never takes the lowered program from the scene's
    eager memo (a captured frame must lower the values inside the
    capture), and lowers once for all of its marches."""
    ts = scene_pair("torus96")[1]
    eager = mk.lower_program(ts, "cpu")
    assert mk.lower_program(ts, "cpu") is eager
    frame = deferred.Frame("cpu")
    with deferred.deferring(frame):
        mine = mk.lower_program(ts, "cpu")
        assert mine is not eager and mk.lower_program(ts, "cpu") is mine
        assert torch.equal(mine.ent_params, eager.ent_params)
        with torch.no_grad():
            ts.prim_params["torus"][0, 0] += 1.0
        edited = mk.lower_program(ts, "cpu")
    assert edited is not mine
    assert not torch.equal(edited.ent_params, mine.ent_params)
    assert mk.lower_program(ts, "cpu") is not eager


def routed_frames(monkeypatch, ts, cam, cfg, calls=2):
    """``calls`` frames of ``render_with_stats`` routed as on the card (the
    graph frame taken on the CPU, a capture recorded: ``recorded``, the
    promoted sites each capture saw), from counts of 0: ``(frames, graph
    counts, the key's graph, recorded)``."""
    from fraytracer_tpu_torch.ops import cuda as ops_cuda
    recorded = []

    def capture(self):
        recorded.append(self.frame.promoted)
        recorded_capture(self)
    monkeypatch.setattr(graph, "capturable", lambda *a: True)
    monkeypatch.setattr(graph, "_graphs", {})
    monkeypatch.setattr(graph._FrameGraph, "_capture", capture)
    ops_cuda.reset_launch_counts()
    frames = [tft.render_with_stats(ts, cam, cfg) for _ in range(calls)]
    counts = ops_cuda.graph_counts()
    ops_cuda.reset_launch_counts()
    return frames, counts, trender.frame_graph(ts, cam, cfg), recorded


def overflow_case(**tables):
    """The 96-torus 32² culled frame with small tables: ``(scene, camera,
    config, the eager frame, the sites its first deferred run saw
    overflow)``."""
    ts = scene_pair("torus96")[1]
    cam = port_camera()
    cfg = tft.RenderConfig(width=32, height=32, march=TMC(
        backend="cuda", **dict(CULL, **tables)))
    first = deferred_frame(ts, cfg, cam)[2]
    assert bool(first.flag)
    return ts, cam, cfg, trender._frame(ts, cam, cfg), \
        first.overflowed_sites()


def test_key_whose_first_frame_flags_runs_eagerly(monkeypatch):
    """Tables of 8 everywhere: the key's first frame overflows the primary
    march (site 0), which is promoted; the frame runs once more, and its
    shadow marches, fed the now exact hits, overflow their tables: that
    run raises the flag too, so nothing is captured, the call runs the
    eager frame again and the key's later frames run eagerly; each is the
    eager frame bit for bit, and counted."""
    ts, cam, cfg, (want, wn), sites = overflow_case(cull_m=8,
                                                    cull_m_shadow=8)
    assert sites == {0}
    frames, counts, fg, recorded = routed_frames(monkeypatch, ts, cam, cfg)
    for img, n in frames:
        assert torch.equal(img, want) and int(n) == int(wn)
    assert fg.graph is None and fg.frame.promoted == sites
    assert not recorded and bool(fg.frame.flag)
    assert fg.frame.overflowed_sites() == {1, 2}
    assert counts == {"captures": 0, "replays": 0, "eager_reruns": 1,
                      "eager_frames": 1}


def test_key_whose_first_frame_overflows_captures_the_promoted_frame(
        monkeypatch):
    """Tables of 8 for the primary march alone (the shadow marches' hold
    the group): the key's first frame overflows site 0, which is promoted
    to full-group tables; the frame runs once more deferred, raises no
    flag and is captured with that site; that call and the replay are the
    eager frame bit for bit, and nothing runs eagerly."""
    ts, cam, cfg, (want, wn), sites = overflow_case(cull_m=8,
                                                    cull_m_shadow=96)
    assert sites == {0}
    frames, counts, fg, recorded = routed_frames(monkeypatch, ts, cam, cfg)
    for img, n in frames:
        assert torch.equal(img, want) and int(n) == int(wn)
    assert recorded == [sites] and fg.frame.promoted == sites
    assert fg.graph is not None and not bool(fg.frame.flag)
    assert counts == {"captures": 1, "replays": 1, "eager_reruns": 0,
                      "eager_frames": 0}


def test_key_whose_first_frame_needs_a_repair_runs_eagerly(monkeypatch):
    """A key whose first frame raises the flag with no overflowed site (a
    material repair, forced in every frame): nothing is promoted or
    captured, that call runs the eager frame again and the key's later
    frames run eagerly; each is the eager frame bit for bit, and
    counted."""
    ts = scene_pair("torus96")[1]
    cam = port_camera()
    cfg = tft.RenderConfig(width=32, height=32,
                           march=TMC(backend="cuda", **CULL))
    with forced_repair():
        want, wn = trender._frame(ts, cam, cfg)
        frames, counts, fg, recorded = routed_frames(monkeypatch, ts, cam,
                                                     cfg)
    for img, n in frames:
        assert torch.equal(img, want) and int(n) == int(wn)
    assert fg.graph is None and not fg.frame.promoted and not recorded
    assert counts == {"captures": 0, "replays": 0, "eager_reruns": 1,
                      "eager_frames": 1}


@pytest.mark.parametrize("name,made", [
    ("smooth_materials", {"_static_on", "slots_on", "mat_kinds", "_tables"}),
    ("torus96", {"_static_on", "slots_on", "_row_ids"})])
def test_device_constants_live_with_their_frame(name, made):
    """The caches of device constants are bounded; a deferred frame keeps
    what it took from them, so its second run, after every cache was
    cleared, takes each constant from the frame and calls no cache."""
    from fraytracer_tpu_torch.ops.cuda import cull
    from fraytracer_tpu_torch.utils import noise
    caches = (mk._static_on, tsdf.slots_on, tsdf.mat_kinds, noise._tables,
              cull._row_ids)
    assert all(c.cache_info().maxsize is not None for c in caches)
    ts = tft.flatten(smooth_materials(TN, TG), device="cpu") \
        if name == "smooth_materials" else scene_pair(name)[1]
    cfg = tft.RenderConfig(width=32, height=32,
                           march=TMC(backend="cuda", **CULL))
    frame = deferred.Frame("cpu")

    def run():
        frame.programs.clear()      # as the capture does
        with deferred.deferring(frame):
            mk.lower_program(ts, "cpu")     # what the card's launches lower
            return trender._frame(ts, port_camera(), cfg)[0]
    img = run()
    kept = dict(frame.constants)
    assert made <= {key[0].__name__ for key in kept}
    for c in caches:
        c.cache_clear()
    assert torch.equal(run(), img)
    assert all(c.cache_info().currsize == 0 for c in caches)
    assert frame.constants.keys() == kept.keys()
    assert all(frame.constants[k] is v for k, v in kept.items())
