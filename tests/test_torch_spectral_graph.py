"""The compiled spectral frame's glue on the CPU: on the card
``ops/wavefront.py::render_spectral_with_stats`` replays one captured CUDA
graph a key (``ops/graph.py``, the counterpart of JAX's jitted
wavefront), and a culled march call whose tables overflowed in the key's
first run is a promoted site: it builds full-group tables at once, as
JAX's ``lax.cond`` fallback marches on them (``ops/deferred.py``).  Here the
frame the card captures runs eagerly with its host reads deferred.

``spectral_csg_scene(19, 64)`` at 32² (eight 1024-lane tiles in the queue,
so the block tier runs), depth 3, the "cuda" glue on CPU tensors.  With
``cull_m = cull_m_shadow = 48`` round 0's march and both of its shadow
marches overflow (one tile sees 64 / 62 / 59 candidates: the point light's
is the smallest, and a shadow march takes ``max(cull_m, cull_m_shadow)``),
the bounce rounds' tables hold the whole group.

* (a) The deferred frame reads nothing on the host
  (``test_torch_frame_graph.NoHostRead``): with the default tables it
  raises no flag and is the eager frame bit for bit; with the small
  tables it raises the flag, and its overflowing sites are exactly the
  calls the eager frame runs again (spied).
* (b) With those sites promoted the deferred frame raises no flag and is
  bit for bit the eager frame and the frame whose promoted calls ran at
  the full group; routed as on the card, a key's first call promotes
  them and returns that frame.
* (c) The condition that makes promotion exact: a culled march, an
  occlusion march with the point light's cone apex and a surface pass
  whose tables do not overflow give the same outputs, bit for bit, at
  their own ``m`` (40) and at the full group (64), on the kernels' plain
  versions (64² primary lanes: at most 37 candidates a tile).
* (d) The promoted frame against JAX's ``render_spectral_with_stats`` on
  "pallas_interpret" with the same small tables (JAX takes its
  ``lax.cond`` fallback), within ``test_torch_wavefront_culled.py``'s bound
  (max < 5e-2, mean < 2e-3): at depth 1 (round 0, where every promoted
  site lies) with rays marched within 0.5%; at depth 3 the image alone —
  the bounce rounds count a shadow ray on every lane of the queue whose
  normal faces a light, dead lanes too, and JAX's CPU route compacts the
  queue lane by lane where the port keeps whole blocks, so the counts
  differ by design ("jnp", whose plain march does not cull, is no
  fallback and lands 0.64 off on a pixel at ω 1.4).
* (e) The spectral frame's key holds what ``jax.jit`` keys on.
* (f) Routed as on the card, a key whose promoted run still raises the
  flag (a forced material repair) runs eagerly, and is counted.
* (g) ``spectral.table`` lives with its frame, as the other device
  constants do.

About 49 s alone on one worker, 34 s of it JAX's two interpreted
frames."""
import dataclasses

import pytest
import torch

import fraytracer_tpu as jft
import fraytracer_tpu_torch as tft
from fraytracer_tpu.ops import wavefront as jw
from fraytracer_tpu.ops.march import MarchConfig as JMC
from fraytracer_tpu.scene import generators as JG
from fraytracer_tpu_torch.camera import to_blocks
from fraytracer_tpu_torch.ops import cuda as ops_cuda, deferred, graph
from fraytracer_tpu_torch.ops import spectral
from fraytracer_tpu_torch.ops import wavefront as tw
from fraytracer_tpu_torch.ops.cuda import march_kernel as mk
from fraytracer_tpu_torch.ops.shade import light_dir_and_dist
from fraytracer_tpu_torch.scene import generators as TG
from fraytracer_tpu_torch.scene.nodes import LIGHT_POINT
from fraytracer_tpu_torch.types import Rays
from test_torch_frame_graph import NoHostRead, no_host_read  # noqa: F401
from test_torch_render import port_camera
from test_torch_wavefront_culled import assert_bound

SIZE = 32
DEPTH = 3
MARCH = dict(max_steps=192, relax_omega=1.4)
SMALL = dict(MARCH, cull_m=48, cull_m_shadow=48)
ROUND0 = frozenset({0, 1, 2})     # round 0: the march, then a light each
CAM = port_camera()


def scene():
    return tft.flatten(TG.spectral_csg_scene(19, 64), device="cpu")


def wcfg(march, depth=DEPTH):
    return tw.WavefrontConfig(depth=depth,
                              march=tft.MarchConfig(backend="cuda", **march))


def eager(ts, cfg):
    return tw._spectral_frame(ts, CAM, SIZE, SIZE, cfg)


def deferred_frame(ts, cfg, promoted=frozenset()):
    """The frame the card captures, run eagerly: ``(image, n_rays,
    frame)``."""
    frame = deferred.Frame("cpu")
    frame.promoted = promoted
    with deferred.deferring(frame):
        img, n = eager(ts, cfg)
    return img, n, frame


def spy_march_calls(monkeypatch, full=frozenset()):
    """Record the frame's culled march calls (``calls``: each one's
    ``cull_m``) and which of them ran again (``reruns``: the index of the
    call a nested call re-runs); the calls numbered in ``full`` build
    full-group tables at once."""
    real, depth = mk.cuda_march_raw, [0]
    rec = {"calls": [], "reruns": set()}

    def spy(scene_, rays, cfg, *a, **k):
        if depth[0]:
            rec["reruns"].add(len(rec["calls"]) - 1)
        else:
            if len(rec["calls"]) in full:
                cfg = mk._full_tables(cfg, mk.cull_pairs_for(scene_, cfg))
            rec["calls"].append(cfg.cull_m)
        depth[0] += 1
        try:
            return real(scene_, rays, cfg, *a, **k)
        finally:
            depth[0] -= 1
    monkeypatch.setattr(mk, "cuda_march_raw", spy)
    return rec


def same(a, b):
    return torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])


@pytest.mark.parametrize("march,sites", [(MARCH, frozenset()),
                                         (SMALL, ROUND0)],
                         ids=["default", "overflow"])
def test_deferred_spectral_frame_reads_nothing_on_the_host(
        no_host_read, monkeypatch, march, sites):
    ts, cfg = scene(), wcfg(march)
    # the eager frame fills the caches of device constants, as the graph
    # frame's first call does before its capture
    rec = spy_march_calls(monkeypatch)
    want = eager(ts, cfg)
    assert len(rec["calls"]) == 3 * DEPTH and rec["reruns"] == set(sites)
    for _ in range(2):
        with no_host_read:
            img, n, frame = deferred_frame(ts, cfg)
        assert bool(frame.flag) == bool(sites)
        assert len(frame.overflows) == 3 * DEPTH
        # the bounce rounds' tables hold the whole group
        assert all(o is None for o in frame.overflows[3:])
        assert frame.overflowed_sites() == sites
        if not sites:
            assert same((img, n), want)


def test_promoted_sites_give_the_eager_frame(no_host_read, monkeypatch):
    ts, cfg = scene(), wcfg(SMALL)
    want = eager(ts, cfg)
    with no_host_read:
        img, n, frame = deferred_frame(ts, cfg, promoted=ROUND0)
    assert not bool(frame.flag)
    assert all(o is None for o in frame.overflows[:3])
    assert same((img, n), want)
    # the frame whose promoted calls build full-group tables themselves
    rec = spy_march_calls(monkeypatch, full=ROUND0)
    full = eager(ts, cfg)
    # round 0's three calls at 64, the bounce rounds' at bounce_cull_m
    assert rec["calls"] == [64] * 3 + [1024] * 6 and not rec["reruns"]
    assert same(full, want)


def test_first_call_promotes_and_captures_the_promoted_frame(monkeypatch):
    """``render_spectral_with_stats`` routed as on the card: the key's
    first run overflows round 0, the graph's frame promotes those sites,
    its second deferred run raises no flag, and the capture (recorded here:
    the CPU has no CUDA graph) sees the promoted sites; the call returns
    the eager frame bit for bit."""
    ts, cfg = scene(), wcfg(SMALL)
    want = eager(ts, cfg)
    captured = []
    monkeypatch.setattr(graph, "capturable", lambda *a: True)
    monkeypatch.setattr(graph, "_graphs", {})
    monkeypatch.setattr(graph._FrameGraph, "_capture",
                        lambda self: captured.append(self.frame.promoted))
    ops_cuda.reset_launch_counts()
    got = tft.render_spectral_with_stats(ts, CAM, SIZE, SIZE, cfg)
    assert same(got, want)
    fg = tw.spectral_graph(ts, CAM, SIZE, SIZE, cfg)
    assert captured == [ROUND0] and fg.frame.promoted == ROUND0
    assert not bool(fg.frame.flag) and fg.capture_s > 0
    assert ops_cuda.graph_counts() == {"captures": 0, "replays": 0,
                                       "eager_reruns": 0, "eager_frames": 0}


def _primary_lanes(ts, size=64):
    rays = tft.camera_rays(CAM, size, size, 0.01, 30.0)
    return rays.map(lambda x: to_blocks(x, size, size, 32))


@pytest.mark.parametrize("call", ["march", "occlusion_point", "surface"])
def test_unfilled_tables_march_alike_at_any_m(call):
    """(c): the tables at ``m`` 40 hold every tile's candidates (no
    overflow), and the outputs equal those at the full group (m 64)."""
    ts = scene()
    flat = _primary_lanes(ts)
    own, full = (tft.MarchConfig(backend="cuda", cull_m=m, cull_m_shadow=m,
                                 **MARCH) for m in (40, 64))
    if call == "occlusion_point":
        res, nrm, _m, _c = mk.cuda_march_raw(ts, flat, full,
                                             want_surface=True)
        i = ts.light_kind.index(LIGHT_POINT)
        pos = flat.at(res.t - flat.epsilon)
        ldir, budget, _s = light_dir_and_dist(ts, i, pos)
        facing = res.hit & ((nrm * ldir).sum(-1) > 0.0)
        flat = Rays(origin=pos, direction=ldir,
                    length=torch.where(facing, budget, 0.0),
                    epsilon=flat.epsilon)
        kw = dict(occlusion=True, cone_apex=ts.light_vec[i])
    else:
        kw = dict(want_surface=call == "surface")
    tables = {c.cull_m: mk.march_tables(ts, flat, c,
                                        kw.get("cone_apex"))[3]
              for c in (own, full)}
    assert [q.m for q in tables[40].tables] == [40]
    assert [q.m for q in tables[64].tables] == [64]
    assert not bool(tables[40].overflow)
    assert int(tables[40].tables[0].count.max()) > 8
    a = mk.cuda_march_raw(ts, flat, own, **kw)
    b = mk.cuda_march_raw(ts, flat, full, **kw)
    if call == "occlusion_point":
        assert bool(a.any()) and torch.equal(a, b)
    elif call == "march":
        for f in ("hit", "t", "distance", "steps"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    else:
        assert bool(a[0].hit.any())
        for x, y in zip(a[1:], b[1:]):
            assert torch.equal(x, y)


@pytest.mark.parametrize("depth", [1, DEPTH], ids=["round0", "depth3"])
def test_promoted_frame_matches_jax_fallback(depth):
    """(d): JAX's frame overflows the same tables and takes its
    ``lax.cond`` fallback at each overflowing call."""
    ts, cfg = scene(), wcfg(SMALL, depth)
    img, n, frame = deferred_frame(ts, cfg, promoted=ROUND0)
    assert not bool(frame.flag)
    jimg, jn = jw.render_spectral_with_stats(
        jft.flatten(JG.spectral_csg_scene(19, 64)),
        jft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0), SIZE, SIZE,
        jw.WavefrontConfig(depth=depth, march=JMC(
            backend="pallas_interpret", **SMALL)))
    assert img.shape == (SIZE, SIZE, 3)
    assert_bound(img, jimg)
    if depth == 1:
        assert abs(int(n) - float(jn)) <= 5e-3 * float(jn), (int(n), jn)


def spectral_key(scene, camera, width, height, cfg):
    """The key ``render_spectral_with_stats`` keeps a frame under."""
    return graph.key("spectral", scene, camera, cfg, extra=(width, height))


def test_spectral_key_is_what_jit_keys_on():
    ts, cam = scene(), CAM
    cfg = wcfg(MARCH)
    key = spectral_key(ts, cam, SIZE, SIZE, cfg)
    # parameter values and the scene object are not in the key
    moved = {k: v + 0.25 for k, v in ts.tensors().items()}
    assert spectral_key(ts.with_tensors(moved), cam, SIZE, SIZE,
                        cfg) == key
    assert spectral_key(ts, port_camera(fov=30.0), SIZE, SIZE, cfg) == key
    # the static arguments, static fields, shapes and projection are
    assert spectral_key(ts, cam, SIZE, 64, cfg) != key
    assert spectral_key(ts, cam, 64, SIZE, cfg) != key
    assert spectral_key(ts, cam, SIZE, SIZE,
                        dataclasses.replace(cfg, depth=2)) != key
    assert spectral_key(ts, cam, SIZE, SIZE, wcfg(SMALL)) != key
    mats = dataclasses.replace(ts, mat_kind=(0,) * len(ts.mat_kind))
    assert spectral_key(mats, cam, SIZE, SIZE, cfg) != key
    lights = dataclasses.replace(ts, light_kind=ts.light_kind[::-1])
    assert spectral_key(lights, cam, SIZE, SIZE, cfg) != key
    wide = dict(ts.tensors(), background=torch.zeros(4))
    assert spectral_key(ts.with_tensors(wide), cam, SIZE, SIZE, cfg) != key
    ortho = dataclasses.replace(cam, ortho_scale=2.0)
    assert spectral_key(ts, ortho, SIZE, SIZE, cfg) != key
    # a spectral frame never shares a key with a forward frame
    assert key != graph.key("frame", ts, cam, tft.RenderConfig(
        width=SIZE, height=SIZE, march=cfg.march))
    # the CPU stays eager
    assert not graph.capturable(ts, cam, cfg)


def test_key_whose_promoted_run_flags_runs_eagerly(monkeypatch):
    """Every surface pass marks lanes unresolved, so each frame needs a
    material repair: the key's first run raises the flag (round 0 overflows
    too), the promoted run raises it again, nothing is captured; that call
    and the key's later calls run the eager frame, bit for bit, counted."""
    ts, cfg = scene(), wcfg(SMALL)
    real = mk.surface_kernel

    def marked(*a, **k):
        normal, midx, code = real(*a, **k)
        lane = torch.arange(midx.shape[0])
        return normal, torch.where(lane % 7 == 3, -1, midx), code
    monkeypatch.setattr(mk, "surface_kernel", marked)
    want = eager(ts, cfg)
    monkeypatch.setattr(graph, "capturable", lambda *a: True)
    monkeypatch.setattr(graph, "_graphs", {})
    ops_cuda.reset_launch_counts()
    for _ in range(2):
        got = tft.render_spectral_with_stats(ts, CAM, SIZE, SIZE, cfg)
        assert same(got, want)
    fg = tw.spectral_graph(ts, CAM, SIZE, SIZE, cfg)
    assert fg.graph is None and fg.frame.promoted == ROUND0
    assert ops_cuda.graph_counts() == {"captures": 0, "replays": 0,
                                       "eager_reruns": 1, "eager_frames": 1}
    ops_cuda.reset_launch_counts()


def test_spectral_tables_live_with_their_frame():
    """``spectral.table`` is a bounded cache; a deferred frame keeps what it
    took from it, so its second run, after the cache was cleared, takes
    the tables from the frame."""
    assert spectral.table.cache_info().maxsize == 8
    ts, cfg = scene(), wcfg(MARCH)
    frame = deferred.Frame("cpu")

    def run():
        frame.programs.clear()
        frame.overflows.clear()
        with deferred.deferring(frame):
            return eager(ts, cfg)[0]
    img = run()
    kept = {k: v for k, v in frame.constants.items() if k[0] is
            spectral.table.__wrapped__}
    assert {k[1][0] for k in kept} == {"bin_rgb", "bin_rgb_sum",
                                       "wavelengths_um"}
    spectral.table.cache_clear()
    assert torch.equal(run(), img)
    assert spectral.table.cache_info().currsize == 0
    assert all(frame.constants[k] is v for k, v in kept.items())
