"""Port parity, the whole forward frame: ``fraytracer_tpu_torch.render``
(the "cuda" backend on CPU tensors, i.e. the kernels' plain versions behind
the real host glue) against ``fraytracer_tpu.render`` (JAX kernels in
interpret mode, ``cull=False``, ω = 1.4), tone mapping with shared noise,
and the float64 oracle gate of tests/test_benchmark_oracle.py through
``chip_smoke.py``'s ``oracle_gate``.

Frame tolerance: max |Δ| < 2e-3 outside pixels whose primary hit, facing
or occlusion bit flipped, median < 1e-5 — float32 in two frameworks lands
hits at slightly different points inside the epsilon shell."""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fraytracer_tpu as jft
import fraytracer_tpu_torch as tft
from fraytracer_tpu.ops import shade as jshade
from fraytracer_tpu.ops import tonemap as jtonemap
from fraytracer_tpu.ops.march import MarchConfig as JMC
from fraytracer_tpu.ops.march import march_occlusion as jocclusion
from fraytracer_tpu.oracle.cpu_ref import Oracle
from fraytracer_tpu.types import Rays as JRays
from fraytracer_tpu_torch.ops import shade as tshade
from fraytracer_tpu_torch.ops import tonemap as ttonemap
from fraytracer_tpu_torch.ops.march import MarchConfig as TMC
from fraytracer_tpu_torch.ops.march import march_occlusion as tocclusion
from fraytracer_tpu_torch.scene import generators as TG
from fraytracer_tpu_torch.scene.nodes import LIGHT_POINT
from test_torch_scene import SCENES, scene_pair

EPS = 0.01
CAM = (0.0, 0.0, -10.0)


def jax_masks(js, cfg, w, h, with_t=False):
    """Primary hit, then facing and occlusion bits per light (JAX), marched
    in the frame's 32×32 block order (the kernels' tiles), the point
    light's occlusion with its converging cone, as the frame runs them;
    ``with_t`` adds the winning material and returns the primary t."""
    from fraytracer_tpu.render import _from_blocks, _to_blocks
    cam = jft.look_at(CAM, (0, 0, 0), fov_degrees=60.0)
    rays = jax.tree.map(lambda x: _to_blocks(x, h, w, 32),
                        jft.camera_rays(cam, w, h, EPS, 30.0))
    sh = jshade.surface_hit(js, rays, cfg)
    masks = [sh.hit]
    for i in range(js.num_lights):
        ldir, budget, _ = jshade.light_dir_and_dist(js, i, sh.position)
        facing = sh.hit & (jnp.sum(sh.normal * ldir, -1) > 0.0)
        sr = JRays(origin=sh.position, direction=ldir,
                   length=jnp.where(facing, budget, 0.0),
                   epsilon=rays.epsilon)
        apex = js.light_vec[i] if js.light_kind[i] == LIGHT_POINT else None
        masks += [facing, jocclusion(js, sr, cfg, cone_apex=apex)]
    if with_t:      # + the winning material, a discrete outcome too
        masks.insert(1, sh.material)
    out = [np.asarray(_from_blocks(m, h, w, 32)) for m in masks]
    return (out, np.asarray(_from_blocks(sh.t, h, w, 32))) if with_t \
        else out


@functools.cache
def load_chip_smoke():
    """``chip_smoke.py``, loaded by path (it imports only torch at module
    level): its ``oracle_gate`` is the one f64-oracle gate of the port."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_by_path", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_camera(fov=60.0):
    return tft.look_at(CAM, (0, 0, 0), fov_degrees=fov, device="cpu")


def port_masks(ts, cfg, w, h, with_t=False):
    from fraytracer_tpu_torch.camera import from_blocks, to_blocks
    cam = port_camera()
    rays = tft.camera_rays(cam, w, h, EPS, 30.0).map(
        lambda x: to_blocks(x, h, w, 32))
    sh = tshade.surface_hit(ts, rays, cfg)
    masks = [sh.hit]
    for i in range(ts.num_lights):
        ldir, budget, _ = tshade.light_dir_and_dist(ts, i, sh.position)
        facing = sh.hit & ((sh.normal * ldir).sum(-1) > 0.0)
        sr = tft.Rays(origin=sh.position, direction=ldir,
                      length=torch.where(facing, budget, 0.0),
                      epsilon=rays.epsilon)
        apex = ts.light_vec[i] if ts.light_kind[i] == LIGHT_POINT else None
        masks += [facing, tocclusion(ts, sr, cfg, cone_apex=apex)]
    if with_t:
        masks.insert(1, sh.material)
    out = [from_blocks(m, h, w, 32).numpy() for m in masks]
    return (out, from_blocks(sh.t, h, w, 32).numpy()) if with_t else out


@pytest.mark.parametrize("size", [64])
def test_render_matches_jax_pallas(size):
    js, ts = scene_pair("torus96")
    jcfg = JMC(backend="pallas_interpret", cull=False, relax_omega=1.4)
    tcfg = TMC(backend="cuda", cull=False, relax_omega=1.4)
    jcam = jft.look_at(CAM, (0, 0, 0), fov_degrees=60.0)
    tcam = port_camera()
    jimg, jn = jft.render_with_stats(js, jcam, jft.RenderConfig(
        width=size, height=size, march=jcfg))
    timg, tn = tft.render_with_stats(ts, tcam, tft.RenderConfig(
        width=size, height=size, march=tcfg))
    jimg, timg = np.asarray(jimg), timg.numpy()
    assert timg.shape == (size, size, 3) and np.isfinite(timg).all()
    flipped = np.zeros((size, size), bool)
    for a, b in zip(jax_masks(js, jcfg, size, size),
                    port_masks(ts, tcfg, size, size)):
        flipped |= a != b
    assert flipped.mean() <= 0.005
    diff = np.abs(timg - jimg).max(-1)
    assert diff[~flipped].max() < 2e-3
    assert float(np.median(diff)) < 1e-5
    # marched-ray count: primary + facing shadow lanes
    assert abs(int(tn) - float(jn)) <= flipped.sum() * 2


def test_culled_render_matches_jax_pallas():
    """The culled frame (cull_threshold=64, cull_m=128: the 96 tori form a
    culled pair) against the JAX culled render
    (tests/test_pallas_march.py:118) with the frame tolerance above, off
    flipped pixels (a different winning material counts as a flip too)
    and off pixels whose primary hit landed at another
    point of the ε-shell (|Δt| > 1e-3: the port's per-warp windows step
    differently from JAX's per-tile ones).  Shell pixels at |Δ| ≥ 2e-3 are
    ≤ 0.5% of the frame and below 3e-2 (the oracle gate's shell bound)."""
    size = 64
    js, ts = scene_pair("torus96")
    kw = dict(cull=True, cull_threshold=64, cull_m=128, relax_omega=1.4)
    jcfg = JMC(backend="pallas_interpret", **kw)
    tcfg = TMC(backend="cuda", **kw)
    from fraytracer_tpu_torch.ops.cuda import cull as tcull
    assert tcull._cull_pairs(ts.kind_counts, ts.plan, 64)
    jimg = np.asarray(jft.render(js, jft.look_at(CAM, (0, 0, 0),
                                                 fov_degrees=60.0),
                                 jft.RenderConfig(width=size, height=size,
                                                  march=jcfg)))
    timg = tft.render(ts, port_camera(),
                      tft.RenderConfig(width=size, height=size,
                                       march=tcfg)).numpy()
    assert np.isfinite(timg).all()
    (jm, jt), (tm, tt) = (jax_masks(js, jcfg, size, size, with_t=True),
                          port_masks(ts, tcfg, size, size, with_t=True))
    flipped = np.zeros((size, size), bool)
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


def test_torch_backend_render_matches_jnp():
    js, ts = scene_pair("torus48")
    jimg = np.asarray(jft.render(js, jft.look_at(CAM, (0, 0, 0)),
                                 jft.RenderConfig(width=32, height=32,
                                                  tile_rays=512)))
    timg = tft.render(ts, port_camera(),
                      tft.RenderConfig(width=32, height=32, tile_rays=400,
                                       march=TMC(backend="torch"))).numpy()
    diff = np.abs(timg - jimg).max(-1)
    assert (diff < 2e-3).mean() >= 0.995
    assert float(np.median(diff)) < 1e-5


def test_tonemap_matches_jax_with_shared_dither(monkeypatch):
    rng = np.random.default_rng(5)
    img = (rng.uniform(0, 1.3, size=(16, 20, 3)) ** 2).astype(np.float32)
    dither = rng.uniform(0, 1, size=img.shape).astype(np.float32)
    # pre-quantization: exposure + gamma
    want = np.asarray(jnp.power(
        jnp.maximum(img / jtonemap.auto_exposure_scale(img), 0.0),
        jnp.float32(1.0 / 2.2)))
    got = ttonemap.tone_curve(torch.from_numpy(img), 2.2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # quantized, both fed the same noise
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype: jnp.asarray(dither))
    q_j = np.asarray(jtonemap.tonemap(jnp.asarray(img), jax.random.key(0)))
    q_t = ttonemap.tonemap(torch.from_numpy(img),
                           dither=torch.from_numpy(dither)).numpy()
    assert q_t.dtype == np.uint8
    assert np.abs(q_t.astype(int) - q_j.astype(int)).max() <= 1
    # generator noise: deterministic per seed, full range
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = ttonemap.tonemap(torch.from_numpy(img), g1)
    assert torch.equal(a, ttonemap.tonemap(torch.from_numpy(img), g2))
    assert int(a.max()) >= 250


def test_benchmark_scene_image_allclose_oracle():
    """tests/test_benchmark_oracle.py on the port's "cuda" path (plain
    versions on CPU), dense, through ``chip_smoke.py``'s gate."""
    oracle_gate(TMC(backend="cuda", cull=False, bound_skip=True,
                    max_steps=512))


def test_benchmark_scene_image_allclose_oracle_culled():
    """The same gate on the default, culled "cuda" configuration."""
    mcfg = TMC(backend="cuda", bound_skip=True, max_steps=512)
    assert mcfg.cull
    oracle_gate(mcfg)


def oracle_gate(mcfg):
    """The f64-oracle gate of tests/test_benchmark_oracle.py at 64²:
    ``chip_smoke.py``'s ``oracle_gate`` (the gate the card runs) on the
    frame's own outcomes (``frame_outcomes``: marched in its block order)
    against JAX's oracle."""
    cs = load_chip_smoke()
    W = H = 64
    fscene = tft.flatten(TG.torus_csg_scene(seed=19, n_tori=1000),
                         device="cpu")
    cfg = tft.RenderConfig(width=W, height=H, epsilon=EPS, length=30.0,
                           march=mcfg)
    frame = cs.frame_outcomes(fscene, port_camera(), cfg)
    want, aux = Oracle(SCENES["torus1000"](*_jax_modules())).render(
        CAM, (0, 0, 0), fov_degrees=60.0, width=W, height=H,
        epsilon=EPS, length=30.0, return_aux=True)
    r = cs.oracle_gate(f"torus1000 {W}^2, cull={mcfg.cull}", frame,
                       (want.reshape(-1, 3), [a for row in aux for a in row]))
    assert r["rays"] == W * H


def _jax_modules():
    from fraytracer_tpu.scene import generators as JG, nodes as JN
    return JN, JG


def test_cuda_backend_refuses_cull_and_missing_gpu(tmp_path):
    """The default (culled) "cuda" configuration renders, a smooth union
    in the fused surface pass (K3 AD mode) too; without a GPU the default
    device (the card) is refused with torch's own error."""
    _js, ts = scene_pair("torus16")
    cam = port_camera()
    img = tft.render(ts, cam, tft.RenderConfig(
        width=8, height=8, march=TMC(backend="cuda", cull_threshold=8)))
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    _js, smooth = scene_pair("smooth_materials")
    near = tft.look_at((0, 0, -4), (0, 0, 0), device="cpu")
    img = tft.render(smooth, near, tft.RenderConfig(
        width=8, height=8, march=TMC(backend="cuda")))
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    assert bool(((img - smooth.background).abs().amax(-1) > 1e-6).any())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises((RuntimeError, AssertionError)):
        tft.flatten(TG.torus_csg_scene(19, 4))
    from fraytracer_tpu_torch import cli
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["render", "--size", "8", "--out",
                  str(tmp_path / "x.png")])


def test_cli_render_on_cpu(tmp_path, capsys):
    from fraytracer_tpu_torch import cli
    out = tmp_path / "frame.png"
    assert cli.main(["render", "--device", "cpu", "--size", "16", "--tori",
                     "12", "--out", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "Time =" in capsys.readouterr().out
