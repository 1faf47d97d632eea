"""Port parity, the whole forward frame: ``fraytracer_tpu_torch.render``
(the "cuda" backend on CPU tensors, i.e. the kernels' plain versions behind
the real host glue) against ``fraytracer_tpu.render`` (JAX kernels in
interpret mode, ``cull=False``, ω = 1.4), tone mapping with shared noise,
and the float64 oracle gate of tests/test_benchmark_oracle.py with its
bounds unchanged.

Frame tolerance: max |Δ| < 2e-3 outside pixels whose primary hit, facing
or occlusion bit flipped, median < 1e-5 — float32 in two frameworks lands
hits at slightly different points inside the epsilon shell."""
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
from fraytracer_tpu_torch.ops.march import march as tmarch
from fraytracer_tpu_torch.ops.march import march_occlusion as tocclusion
from fraytracer_tpu_torch.scene import generators as TG
from test_torch_scene import SCENES, scene_pair

EPS = 0.01
CAM = (0.0, 0.0, -10.0)


def jax_masks(js, cfg, w, h):
    """Primary hit, then facing and occlusion bits per light (JAX)."""
    cam = jft.look_at(CAM, (0, 0, 0), fov_degrees=60.0)
    rays = jft.camera_rays(cam, w, h, EPS, 30.0)
    sh = jshade.surface_hit(js, rays, cfg)
    masks = [np.asarray(sh.hit)]
    for i in range(js.num_lights):
        ldir, budget, _ = jshade.light_dir_and_dist(js, i, sh.position)
        facing = sh.hit & (jnp.sum(sh.normal * ldir, -1) > 0.0)
        sr = JRays(origin=sh.position, direction=ldir,
                   length=jnp.where(facing, budget, 0.0),
                   epsilon=rays.epsilon)
        masks += [np.asarray(facing), np.asarray(jocclusion(js, sr, cfg))]
    return masks


def port_masks(ts, cfg, w, h):
    cam = tft.look_at(CAM, (0, 0, 0), fov_degrees=60.0)
    rays = tft.camera_rays(cam, w, h, EPS, 30.0)
    sh = tshade.surface_hit(ts, rays, cfg)
    masks = [sh.hit.numpy()]
    for i in range(ts.num_lights):
        ldir, budget, _ = tshade.light_dir_and_dist(ts, i, sh.position)
        facing = sh.hit & ((sh.normal * ldir).sum(-1) > 0.0)
        sr = tft.Rays(origin=sh.position, direction=ldir,
                      length=torch.where(facing, budget, 0.0),
                      epsilon=rays.epsilon)
        masks += [facing.numpy(), tocclusion(ts, sr, cfg).numpy()]
    return masks


@pytest.mark.parametrize("size", [64])
def test_render_matches_jax_pallas(size):
    js, ts = scene_pair("torus96")
    jcfg = JMC(backend="pallas_interpret", cull=False, relax_omega=1.4)
    tcfg = TMC(backend="cuda", cull=False, relax_omega=1.4)
    jcam = jft.look_at(CAM, (0, 0, 0), fov_degrees=60.0)
    tcam = tft.look_at(CAM, (0, 0, 0), fov_degrees=60.0)
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


def test_torch_backend_render_matches_jnp():
    js, ts = scene_pair("torus48")
    jimg = np.asarray(jft.render(js, jft.look_at(CAM, (0, 0, 0)),
                                 jft.RenderConfig(width=32, height=32,
                                                  tile_rays=512)))
    timg = tft.render(ts, tft.look_at(CAM, (0, 0, 0)),
                      tft.RenderConfig(width=32, height=32,
                                       tile_rays=400)).numpy()
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
    versions on CPU), bounds unchanged."""
    W = H = 64
    scene = TG.torus_csg_scene(seed=19, n_tori=1000)
    fscene = tft.flatten(scene)
    mcfg = TMC(backend="cuda", cull=False, bound_skip=True, max_steps=512)
    cfg = tft.RenderConfig(width=W, height=H, epsilon=EPS, length=30.0,
                           march=mcfg)
    cam = tft.look_at(CAM, (0, 0, 0), fov_degrees=60.0)
    img = tft.render(fscene, cam, cfg).numpy()
    want, aux = Oracle(SCENES["torus1000"](*_jax_modules())).render(
        CAM, (0, 0, 0), fov_degrees=60.0, width=W, height=H,
        epsilon=EPS, length=30.0, return_aux=True)

    rays = tft.camera_rays(cam, W, H, EPS, 30.0)
    res = tmarch(fscene, rays, mcfg)
    hit_j = res.hit.numpy()
    t_j = res.t.numpy()
    sh = tshade.surface_hit(fscene, rays, mcfg)
    occ_j = []
    for i in range(fscene.num_lights):
        ldir, budget, _ = tshade.light_dir_and_dist(fscene, i, sh.position)
        facing = sh.hit & ((sh.normal * ldir).sum(-1) > 0.0)
        sr = tft.Rays(origin=sh.position, direction=ldir,
                      length=torch.where(facing, budget, 0.0),
                      epsilon=rays.epsilon)
        occ_j.append(tmarch(fscene, sr, mcfg).hit.numpy())

    hit_o = np.array([[aux[y][x]["hit"] for x in range(W)]
                      for y in range(H)])
    t_o = np.array([[aux[y][x]["t"] for x in range(W)] for y in range(H)])
    min_o = np.array([[aux[y][x]["min_d"] for x in range(W)]
                      for y in range(H)])
    assert hit_o.mean() > 0.25, "oracle sees the torus blob"

    flips = hit_j != hit_o
    assert flips.mean() < 0.02, f"{flips.mean():.4f} hit flips"
    if flips.any():
        assert np.abs(min_o[flips] - EPS).max() < 5e-3
    both = hit_j & hit_o
    dt = np.abs(t_j - t_o)
    divergent = both & (dt > 3 * EPS)
    assert divergent.mean() < 0.02, f"{divergent.mean():.4f} divergent"
    agree = both & ~divergent
    assert dt[agree].max() < 3 * EPS

    occ_flip = np.zeros((H, W), bool)
    for i in range(fscene.num_lights):
        occ_o = np.array([[bool(aux[y][x]["occluded"][i])
                           if len(aux[y][x]["occluded"]) > i else False
                           for x in range(W)] for y in range(H)])
        smin_o = np.array([[aux[y][x]["shadow_min_d"][i]
                            if len(aux[y][x]["shadow_min_d"]) > i
                            else np.inf
                            for x in range(W)] for y in range(H)])
        f = agree & (occ_j[i] != occ_o)
        occ_flip |= f
        marched = f & np.isfinite(smin_o)
        if marched.any():
            assert np.abs(smin_o[marched] - EPS).max() < 5e-3
    assert occ_flip.mean() < 0.03

    diff = np.abs(img - want).max(axis=-1)
    clean = (~flips) & (~occ_flip) & ~divergent \
        & ((~both) | (dt <= 2e-6 * (1 + t_o)))
    assert clean.mean() > 0.6, f"only {clean.mean():.2f} clean pixels"
    assert diff[clean].max() < 1e-4, f"clean-pixel error {diff[clean].max()}"
    shell = agree & (~flips) & (~occ_flip) & ~clean
    if shell.any():
        assert np.percentile(diff[shell], 99) < 3e-2
    assert float(np.median(diff)) < 1e-5


def _jax_modules():
    from fraytracer_tpu.scene import generators as JG, nodes as JN
    return JN, JG


def test_cuda_backend_refuses_cull_and_missing_gpu(tmp_path):
    _js, ts = scene_pair("torus16")
    cam = tft.look_at(CAM, (0, 0, 0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tft.render(ts, cam, tft.RenderConfig(
            width=8, height=8, march=TMC(backend="cuda")))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises((RuntimeError, AssertionError)):
        tft.flatten(TG.torus_csg_scene(19, 4), device="cuda")
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
