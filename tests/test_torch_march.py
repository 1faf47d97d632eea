"""Port parity, K1/K2 (march / occlusion): the "cuda" backend on CPU tensors
(the kernels' plain version ``march_plain`` behind the same host glue)
against the JAX kernel in interpret mode with ``cull=False``, and the
"torch" backend against JAX "jnp".

Tolerance: hit masks equal on ≥ 99.5% of lanes, every flipped lane grazing
(JAX's final |d| within 1e-3 of ε), t within 1e-4 on lanes both hit.  The
two frameworks order float32 operations differently over up to 192 steps;
the 2e-6 JAX-vs-JAX bound assumes one framework."""
import dataclasses

import numpy as np
import pytest
import torch

import fraytracer_tpu_torch as tft
from fraytracer_tpu.ops.march import MarchConfig as JMC
from fraytracer_tpu.ops.march import march as jmarch
from fraytracer_tpu.ops.march import march_occlusion as jocclusion
from fraytracer_tpu_torch.ops.march import MarchConfig as TMC
from fraytracer_tpu_torch.ops.march import march as tmarch
from fraytracer_tpu_torch.ops.march import march_occlusion as tocclusion
from test_torch_scene import flat_camera_rays, scene_pair

PAL = JMC(backend="pallas_interpret", cull=False, max_steps=128)
CUDA = TMC(backend="cuda", cull=False, max_steps=128)


def assert_march_close(j, t, eps):
    hj, ht = np.asarray(j.hit), t.hit.numpy()
    flips = hj != ht
    assert flips.mean() <= 0.005, f"{flips.sum()} hit flips"
    if flips.any():
        dj = np.abs(np.asarray(j.distance)[flips])
        assert np.abs(dj - eps).max() < 1e-3, "a non-grazing hit flip"
    both = hj & ht
    if both.any():
        np.testing.assert_allclose(t.t.numpy()[both], np.asarray(j.t)[both],
                                   atol=1e-4)


CASES = {
    "torus48_32px": ("torus48", dict(w=32, h=32)),
    "all_kinds": ("all_kinds", dict(w=32, h=32, length=40.0)),
    "smooth_subtract": ("smooth_subtract", dict(w=24, h=24)),
    "nonmultiple_330": ("torus16", dict(w=30, h=11)),
}


@pytest.mark.parametrize("omega", [1.0, 1.4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_backend_matches_pallas(case, omega):
    name, kw = CASES[case]
    js, ts = scene_pair(name)
    jr, tr = flat_camera_rays(**kw)
    j = jmarch(js, jr, dataclasses.replace(PAL, relax_omega=omega))
    t = tmarch(ts, tr, dataclasses.replace(CUDA, relax_omega=omega))
    assert np.asarray(j.hit).any()
    assert_march_close(j, t, 0.01)
    # per-lane evaluation counts follow the same stepping
    np.testing.assert_array_equal(t.steps.numpy(), np.asarray(j.steps))


@pytest.mark.parametrize("name,kw", [("torus48", dict(w=32, h=32)),
                                     ("all_kinds",
                                      dict(w=24, h=24, length=40.0))])
def test_torch_backend_matches_jnp(name, kw):
    js, ts = scene_pair(name)
    jr, tr = flat_camera_rays(**kw)
    j = jmarch(js, jr, JMC(backend="jnp", max_steps=128))
    t = tmarch(ts, tr, TMC(backend="torch", max_steps=128,
                           relax_omega=1.4))   # ignored, as by "jnp"
    assert_march_close(j, t, 0.01)
    assert int(t.steps[0]) == int(np.asarray(j.steps)[0])


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_budget_and_miss(backend):
    _js, ts = scene_pair("sphere")
    origins = np.array([[0, 0, -5.0]] * 4, np.float32)
    dirs = np.array([[0, 0, 1.0], [0, 1, 0], [0, 0, 1.0], [0, 0, -1.0]],
                    np.float32)
    lengths = np.array([100.0, 100.0, 3.0, 100.0], np.float32)
    rays = tft.make_rays(origins, dirs, lengths, 1e-3)
    r = tmarch(ts, rays, dataclasses.replace(CUDA, backend=backend))
    assert r.hit.tolist() == [True, False, False, False]
    assert abs(float(r.t[0]) - 4.0) < 2e-3


@pytest.mark.parametrize("omega", [1.0, 1.4])
def test_occlusion_equals_march_hits(omega):
    js, ts = scene_pair("torus48")
    jr, tr = flat_camera_rays(24, 24)
    cfg = dataclasses.replace(CUDA, relax_omega=omega)
    np.testing.assert_array_equal(tocclusion(ts, tr, cfg).numpy(),
                                  tmarch(ts, tr, cfg).hit.numpy())
    j = jocclusion(js, jr, dataclasses.replace(PAL, relax_omega=omega))
    hj = np.asarray(j)
    assert (hj != tocclusion(ts, tr, cfg).numpy()).mean() <= 0.005


def test_march_batch_shape_kept():
    _js, ts = scene_pair("torus16")
    cam = tft.look_at((0, 0, -10), (0, 0, 0))
    rays = tft.camera_rays(cam, 12, 8, 0.01, 30.0)
    r = tmarch(ts, rays, CUDA)
    assert r.hit.shape == (8, 12) and r.t.shape == (8, 12)
    assert r.steps.dtype == torch.int32


def test_cuda_backend_rejects_unported_options():
    _js, ts = scene_pair("sphere")
    _jr, tr = flat_camera_rays(8, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmarch(ts, tr, TMC(backend="cuda"))               # cull=True
    for knob in ("shadow_compact", "shadow_block_sort", "shadow_axial_sort",
                 "shadow_block_compact", "debug_window_stats"):
        with pytest.raises(NotImplementedError):
            tmarch(ts, tr, dataclasses.replace(CUDA, **{knob: True}))
    with pytest.raises(NotImplementedError):
        tmarch(ts, tr, dataclasses.replace(CUDA, step_unroll=2))
    with pytest.raises(NotImplementedError, match="sign"):
        tmarch(ts, tr, CUDA, sign=torch.ones(64))
    with pytest.raises(ValueError):
        tmarch(ts, tr, TMC(backend="pallas"))


def test_march_config_mirrors_jax_defaults():
    jf = {f.name: f.default for f in dataclasses.fields(JMC)}
    tf = {f.name: f.default for f in dataclasses.fields(TMC)}
    assert set(jf) == set(tf)
    for name, default in jf.items():
        if name != "backend":
            assert tf[name] == default, name
    assert (jf["backend"], tf["backend"]) == ("jnp", "torch")
