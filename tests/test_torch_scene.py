"""Port parity, scene layer: ``fraytracer_tpu_torch`` flatten / camera /
import hygiene against the JAX package on the same inputs.

The scene builders here are shared by the other ``test_torch_*`` files:
each builds one scene with a given package's ``nodes``/``generators``
modules, so both packages get equal scenes from their own classes."""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import fraytracer_tpu as jft
import fraytracer_tpu_torch as tft
from fraytracer_tpu.scene import generators as JG, nodes as JN
from fraytracer_tpu_torch.scene import generators as TG, nodes as TN
from fraytracer_tpu_torch.scene.flatten import from_jax_arrays


def all_kinds(N, G):
    """One scene with every primitive kind (tests/test_pallas_march.py)."""
    return N.Scene(root=N.union(
        N.sphere((0, 0, 0), 0.8, material=N.solid(1, 0, 0)),
        N.capsule((-2, -1, 0), (-2, 1, 0), 0.3),
        N.torus((2, 0, 0), (0, 1, 0.3), 0.7, 0.2),
        N.triangle((-1, 1.5, 0), (1, 1.5, 0), (0, 2.5, 0.5), 0.1),
        N.box((0, -2, 0), (0.6, 0.4, 0.5), 0.05),
        N.cone((2, -2.5, 0), (2, -1, 0), 0.6, 0.1),
        N.plane((0, 1, 0), -3.5),
    ), lights=(N.directional_light((-0.4, -1.0, 0.6), (0.7, 0.7, 0.65)),))


def smooth_subtract(N, G):
    """Smooth union under intersect and subtract
    (tests/test_pallas_march.py::test_parity_smooth_union_and_subtract)."""
    return N.Scene(root=N.subtract(
        N.intersect(
            N.smooth_union(0.3, N.sphere((0, 0, 0), 1.0),
                           N.sphere((0.8, 0.3, 0), 0.7)),
            N.sphere((0, 0, 0), 1.5),
        ),
        N.box((0.3, 0.5, -0.7), (0.4, 0.4, 0.4), 0.05),
    ))


def single_sphere(N, G):
    return N.Scene(root=N.sphere((0, 0, 0), 1.0))


SCENES = {
    "torus1000": lambda N, G: G.torus_csg_scene(seed=19, n_tori=1000),
    "torus96": lambda N, G: G.torus_csg_scene(seed=19, n_tori=96),
    "torus48": lambda N, G: G.torus_csg_scene(seed=19, n_tori=48),
    "torus16": lambda N, G: G.torus_csg_scene(seed=19, n_tori=16),
    "csg_demo": lambda N, G: G.csg_demo_scene(),
    "all_kinds": all_kinds,
    "smooth_subtract": smooth_subtract,
    "sphere": single_sphere,
}


def scene_pair(name):
    """(JAX FlatScene, port FlatScene) of one named scene."""
    build = SCENES[name]
    return jft.flatten(build(JN, JG)), tft.flatten(build(TN, TG))


def flat_camera_rays(w, h, eps=0.01, length=30.0, pos=(0, 0, -10)):
    """JAX flat camera rays and the same rays as port ``Rays``."""
    cam = jft.look_at(pos, (0, 0, 0))
    jr = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]),
                      jft.camera_rays(cam, w, h, eps, length))
    return jr, to_port_rays(jr)


def to_port_rays(jr):
    return tft.Rays(*(torch.from_numpy(np.array(x, np.float32))
                      for x in (jr.origin, jr.direction, jr.length,
                                jr.epsilon)))


def plan_tuple(p):
    return (p.op, tuple(p.prim_slots), tuple(plan_tuple(c) for c in
                                             p.children), float(p.k))


ARRAYS = ("mat_albedo", "mat_emission", "mat_reflectivity", "mat_ior",
          "mat_tint", "light_vec", "light_color", "light_shadow_len",
          "background")


def assert_scene_equal(js, ts):
    assert plan_tuple(js.plan) == plan_tuple(ts.plan)
    assert tuple(js.kind_counts) == tuple(ts.kind_counts)
    assert tuple(js.prim_material) == tuple(ts.prim_material)
    assert tuple(js.mat_kind) == tuple(ts.mat_kind)
    assert tuple(js.light_kind) == tuple(ts.light_kind)
    assert js.visible_material() == ts.visible_material()
    assert set(js.prim_params) == set(ts.prim_params)
    for k in js.prim_params:
        np.testing.assert_array_equal(np.asarray(js.prim_params[k]),
                                      ts.prim_params[k].numpy())
    for f in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(ts, f).numpy())


@pytest.mark.parametrize("name", ["torus1000", "csg_demo", "all_kinds",
                                  "smooth_subtract"])
def test_flatten_parity(name):
    js, ts = scene_pair(name)
    assert_scene_equal(js, ts)


@pytest.mark.parametrize("name", ["torus1000", "all_kinds"])
def test_from_jax_arrays_equals_flatten(name):
    js, ts = scene_pair(name)
    rebuilt = from_jax_arrays(
        {k: np.asarray(v) for k, v in js.prim_params.items()},
        plan=js.plan, kind_counts=js.kind_counts,
        prim_material=js.prim_material, mat_kind=js.mat_kind,
        light_kind=js.light_kind,
        **{f: np.asarray(getattr(js, f)) for f in ARRAYS})
    assert rebuilt.plan == ts.plan
    assert_scene_equal(js, rebuilt)
    with pytest.raises(ValueError):
        from_jax_arrays({}, plan=js.plan, kind_counts=(), prim_material=(),
                        mat_kind=(), light_kind=())


@pytest.mark.parametrize("w,h,ortho", [(32, 32, 0.0), (40, 24, 0.0),
                                       (24, 16, 2.5)])
def test_camera_rays_parity(w, h, ortho):
    jc = jft.look_at((1.0, 2.0, -7.0), (0.2, 0.1, 0.0), fov_degrees=55.0,
                     ortho_scale=ortho)
    tc = tft.look_at((1.0, 2.0, -7.0), (0.2, 0.1, 0.0), fov_degrees=55.0,
                     ortho_scale=ortho)
    jr = jft.camera_rays(jc, w, h, 0.01, 30.0)
    tr = tft.camera_rays(tc, w, h, 0.01, 30.0)
    for f in ("origin", "direction", "length", "epsilon"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)), atol=1e-6)


def test_flatten_rejects_foreign_nodes():
    with pytest.raises(TypeError):
        tft.flatten(JG.csg_demo_scene())


def test_import_leaves_jax_out():
    code = ("import sys\n"
            "import fraytracer_tpu_torch, fraytracer_tpu_torch.cli\n"
            "import fraytracer_tpu_torch.ops.cuda.build\n"
            "import fraytracer_tpu_torch.ops.cuda.march_kernel\n"
            "import fraytracer_tpu_torch.ops.cuda.gather\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'fraytracer_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])
