"""Port parity, ``fraytracer_tpu_torch/utils/debug.py`` (counterparts of
``tests/test_debug.py``): ``validate_scene`` gives the JAX package's
problem list on the same bad scenes, ``nan_guard`` raises at a NaN made in
the forward and in the backward and is silent outside its scope, and the
benchmark scene renders finite."""
import numpy as np
import pytest
import torch

import fraytracer_tpu as jft
import fraytracer_tpu_torch as tft
from fraytracer_tpu.scene import generators as JG
from fraytracer_tpu.utils.debug import validate_scene as jvalidate
from fraytracer_tpu_torch.scene import generators as TG
from fraytracer_tpu_torch.utils.debug import nan_guard, validate_scene


def sphere(N):
    return N.Scene(root=N.sphere((0, 0, 0), 1.0),
                   lights=[N.directional_light((0, -1, 0), (1, 1, 1))])


def torus(N):
    return N.Scene(root=N.torus((0, 0, 0), (0, 1, 0), 1.0, 0.25))


def edit(scene, field, index, value):
    """A copy of a flattened scene (either package) with one entry of a
    field (``prim_params/<kind>`` or a material or light field) set."""
    if isinstance(scene, tft.FlatScene):
        leaves = {k: v.clone() for k, v in scene.tensors().items()}
        leaves[field][index] = value
        return scene.with_tensors(leaves)
    if field.startswith("prim_params/"):
        kind = field.split("/")[1]
        pp = dict(scene.prim_params)
        pp[kind] = pp[kind].at[index].set(value)
        return scene.replace(prim_params=pp)
    return scene.replace(**{field: getattr(scene, field).at[index]
                            .set(value)})


BAD = {
    "radius": (sphere, "prim_params/sphere", (0, 3), -1.0),
    "nonfinite_param": (sphere, "prim_params/sphere", (0, 1), np.inf),
    "nonfinite_albedo": (sphere, "mat_albedo", (0, 0), np.nan),
    "degenerate_axis": (torus, "prim_params/torus", (0, slice(3, 6)), 0.0),
    "torus_radius": (torus, "prim_params/torus", (0, 7), 0.0),
    "light": (sphere, "light_color", (0, 1), np.nan),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_problem_list_matches_jax(case):
    build, field, index, value = BAD[case]
    want = jvalidate(edit(jft.flatten(build(jft)), field, index, value))
    got = validate_scene(edit(tft.flatten(build(tft), device="cpu"), field,
                              index, value))
    assert got == want and got


def test_valid_scene_passes():
    assert validate_scene(tft.flatten(TG.torus_csg_scene(19, 16),
                                      device="cpu")) == []
    assert jvalidate(jft.flatten(JG.torus_csg_scene(19, 16))) == []


def test_out_of_range_material_index():
    scene = tft.flatten(sphere(tft), device="cpu")
    bad = tft.FlatScene(**{**scene.__dict__, "prim_material": (5,)})
    assert validate_scene(bad) == ["primitive material index 5 out of range"]


def test_nan_guard_raises_in_the_forward():
    with pytest.raises(FloatingPointError, match="log"):
        with nan_guard():
            torch.log(torch.tensor([-1.0]))


def test_nan_guard_raises_in_the_backward():
    x = torch.zeros(3, requires_grad=True)
    with nan_guard():
        y = (torch.sqrt(x) * 0.0).sum()     # finite: 0
        assert float(y) == 0.0
        with pytest.raises(FloatingPointError):
            y.backward()                     # 0 · 1/(2·sqrt(0)) = NaN


def test_nan_guard_is_silent_outside_its_scope():
    with nan_guard():
        torch.ones(2).sum()
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()
    x = torch.zeros(3, requires_grad=True)
    (torch.sqrt(x) * 0.0).sum().backward()
    assert torch.isnan(x.grad).all()


def test_render_produces_no_nans_under_the_guard():
    """A render and its backward on the benchmark scene make no NaN in any
    operator (inactive-lane masking never leaks one)."""
    scene = tft.flatten(TG.torus_csg_scene(19, 48), device="cpu")
    cam = tft.look_at((0, 0, -10), (0, 0, 0), device="cpu")
    cfg = tft.RenderConfig(width=32, height=32,
                           march=tft.MarchConfig(backend="cuda"))
    scene.requires_grad_(True)
    with nan_guard():
        img = tft.render(scene, cam, cfg)
        (img ** 2).sum().backward()
    assert torch.isfinite(img).all()
    assert all(torch.isfinite(x.grad).all()
               for x in scene.tensors().values() if x.grad is not None)
