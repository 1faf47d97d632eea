"""Port parity, SDF layer: ``fraytracer_tpu_torch.ops.sdf`` against
``fraytracer_tpu.ops.sdf`` on the same random points (mirrors
test_primitives, test_csg and test_bounds).

Tolerance atol 1e-5: float32 with a different operation order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fraytracer_tpu as jft
import fraytracer_tpu_torch as tft
from fraytracer_tpu.ops import sdf as jsdf
from fraytracer_tpu.scene import nodes as JN
from fraytracer_tpu_torch.ops import sdf as tsdf
from fraytracer_tpu_torch.scene import nodes as TN
from test_torch_scene import scene_pair

ATOL = 1e-5

PRIMS = [
    lambda N: N.sphere((0.3, -0.2, 0.5), 0.7),
    lambda N: N.capsule((-1, 0, 0), (1, 0.5, 0.3), 0.3),
    lambda N: N.torus((0.1, 0.2, -0.3), (1, 2, 0.5), 0.8, 0.2),
    lambda N: N.triangle((0, 0, 0), (1, 0.2, 0), (0.3, 1, 0.5), 0.15),
    lambda N: N.box((0.2, -0.1, 0.4), (0.5, 0.8, 0.3), 0.05),
    lambda N: N.cone((0, -1, 0), (0.2, 1, 0.1), 0.6, 0.2),
    lambda N: N.plane((0.3, 1, -0.2), 0.4),
]
KIND_NAMES = ["sphere", "capsule", "torus", "triangle", "box", "cone",
              "plane"]


def pair(build):
    """(JAX FlatScene, port FlatScene) of a root node built per package."""
    return (jft.flatten(jft.Scene(root=build(JN))),
            tft.flatten(tft.Scene(root=build(TN))))


def pts(rng, n=256, lo=-3.0, hi=3.0):
    return rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("build", PRIMS, ids=KIND_NAMES)
def test_prim_distance_parity(build, rng):
    js, ts = pair(build)
    p = pts(rng)
    want = np.asarray(jsdf.prim_distances(js, jnp.asarray(p)))
    got = tsdf.prim_distances(ts, torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # per-lane parameter rows [n, 1, P] give the same distances
    kind = ts.kind_counts[0][0]
    rows = ts.prim_params[kind].expand(len(p), -1)[:, None, :]
    per_lane = tsdf.DIST_FNS[kind](rows, torch.from_numpy(p))[:, 0]
    np.testing.assert_allclose(per_lane.numpy(), got[:, 0], atol=1e-6)


@pytest.mark.parametrize("name", ["torus96", "csg_demo", "all_kinds",
                                  "smooth_subtract"])
def test_scene_distance_normal_material_parity(name, rng):
    js, ts = scene_pair(name)
    p = pts(rng, 512, -4.0, 4.0)
    jp, tp = jnp.asarray(p), torch.from_numpy(p)
    np.testing.assert_allclose(tsdf.scene_distance(ts, tp).numpy(),
                               np.asarray(jsdf.scene_distance(js, jp)),
                               atol=ATOL)
    np.testing.assert_allclose(tsdf.scene_normal(ts, tp).numpy(),
                               np.asarray(jsdf.scene_normal(js, jp)),
                               atol=ATOL)
    m_t, a_t = tsdf.material_at(ts, tp)
    m_j, a_j = jsdf.material_at(js, jp)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))


@pytest.mark.parametrize("name", ["torus96", "csg_demo", "all_kinds"])
def test_winning_leaf_code_parity(name, rng):
    js, ts = scene_pair(name)
    p = pts(rng, 512, -4.0, 4.0)
    c_t = tsdf.winning_leaf_code(ts, torch.from_numpy(p)).numpy()
    c_j = np.asarray(jsdf.winning_leaf_code(js, jnp.asarray(p)))
    np.testing.assert_array_equal(c_t, c_j)
    assert np.all(np.abs(c_t) >= 1)


def test_csg_identities(rng):
    """union = min, intersect = max, subtract = max(a, -b) (SdfForm.fs)."""
    p = torch.from_numpy(pts(rng, 128))

    def dist(node):
        return tsdf.scene_distance(tft.flatten(tft.Scene(root=node)), p)
    A = tft.sphere((0, 0, 0), 1.0)
    B = tft.sphere((1.2, 0, 0), 0.8)
    C = tft.box((0, 1, 0), (0.5, 0.5, 0.5), 0.1)
    torch.testing.assert_close(
        dist(tft.union(A, B, C)),
        torch.minimum(dist(A), torch.minimum(dist(B), dist(C))))
    torch.testing.assert_close(
        dist(tft.intersect(A, B, C)),
        torch.maximum(dist(A), torch.maximum(dist(B), dist(C))))
    torch.testing.assert_close(dist(tft.subtract(A, B)),
                               torch.maximum(dist(A), -dist(B)))
    smooth = dist(tft.smooth_union(0.2, A, B, C))
    hard = torch.minimum(dist(A), torch.minimum(dist(B), dist(C)))
    assert bool((smooth <= hard + 1e-5).all())
    assert bool((smooth >= hard - 0.2 * np.log(3.0) - 1e-5).all())


@pytest.mark.parametrize("name", ["torus1000", "csg_demo", "all_kinds",
                                  "smooth_subtract"])
def test_bounds_parity(name):
    js, ts = scene_pair(name)
    np.testing.assert_allclose(tsdf.prim_bounds(ts).numpy(),
                               np.asarray(jsdf.prim_bounds(js)), atol=ATOL,
                               rtol=1e-6)
    np.testing.assert_allclose(tsdf.root_bound(ts).numpy(),
                               np.asarray(jsdf.root_bound(js)), atol=ATOL)


def test_bound_min_distance_is_lower_bound(rng):
    _js, ts = scene_pair("torus96")
    p = torch.from_numpy(pts(rng, 512, -8.0, 8.0))
    lb = tsdf.bound_min_distance(tsdf.root_bound(ts), p)
    assert bool((lb <= tsdf.scene_distance(ts, p) + 1e-5).all())


def test_procedural_albedo_not_ported():
    s = tft.flatten(tft.Scene(root=tft.sphere(
        (0, 0, 0), 1.0, material=tft.procedural((1, 0, 0), (0, 0, 1)))))
    with pytest.raises(NotImplementedError, match="noise"):
        tsdf.material_at(s, torch.zeros(4, 3))
