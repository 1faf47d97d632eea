"""The table build's host side (``ops/cuda/cull_kernel.py``) on the CPU:
CPU tensors take the plain build and launch nothing; the kernels' wrapper
refuses what they do not take, with a clear error, before any launch; a
select block's buffers and path come from shapes alone; the cones buffer
reads back as the plain build's ``TileCones``.  No kernel runs here
(``tests/test_torch_cull_cuda.py`` holds them to the plain build on the
card)."""
import re
from pathlib import Path

import pytest
import torch

import fraytracer_tpu_torch as ft
from fraytracer_tpu_torch.ops import cuda as ops_cuda
from fraytracer_tpu_torch.ops.cuda import cull, cull_kernel as ck
from fraytracer_tpu_torch.ops.march import bound_skip_start
from fraytracer_tpu_torch.render import _to_blocks
from fraytracer_tpu_torch.scene.generators import torus_csg_scene

SOURCE = (Path(ck.__file__).resolve().parents[2] / "csrc"
          / "cull.cu").read_text()


@pytest.fixture(scope="module")
def case():
    """96 tori, 64² camera rays in block order (4 tiles) with the
    root-bound range, the scene's culled pair."""
    scene = ft.flatten(torus_csg_scene(19, 96), device="cpu")
    cam = ft.look_at((0, 0, -10), (0, 0, 0), device="cpu")
    rays = ft.camera_rays(cam, 64, 64, 0.01, 30.0).map(
        lambda x: _to_blocks(x, 64, 64, 32).contiguous())
    t0, miss0, t_exit = bound_skip_start(scene, rays)
    length = torch.where(miss0, 0.0, torch.minimum(rays.length, t_exit))
    lanes = (rays.origin, rays.direction, t0, length.contiguous(),
             rays.epsilon)
    pairs = cull._cull_pairs(scene.kind_counts, scene.plan, 48)
    return scene, lanes, pairs


@pytest.mark.parametrize("cull_m", [16, 256])
def test_cpu_tensors_take_the_plain_build(case, cull_m):
    """``build_pair_tables`` on CPU tensors is the plain build, field for
    field, and launches no kernel."""
    scene, lanes, pairs = case
    ops_cuda.reset_launch_counts()
    got = cull.build_pair_tables(scene, *lanes, pairs, cull_m, 0.125)
    want = cull.build_pair_tables_plain(scene, *lanes, pairs, cull_m, 0.125)
    assert not any(ops_cuda.launch_counts().values())
    assert got.pairs == want.pairs
    for f in ("oa", "ca"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert (got.overflow is None) == (cull_m >= 96)
    if got.overflow is not None:
        assert torch.equal(got.overflow, want.overflow)
    for q, w in zip(got.tables, want.tables):
        for f in ("idx", "count", "table", "keys", "misc", "hsuf"):
            assert torch.equal(getattr(q, f), getattr(w, f)), f


def test_other_devices_are_refused(case):
    scene, lanes, pairs = case
    meta = tuple(x.to("meta") for x in lanes)
    with pytest.raises(ValueError, match="unsupported device"):
        cull.build_pair_tables(scene, *meta, pairs, 256, 0.125)


def _bad(kind, lanes, pairs):
    o, d, t0, ln, e = lanes
    if kind == "dtype":
        return (o.double(), d, t0, ln, e), pairs, TypeError, "float32"
    if kind == "contiguity":
        dt = torch.stack([d[:, 0], d[:, 1], d[:, 2]], 1).t().contiguous().t()
        return (o, dt, t0, ln, e), pairs, ValueError, "contiguous"
    if kind == "shape":
        return (o, d, t0, ln[:-1], e), pairs, ValueError, "shape"
    if kind == "pairs":
        return lanes, pairs * (cull.MAX_PAIRS + 1), NotImplementedError, \
            "culled pairs"
    if kind == "group":
        gid, kname, ki, lo, _hi = pairs[0]
        return lanes, ((gid, kname, ki, lo, lo + ck.MAX_GROUP),), \
            NotImplementedError, "members"
    assert kind == "device"
    return lanes, pairs, ValueError, "not a CUDA device"


@pytest.mark.parametrize("kind", ["dtype", "contiguity", "shape", "pairs",
                                  "group", "device"])
def test_kernel_wrapper_refuses_what_it_does_not_take(case, kind):
    """The wrapper raises before any launch: lanes that are not float32,
    contiguous and of the batch's shape, more than MAX_PAIRS pairs, a
    group beyond every path, lanes off a CUDA device."""
    scene, lanes, pairs = case
    bad, bad_pairs, exc, text = _bad(kind, lanes, pairs)
    ops_cuda.reset_launch_counts()
    with pytest.raises(exc, match=text):
        ck.build_tables(scene, *bad, bad_pairs, 256, 0.125)
    assert not any(ops_cuda.launch_counts().values())


@pytest.mark.parametrize("g,m,path", [
    (96, 96, "shared"), (1000, 256, "shared"), (1000, 1000, "shared"),
    (10_000, 768, "shared"), (16_384, 16_384, "shared"),
    (16_385, 256, "large"), (1 << 20, 256, "large")])
def test_select_path_from_shapes(g, m, path):
    """Shared memory while a block's buffers fit beside its own (the
    benchmark's groups, the 10,000-torus pair), device memory past that."""
    assert ck.select_path(g, m) == path
    fits = 4 * ck.select_words(g, m) + ck.SELECT_STATIC <= cull.SMEM_LIMIT
    assert fits == (path == "shared")


def test_select_path_refuses_a_group_beyond_every_path():
    with pytest.raises(NotImplementedError, match="members"):
        ck.select_path(ck.MAX_GROUP, 256)


@pytest.mark.parametrize("g,m,words", [
    (1, 8, 1 * 2 + 2 + 1), (96, 96, 128 * 2 + 3 * 2 + 12),
    (1000, 256, 1024 * 2 + 32 * 2 + 32), (1024, 1024, 1024 * 2 + 64 + 128)])
def test_select_words(g, m, words):
    """Sort keys and rows (the next power of two of the group each), the
    ballot words and their prefix, a float a chunk."""
    assert ck.select_words(g, m) == words


def test_cones_buffer_reads_as_tile_cones(case):
    """A buffer packed from the plain cones (the kernel's field order, the
    tile first, then its sub-tiles) reads back as those cones."""
    _scene, lanes, _pairs = case
    tile, sub, _o, _d = cull.lane_cones(*lanes)
    grid = tile.apex.shape[0]

    def pack(c):
        cols = [c.apex, c.axis] + [getattr(c, f)[:, None].float()
                                   for f in cull.TileCones._fields[2:]]
        return torch.nn.functional.pad(torch.cat(cols, 1), (0, 1))
    buf = torch.cat([pack(tile)[:, None], pack(sub).reshape(grid, cull.SUBF,
                                                            -1)], 1)
    assert buf.shape == (grid, ck.CONES, ck.CONE_W)
    for want, got in zip((tile, sub), ck.cones_of(buf)):
        for f in cull.TileCones._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_kernel_field_order_is_tile_cones():
    """The cone fields of ``csrc/cull.cu`` (enum C_*) in TileCones' order,
    vectors three floats wide."""
    body = re.search(r"enum \{\s*(C_APEX.*?)\};", SOURCE, re.S).group(1)
    names = [re.sub(r"\s*=.*", "", x).strip() for x in body.split(",")]
    fields = cull.TileCones._fields
    short = {"any_active": "any", "o_off_lo": "off_lo", "o_off_hi": "off_hi"}
    assert [n.lower() for n in names] == \
        ["c_" + short.get(f, f) for f in fields]
    assert re.search(r"C_AXIS = 3, C_COS_HALF = 6", SOURCE)
    assert 6 + len(fields) - 2 < ck.CONE_W
