"""Port parity, W and P1–P4 (``ops/cuda/probe.py``): the plain versions
against the numpy oracles written in ``tools/probe_pallas_features.py``
and, through ``pl.pallas_call`` forced into interpret mode here in the
test, against the TPU probes' own kernels on their own inputs.

Exact for W, P1, P2 (one multiply); P3 within rtol 1e-6 (the oracle's own
bound); P4: the trip count and ``t > 9.9`` as the probe asserts, values
within 1e-5 (float32 sums of 0.01-steps).  Every tensor is on the CPU,
where the wrappers take their plain versions.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fraytracer_tpu_torch.ops.cuda import probe

G, M, P = probe.G, probe.M, probe.P
TOOL = Path(__file__).resolve().parents[1] / "tools" / \
    "probe_pallas_features.py"


@pytest.fixture(scope="module")
def inputs():
    return probe.probe_inputs("cpu")


def test_warm_is_times_two():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8, 128)).astype(np.float32))
    before = probe.LAUNCHES["warm"]
    np.testing.assert_array_equal(probe.warm(x).numpy(), x.numpy() * 2.0)
    assert probe.LAUNCHES["warm"] == before     # CPU: no kernel launched


def test_smem_block_oracles(inputs):
    """:54 and :77-78 of the TPU probe: out[0, 0] is the table's scalar."""
    cand = np.arange(G * M * P, dtype=np.float32).reshape(G, M, P)
    out = probe.smem_block(inputs["ones"], inputs["ramp3"]).numpy()
    np.testing.assert_allclose(out[0, 0], float(cand[0, 0, 3]))
    want = np.repeat(cand[:, 0, 3], 8)[:, None] * np.ones((G * 8, 128),
                                                          np.float32)
    np.testing.assert_array_equal(out, want)
    out2 = probe.smem_block_2d(inputs["ones"], inputs["ramp2"]).numpy()
    np.testing.assert_allclose(out2[0, 0], float(cand[0, 3, 1]))
    np.testing.assert_array_equal(
        out2, np.repeat(cand[:, 3, 1], 8)[:, None] * np.ones((G * 8, 128),
                                                             np.float32))


def dyn_loop_oracle(x, cand, keys):
    """The brute-force oracle of the TPU probe (:122-135)."""
    g = keys.shape[0]
    m = keys.shape[1]
    xo = x.reshape(g, 8, 128)
    co = cand.reshape(g, m, -1)
    ref = np.full((g, 8, 128), 1e30, np.float32)
    for i in range(g):
        rel = keys[i] < xo[i].max()
        if rel.any():
            lo, hi = np.argmax(rel), m - np.argmax(rel[::-1])
            for c in range(lo, hi):
                ref[i] = np.minimum(ref[i],
                                    np.abs(xo[i] - co[i, c, 0]) + co[i, c, 1])
    return ref.reshape(x.shape)


@pytest.mark.parametrize("table", ["smem", "ldg"])
def test_dyn_loop_oracle_on_probe_inputs(inputs, table):
    out = probe.dyn_loop(inputs["x3"], inputs["cand3"], inputs["keys3"],
                         table=table).numpy()
    ref = dyn_loop_oracle(inputs["x3"].numpy(), inputs["cand3"].numpy(),
                          inputs["keys3"].numpy())
    np.testing.assert_allclose(out, ref, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dyn_loop_oracle_on_random_windows(seed):
    """Windows that start late, end early, hold gaps, or are empty."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(G * 8, 128)).astype(np.float32)
    x[8:16] *= 0.0                      # tile 1: max 0 → an empty window
    cand = rng.normal(size=(G * M, P)).astype(np.float32)
    keys = rng.uniform(-0.5, 2.0, size=(G, M)).astype(np.float32)
    keys[1] = np.abs(keys[1]) + 0.1
    out = probe.dyn_loop(*(torch.from_numpy(a) for a in (x, cand, keys)))
    ref = dyn_loop_oracle(x, cand, keys)
    assert (ref[8:16] == np.float32(1e30)).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)


def test_while_loop_oracle(inputs):
    """:174 of the TPU probe (``out[0, 0] > 9.9``) and the loop by hand."""
    t, trips = probe.while_loop(inputs["zeros"], inputs["cand4"])
    assert float(t[0, 0]) > 9.9
    # 0.51 + 0.52 + 0.53 + 0.54·16 = 10.2 after 19 trips
    assert trips.tolist() == [19] * G
    np.testing.assert_allclose(t.numpy(), 10.2, atol=1e-5)
    # a tile that starts above the bound never steps; one at the cap
    x = inputs["zeros"].clone()
    x[0:8] = 11.0
    x[8:16] = -100.0
    t2, trips2 = probe.while_loop(x, inputs["cand4"])
    assert trips2.tolist() == [0, 50, 19, 19]
    np.testing.assert_array_equal(t2[0:8].numpy(), 11.0)


def test_wrappers_reject_bad_inputs(inputs):
    with pytest.raises(ValueError):
        probe.smem_block(inputs["ones"], inputs["ramp2"])
    with pytest.raises(ValueError):
        probe.dyn_loop(inputs["x3"], inputs["cand3"], inputs["keys3"],
                       table="l2")
    with pytest.raises(ValueError):
        probe.smem_block_2d(inputs["ones"][:7], inputs["ramp2"])
    with pytest.raises(ValueError):
        probe.while_loop(inputs["zeros"], inputs["cand4"][:-1])
    with pytest.raises(ValueError):
        probe.empty_launch("cpu")


def test_features_table_passes_on_plain_versions(inputs):
    """The probe program's own checks, on the plain versions."""
    for name, (kernel, plain, check) in probe.features(inputs).items():
        assert check(kernel(), plain()), name


# ---------------------------------------------------------------------------
# the TPU probes themselves, in interpret mode
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _tool():
    spec = importlib.util.spec_from_file_location("_probe_tool", TOOL)
    mod = importlib.util.module_from_spec(spec)
    # the tool points JAX's persistent compile cache at a fixed directory
    # when it is imported: put the test process's settings back
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in before.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture()
def jax_probe_outputs(monkeypatch):
    """Run one of the tool's probes with ``pl.pallas_call`` in interpret
    mode and return the arrays its kernel produced."""
    tool = _tool()
    real = pl.pallas_call
    seen = []

    def interpreted(*a, **kw):
        kw["interpret"] = True
        call = real(*a, **kw)

        def run(*args):
            out = call(*args)
            seen.append(np.asarray(out))
            return out
        return run

    monkeypatch.setattr(tool.pl, "pallas_call", interpreted)

    def run(name):
        seen.clear()
        getattr(tool, name)()        # asserts its own oracle
        return seen[-1]
    return run


def test_the_3d_tpu_probe_does_not_trace(jax_probe_outputs, inputs):
    """P1's TPU form reads its (1, M, P) block with two indices, which
    yields a [P] row and cannot multiply the tile: the probe reported FAIL
    and its successor (P2) folded the grid axis.  What it meant is its
    oracle line (:54), which the port's P1 is held to above."""
    with pytest.raises((ValueError, TypeError)):
        jax_probe_outputs("smem_block")


@pytest.mark.parametrize("name", ["smem_block_2d", "dyn_fori_scalar_loop",
                                  "while_with_inner_fori"])
def test_plain_versions_match_the_tpu_probes(jax_probe_outputs, inputs,
                                             name):
    want = jax_probe_outputs(name)
    if name == "smem_block_2d":
        got = probe.smem_block_2d(inputs["ones"], inputs["ramp2"])
        np.testing.assert_array_equal(got.numpy(), want)
    elif name == "dyn_fori_scalar_loop":
        got = probe.dyn_loop(inputs["x3"], inputs["cand3"], inputs["keys3"])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    else:
        got, trips = probe.while_loop(inputs["zeros"], inputs["cand4"])
        assert trips.tolist() == [19] * G
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_warm_matches_the_bench_kernel():
    """W against ``bench.py::_warm_kernel`` (the same two lines, run in
    interpret mode: importing ``bench.py`` would start a benchmark)."""
    def _warm_kernel(x_ref, o_ref):
        o_ref[:] = x_ref[:] * 2.0

    x = np.random.default_rng(1).normal(size=(8, 128)).astype(np.float32)
    want = pl.pallas_call(
        _warm_kernel, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True)(jnp.asarray(x))
    np.testing.assert_array_equal(probe.warm(torch.from_numpy(x)).numpy(),
                                  np.asarray(want))
