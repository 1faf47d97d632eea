"""Port parity, ``fraytracer_tpu_torch/utils/profiling.py`` (counterparts
of ``tests/test_profiling.py``): the march report against the JAX
package's on the same rays (equal but for the wall time), the stopwatch
line, and a profiler trace written."""
import json
import os

import jax
import numpy as np
import pytest

import fraytracer_tpu as jft
import fraytracer_tpu_torch as tft
from fraytracer_tpu.ops.march import MarchConfig as JMC
from fraytracer_tpu.utils.profiling import march_stats as jmarch_stats
from fraytracer_tpu_torch.utils.profiling import (HIST_EDGES, RenderStats,
                                                  march_stats, stopwatch,
                                                  trace)


def rays_of(ft, device=None):
    kw = {} if device is None else {"device": device}
    cam = ft.look_at((0, 0, -5), (0, 0, 0), **kw)
    return ft.camera_rays(cam, 16, 16, 0.01, 20.0)


def test_march_stats_report():
    scene = tft.flatten(tft.Scene(root=tft.sphere((0, 0, 0), 1.0)),
                        device="cpu")
    flat = rays_of(tft, "cpu").map(lambda x: x.reshape((-1,)
                                                       + x.shape[2:]))
    stats = march_stats(scene, flat, tft.MarchConfig(max_steps=64),
                        repeats=1)
    assert stats.n_rays == 256
    assert 0.0 < stats.hit_fraction < 1.0
    assert stats.steps_max <= 64
    assert stats.rays_per_sec > 0
    report = json.loads(stats.to_json())
    assert set(report) == {f.name for f in
                           RenderStats.__dataclass_fields__.values()}
    assert sum(report["steps_histogram"].values()) == 256


@pytest.mark.parametrize("bound_skip", [True, False])
def test_march_stats_matches_jax(bound_skip):
    """Each route against its JAX counterpart on the same rays — "torch"
    against "jnp" (a lane's steps run to the batch's last), "cuda" against
    "pallas_interpret" (a lane's own) — gives the same report but for the
    wall time."""
    jscene = jft.flatten(jft.Scene(root=jft.sphere((0, 0, 0), 1.0)))
    jflat = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]),
                         rays_of(jft))
    scene = tft.flatten(tft.Scene(root=tft.sphere((0, 0, 0), 1.0)),
                        device="cpu")
    flat = rays_of(tft, "cpu").map(lambda x: x.reshape((-1,)
                                                       + x.shape[2:]))
    for route, jroute in (("torch", "jnp"), ("cuda", "pallas_interpret")):
        want = jmarch_stats(jscene, jflat, JMC(max_steps=64, backend=jroute,
                                               bound_skip=bound_skip),
                            repeats=1)
        got = march_stats(scene, flat, tft.MarchConfig(
            max_steps=64, backend=route, bound_skip=bound_skip), repeats=1)
        for f in ("n_rays", "hit_fraction", "steps_mean", "steps_max",
                  "steps_histogram"):
            assert getattr(got, f) == getattr(want, f), (route, f)
    assert HIST_EDGES == (0, 8, 16, 32, 64, 128, 256, 1 << 30)


def test_stopwatch_prints(capsys):
    with stopwatch("unit"):
        pass
    out = capsys.readouterr().out
    assert out.startswith("unit:") and "sec" in out


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "prof"
    with trace(str(log_dir)):
        tft.render(tft.flatten(tft.Scene(root=tft.sphere((0, 0, 0), 1.0)),
                               device="cpu"),
                   tft.look_at((0, 0, -5), (0, 0, 0), device="cpu"),
                   tft.RenderConfig(width=8, height=8))
    files = os.listdir(log_dir)
    assert files == [f"trace_{os.getpid()}.json"]
    events = json.loads((log_dir / files[0]).read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    with trace(None):      # no-op
        np.zeros(1)
