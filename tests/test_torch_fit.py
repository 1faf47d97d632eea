"""Port parity, the training entry points: scene checkpoints between the
two packages, the ``fit`` subcommand and the ``bench`` module.

* a checkpoint written by either package loads in the other with every
  leaf bit-equal and the static structure equal;
* ``fit`` at 24² for 8 steps descends the image L2 (its mid-run checkpoint
  round trip included) and reports JAX's fields;
* ``bench`` prints one JSON line per stage, each a superset of the last,
  with JAX's field names where they mean the same and none of its
  TPU-round fields.

Every call names ``--device cpu``.
"""
import json

import numpy as np
import pytest
import torch

import fraytracer_tpu as jft
import fraytracer_tpu_torch as tft
from fraytracer_tpu.scene import generators as JG, nodes as JN
from fraytracer_tpu.utils import checkpoint as jck
from fraytracer_tpu_torch import bench as tbench
from fraytracer_tpu_torch import cli as tcli
from fraytracer_tpu_torch.scene import generators as TG, nodes as TN
from fraytracer_tpu_torch.utils import checkpoint as tck
from test_torch_scene import SCENES, assert_scene_equal


@pytest.mark.parametrize("name", ["torus48", "all_kinds", "smooth_materials",
                                  "csg_demo"])
def test_checkpoint_written_by_jax_loads_in_the_port_and_back(name, tmp_path):
    js = jft.flatten(SCENES[name](JN, JG))
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    jck.save_scene(a, js)
    ts = tck.load_scene(a, device="cpu")
    assert_scene_equal(js, ts)
    assert all(v.device.type == "cpu" and v.dtype == torch.float32
               for v in ts.tensors().values())
    tck.save_scene(b, ts)
    back = jck.load_scene(b)
    assert_scene_equal(back, ts)
    assert back.plan == js.plan
    with np.load(a) as fa, np.load(b) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for k in fa.files:
            np.testing.assert_array_equal(fa[k], fb[k])


def test_checkpoint_of_a_scene_with_gradients(tmp_path):
    ts = tft.flatten(SCENES["torus16"](TN, TG),
                     device="cpu").requires_grad_(True)
    path = str(tmp_path / "g.npz")
    tck.save_scene(path, ts)
    back = tck.load_scene(path, device="cpu")
    assert not any(v.requires_grad for v in back.tensors().values())
    for k, v in ts.tensors().items():
        np.testing.assert_array_equal(back.tensors()[k].numpy(),
                                      v.detach().numpy())
    bad = dict(np.load(path))
    bad["__static__"] = np.frombuffer(
        json.dumps({"version": 2}).encode(), dtype=np.uint8)
    np.savez(str(tmp_path / "bad.npz"), **bad)
    with pytest.raises(ValueError):
        tck.load_scene(str(tmp_path / "bad.npz"), device="cpu")


def test_fit_descends_with_checkpoint_round_trip(tmp_path, capsys):
    report = tmp_path / "fit.json"
    ck = tmp_path / "mid.npz"
    rc = tcli.main(["fit", "--device", "cpu", "--size", "24", "--tori", "16",
                    "--steps", "8", "--max-steps", "96",
                    "--checkpoint", str(ck), "--out-report", str(report)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "checkpointed + resumed at step 4" in out
    r = json.loads(report.read_text())
    for field in ("backend", "size", "scene", "tori", "steps", "lr",
                  "perturb", "n_params", "loss_first", "loss_last",
                  "param_l1_before", "param_l1_after", "param_recovery",
                  "wall_s", "losses"):
        assert field in r, field
    assert r["backend"] == "cpu" and r["n_params"] == 2 * 4 + 16 * 8
    assert len(r["losses"]) == 8 and np.isfinite(r["losses"]).all()
    assert r["loss_last"] < r["loss_first"]
    assert r["param_l1_after"] < r["param_l1_before"]
    # the resumed scene is the one the second half descended from
    mid = tck.load_scene(str(ck), device="cpu")
    assert mid.kind_counts == (("sphere", 2), ("torus", 16))


def test_fit_perturbation_is_seeded():
    """The explicit generator makes two runs of ``fit`` identical."""
    def losses():
        import io
        from contextlib import redirect_stdout
        buf = io.StringIO()
        with redirect_stdout(buf):
            tcli.main(["fit", "--device", "cpu", "--size", "16", "--tori",
                       "8", "--steps", "2", "--max-steps", "64"])
        return [l for l in buf.getvalue().splitlines() if "loss" in l]
    assert losses() == losses()


JAX_NAMES = ("metric", "value", "unit", "image_size", "n_tori", "n_rays",
             "n_rays_primary", "rays_per_sec_primary_only", "fwd_time_s",
             "timing_method", "backend_warmup_s", "backend", "device")
TPU_ROUND = ("vs_baseline", "roofline", "compile_budget_s",
             "compile_budget_ok", "tpu_parity_ok", "compile_cache_hit")


def _bench_lines(capsys, *argv):
    assert tbench.main(["--device", "cpu", *argv]) == 0
    return [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]


def test_bench_forward_only_json_line(capsys):
    (line,) = _bench_lines(capsys, "--size", "32", "--tori", "16",
                           "--repeats", "1", "--no-bwd", "--no-spectral",
                           "--no-scaling")
    for k in JAX_NAMES:
        assert k in line, k
    assert not set(TPU_ROUND) & set(line)
    assert "fwd_bwd_time_s" not in line
    assert line["metric"] == "rays_per_sec_per_chip_fwd"
    assert line["unit"] == "rays/s" and line["device"] == "cpu"
    assert line["image_size"] == 32 and line["n_tori"] == 16
    assert line["n_rays_primary"] == 32 * 32 <= line["n_rays"] <= 3 * 32 * 32
    assert line["value"] == pytest.approx(line["n_rays"] / line["fwd_time_s"])
    assert line["fwd_time_s"] > 0 and line["backend_warmup_s"] >= 0


def test_bench_stages_are_supersets_and_report_the_backward(capsys):
    first, last = _bench_lines(capsys, "--size", "32", "--tori", "16",
                               "--repeats", "1", "--no-spectral",
                               "--no-scaling")
    assert set(first) < set(last)
    assert all(last[k] == v for k, v in first.items())
    for k in ("fwd_bwd_time_s", "fwd_bwd_over_fwd", "fwd_bwd_first_s",
              "grad_abs_sum_prim_params"):
        assert k in last, k
    assert last["fwd_bwd_over_fwd"] == pytest.approx(
        last["fwd_bwd_time_s"] / last["fwd_time_s"])
    assert np.isfinite(last["grad_abs_sum_prim_params"])
    assert last["grad_abs_sum_prim_params"] > 0


def test_bench_spectral_line_is_the_third_superset(capsys):
    """The spectral section (bench.py:329-370 of the JAX package): a third
    line holding every field of the second, the spectral frame's time,
    size and rays, no compile field and no target."""
    lines = _bench_lines(capsys, "--size", "16", "--tori", "16",
                         "--repeats", "1", "--no-scaling")
    assert len(lines) == 3
    fwd, bwd, spec = lines
    assert set(fwd) < set(bwd) < set(spec)
    assert all(spec[k] == v for k, v in bwd.items() if k != "kernel_launches")
    assert "spectral_time_s" not in bwd
    assert spec["spectral_size"] == 16
    assert spec["spectral_time_s"] > 0
    # primary rays, then bounce and shadow rays of 16² · 8 bins
    assert spec["spectral_rays_marched"] > 16 * 16
    assert spec["spectral_rays_per_sec"] == pytest.approx(
        spec["spectral_rays_marched"] / spec["spectral_time_s"])
    assert not {k for k in spec if "compile" in k} | (set(TPU_ROUND)
                                                       & set(spec))


def test_bench_scaling_line_names_what_ran(capsys):
    """The scaling section (bench.py:392-414 of the JAX package) as the
    last line: the sharded render's report merged under ``scaling_*`` keys
    (the headline fields untouched), naming ranks, backend and cards; on
    the CPU one gloo rank and no card.  No 10k line off the card."""
    lines = _bench_lines(capsys, "--size", "32", "--tori", "16",
                         "--repeats", "1", "--no-bwd", "--no-spectral")
    assert len(lines) == 2
    fwd, last = lines
    assert set(fwd) < set(last) and "tori_10k" not in last
    assert all(last[k] == v for k, v in fwd.items())
    added = set(last) - set(fwd)
    assert all(k.startswith("scaling_") for k in added)
    assert (last["scaling_ranks"], last["scaling_backend"],
            last["scaling_cards"]) == (1, "gloo", 0)
    assert (last["scaling_image_size"], last["scaling_n_tori"]) == (32, 16)
    assert last["scaling_max_abs_diff"] <= 1e-5
    assert last["scaling_sharding_overhead"] == pytest.approx(
        last["scaling_t_sharded_s"] / last["scaling_t_single_s"])
    assert "not multi-card scaling" in last["scaling_measures"]


def test_cli_bench_runs_the_module(capsys, monkeypatch):
    seen = []
    monkeypatch.setattr(tbench, "main", lambda argv: seen.append(argv) or 0)
    assert tcli.main(["bench", "--quick", "--no-bwd", "--device", "cpu"]) == 0
    assert tcli.main(["bench", "--no-spectral", "--device", "cpu"]) == 0
    assert seen == [["--device", "cpu", "--quick", "--no-bwd"],
                    ["--device", "cpu", "--no-spectral"]]


def test_cli_spectral_writes_the_image(tmp_path, capsys):
    """``cli spectral`` (the JAX command's arguments, cli.py:62-88): the
    glass demo scene through the wavefront, tone-mapped to a PNG."""
    import struct
    out = tmp_path / "s.png"
    assert tcli.main(["spectral", "--device", "cpu", "--scene", "glass",
                      "--size", "16", "--depth", "3", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "depth 3, 8 bins" in text and "Time = " in text
    assert f"Wrote {out}" in text
    png = out.read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert struct.unpack(">II", png[16:24]) == (16, 16)


def test_entry_points_need_a_card_unless_told(monkeypatch):
    """The defaults are the card: without one, ``fit`` and ``bench`` stop
    with a message instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(["fit", "--size", "16", "--steps", "1"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        tbench.main(["--quick"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(["spectral", "--size", "16"])
