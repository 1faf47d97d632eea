"""Port parity, the 10,000-torus benchmark (``fraytracer_tpu_torch/
bench_10k.py``, counterpart of ``tools/bench_10k.py``) on the CPU: its
smoke line, and the table sizing — the largest candidate count of a tile
of the primary march and of the shadow marches — against the same counts
from the JAX package's host prep (``_tile_cones``, ``_cand_mask``,
``_cone_candidates``) at 64² / 200 tori: equal."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

import fraytracer_tpu as jft
from fraytracer_tpu import camera as jcam
from fraytracer_tpu.ops import sdf as jsdf
from fraytracer_tpu.ops.march import MarchConfig as JMC
from fraytracer_tpu.ops.march import bound_skip_start, march_surface
from fraytracer_tpu.ops.pallas.march_kernel import (_cand_mask,
                                                    _cone_candidates,
                                                    _tile_cones, ray_tile)
from fraytracer_tpu.ops.shade import light_dir_and_dist
from fraytracer_tpu.render import _auto_block, _block_perm
from fraytracer_tpu.scene.generators import torus_csg_scene
from fraytracer_tpu.types import Rays
from fraytracer_tpu_torch import bench_10k

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, TORI = 64, 200


def jax_cand_count(scene, sh, apex):
    """``tools/bench_10k.py::cand_counts`` (:53-69), as the tool computes
    it (the tool itself reads its sizes from ``sys.argv`` at import)."""
    tile = ray_tile()
    grid = sh.origin.shape[0] // tile
    t0, miss0, t_exit = bound_skip_start(scene, sh)
    length = jnp.where(miss0, 0.0, jnp.minimum(sh.length, t_exit))
    thi = jnp.where(length > 0.0, length, t0)
    cones = _tile_cones(sh.origin, sh.direction, t0, thi, sh.epsilon,
                        grid, tile, conv_apex=apex)
    conesf = _tile_cones(sh.origin, sh.direction, t0, thi, sh.epsilon,
                         grid * 4, tile // 4, conv_apex=apex)
    kb = jsdf._prim_bound_rows("torus", scene.prim_params["torus"])
    cm = jnp.any(_cand_mask(kb, conesf, apex is not None)
                 .reshape(grid, 4, -1), axis=1)
    sel = _cone_candidates(kb, cones, 8, converging=apex is not None,
                           cand=cm)
    return int(jnp.max(sel.count))


def jax_sizes():
    """The tool's sizing (:96-117) on the CPU backend ("jnp")."""
    scene = jft.flatten(torus_csg_scene(seed=19, n_tori=TORI))
    camera = jft.look_at((0.0, 0.0, -10.0), (0.0, 0.0, 0.0),
                         fov_degrees=60.0)
    base = JMC(max_steps=192, bound_skip=True, backend="jnp",
               relax_omega=1.4)
    rays = jcam.camera_rays(camera, SIZE, SIZE, 0.01, 30.0)
    flat = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), rays)
    perm, _inv = _block_perm(SIZE, SIZE, _auto_block(SIZE, SIZE))
    flat = jax.tree.map(lambda x: x[perm], flat)
    c_prim = jax_cand_count(scene, flat, None)
    m_prim = bench_10k.round_up(int(c_prim * 1.3))
    res, nrm, _m = march_surface(scene, flat,
                                 dataclasses.replace(base, cull_m=m_prim))
    pos = flat.at(res.t - flat.epsilon)
    shadows = []
    for li in range(scene.num_lights):
        ldir, budget, _sc = light_dir_and_dist(scene, li, pos)
        facing = res.hit & (jnp.sum(nrm * ldir, axis=-1) > 0.0)
        sh = Rays(origin=pos, direction=ldir,
                  length=jnp.where(facing, budget, 0.0),
                  epsilon=flat.epsilon)
        apex = scene.light_vec[li] if scene.light_kind[li] == 1 else None
        shadows.append((jax.tree.map(np.asarray, sh),
                        None if apex is None else np.asarray(apex),
                        jax_cand_count(scene, sh, apex)))
    c_shadow = max(c for _sh, _a, c in shadows)
    return {"cand_max_primary": c_prim, "cull_m": m_prim,
            "cand_max_shadow": c_shadow,
            "cull_m_shadow": bench_10k.round_up(int(c_shadow * 1.3))}, \
        shadows


def test_table_sizing_matches_jax_host_prep():
    """The counts on the same rays are equal — the primary rays (the same
    camera in both packages) and JAX's own shadow rays, handed to the
    port — and the port's sizing from its own march gives JAX's table
    rows (its shadow rays start from its own hits, so a count may move by
    a candidate)."""
    import torch
    from fraytracer_tpu_torch.types import Rays as TRays
    scene, _camera, base, flat = bench_10k.setup(SIZE, TORI, "cpu")
    want, shadows = jax_sizes()
    assert bench_10k.cand_count(scene, flat) == want["cand_max_primary"]
    for sh, apex, count in shadows:
        rays = TRays(**{f: torch.from_numpy(np.array(getattr(sh, f)))
                        for f in ("origin", "direction", "length",
                                  "epsilon")})
        assert bench_10k.cand_count(
            scene, rays,
            None if apex is None else torch.tensor(apex)) == count
    got = bench_10k.table_sizes(scene, base, flat)
    assert (got["cull_m"], got["cull_m_shadow"]) \
        == (want["cull_m"], want["cull_m_shadow"])
    assert got["cand_max_primary"] == want["cand_max_primary"]
    assert abs(got["cand_max_shadow"] - want["cand_max_shadow"]) \
        <= 0.01 * want["cand_max_shadow"]
    assert want["cand_max_primary"] > 8 and want["cand_max_shadow"] > 8


def test_cpu_smoke_line():
    proc = subprocess.run(
        [sys.executable, "-m", "fraytracer_tpu_torch.bench_10k", str(SIZE),
         str(TORI), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line == {"tori10k_ok": True, "tori10k_backend": "cpu"}


def test_round_up_to_whole_chunks_of_128():
    assert [bench_10k.round_up(x) for x in (1, 128, 129, 4001)] \
        == [128, 128, 256, 4096]
    assert np.ceil(354 * 1.3 / 128) * 128 == bench_10k.round_up(
        int(354 * 1.3))
