"""Every call the benchmark makes into the program under test,
``fraytracer_tpu_torch`` (the PyTorch and CUDA port), and nothing else:
the scene through the port's public node API and ``flatten``, the camera
and configs, the timed entries, the graph counters and the leaves of a
scene.  The port is imported from the checkout this file lies in, never
from an installed copy.
"""
from __future__ import annotations

import importlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "fraytracer_tpu_torch"


def port():
    """The port's package, from this checkout (``ImportError`` where the
    checkout does not hold it)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    ft = importlib.import_module(PACKAGE)
    where = Path(ft.__file__).resolve()
    if ROOT not in where.parents:
        raise ImportError(f"{PACKAGE} was found at {where}, outside the "
                          f"checkout {ROOT}")
    return ft


def scene(arrays, device):
    """The port's flat scene of ``arrays`` (``scenes.SceneArrays``), built
    from its nodes: ``subtract(intersect(union(tori), clip), cut)``."""
    ft = port()
    mats = []
    for i in range(arrays.tori.shape[0]):
        k = int(arrays.mat_kind[i])
        if k == 2:
            mats.append(ft.dielectric(float(arrays.ior[i, 0]),
                                      float(arrays.ior[i, 1]),
                                      tint=tuple(arrays.tint[i])))
        elif k == 1:
            mats.append(ft.mirror(float(arrays.reflectivity[i]),
                                  albedo=tuple(arrays.albedo[i])))
        else:
            mats.append(ft.solid(*arrays.albedo[i]))
    tori = [ft.torus(p[0:3], p[3:6], float(p[6]), float(p[7]), material=m)
            for p, m in zip(arrays.tori, mats)]
    root = ft.subtract(
        ft.intersect(ft.union(*tori),
                     ft.sphere(arrays.clip[0:3], float(arrays.clip[3]))),
        ft.sphere(arrays.cut[0:3], float(arrays.cut[3])))
    lights = []
    for kind, vec, col in zip(arrays.light_kind, arrays.light_vec,
                              arrays.light_color):
        make = ft.directional_light if kind == "directional" \
            else ft.point_light
        lights.append(make(tuple(vec), tuple(col)))
    return ft.flatten(ft.Scene(root=root, background=tuple(arrays.background),
                               lights=tuple(lights)), device=device)


def camera(cam: dict, device):
    return port().look_at(tuple(cam["position"]), tuple(cam["target"]),
                          tuple(cam["up"]), fov_degrees=cam["fov_degrees"],
                          device=device)


def march_config(march: dict):
    return port().MarchConfig(**march)


def render_config(render: dict, march: dict):
    return port().RenderConfig(
        width=render["width"], height=render["height"],
        epsilon=render["epsilon"], length=render["length"],
        march=march_config(march))


def wavefront_config(wave: dict, march: dict):
    keys = ("depth", "num_bins", "epsilon", "length", "min_throughput",
            "overflow_drop_threshold", "bounce_cull_m")
    return port().WavefrontConfig(march=march_config(march),
                                  **{k: wave[k] for k in keys})


def graph_counts() -> dict:
    from fraytracer_tpu_torch.ops import cuda
    return cuda.graph_counts()
