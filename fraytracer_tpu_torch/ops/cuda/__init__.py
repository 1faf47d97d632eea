"""Hand-written CUDA kernels (sources in ``fraytracer_tpu_torch/csrc``) and
their host wrappers.  Importing this package builds nothing: the kernels are
compiled on the first launch (``build.library``).

Each wrapper counts its launches; :func:`launch_counts` reads the counts
and :func:`reset_launch_counts` sets them to zero (``leaf_vjp_plain``
counts the march backwards on CUDA tensors that took the plain version,
``ops/march.py::implicit_vjp``, instead of ``leaf_vjp``'s kernel).  A
wrapper does not run
when a captured CUDA graph replays (``ops/graph.py``): each replay adds
the launches recorded at its capture (:func:`add_launch_counts`), so the
counts still mean kernels launched on the card.  ``GRAPH`` counts the
frames captured, the replays, the eager re-runs of frames that raised
their flag, and the frames of keys run eagerly because their first frame
raised it; a step of ``render_value_and_grad`` (a frame and its backward
in one graph) and a spectral frame of ``render_spectral_with_stats`` count
as frames under the same keys.

:func:`dense_counts` reads the dense form's counters: the program its
last launches lowered (ops, kind runs, value-stack depth, the bytes a
block stages against those it reads from device memory), the last K1/K2
launch's threads a block and blocks an SM, and the lane-steps its K1/K2
evaluated, counted on the device.
"""
from . import cull_kernel, gather, leaf_vjp, march_kernel, scatter

GRAPH = {"captures": 0, "replays": 0, "eager_reruns": 0, "eager_frames": 0}


def _tables():
    # ``probe`` also runs as a program (``python -m ...probe``): it is
    # imported here at first use, not with the package
    from . import probe
    return (march_kernel.LAUNCHES, cull_kernel.LAUNCHES, gather.LAUNCHES,
            scatter.LAUNCHES, leaf_vjp.LAUNCHES, probe.LAUNCHES)


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {k: v for table in _tables() for k, v in table.items()}


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` (kernel name → launches, as :func:`launch_counts`
    keys them) to the counts."""
    for table in _tables():
        for k in table:
            table[k] += delta.get(k, 0)


def graph_counts() -> dict:
    """Graph frames captured, replayed, run again eagerly, and run eagerly
    for their key, since the last reset (graph steps and spectral frames
    counted as frames)."""
    return dict(GRAPH)


def dense_counts() -> dict:
    """The dense form's program and its last K1/K2 launch's width
    (``march_kernel.DENSE``: ``march_threads`` a block,
    ``march_blocks_per_sm``) and ``lane_steps``: the scene evaluations its
    K1/K2 made since the last reset, graph replays included (a read of the
    device)."""
    steps = sum(int(c.sum()) for c in march_kernel.LANE_STEPS.values())
    return {**march_kernel.DENSE, "lane_steps": steps}


def reset_launch_counts() -> None:
    """Set every launch count, the graph counts and the lane-steps to
    zero."""
    for table in _tables() + (GRAPH,):
        for k in table:
            table[k] = 0
    for c in march_kernel.LANE_STEPS.values():
        c.zero_()
