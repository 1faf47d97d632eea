"""Hand-written CUDA kernels (sources in ``fraytracer_tpu_torch/csrc``) and
their host wrappers.  Importing this package builds nothing: the kernels are
compiled on the first launch (``build.library``).

Each wrapper counts its launches; :func:`launch_counts` reads the counts
and :func:`reset_launch_counts` sets them to zero.
"""
from . import gather, march_kernel


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {**march_kernel.LAUNCHES, **gather.LAUNCHES}


def reset_launch_counts() -> None:
    for table in (march_kernel.LAUNCHES, gather.LAUNCHES):
        for k in table:
            table[k] = 0
