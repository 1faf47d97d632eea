"""Hand-written CUDA kernels (sources in ``fraytracer_tpu_torch/csrc``) and
their host wrappers.  Importing this package builds nothing: the kernels are
compiled on the first launch (``build.library``).

Each wrapper counts its launches; :func:`launch_counts` reads the counts
and :func:`reset_launch_counts` sets them to zero.
"""
from . import gather, march_kernel


def _tables():
    # ``probe`` also runs as a program (``python -m ...probe``): it is
    # imported here at first use, not with the package
    from . import probe
    return (march_kernel.LAUNCHES, gather.LAUNCHES, probe.LAUNCHES)


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {k: v for table in _tables() for k, v in table.items()}


def reset_launch_counts() -> None:
    for table in _tables():
        for k in table:
            table[k] = 0
