"""``layers.dense_march_ms.frame``: device ms a frame of the dense K1/K2
(``march_dense_kernel`` in ``csrc/march.cu``), read by kernel name: the
work of the port's ``march.dense`` spans (``ops/cuda/march_kernel.py::
march_kernel`` in its dense form), less their microseconds of counter
reset and the hit mask's cast. Nothing where no dense K1/K2 ran."""

KERNEL = "march_dense_kernel"


def _base(name):
    return name.split("(")[0].replace("void ", "").split("<")[0].strip()


def read(run):
    if run.tr is None or not run.completed:
        return None
    ms = run.tr.ms(lambda n: _base(n) == KERNEL)
    return ms / run.completed if ms > 0 else None
