"""``kernels.march_ms.frame``: device ms per frame of the march kernels
K1/K2 and the surface pass K3 (``csrc/march.cu``), by name."""

MARCH_KERNELS = ("march_kernel", "march_dense_kernel", "surface_kernel",
                 "surface_dense_kernel", "surface_ad_kernel",
                 "surface_ad_dense_kernel")


def _base(name):
    return name.split("(")[0].replace("void ", "").split("<")[0].strip()


def read(run):
    if run.tr is None or not run.completed:
        return None
    return run.tr.ms(lambda n: _base(n) in MARCH_KERNELS) / run.completed
