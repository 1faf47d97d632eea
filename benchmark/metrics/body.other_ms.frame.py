"""``body.other_ms.frame``: device ms per frame of the ops that are not
the port's own kernels (``csrc/*.cu``): the table build, shading and glue
of the graph body."""

# the port's hand-written kernels, by the short name the trace gives them
PORT_KERNELS = ("march_kernel", "march_dense_kernel", "surface_kernel",
                "surface_dense_kernel", "surface_ad_kernel",
                "surface_ad_dense_kernel", "block_gather_kernel")


def _base(name):
    return name.split("(")[0].replace("void ", "").split("<")[0].strip()


def read(run):
    if run.tr is None or not run.completed:
        return None
    return run.tr.ms(lambda n: _base(n) not in PORT_KERNELS) / run.completed
