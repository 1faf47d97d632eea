"""``body.device_ops.frame``: device ops (kernels, copies, sets) per call in the traced
window, every op of the graph body: table build, march, surface,
shading, glue."""


def read(run):
    if run.tr is None or not run.completed:
        return None
    return len(run.tr.ops) / run.completed
