"""``bwd.scatter_ms.step``: device ms per step of the scatter kernels of
the backward (the transposes of ``take_rows`` and of the leaf and
candidate gathers: ``index_add_``, ``scatter_add_``, indexing backward),
by name."""

SCATTER = ("indexFuncLargeIndex", "indexFuncSmallIndex", "index_add",
           "scatter", "indexing_backward", "index_put")


def _head(name):
    """The name before its parameter list."""
    return name.replace("(anonymous namespace)::", "").split("(")[0]


def read(run):
    if run.tr is None or not run.completed:
        return None
    ms = run.tr.ms(lambda n: any(s in _head(n) for s in SCATTER))
    return ms / run.completed
