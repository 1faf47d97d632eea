"""``step_ms``: the window's length in ms over the fit steps it completed
(a step: the loss and gradients, the SGD update of every floating leaf
and the loss read to the host)."""


def read(run):
    if not run.latencies:
        return None
    return 1e3 * run.window_s / run.completed
