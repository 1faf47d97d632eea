"""``graph.eager_share.step``: the share of the traced window's steps the
port ran eagerly, not as a graph replay: (``eager_reruns`` +
``eager_frames``) / steps, from ``ops.cuda.graph_counts()``."""


def read(run):
    if not run.completed or not run.counts:
        return None
    c = run.counts
    return (c.get("eager_reruns", 0) + c.get("eager_frames", 0)) / run.completed
