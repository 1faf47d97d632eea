"""``layers.other_ms.step``: device ms a step of the graph's ops inside no
layer span: camera rays, block order, the flag and the step's own glue.
From the layer table of the replayed graph (``benchmark/layers.py``)."""
from benchmark import layers


def _keep(chain):
    return not chain


def read(run):
    return layers.ms(run, _keep)
