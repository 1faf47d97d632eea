"""``layers.other_ms.frame``: device ms a frame of the graph's ops inside
no layer span: camera rays, block order, the flag and the frame's own
glue. From the layer table of the replayed graph
(``benchmark/layers.py``)."""
from benchmark import layers


def _keep(chain):
    return not chain


def read(run):
    return layers.ms(run, _keep)
