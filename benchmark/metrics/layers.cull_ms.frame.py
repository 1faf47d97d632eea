"""``layers.cull_ms.frame``: device ms a frame of the ops the port's
``cull`` spans issued themselves: the candidate-table builds of every
culled march site (``ops/cuda/cull.py::build_pair_tables``). From the
layer table of the replayed graph (``benchmark/layers.py``)."""
from benchmark import layers


def _keep(chain):
    return chain[:1] == ("cull",)


def read(run):
    return layers.ms(run, _keep)
