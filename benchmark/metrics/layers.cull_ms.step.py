"""``layers.cull_ms.step``: device ms a step of the ops the port's ``cull``
spans issued themselves, in the forward
(``ops/cuda/cull.py::build_pair_tables``) and the backward
(``ops/point_eval.py::build_culled_eval``). From the layer table of the
replayed graph (``benchmark/layers.py``)."""
from benchmark import layers


def _keep(chain):
    return chain[:1] == ("cull",)


def read(run):
    return layers.ms(run, _keep)
