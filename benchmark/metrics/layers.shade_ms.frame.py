"""``layers.shade_ms.frame``: device ms a frame of the ops the port's
``surface`` and ``shade`` spans issued themselves: the hit points,
``resolve_material`` and the albedo, then the lights' terms, the sums
and emission (``ops/shade.py``; in the spectral frame the same steps of
``ops/wavefront.py::_surface_terms``), less their shadow marches. From
the layer table of the replayed graph (``benchmark/layers.py``)."""
from benchmark import layers


def _keep(chain):
    return chain[:1] in (("surface",), ("shade",))


def read(run):
    return layers.ms(run, _keep)
