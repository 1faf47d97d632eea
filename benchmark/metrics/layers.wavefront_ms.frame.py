"""``layers.wavefront_ms.frame``: device ms a frame of the ops the port's
``wavefront`` spans issued themselves: the bounce queue's glue, the
Fresnel children and the compactions with K4 (``ops/wavefront.py``),
less the marches and shading nested in them. From the layer table of the
replayed graph (``benchmark/layers.py``)."""
from benchmark import layers


def _keep(chain):
    return chain[:1] == ("wavefront",)


def read(run):
    return layers.ms(run, _keep)
