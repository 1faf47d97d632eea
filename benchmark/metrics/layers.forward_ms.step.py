"""``layers.forward_ms.step``: device ms a step of the forward's layers
outside the backward: the ops the ``march``, ``surface``, ``shade`` and
``loss`` spans issued themselves. From the layer table of the replayed
graph (``benchmark/layers.py``)."""
from benchmark import layers


def _keep(chain):
    return (chain[:1] in (("march",), ("surface",), ("shade",), ("loss",))
            and "vjp" not in chain)


def read(run):
    return layers.ms(run, _keep)
