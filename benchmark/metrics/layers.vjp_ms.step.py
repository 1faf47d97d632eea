"""``layers.vjp_ms.step``: device ms a step of the backward less its table
builds: the ops under the ``vjp`` span (``torch.autograd.grad`` in
``render.py::_step``) in no ``cull`` span. From the layer table of the
replayed graph (``benchmark/layers.py``)."""
from benchmark import layers


def _keep(chain):
    return "vjp" in chain and "cull" not in chain


def read(run):
    return layers.ms(run, _keep)
