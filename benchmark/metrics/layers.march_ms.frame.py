"""``layers.march_ms.frame``: device ms a frame of the ops the port's
``march`` spans issued themselves
(``ops/cuda/march_kernel.py::cuda_march_raw`` less its table builds):
the bound skip, K1 or K2, K3 when fused, and each site's overflow
bookkeeping. From the layer table of the replayed graph
(``benchmark/layers.py``)."""
from benchmark import layers


def _keep(chain):
    return chain[:1] == ("march",)


def read(run):
    return layers.ms(run, _keep)
