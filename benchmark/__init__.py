"""The benchmark of ``fraytracer_tpu_torch`` (the PyTorch and CUDA port).

Run one cell with ``python benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the repository's root.  Everything that
belongs to one configuration, traffic kind or metric sits in a file of its
own (``configs/``, ``workloads/``, ``traffic/``, ``metrics/``) that the
harness finds by the name ``BENCHMARK.json`` gives.  ``reference/`` is the
plain PyTorch renderer that decides ``correct``; it imports nothing of the
port.  Only ``program.py`` imports the port.
"""
