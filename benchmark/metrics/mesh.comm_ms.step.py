"""``mesh.comm_ms.step``: device ms per step, on rank 0's trace, of the
NCCL kernels (the collectives of ``parallel/mesh.py``: each chunk's
gradient ``all_reduce``, the losses' and the flag's), covered by other
work or not; ``mesh.exposed_comm_ms.step`` is the part left uncovered."""


def read(run):
    tr = run.tr
    if tr is None or not run.completed:
        return None
    ms = tr.ms(lambda name: name.lower().startswith("nccl"))
    return ms / run.completed if ms > 0 else None
