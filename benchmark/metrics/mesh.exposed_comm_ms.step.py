"""``mesh.exposed_comm_ms.step``: device ms per step, on rank 0's trace,
of the NCCL kernels (the collectives of ``parallel/mesh.py``) that no
other device op covers: the part of the exchange the backward does not
hide."""


def _nccl(name):
    return name.lower().startswith("nccl")


def read(run):
    tr = run.tr
    if tr is None or not run.completed:
        return None
    comm = [(a, b) for n, a, b in tr.ops if _nccl(n)]
    if not comm:
        return None
    work = []
    for _n, a, b in sorted((o for o in tr.ops if not _nccl(o[0])),
                           key=lambda o: o[1]):
        if work and a <= work[-1][1]:
            work[-1][1] = max(work[-1][1], b)
        else:
            work.append([a, b])
    exposed = 0.0
    for a, b in comm:
        covered = sum(max(0.0, min(b, y) - max(a, x)) for x, y in work
                      if x < b and y > a)
        exposed += (b - a) - covered
    return exposed * 1e-3 / run.completed
