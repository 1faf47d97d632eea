"""A traced window's device ops split by the port's layers.

A frame, step or spectral frame on the card is one CUDA graph replay, and
a replay runs no host code, so no range placed in the program shows up
inside it.  The port instead builds a *layer table* when it captures the
graph (``fraytracer_tpu_torch/utils/profiling.py``): its spans count the
capture's op nodes, so the table says which of a replay's ops (kernels,
memcpys, memsets, in capture order) each layer issued, with the kind of
every op and the position of each of the port's own kernels (its anchors).

Here each replay's block of ops is found in ``run.tr.ops`` by those
anchors, checked, and joined with the table.  A block is taken only where
it has exactly the table's ops: every op of the kind the table gives and
every anchor the kernel the table names.  Tables are tried longest first
and a block may not overlap one already taken (a frame's graph also
matches the forward of a step's).  Where the window ran a call eagerly,
where the blocks found are not the window's replays, or where the program
has no layer tables, the split is nothing: never a guess.
"""
from __future__ import annotations

from benchmark import program
from benchmark.trace import short

_memo: dict = {}


def op_kind(name: str) -> str:
    """An op's kind as the layer tables write it: memcpy ``c``, memset
    ``s``, kernel ``k``.  A graph may run a memcpy node as one of the
    driver's copy kernels (``memcpy128``, ``memcpy32_post``): a memcpy."""
    if name.startswith(("Memcpy", "memcpy")):
        return "c"
    if name.startswith("Memset"):
        return "s"
    return "k"


def graph_tables() -> list | None:
    """The port's layer tables, or ``None`` where it keeps none."""
    try:
        read = program.port().utils.profiling.graph_layers
    except (ImportError, AttributeError):
        return None
    return read()


def chains(table: dict) -> list:
    """For each op of the table's graph, the names of the spans holding it,
    innermost first (``()``: in no span)."""
    out = [()] * table["n_ops"]
    of_entry = []
    # entries are in the order they opened: a child after its parent
    for name, parent, first, n in table["layers"]:
        chain = (name,) + (of_entry[parent] if parent is not None else ())
        of_entry.append(chain)
        out[first:first + n] = [chain] * n
    return out


def blocks(names: list, kinds: str, table: dict) -> list:
    """The starts ``p`` in a window's ops (``names``, their ``kinds``) at
    which ``names[p:p + n_ops]`` is a replay of ``table``'s graph."""
    n, anchors = table["n_ops"], table["anchors"]
    if not n or not anchors or len(table["kinds"]) != n:
        return []
    a0, k0 = anchors[0]
    found = []
    for i, name in enumerate(names):
        p = i - a0
        if name != k0 or p < 0 or p + n > len(names):
            continue
        if kinds[p:p + n] == table["kinds"] and all(
                names[p + a] == k for a, k in anchors):
            found.append(p)
    return found


def split(ops: list, tables: list, replays: int) -> list | None:
    """``[(table, start)]``: the block of each of ``replays`` replays in
    ``ops`` (``(name, start µs, end µs)`` in start order), or ``None``
    where they are not all found exactly (module docstring)."""
    names = [short(n) for n, _a, _b in ops]
    kinds = "".join(op_kind(n) for n, _a, _b in ops)
    taken = bytearray(len(ops))
    found = []
    for t in sorted((t for t in tables if t["replays"] > 0),
                    key=lambda t: -t["n_ops"]):
        n = t["n_ops"]
        for p in blocks(names, kinds, t):
            if any(taken[p:p + n]):
                continue
            taken[p:p + n] = b"\1" * n
            found.append((t, p))
    if not replays or len(found) != replays:
        return None
    return found


def _split(run):
    tr = run.tr
    if tr is None or not run.completed:
        return None
    c = run.counts
    if c.get("eager_reruns", 0) or c.get("eager_frames", 0):
        return None
    key = id(tr)
    if key not in _memo or _memo[key][0] is not tr:
        tables = graph_tables()
        got = None if not tables else split(tr.ops, tables,
                                            c.get("replays", 0))
        _memo.clear()
        _memo[key] = (tr, got)
    return _memo[key][1]


def ms(run, keep) -> float | None:
    """Device ms a call of the replays' ops whose chain of spans (innermost
    first) ``keep`` accepts; ``None`` where the window has no split."""
    found = _split(run)
    if found is None:
        return None
    total, of = 0.0, {}
    for table, p in found:
        if id(table) not in of:
            of[id(table)] = chains(table)
        for chain, (_n, a, b) in zip(of[id(table)],
                                     run.tr.ops[p:p + table["n_ops"]]):
            if keep(chain):
                total += b - a
    return total * 1e-3 / run.completed
