"""The CUDA header and its Python mirrors say the same thing
(``fraytracer_tpu_torch/csrc/ft_sdf.cuh`` against ``ops/cuda/cull.py`` and
``ops/cuda/march_kernel.py``): the ``#define``s of the table layout, the
field order and size of the structs a launch passes by value, and the host
function that sizes a K1/K2/K3 block's shared memory.  No kernel runs here:
the header is parsed as text."""
import ctypes
import dataclasses
import re
from pathlib import Path

import pytest
import torch

from fraytracer_tpu_torch.ops.cuda import cull as TC
from fraytracer_tpu_torch.ops.cuda import cull_kernel as CK
from fraytracer_tpu_torch.ops.cuda import march_kernel as MK

HEADER = (Path(MK.__file__).resolve().parents[2] / "csrc"
          / "ft_sdf.cuh").read_text()


def define(name: str) -> int:
    m = re.search(rf"^#define {name}\s+(\d+)\b", HEADER, re.M)
    assert m, f"{name} is not defined in ft_sdf.cuh"
    return int(m.group(1))


@pytest.mark.parametrize("name,want", [
    ("FT_TILE", TC.TILE),
    ("FT_CAND_UNROLL", TC.CAND_UNROLL),
    ("FT_TABLE_W", TC.PSTRIDE + 2),
    ("FT_PSTRIDE", TC.PSTRIDE),
    ("FT_MAX_PAIRS", TC.MAX_PAIRS),
    ("FT_MAX_STACK", MK.MAX_STACK),
    ("FT_SURF_LIST_BYTES", TC.SURF_LIST_BYTES),
    ("FT_SUBF", TC.SUBF),
    ("FT_CONES", CK.CONES),
    ("FT_CONE_W", CK.CONE_W),
])
def test_header_defines_match_python(name, want):
    assert define(name) == want


def test_staged_record_sizes():
    """The staged op record and pair record as the host sizes them."""
    assert c_layout(struct_fields("SOp"))[0] == TC.STAGE_OP_BYTES
    assert 16 + TC.MAX_PAIRS * c_layout(struct_fields("SPair"))[0] \
        == TC.STAGE_HEADER


def test_window_and_block_granularity():
    """A window spans a warp; a K1/K2 block is whole warps and divides a
    tile, so a block reads one tile's tables."""
    assert TC.WINDOW_LANES == 32
    block = define("FT_BLOCK")
    assert block % TC.WINDOW_LANES == 0 and TC.TILE % block == 0
    assert TC.TABLE_W == define("FT_TABLE_W") and TC.TABLE_W % 4 == 0


def test_surface_list_layout():
    """K3's hit-lane list: an int count a warp of a block, then one byte a
    lane (thread indices fit a byte), 16-byte aligned at the plan's end."""
    block = define("FT_BLOCK")
    assert TC.SURF_LIST_BYTES == 4 * (block // 32) + block
    assert TC.SURF_LIST_BYTES % 16 == 0 and block <= 256


def struct_fields(name: str):
    """``[(field, c type, array length)]`` of ``struct name`` in the
    header, in order."""
    m = re.search(rf"^struct {name} \{{\n(.*?)^\}};", HEADER, re.M | re.S)
    assert m, f"struct {name} not found"
    body = re.sub(r"//[^\n]*", "", m.group(1))
    out = []
    for decl in body.split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        d = re.fullmatch(r"(const \w+\*|\w+\*|\w+) (.+)", decl)
        assert d, decl
        for item in d.group(2).split(","):
            a = re.fullmatch(r"\s*(\w+)(?:\[(\w+)\])?\s*", item)
            assert a, decl
            n = a.group(2)
            out.append((a.group(1), d.group(1),
                        None if n is None else
                        int(n) if n.isdigit() else define(n)))
    return out


def c_layout(fields):
    """Size of a C struct with these fields (pointers 8 bytes, int and
    float 4, nested structs by their own layout)."""
    size, align = 0, 1
    for _name, ctype, n in fields:
        if ctype.endswith("*"):
            s = a = 8
        elif ctype in ("int", "float"):
            s = a = 4
        else:
            s, a = c_layout(struct_fields(ctype))
        size = -(-size // a) * a + s * (n or 1)
        align = max(align, a)
    return -(-size // align) * align, align


@pytest.mark.parametrize("name,mirror", [
    ("FtProgram", MK.FtProgram), ("FtPair", MK.FtPair),
    ("FtCull", MK.FtCull), ("FtStage", MK.FtStage),
    ("FtDenseStage", MK.FtDenseStage), ("FtBuildPair", CK.FtBuildPair),
    ("FtBuild", CK.FtBuild)])
def test_struct_mirrors_header(name, mirror):
    """Field names in order, each field's type, and the struct's size."""
    fields = struct_fields(name)
    assert [f for f, _t, _n in fields] == [f for f, _t in mirror._fields_]
    for (fname, ctype, n), (_f, ptype) in zip(fields, mirror._fields_):
        if ctype.endswith("*"):
            assert ptype is ctypes.c_void_p, fname
        elif ctype in ("int", "float") and n is None:
            assert ptype is getattr(ctypes, "c_" + ctype), fname
        else:
            assert ptype._length_ == n, fname
    assert ctypes.sizeof(mirror) == c_layout(fields)[0]


# (table rows of the pairs, staged?, bytes of one pair)
PLANS = {
    "bench_primary_m256": ((256,), (True,), 256 * 48 + 256 + 128),
    "bench_shadow_m512": ((512,), (True,), 512 * 48 + 512 + 256),
    "eight_pairs_m1000": ((1000,) * 8, (True,) * 4 + (False,) * 4,
                          1000 * 48 + 1008 + 512),
}


@pytest.mark.parametrize("name", PLANS)
def test_stage_plan(name):
    """Bytes per pair, which pairs are staged (program order, while they
    fit) and the 227 KB limit."""
    ms, staged, pair_bytes = PLANS[name]
    plan = TC.stage_plan(ms, n_ops=5, n_dense=2)
    assert TC.SMEM_LIMIT == 227 * 1024
    assert all(TC.pair_stage_bytes(m) == pair_bytes for m in ms)
    assert plan.staged == staged
    assert plan.bytes <= TC.SMEM_LIMIT
    # the next pair would not have fitted
    if not all(staged):
        assert plan.bytes + pair_bytes > TC.SMEM_LIMIT
    # header, program, entries, pairs: in that order, 16-byte aligned, no
    # overlap
    offs = [plan.ops_off, plan.ents_off] \
        + [o for o in plan.pair_off if o >= 0]
    assert offs[0] == TC.STAGE_HEADER and offs == sorted(set(offs))
    assert plan.ents_off == plan.ops_off + 5 * TC.STAGE_OP_BYTES
    assert all(o % 16 == 0 for o in offs)
    assert plan.ents == 2
    assert plan.pair_off[0] == plan.ents_off + 2 * TC.TABLE_W * 4
    n_staged = sum(staged)
    assert plan.bytes == plan.pair_off[0] + n_staged * pair_bytes
    want_bulk = sum(sum(TC.pair_slice_bytes(m)[k] for k in TC.bulk_slices(m))
                    for m in ms[:n_staged])
    assert plan.bulk_bytes == want_bulk
    mask = (1 << n_staged) - 1
    assert plan.bulk_keys == (mask if ms[0] % 16 == 0 else 0)
    assert plan.bulk_hsuf == (mask if ms[0] % 32 == 0 else 0)
    stage = MK._stage_struct(plan)
    assert list(stage.pair_off) == list(plan.pair_off) \
        + [-1] * (TC.MAX_PAIRS - len(ms))
    assert stage.bytes == plan.bytes and stage.bulk_bytes == plan.bulk_bytes


def test_stage_plan_dense_form_and_limits():
    """The dense form stages its program, its kind runs and its packed
    rows: the benchmark's 1002 entries (1000 tori at 32 bytes, 2 spheres
    at 16) fit a block beside them, as one bulk copy at the plan's end;
    rows past the limit are read from device memory, and so are K3's
    (material, slot) pairs; a plan too large for a block is refused."""
    rows = 1000 * 32 + 2 * 16
    plan = TC.dense_stage_plan(n_ops=5, n_runs=3, rows_bytes=rows)
    assert (plan.ops_off, plan.runs_off) == (TC.DENSE_HEADER,
                                             TC.DENSE_HEADER + 5 * 32)
    assert plan.staged and plan.ms_off == -1
    assert plan.rows_off == plan.runs_off + 3 * TC.STAGE_RUN_BYTES
    assert plan.rows_off % 16 == 0 and plan.rows_bytes == rows
    assert plan.bytes == plan.rows_off + rows < 48 * 1024
    surf = TC.dense_stage_plan(5, 3, rows, members=1002,
                               reserve=TC.SURF_LIST_BYTES)
    assert surf.ms_off == plan.rows_off and surf.staged
    assert surf.rows_off == surf.ms_off + 8 * 1002
    assert surf.bytes == surf.rows_off + rows + TC.SURF_LIST_BYTES
    # past the limit: the rows from device memory, the rest still staged
    big = TC.dense_stage_plan(5, 3, TC.SMEM_LIMIT)
    assert big.rows_off == -1 and not big.staged
    assert big.bytes == big.runs_off + 3 * TC.STAGE_RUN_BYTES
    members = TC.dense_stage_plan(5, 3, rows, members=30000,
                                  reserve=TC.SURF_LIST_BYTES)
    assert members.ms_off == -1 and members.staged
    with pytest.raises(NotImplementedError):
        TC.dense_stage_plan(n_ops=20000, n_runs=1, rows_bytes=16)
    with pytest.raises(NotImplementedError):
        TC.stage_plan((), n_ops=20000, n_dense=0)
    with pytest.raises(NotImplementedError):
        TC.stage_plan((8,) * (TC.MAX_PAIRS + 1), 5, 2)


class _Shapes:
    """Stands in for CullTables where only the pairs' table rows are read:
    a plan is made from shapes, never from the tables' contents."""

    def __init__(self, ms):
        self.tables = [type("Pair", (), {"m": m})() for m in ms]


@pytest.mark.parametrize("ms", [(256,), (512,), (1000,) * 8, ()])
def test_surface_stage_plan_is_the_march_plan_and_the_list(ms):
    """K3's plan from shapes alone: K1/K2's offsets and staged pairs, then
    the hit-lane list at its end (``S.bytes - FT_SURF_LIST_BYTES``)."""
    five_ops = torch.zeros((5, 2), dtype=torch.int32)
    prog = MK.Program(**{f.name: five_ops for f in dataclasses.fields(
        MK.Program) if f.name != "n_dense"}, n_dense=2)
    march = MK.march_stage_plan(prog, _Shapes(ms))
    surf = MK.surface_stage_plan(prog, _Shapes(ms))
    assert surf == TC.stage_plan(ms, 5, 2, TC.SURF_LIST_BYTES)
    assert surf.bytes == march.bytes + TC.SURF_LIST_BYTES <= TC.SMEM_LIMIT
    assert (surf.ops_off, surf.ents_off, surf.pair_off, surf.bulk_bytes) \
        == (march.ops_off, march.ents_off, march.pair_off, march.bulk_bytes)
    assert (surf.bytes - TC.SURF_LIST_BYTES) % 16 == 0


def test_stage_plan_reserve_counts_against_the_limit():
    """A pair that fits a block with fewer than SURF_LIST_BYTES to spare is
    staged by K1/K2's plan and read from device memory by K3's."""
    m = 4680
    start = TC.STAGE_HEADER + 5 * TC.STAGE_OP_BYTES + 2 * TC.TABLE_W * 4
    end = start + TC.pair_stage_bytes(m)
    assert TC.SMEM_LIMIT - TC.SURF_LIST_BYTES < end <= TC.SMEM_LIMIT
    assert TC.stage_plan((m,), 5, 2).staged == (True,)
    plan = TC.stage_plan((m,), 5, 2, TC.SURF_LIST_BYTES)
    assert plan.staged == (False,) and plan.bulk_bytes == 0
    assert plan.bytes == start + TC.SURF_LIST_BYTES
