"""The port's ``scatter-bounds`` pass (``analysis/bounds.py``:
``BoundsWalker``, ``check_bounds``) over traced aten graphs, on the CPU.

The JAX walker (``analysis/bounds.py:269-674``) propagates declared
intervals through a jaxpr and proves every gather, scatter and dynamic
slice inside its operand. The port's walks the aten ops a traced program
holds — ``index``, ``index_put_``, ``index_select``, ``gather``,
``scatter`` (and its reduce/add forms), ``index_copy_``, ``embedding``,
``select``/``narrow`` at offsets, and the kernel nodes through
``kernels.py``'s index-map checks — with the JAX verdicts: ``ok`` (a
proof), ``out-of-range`` ERROR (a finite bound reaches outside),
``unproven-promise`` WARNING (only an infinite side is unbounded). Each
case here is a JAX test's program re-written with torch ops, at the same
verdict. Trace-only.
"""

import pytest
import torch

from simple_distributed_machine_learning_tpu_torch.analysis import (
    analyze,
    spec,
)
from simple_distributed_machine_learning_tpu_torch.analysis.bounds import (
    TOP,
    BoundsWalker,
    Interval,
    check_bounds,
)
from simple_distributed_machine_learning_tpu_torch.analysis.trace import (
    trace_program,
)

OOB = "scatter-bounds.out-of-range"
UNPROVEN = "scatter-bounds.unproven-promise"


def _verdict(fn, *args) -> set:
    return {f.rule for f in analyze(fn, *args).findings}


def _idx(lo, hi, shape=(3,)):
    return spec(shape, torch.int64, lo, hi)


X = spec((4, 8), torch.float32)

# (name, fn, operand rows the index addresses)
INDEX_OPS = [
    ("index", lambda x, i: x[i]),
    ("index_select", lambda x, i: x.index_select(0, i)),
    ("gather", lambda x, i: x.gather(0, i[:, None].expand(3, 8))),
    ("index_put_", lambda x, i: x.index_put_((i,), torch.zeros(3, 8))),
    ("index_copy_", lambda x, i: x.index_copy_(0, i, torch.zeros(3, 8))),
    ("index_add_", lambda x, i: x.index_add_(0, i, torch.zeros(3, 8))),
    ("scatter", lambda x, i: x.scatter(0, i[:, None].expand(3, 8),
                                       torch.zeros(3, 8))),
    ("scatter_add", lambda x, i: x.scatter_add(0, i[:, None].expand(3, 8),
                                               torch.zeros(3, 8))),
    ("embedding", lambda x, i: torch.nn.functional.embedding(i, x)),
]


@pytest.mark.parametrize("name,fn", INDEX_OPS, ids=[n for n, _ in INDEX_OPS])
@pytest.mark.parametrize("lo,hi,want", [
    (0, 3, set()),             # proven inside the 4 rows
    (0, 4, {OOB}),             # one past the last row
    (5, 9, {OOB}),             # every value outside
    (-1, 2, {OOB}),            # a finite negative bound
    (0, None, {UNPROVEN}),     # only the infinite side unbounded
    (None, None, {UNPROVEN}),  # no contract at all
])
def test_index_op_verdicts(name, fn, lo, hi, want):
    idx = (spec((3,), torch.int64) if lo is None and hi is None
           else _idx(lo, hi))
    assert _verdict(fn, X, idx) == want


def test_arithmetic_carries_the_proof():
    """pos // bs and pos % bs (the block and offset of a position), a
    clamp, a where on a decided predicate and an int cast that fits keep
    the interval; the JAX lattice's results."""
    def f(x, pos):
        blk = torch.div(pos, 2, rounding_mode="floor")         # [0, 3]
        off = pos % 2                                          # [0, 1]
        c = torch.clamp(pos - 10, min=0, max=3)                # [0, 3]
        w = torch.where(pos < 100, blk, pos)                   # decided
        return x[blk] + x[off] + x[c] + x[w.to(torch.int32)]

    assert _verdict(f, X, _idx(0, 7)) == set()
    assert _verdict(f, X, _idx(0, 8)) == {OOB}


def test_tables_gathered_through_a_table():
    """An index read out of a table carries the table's contract: the
    paged path's ``tables.gather(1, pos // bs)``."""
    def f(pool, tables, pos):
        phys = tables.gather(1, (pos // 4)[:, None])[:, 0]
        return pool[phys]

    pool = spec((7, 4), torch.float32)
    tables = spec((2, 3), torch.int64, 0, 6)
    assert _verdict(f, pool, tables, _idx(0, 11, (2,))) == set()
    assert _verdict(f, pool, spec((2, 3), torch.int64, 0, 7),
                    _idx(0, 11, (2,))) == {OOB}
    # a position past the table: the gather itself is out of range
    assert _verdict(f, pool, tables, _idx(0, 12, (2,))) == {OOB}


def test_arange_and_constant_indices():
    def inside(x):
        return x[torch.arange(4)].sum(0) + x[torch.tensor([0, 3])].sum(0)

    def past(x):
        return x[torch.arange(5) % 5]

    assert _verdict(inside, X) == set()
    assert _verdict(past, X) == {OOB}


def test_argmax_and_topk_indices_are_proven():
    def f(x, scores):
        return (x[scores.argmax(-1)].sum(0)
                + x[torch.topk(scores, 2).indices[0]].sum(0))

    assert _verdict(f, X, spec((3, 4), torch.float32)) == set()


def test_narrow_and_select_at_offsets():
    """``select``/``narrow``/``slice`` at a host offset trace only when
    in range (torch checks them at trace time): a bad one is a trace
    failure, not a silent pass."""
    def ok(x):
        return x.select(0, 3) + x.narrow(0, 1, 3).sum(0)

    def bad(x):
        return x.select(0, 4)

    assert _verdict(ok, X) == set()
    assert _verdict(bad, X) == {"trace.failed"}


def test_data_dependent_shapes_fail_the_trace():
    """A boolean mask's selection has a data-dependent shape, which no
    fake-tensor trace can give a static graph: a trace failure (a
    finding), never a vacuous pass; the same mask in a ``where`` traces
    clean."""
    def select(x, m):
        return x[m]

    def keep(x, m):
        return torch.where(m, x, 0.0)

    x, m = spec((4,), torch.float32), spec((4,), torch.bool)
    assert _verdict(select, x, m) == {"trace.failed"}
    assert _verdict(keep, x, m) == set()


def test_walker_intervals_on_the_graph():
    """The walker's environment holds the propagated interval of each
    node: the declared input, the derived block index, TOP for float
    math."""
    def f(x, pos):
        return x[pos // 2] * 2.0

    prog = trace_program(f, torch.zeros(4, 8), torch.zeros(3,
                                                           dtype=torch.long))
    w = BoundsWalker(lambda f_: None)
    w.run(prog, [None, Interval(0, 7)])
    ivs = {n.name: w.iv[n] for n in prog.graph.nodes if n in w.iv}
    assert Interval(0, 3) in ivs.values()
    assert ivs[prog.placeholders[1].name] == Interval(0, 7)
    assert ivs[prog.placeholders[0].name] == TOP
    assert check_bounds(prog, [None, Interval(0, 7)]) == []


def test_kernel_node_index_maps_checked():
    """A K4 node's launch spec gets the contracts its table inputs carry
    in the graph: in range it proves clean, one past the pool it is
    ``kernel-oob`` (the spec's index map), where the plain version would
    have no node to check."""
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention,
    )

    def attend(q, kc, vc, tables, qpos):
        return paged_attention(q, kc, vc, tables, qpos, block_size=4,
                               device="cpu")

    q = spec((2, 2, 1, 8), torch.float32)
    kv = spec((6, 2, 4, 8), torch.float32)
    qpos = spec((2, 1), torch.int32, 0, 11)
    assert _verdict(attend, q, kv, kv, spec((2, 3), torch.int32, 0, 5),
                    qpos) == set()
    assert _verdict(attend, q, kv, kv, spec((2, 3), torch.int32, 0, 6),
                    qpos) == {"kernel-oob.index-map"}
    assert _verdict(attend, q, kv, kv, spec((2, 3), torch.int32),
                    qpos) == {"kernel-unproven.index-map"}
