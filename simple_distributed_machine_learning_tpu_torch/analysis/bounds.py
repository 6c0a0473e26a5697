"""The interval lattice of the bounds analysis (port of the lattice half of
``analysis/bounds.py``).

An index is the serving path's one irreducible hazard: a block-table entry
that picks a K/V block, a position that picks a row. A kernel on the card
never raises on an out-of-range index; it reads or writes someone else's
memory. The kernel linter (:mod:`.kernels`) proves every block index a
launch can form inside its operand, given the value ranges the caller
declares for its index-bearing inputs (:func:`spec`): this module holds
the inclusive-interval arithmetic it propagates them with, and the verdict
on a result.

:class:`BoundsWalker` / :func:`check_bounds` are the program linter's
``scatter-bounds`` pass: the interval propagation over a traced aten
graph (``trace.trace_program``) from the declared contracts of its
inputs, proving every index op — ``index``, ``index_put_``,
``index_select``, ``gather``, ``scatter``, ``index_copy_``,
``embedding`` — inside its operand, and handing each kernel node its
launch spec with the contracts its own inputs carry (``kernels.py``).

The propagation is deliberately conservative: unknown values are
``[-inf, inf]`` and an operation it cannot bound gives the unknown, so it
can miss a proof (a WARNING at worst) but never claims safety it did not
derive. The lattice is stdlib; the graph walk reads torch graphs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

_INF = math.inf


@dataclasses.dataclass(frozen=True)
class Interval:
    """Inclusive value bounds; ``[-inf, inf]`` is the unknown (TOP)."""
    lo: float
    hi: float

    @property
    def known(self) -> bool:
        return self.lo > -_INF or self.hi < _INF

    def __or__(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))


TOP = Interval(-_INF, _INF)
BOOL = Interval(0, 1)


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """An argument's shape and dtype plus its declared value contract:
    ``lo``/``hi`` are the inclusive bounds the CALLER guarantees for every
    element (the host-side discipline being machine-checked); ``vary``
    the mesh axes its content differs over although its shape is
    replicated (a ZeRO-style shard: the sharded-state rule's seed);
    ``device`` where its stand-in lies in a trace (None: the CPU, as a
    host-side input)."""
    shape: tuple
    dtype: Any
    lo: float | None = None
    hi: float | None = None
    vary: tuple = ()
    device: Any = None

    @property
    def interval(self) -> Interval | None:
        if self.lo is None and self.hi is None:
            return None
        return Interval(-_INF if self.lo is None else self.lo,
                        _INF if self.hi is None else self.hi)


def spec(shape, dtype, lo=None, hi=None, vary=(), device=None) -> ArgSpec:
    """A shape and dtype carrying a value contract (see :class:`ArgSpec`)."""
    return ArgSpec(tuple(int(d) for d in shape), dtype, lo=lo, hi=hi,
                   vary=tuple(vary),
                   device=None if device is None else str(device))


def _mul_iv(a: Interval, b: Interval) -> Interval:
    prods = []
    for x in (a.lo, a.hi):
        for y in (b.lo, b.hi):
            if (x in (0, -0.0) or y in (0, -0.0)):
                prods.append(0.0)
            elif abs(x) == _INF or abs(y) == _INF:
                prods.append(_INF if (x > 0) == (y > 0) else -_INF)
            else:
                prods.append(x * y)
    return Interval(min(prods), max(prods))


def _div_iv(a: Interval, b: Interval) -> Interval:
    # only the shape the index programs use: a known nonneg dividend over a
    # positive constant divisor (pos // block_size)
    if b.lo == b.hi and b.lo > 0 and a.lo >= 0 and a.known:
        c = b.lo
        hi = a.hi if a.hi == _INF else float(int(a.hi // c))
        return Interval(float(int(a.lo // c)), hi)
    return TOP


def _floordiv_iv(a: Interval, b: Interval) -> Interval:
    # any-sign dividend over a positive constant divisor
    if b.lo == b.hi and b.lo > 0 and a.known:
        c = b.lo
        lo = a.lo if a.lo == -_INF else float(math.floor(a.lo / c))
        hi = a.hi if a.hi == _INF else float(math.floor(a.hi / c))
        return Interval(lo, hi)
    return TOP


def _mod_iv(a: Interval, b: Interval) -> Interval:
    # Python-semantics mod (sign follows the divisor)
    if b.lo == b.hi and b.lo > 0:
        return Interval(0, b.lo - 1)
    return TOP


def _cmp_iv(prim: str, a: Interval, b: Interval) -> Interval:
    """Comparison result interval: [0,0]/[1,1] when the operand intervals
    decide it, else the unknown bool [0,1]."""
    if prim == "lt":
        if a.hi < b.lo:
            return Interval(1, 1)
        if a.lo >= b.hi:
            return Interval(0, 0)
    elif prim == "le":
        if a.hi <= b.lo:
            return Interval(1, 1)
        if a.lo > b.hi:
            return Interval(0, 0)
    elif prim == "gt":
        if a.lo > b.hi:
            return Interval(1, 1)
        if a.hi <= b.lo:
            return Interval(0, 0)
    elif prim == "ge":
        if a.lo >= b.hi:
            return Interval(1, 1)
        if a.hi < b.lo:
            return Interval(0, 0)
    elif prim == "eq":
        if a.lo == a.hi == b.lo == b.hi:
            return Interval(1, 1)
        if a.hi < b.lo or b.hi < a.lo:
            return Interval(0, 0)
    elif prim == "ne":
        if a.lo == a.hi == b.lo == b.hi:
            return Interval(0, 0)
        if a.hi < b.lo or b.hi < a.lo:
            return Interval(1, 1)
    return BOOL


def _rem_iv(a: Interval, b: Interval) -> Interval:
    # a truncating remainder's sign follows the dividend
    if b.lo == b.hi and b.lo > 0:
        c = b.lo
        hi = min(a.hi, c - 1) if a.hi < _INF else c - 1
        if a.lo >= 0:
            return Interval(0.0, max(0.0, hi))
        return Interval(-(c - 1), c - 1)
    return TOP


def _index_verdict(iv: Interval, allowed_hi: int) -> str:
    """Classify an index interval against ``[0, allowed_hi]``.

    ``"ok"`` — provably in bounds. ``"oob"`` — the violation is carried by
    a FINITE bound (a declared/derived range that genuinely reaches outside
    the operand). ``"unproven"`` — the only violating side is infinite:
    nothing was proven either way, so a half-declared contract (only ``lo``
    or only ``hi``) degrades to the same not-proven treatment as no
    contract at all instead of escalating to a gating ERROR."""
    if iv.lo >= 0 and iv.hi <= allowed_hi:
        return "ok"
    if iv.lo > allowed_hi or iv.hi < 0:
        return "oob"                    # EVERY possible value is outside
    if (iv.lo < 0 and iv.lo > -_INF) or (allowed_hi < iv.hi < _INF):
        return "oob"                    # a finite declared bound reaches out
    return "unproven"


# -- the walk over a traced program -------------------------------------------

#: ops whose result holds the values of their first tensor operand (a
#: view, a copy, a reordering): the interval passes through
_PASS = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "unsqueeze",
    "squeeze", "permute", "t", "transpose", "select", "slice", "detach",
    "alias", "clone", "contiguous", "flatten", "repeat", "narrow",
    "unbind", "split", "split_with_sizes", "chunk", "lift_fresh_copy",
    "lift_fresh", "movedim", "unfold", "as_strided", "index",
    "index_select", "gather", "take_along_dim", "roll", "flip", "cummax",
    "cummin", "amax", "amin", "max", "min", "sort", "msort", "unsqueeze_",
    "view_as", "_reshape_alias", "diagonal", "tril", "triu", "masked_select",
    "embedding", "squeeze_", "copy", "fill", "pad", "constant_pad_nd",
})
_CMP = {"lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "eq": "eq",
        "ne": "ne"}
_BOOL_OPS = frozenset({"logical_and", "logical_or", "logical_not",
                       "logical_xor", "isfinite", "isnan", "isinf",
                       "bitwise_not", "any", "all"})


def _iv_of_value(v) -> Interval:
    if isinstance(v, bool):
        return Interval(float(v), float(v))
    if isinstance(v, (int, float)):
        return Interval(float(v), float(v))
    return TOP


def _cast_iv(a: Interval, dtype) -> Interval:
    """A cast's result: a narrowing integer cast WRAPS, so the interval
    survives only when representable; a bool cast gives [0, 1]."""
    import torch
    if dtype is None:
        return a
    if dtype == torch.bool:
        return BOOL
    if not dtype.is_floating_point and not dtype.is_complex:
        info = torch.iinfo(dtype)
        if a.lo >= info.min and a.hi <= info.max:
            return a
        return TOP
    return a


class BoundsWalker:
    """One interval-propagation pass over a traced program's aten graph;
    findings accumulate on ``emit``."""

    def __init__(self, emit, program=None):
        self._emit = emit
        self.program = program
        self.iv: dict = {}            # node -> Interval or [Interval...]
        self._launch = 0

    # -- helpers ----------------------------------------------------------

    def read(self, a) -> Interval:
        from torch.fx import Node
        if isinstance(a, Node):
            v = self.iv.get(a, TOP)
            return v if isinstance(v, Interval) else TOP
        return _iv_of_value(a)

    @staticmethod
    def _shape(node):
        val = node.meta.get("val") if hasattr(node, "meta") else None
        return tuple(int(d) for d in getattr(val, "shape", ()))

    @staticmethod
    def _dtype(node):
        val = node.meta.get("val") if hasattr(node, "meta") else None
        return getattr(val, "dtype", None)

    def _const(self, node) -> Interval:
        """A ``get_attr`` constant's value range."""
        import torch
        t = getattr(self.program.gm, node.target, None) \
            if self.program is not None else None
        if isinstance(t, torch.Tensor) and t.numel() and not t.is_complex():
            v = t.detach().double()
            return Interval(float(v.min()), float(v.max()))
        return TOP

    # -- the walk ---------------------------------------------------------

    def run(self, program, in_ranges) -> None:
        from simple_distributed_machine_learning_tpu_torch.analysis.trace import (  # noqa: E501
            op_name,
        )
        self.program = program
        ranges = list(in_ranges or ())
        for i, node in enumerate(program.placeholders):
            r = ranges[i] if i < len(ranges) else None
            self.iv[node] = r if r is not None else TOP
        for node in program.graph.nodes:
            if node.op == "get_attr":
                self.iv[node] = self._const(node)
            elif node.op == "call_function":
                self.iv[node] = self._eqn(node, op_name(node))

    def _eqn(self, node, name: str):
        import operator
        args = node.args
        if node.target is operator.getitem:
            src = self.iv.get(args[0])
            if isinstance(src, list) and args[1] < len(src):
                return src[args[1]]
            return src if isinstance(src, Interval) else TOP
        base = name.split(".")[-1].rstrip("_") if "." in name else name
        ns = name.split(".")[0]
        ins = [self.read(a) for a in args]
        a = ins[0] if ins else TOP
        b = ins[1] if len(ins) > 1 else TOP
        if ns == "sdml":
            return self._kernel(node, name)
        if base in ("add", "sub", "rsub") and len(ins) >= 2:
            alpha = node.kwargs.get("alpha", 1)
            b = _mul_iv(b, Interval(alpha, alpha)) if alpha != 1 else b
            if base == "rsub":
                a, b = b, a
            if base == "add":
                return Interval(a.lo + b.lo, a.hi + b.hi)
            return Interval(a.lo - b.hi, a.hi - b.lo)
        if base == "mul" and len(ins) >= 2:
            return _mul_iv(a, b)
        if base in ("floor_divide",) or (base == "div" and node.kwargs.get(
                "rounding_mode") == "floor"):
            return _floordiv_iv(a, b)
        if base == "div" and node.kwargs.get("rounding_mode") == "trunc":
            return _div_iv(a, b) if a.lo >= 0 else TOP
        if base == "remainder":
            return _mod_iv(a, b)
        if base == "fmod":
            return _rem_iv(a, b)
        if base == "neg":
            return Interval(-a.hi, -a.lo)
        if base in ("clamp", "clamp_min", "clamp_max", "clip"):
            lo = (ins[1] if base in ("clamp", "clamp_min", "clip")
                  and len(ins) > 1 else Interval(-_INF, -_INF))
            hi = (ins[2] if base in ("clamp", "clip") and len(ins) > 2
                  else ins[1] if base == "clamp_max" else
                  Interval(_INF, _INF))
            if base == "clamp" and node.kwargs:
                lo = _iv_of_value(node.kwargs.get("min", -_INF))
                hi = _iv_of_value(node.kwargs.get("max", _INF))
            if lo == TOP:
                lo = Interval(-_INF, -_INF)
            if hi == TOP:
                hi = Interval(_INF, _INF)
            m = Interval(max(a.lo, lo.lo), max(a.hi, lo.hi))
            return Interval(min(m.lo, hi.lo), min(m.hi, hi.hi))
        if base in ("maximum", "max") and len(ins) == 2 \
                and not isinstance(args[1], int):
            return Interval(max(a.lo, b.lo), max(a.hi, b.hi))
        if base in ("minimum", "min") and len(ins) == 2 \
                and not isinstance(args[1], int):
            return Interval(min(a.lo, b.lo), min(a.hi, b.hi))
        if base == "abs":
            if a.lo >= 0:
                return a
            return Interval(0, max(abs(a.lo), abs(a.hi)))
        if base in _CMP:
            return _cmp_iv(_CMP[base], a, b)
        if base in _BOOL_OPS:
            return BOOL
        if base == "where" and len(ins) == 3:
            c, x, y = ins
            if c.lo == c.hi == 1:
                return x
            if c.lo == c.hi == 0:
                return y
            return x | y
        if base in ("arange",):
            nums = [v for v in args if isinstance(v, (int, float))]
            if len(nums) == 1:
                return Interval(0, max(0, nums[0] - 1))
            if len(nums) >= 2:
                step = nums[2] if len(nums) > 2 else 1
                if step > 0:
                    return Interval(nums[0], max(nums[0], nums[1] - 1))
            return TOP
        if base in ("zeros", "zeros_like", "new_zeros"):
            return Interval(0, 0)
        if base in ("ones", "ones_like", "new_ones"):
            return Interval(1, 1)
        if base in ("full", "new_full", "full_like", "fill", "scalar_tensor"):
            v = args[1] if base in ("full", "new_full", "full_like",
                                    "fill") and len(args) > 1 else (
                args[0] if args else None)
            return _iv_of_value(v)
        if base in ("_to_copy", "to", "type_as", "_convert_element_type"):
            return _cast_iv(a, node.kwargs.get("dtype", self._dtype(node)))
        if base in ("argmax", "argmin"):
            shape = self._shape(args[0])
            dim = args[1] if len(args) > 1 and isinstance(args[1], int) \
                else node.kwargs.get("dim")
            size = (shape[dim] if dim is not None and shape
                    else max(1, _prod(shape)))
            return Interval(0, max(0, size - 1))
        if base in ("topk", "sort", "max", "min", "kthvalue", "mode",
                    "median") and isinstance(node.meta.get("val"),
                                             (tuple, list)):
            shape = self._shape(args[0])
            dim = -1
            if base != "topk" and len(args) > 1 and isinstance(args[1],
                                                                 int):
                dim = args[1]
            size = shape[dim] if shape else 1
            return [a, Interval(0, max(0, size - 1))]
        if base in ("cat", "stack"):
            parts = [self.read(t) for t in (args[0] if args else [])]
            out = parts[0] if parts else TOP
            for p in parts[1:]:
                out = out | p
            return out
        # the index ops: check, then pass the source's values through
        if base in ("index", "_unsafe_index"):
            self._check_index(node, args[0], args[1], "index")
            return a
        if base == "index_put":
            self._check_index(node, args[0], args[1], "index_put_")
            return a | (ins[2] if len(ins) > 2 else TOP)
        if base in ("index_select", "gather", "index_copy", "index_add",
                    "index_fill", "scatter", "scatter_add", "scatter_reduce",
                    "take_along_dim"):
            dim = args[1]
            self._check_dim_index(node, args[0], dim, args[2], base)
            if base in ("index_select", "gather", "take_along_dim"):
                return a
            if base in ("scatter", "index_copy", "index_fill"):
                return a | (self.read(args[3]) if len(args) > 3 else TOP)
            return TOP
        if base == "embedding":
            self._check_dim_index(node, args[0], 0, args[1], "embedding")
            return a
        if base in ("select",) and len(args) >= 3 and isinstance(args[2],
                                                                int):
            return a
        if base in _PASS:
            return a
        if base == "copy" and len(ins) >= 2:
            return b
        if isinstance(node.meta.get("val"), (tuple, list)):
            return [TOP] * len(node.meta["val"])
        return TOP

    # -- the checks -------------------------------------------------------

    def _verdict(self, node, what, k, dim, iv, size, mode="") -> None:
        allowed_hi = int(size) - 1
        verdict = _index_verdict(iv, allowed_hi)
        if verdict == "oob":
            self._flag(node, what, k, dim, iv, allowed_hi)
        elif verdict == "unproven":
            self._flag_unproven(node, what)

    def _check_index(self, node, src, indices, what: str) -> None:
        shape = self._shape(src)
        for k, idx in enumerate(indices or ()):
            if idx is None or k >= len(shape):
                continue
            if self._dtype(idx) is not None and self._dtype(idx).is_floating_point:
                continue
            if str(self._dtype(idx)) == "torch.bool":
                continue
            self._verdict(node, what, k, k, self.read(idx), shape[k])

    def _check_dim_index(self, node, src, dim, idx, what: str) -> None:
        shape = self._shape(src)
        if not shape or not isinstance(dim, int):
            return
        self._verdict(node, what, 0, dim % len(shape), self.read(idx),
                      shape[dim])

    def _kernel(self, node, name: str):
        """A kernel node: its launch spec (noted in graph order) with the
        contracts its table inputs carry, linted by ``kernels.lint``."""
        from simple_distributed_machine_learning_tpu_torch.analysis import (
            kernels,
        )
        launches = self.program.launches if self.program is not None else []
        if self._launch < len(launches):
            spec_ = launches[self._launch]
            self._launch += 1
            ranges = {}
            for tname, _ in spec_.tables:
                arg = _kernel_arg(node, tname)
                if arg is not None:
                    iv = self.read(arg)
                    ranges[tname] = (None if iv.lo == -_INF else iv.lo,
                                     None if iv.hi == _INF else iv.hi)
            spec_ = spec_.with_contracts(**ranges) if ranges else spec_
            for f in kernels.lint(spec_):
                self._emit(dataclasses.replace(
                    f, where=f"{node.name} ({f.where})"))
        val = node.meta.get("val")
        if isinstance(val, (tuple, list)):
            return [TOP] * len(val)
        return TOP

    def _flag(self, node, what, comp, dim, iv, allowed_hi) -> None:
        from simple_distributed_machine_learning_tpu_torch.analysis.report import (  # noqa: E501
            Finding,
            Severity,
        )
        lo = "-inf" if iv.lo == -_INF else int(iv.lo)
        hi = "inf" if iv.hi == _INF else int(iv.hi)
        shape = self._shape(node.args[0])
        self._emit(Finding(
            rule="scatter-bounds.out-of-range", severity=Severity.ERROR,
            message=(f"{what} index component {comp} into operand dim {dim} "
                     f"(shape {shape}) has range [{lo}, {hi}] but only "
                     f"[0, {allowed_hi}] is addressable — on the card an "
                     f"out-of-range index is a device-side assert, and "
                     f"inside a kernel it reads or writes another "
                     f"request's memory"),
            where=_where(node),
            hint="tighten the producing arithmetic or the declared input "
                 "contract (analysis.bounds.spec) so the index interval "
                 "fits; for K/V writes this is the slots.py block/position "
                 "discipline the program must not outrun"))

    def _flag_unproven(self, node, what: str) -> None:
        from simple_distributed_machine_learning_tpu_torch.analysis.report import (  # noqa: E501
            Finding,
            Severity,
        )
        self._emit(Finding(
            rule="scatter-bounds.unproven-promise", severity=Severity.WARNING,
            message=(f"{what} takes an index whose interval could not be "
                     f"bounded — an out-of-range value here stops the "
                     f"program (a device-side assert on the card)"),
            where=_where(node),
            hint="declare the index-bearing input's range via "
                 "analysis.bounds.spec (or clamp in-program) so the "
                 "access is provable"))


def _prod(shape) -> int:
    out = 1
    for d in shape:
        out *= int(d)
    return out


#: a kernel op's positional argument of each launch-spec table
_KERNEL_TABLE_ARGS = {"tables": 3, "qpos": 4}


def _kernel_arg(node, table: str):
    i = _KERNEL_TABLE_ARGS.get(table)
    if i is None or i >= len(node.args):
        return None
    return node.args[i]


def _where(node) -> str:
    from simple_distributed_machine_learning_tpu_torch.analysis.trace import (
        op_name,
        source_line,
    )
    src = source_line(node)
    loc = f"{node.name} [{op_name(node)}]"
    return f"{loc} ({src})" if src else loc


def check_bounds(program, in_ranges) -> list:
    """Run the interval pass over a traced program given declared input
    ranges (aligned with its placeholders; ``None`` = unknown). Returns
    scatter-bounds (and kernel) findings; an empty list is a PROOF
    relative to the declared contract, not an absence of checking."""
    findings: list = []
    BoundsWalker(findings.append).run(program, in_ranges)
    return findings
