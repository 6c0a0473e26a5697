"""Tracing helpers of the program linter (port of ``analysis/trace.py``).

The JAX linter traces a step to a ``ClosedJaxpr``. The port's counterpart
of a program is the function a builder or step factory returns; the linter
never runs it on data. :func:`trace_program` traces it with
``torch.fx.experimental.proxy_tensor.make_fx`` on ``FakeTensor`` stand-ins
(:func:`abstractify`): the result is an aten ``fx.Graph`` — zero FLOPs, no
device buffers, nothing launched — plus what the graph cannot show:

- **collectives** (:class:`Collective`). In one process most of the
  port's collectives are list rotations and local adds, and across
  processes gloo staged through the host cannot run on fake tensors. So
  every collective site (``parallel/mesh.py``, ``tensor.py``,
  ``overlap.py``, ``pipeline.py``, ``expert.py``, ``sequence.py``) calls
  :func:`note_collective` beside its arithmetic, and inside a trace the
  cross-process wire (:func:`~..parallel.mesh.send`, ``recv``,
  ``all_reduce``, ...) only notes: it moves nothing. Outside a trace a
  note returns at once;
- **coordinates** (:func:`note_vary`): where a program hands one mesh
  coordinate its own slice of an input (a replica's rows, a seq chunk,
  a shard's parameters), the slice is seeded with that coordinate's axes
  for the replication analysis (``rules.py``);
- **sums that move no bytes** (:func:`note_replicated`): a value that is
  the same on every coordinate of an axis although nothing crossed a
  wire for it — the equal per-shard copies of a replicated leaf once
  tied (``tensor.tie``), and in one process the backward sum of the
  shards' input gradients, which is autograd's own accumulation
  (``tensor.grad_sync``);
- **claims** (:func:`note_claim`): a gradient that must be the same on
  every coordinate of an axis — a replicated leaf's of a stage sharded
  over that axis (``Pipeline._reduce_grads``); the rules flag it when it
  still varies there;
- **kernel launches**: the kernel wrappers K1-K4 meet a fake tensor as a
  ``torch.library`` custom op (``sdml::...``) whose fake implementation
  returns the output's shape, so each launch is one graph node, and note
  its :class:`~.kernels.LaunchSpec` (``kernels.note``) as a real launch
  does.

:class:`Program` holds the graph, its placeholders (one per tensor leaf of
the arguments, parameters of ``nn.Module`` trees included) and the notes.
Torch only: no JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import sys
from typing import Any, Callable

import torch

# collectives the lint passes care about, by the JAX package's primitive
# names; ``send``/``recv`` are the port's point-to-point wire across
# processes (one half of a ppermute each)
COLLECTIVE_PRIMS = frozenset({
    "psum", "pmin", "pmax", "ppermute", "pbroadcast",
    "all_gather", "all_to_all", "reduce_scatter", "axis_index",
    "send", "recv",
})
# collectives that are a cross-device rendezvous (axis_index is free)
RENDEZVOUS_PRIMS = COLLECTIVE_PRIMS - {"axis_index"}

#: files of the collective sites: a note's ``where`` is the first frame
#: outside them
_SITE_FILES = tuple(os.path.join("parallel", f) for f in (
    "mesh.py", "tensor.py", "overlap.py")) + (os.path.join(
        "analysis", "trace.py"),)


@dataclasses.dataclass
class Collective:
    """One noted collective: the primitive, the mesh axes it runs over,
    the group's size, the bytes of ONE coordinate's operand
    (``payload``), its dtype, the graph nodes of the tensors it took and
    gave (None outside a graph), and per primitive: ``offset`` (a ring
    permute's), ``pairs`` (an explicit permutation), ``peer``/``tag`` (a
    send's destination or a recv's source rank), ``ranks`` (the process
    group). ``site`` is the port's function, ``where`` the caller's
    ``file:line``. A ``summary`` note states what a composite (a ring of
    noted hops) computes, for the replication analysis only: its bytes
    are its hops'."""
    prim: str
    axes: tuple
    group_size: int
    payload: int
    dtype: Any
    ins: tuple
    outs: tuple
    site: str
    where: str
    offset: int | None = None
    pairs: tuple | None = None
    peer: int | None = None
    tag: int | None = None
    ranks: tuple = ()
    index: int = 0
    summary: bool = False


class Recorder:
    """The notes of one trace."""

    def __init__(self):
        self.events: list[Collective] = []
        self.seeds: list[tuple[Any, frozenset]] = []
        self.joins: list[tuple[Any, frozenset]] = []
        self.claims: list[tuple[Any, frozenset, str]] = []


#: the open recorder, or None; every note tests it once
_recorder: Recorder | None = None


def active() -> bool:
    """True inside :func:`trace_program`: the collective sites note and
    the cross-process wire moves nothing."""
    return _recorder is not None


def _node(t):
    """The graph node of tensor ``t`` in the current trace, else None."""
    if not isinstance(t, torch.Tensor):
        return None
    from torch.fx.experimental import proxy_tensor as pt
    mode = pt.get_proxy_mode()
    if mode is None:
        return None
    slot = pt.get_proxy_slot(t, mode.tracer, None)
    proxy = getattr(slot, "proxy", None)
    return getattr(proxy, "node", None)


def caller_where() -> str:
    """``file:line`` of the site's caller: the first frame past the
    noting site that lies outside the collective modules."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename.endswith(
            os.path.join("analysis", "trace.py")):
        f = f.f_back
    f = f.f_back if f is not None else None     # past the site itself
    while f is not None and f.f_code.co_filename.endswith(_SITE_FILES):
        f = f.f_back
    if f is None:
        return ""
    path = f.f_code.co_filename
    parts = path.split(os.sep)
    short = os.sep.join(parts[-2:]) if len(parts) >= 2 else path
    return f"{short}:{f.f_lineno}"


def tensor_bytes(t) -> int:
    if not isinstance(t, torch.Tensor):
        return 0
    return int(t.numel()) * int(t.element_size())


def note_collective(prim: str, axes, group_size: int, ins, outs, *,
                    site: str, offset: int | None = None, pairs=None,
                    peer: int | None = None, tag: int | None = None,
                    ranks=(), summary: bool = False) -> None:
    """A collective site's note (a no-op outside a trace). ``ins`` and
    ``outs`` are its tensors, one per coordinate this process holds;
    the payload is one coordinate's operand, as the JAX cost table counts
    one device's."""
    rec = _recorder
    if rec is None:
        return
    ins = [t for t in (ins if isinstance(ins, (list, tuple)) else [ins])
           if isinstance(t, torch.Tensor)]
    outs = [t for t in (outs if isinstance(outs, (list, tuple))
                        else [outs]) if isinstance(t, torch.Tensor)]
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    first = ins[0] if ins else (outs[0] if outs else None)
    rec.events.append(Collective(
        prim=prim, axes=axes, group_size=int(group_size),
        payload=tensor_bytes(first),
        dtype=None if first is None else first.dtype,
        ins=tuple(_node(t) for t in ins),
        outs=tuple(_node(t) for t in outs), site=site,
        where=caller_where(), offset=offset,
        pairs=None if pairs is None else tuple(map(tuple, pairs)),
        peer=peer, tag=tag, ranks=tuple(ranks or ()),
        index=len(rec.events), summary=summary))


def _noted(tensors, axes) -> tuple[list, frozenset]:
    """The graph nodes of ``tensors`` (one tensor or a list; those outside
    the trace dropped) and ``axes`` (one name or several) as a set."""
    axes = frozenset((axes,) if isinstance(axes, str) else axes)
    ts = tensors if isinstance(tensors, (list, tuple)) else [tensors]
    nodes = [n for n in map(_node, ts) if n is not None]
    return (nodes if axes else []), axes


def note_vary(tensors, axes) -> None:
    """Seed ``tensors`` (one coordinate's own inputs) with the mesh axes
    they differ over, for the replication analysis."""
    rec = _recorder
    if rec is None:
        return
    nodes, axes = _noted(tensors, axes)
    rec.seeds.extend((n, axes) for n in nodes)


def note_replicated(tensors, axes) -> None:
    """Note ``tensors`` as the same on every coordinate of ``axes``: a
    sum over the axis that moves no bytes, so it is neither billed nor a
    rendezvous — for the replication analysis only."""
    rec = _recorder
    if rec is None:
        return
    nodes, axes = _noted(tensors, axes)
    rec.joins.extend((n, axes) for n in nodes)


def note_claim(tensors, axes, what: str = "") -> None:
    """Claim ``tensors`` replicated over ``axes``: the rules flag each
    one that still varies over one of them (``what`` names it in the
    finding)."""
    rec = _recorder
    if rec is None:
        return
    nodes, axes = _noted(tensors, axes)
    rec.claims.extend((n, axes, what) for n in nodes)


# -- fake stand-ins ---------------------------------------------------------

_PACKAGE = __name__.split(".")[0]

_MODE = None


def fake_mode():
    """The one ``FakeTensorMode`` every abstract argument belongs to."""
    global _MODE
    if _MODE is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        _MODE = FakeTensorMode(allow_non_fake_inputs=True)
    return _MODE


def is_fake(t) -> bool:
    """True for a ``FakeTensor`` (a traced program's stand-in): a kernel
    wrapper meeting one adds its graph node instead of launching."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def shape_dtype(x):
    """A fake stand-in for tensor ``x`` (same shape, dtype, device and
    ``requires_grad``); an ``ArgSpec`` gives a fresh one on its device
    (None: the CPU), a (shape, dtype) pair one on the CPU."""
    mode = fake_mode()
    if is_fake(x):
        return x
    if isinstance(x, torch.Tensor):
        with torch.no_grad():
            fake = mode.from_tensor(x.detach())
        if x.requires_grad:
            fake.requires_grad_(True)
        return fake
    shape, dtype = (x.shape, x.dtype) if hasattr(x, "shape") else x
    device = getattr(x, "device", None) or "cpu"
    with mode:
        return torch.empty(tuple(shape), dtype=_torch_dtype(dtype),
                           device=device)


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    import numpy as np
    return getattr(torch, np.dtype(dtype).name)


def _map(obj, fn, memo: dict | None, module_fn=None):
    """``obj`` with every tensor leaf ``t`` replaced by ``fn(t)``: lists,
    tuples and dicts are rebuilt (their subclasses and attributes kept),
    dataclasses replaced field by field, ``nn.Module`` trees swapped slot
    by slot in place — or, with ``module_fn``, replaced by
    ``module_fn(module)``; a tensor seen twice maps once (``memo`` by id;
    None: every occurrence)."""
    def sub(v):
        return _map(v, fn, memo, module_fn)

    if isinstance(obj, torch.Tensor):
        if memo is None:                # every occurrence, no dedupe
            return fn(obj)
        key = id(obj)
        if key not in memo:
            memo[key] = fn(obj)
        return memo[key]
    if isinstance(obj, torch.nn.Module):
        if module_fn is not None:
            return module_fn(obj)
        for mod in obj.modules():
            for slots in (mod._parameters, mod._buffers):
                for k, v in list(slots.items()):
                    if v is not None:
                        slots[k] = sub(v)
        return obj
    if isinstance(obj, list):
        out = copy.copy(obj)
        out[:] = [sub(v) for v in obj]
        return out
    if isinstance(obj, tuple):
        items = [sub(v) for v in obj]
        return (type(obj)(*items) if hasattr(obj, "_fields")
                else type(obj)(items))
    if isinstance(obj, dict):
        out = copy.copy(obj)
        for k in obj:
            out[k] = sub(obj[k])
        return out
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = {f.name: sub(getattr(obj, f.name))
                  for f in dataclasses.fields(obj) if f.init}
        return dataclasses.replace(obj, **fields)
    if type(obj).__module__.startswith(_PACKAGE) \
            and hasattr(obj, "__dict__") and not callable(obj):
        # a state object of the port's own (a ZeRO-1 state): its
        # attributes, copied shallowly
        out = copy.copy(obj)
        for k, v in vars(obj).items():
            setattr(out, k, sub(v))
        return out
    return obj


def _unspec(obj):
    """``analysis.spec`` contracts as fake stand-ins of their shape and
    dtype (the contract itself is ``analyze``'s to read)."""
    from simple_distributed_machine_learning_tpu_torch.analysis.bounds import (
        ArgSpec,
    )
    if isinstance(obj, ArgSpec):
        return shape_dtype(obj)
    if type(obj) in (list, tuple):
        return type(obj)(_unspec(v) for v in obj)
    if type(obj) is dict:
        return {k: _unspec(v) for k, v in obj.items()}
    return obj


def abstractify(tree):
    """The tree with every tensor a fake stand-in (:func:`shape_dtype`):
    modules are copied without copying a parameter's storage, so nothing
    is allocated on any device; an ``analysis.spec`` becomes a fake of
    its shape and dtype."""
    tree = _unspec(tree)
    fakes: dict = {}         # id of a parameter or buffer -> its stand-in
    copies: dict = {}        # id of a module -> its copy

    def fake_module(m):
        # deepcopy with every parameter and buffer pre-mapped to its fake
        if id(m) not in copies:
            memo = {}
            for t in list(m.parameters()) + list(m.buffers()):
                if id(t) not in fakes:
                    fakes[id(t)] = _fake_param(t)
                memo[id(t)] = fakes[id(t)]
            copies[id(m)] = copy.deepcopy(m, memo)
        return copies[id(m)]

    return _map(tree, shape_dtype, {}, module_fn=fake_module)


def _fake_param(t):
    fake = shape_dtype(t)
    if isinstance(t, torch.nn.Parameter):
        return torch.nn.Parameter(fake, requires_grad=t.requires_grad)
    return fake


# -- the trace ---------------------------------------------------------------

@dataclasses.dataclass
class Program:
    """One traced program: the aten graph, its placeholders (aligned with
    the flat tensor leaves of the arguments), the collectives, coordinate
    seeds, replicated values and claims its sites noted, and the launch
    specs of its kernel nodes (in graph order)."""
    name: str
    gm: Any
    placeholders: list
    events: list
    seeds: list
    launches: list
    joins: list = dataclasses.field(default_factory=list)
    claims: list = dataclasses.field(default_factory=list)

    @property
    def graph(self):
        return self.gm.graph


def flat_tensors(tree, once: bool = True) -> list:
    """The tensor leaves of ``tree`` in :func:`_map`'s order, once each
    (``once=False``: every occurrence)."""
    out: list = []
    _map(tree, lambda t: out.append(t) or t, {} if once else None)
    return out


def trace_program(fn: Callable, *args, name: str = "", **kwargs) -> Program:
    """Trace ``fn(*args, **kwargs)`` to an aten graph on fake stand-ins
    (``args`` from :func:`abstractify`; real tensors are made fake
    first). Raises whatever tracing raises: ``analyze`` turns that into
    a finding."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from simple_distributed_machine_learning_tpu_torch.analysis import (
        kernels,
    )
    global _recorder
    tree = abstractify((list(args), dict(kwargs)))
    leaves = flat_tensors(tree)

    def program(*flat):
        it = iter(flat)
        return fn_on(_map(tree, lambda t: next(it), {}))

    def fn_on(t):
        a, kw = t
        # the graph's outputs: the result's tensor leaves (a module's
        # parameters included), once each
        return tuple(flat_tensors(fn(*a, **kw)))

    outer, rec = _recorder, Recorder()
    _recorder = rec
    try:
        with kernels.record_launches() as launches, fake_mode(), \
                _NoGenerators():
            gm = make_fx(program, tracing_mode="real",
                         record_stack_traces=False)(*leaves)
    finally:
        _recorder = outer
        # the modules of ``tree`` hold graph proxies' fakes now: put the
        # stand-ins back, so a second trace starts from them
        it = iter(leaves)
        _map(tree, lambda t: next(it), {})
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    return Program(name=name or getattr(fn, "__name__", "") or "program",
                   gm=gm, placeholders=placeholders, events=rec.events,
                   seeds=rec.seeds, launches=list(launches),
                   joins=rec.joins, claims=rec.claims)


class _NoGenerators(torch.overrides.TorchFunctionMode):
    """Drop the ``generator=`` of random draws inside a trace: a graph
    cannot hold a generator object, and a fake draw reads no state — the
    program's shapes are the same from any generator."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if kwargs.get("generator") is not None:
            kwargs = {k: v for k, v in kwargs.items() if k != "generator"}
        return func(*args, **kwargs)


def all_primitives(program: Program) -> frozenset:
    """Every aten/custom op name in a traced program, plus the noted
    collectives' primitives — the coverage audit the serve-registry test
    pins."""
    out = {op_name(n) for n in program.graph.nodes
           if n.op == "call_function"}
    out.update(e.prim for e in program.events)
    return frozenset(out)


def op_name(node) -> str:
    """``aten.index_put_``/``sdml.paged_attention``: a node's op without
    its overload."""
    t = node.target
    name = getattr(t, "name", None)
    if callable(name):
        full = name()                   # "aten::index_put_" / overload
        base = full.split(".")[0].replace("::", ".")
        return base
    return getattr(t, "__name__", str(t))


def source_line(node) -> str:
    """The last user frame of a node's recorded stack trace, else ''."""
    st = getattr(node, "meta", {}).get("stack_trace") or ""
    lines = [ln.strip() for ln in st.splitlines()
             if ln.strip().startswith("File ")]
    return lines[-1] if lines else ""


def node_val(node):
    """A node's fake value (``meta['val']``), or None."""
    return getattr(node, "meta", {}).get("val")


def is_low_precision(dtype) -> bool:
    """True for dtypes that silently drop accumulation increments well
    before fp32 does (the dtype-drift rule's definition of '<fp32')."""
    return dtype in (torch.bfloat16, torch.float16, torch.float8_e4m3fn,
                     torch.float8_e5m2)
