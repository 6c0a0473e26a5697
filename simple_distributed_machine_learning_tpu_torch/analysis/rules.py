"""The lint passes over a traced program (port of ``analysis/rules.py``).

The JAX walker visits a ``ClosedJaxpr``'s equations. The port's program
is an aten graph plus the collectives its sites noted
(``trace.trace_program``), so the walk reads both, in graph order,
carrying:

- a **replication environment** (the JAX ``_visit_vma`` lattice): for
  every graph node, the mesh axes its value may VARY over. In one process
  each coordinate's tensors are separate objects, so the seeds come from
  the coordinates instead of ``in_names``: a replica's rows and a seq
  chunk (``trace.note_vary`` at the site that slices them), a shard's
  parameters (``Pipeline._replica_params``: every leaf of a shard, as the
  JAX buffer's ``in_specs`` map the model or expert axis over a whole
  shard row), an argument declared ``spec(..., vary=(...))``. An aten
  op's value varies over the union of its inputs'; a noted
  ``psum``/``all_gather`` over an axis removes it,
  ``all_to_all``/``reduce_scatter``/``pbroadcast`` add it, a permute
  keeps it, and so does a sum that moves no bytes
  (``trace.note_replicated``: a tie of a replicated leaf's equal
  per-shard copies, and in one process the backward sum of the shards'
  input gradients). A value that is written into a parameter or state
  buffer in place, or returned, while it still varies over a replica
  axis (``data``, ``seq``) the buffer was not declared sharded over is a
  dropped reduction: ``unreduced-gradient.missing-reduce`` (re-tagged
  ``sharded-state.missing-gather`` when only a declared shard makes it
  vary, as in JAX). So is a claimed value that still varies over its
  claim's axes (``trace.note_claim``): the gradient of each replicated
  leaf of a stage sharded over the ``model`` or ``expert`` axis, claimed
  over that axis — the JAX rule flags any axis of size > 1 left in a
  value its ``out_specs`` claim replicated, those two included;
- the **cost table**: one :class:`~.report.CollectiveCost` row per noted
  call (JAX's ``_ici_factor``, copied as it is; a ``recv`` is billed at
  its ``send``).

The other families:

- ``ppermute-deadlock`` — a permutation that is not a bijection
  (``partial-perm``: explicit pairs with sources or destinations missing,
  or across processes a send no rank receives / a receive no rank sends),
  and **branch divergence**: the members of one process group issuing
  different collective sequences (:func:`check_ranks` compares the traced
  steps of every rank, coordinate by coordinate);
- ``mesh-axis`` — a collective over an axis the active mesh does not bind
  at the group's width (``unknown-axis``), a group wider than the mesh's
  axis (``mesh-mismatch``), a ring offset outside the axis
  (``perm-out-of-range``);
- ``dtype-drift`` — a summing collective over bf16/f16 operands
  (``low-precision-reduction``) and an unrolled running sum carried in
  sub-fp32 (``low-precision-carry``: a chain of at least
  :data:`CARRY_STEPS` adds whose addend does not depend on the
  accumulator — a loop the trace unrolled; shorter chains are the
  backward's sums of a value's few uses);
- ``donation`` — the port updates buffers in place where JAX donates
  them, so ``read-after-donate`` is a read, after an in-place write, of
  an alias (a view) of the written storage taken before the write and
  not the one written through (it holds the new bytes where the program
  meant the old); ``double-donation`` one buffer passed at two argument
  positions of a program that writes it in place.
"""

from __future__ import annotations

import dataclasses

import torch

from simple_distributed_machine_learning_tpu_torch.analysis.report import (
    CollectiveCost,
    Finding,
    Severity,
)
from simple_distributed_machine_learning_tpu_torch.analysis.trace import (
    RENDEZVOUS_PRIMS,
    is_low_precision,
    node_val,
    op_name,
    source_line,
)

EMPTY: frozenset = frozenset()
#: chained low-precision accumulation steps that make a running sum
CARRY_STEPS = 8
#: the axes every parameter is replicated over: a value still varying
#: over one of them when it lands in a parameter is a missing reduction
#: (the replicated leaves of a sharded stage are claimed over its
#: ``model`` or ``expert`` axis besides, leaf by leaf: ``trace.note_claim``)
REPLICA_AXES = ("data", "seq")
#: ops whose result aliases their first operand's storage
VIEW_OPS = frozenset({
    "aten.view", "aten._unsafe_view", "aten.expand", "aten.unsqueeze",
    "aten.squeeze", "aten.permute", "aten.t", "aten.transpose",
    "aten.select", "aten.slice", "aten.detach", "aten.alias",
    "aten.as_strided", "aten.narrow", "aten.diagonal", "aten.unfold",
    "aten.view_as", "aten._reshape_alias", "aten.split", "aten.unbind",
    "aten.split_with_sizes", "aten.chunk", "aten.movedim",
})


# traffic factor over an axis group of n devices: bytes actually moved per
# operand byte by the standard ring algorithm for each collective kind
def _ici_factor(prim: str, n: int) -> float:
    if n <= 1:
        return 0.0
    return {
        "psum": 2.0 * (n - 1) / n,           # reduce-scatter + all-gather
        "pmin": 2.0 * (n - 1) / n,
        "pmax": 2.0 * (n - 1) / n,
        "all_gather": float(n - 1),           # (n-1) shards arrive
        "reduce_scatter": (n - 1) / n,
        "all_to_all": (n - 1) / n,            # keeps 1/n locally
        "ppermute": 1.0,                      # one hop, whole payload
        "pbroadcast": 1.0,
    }.get(prim, 1.0)


def is_mutation(node) -> bool:
    """An in-place aten node (its schema writes an argument)."""
    schema = getattr(node.target, "_schema", None)
    return node.op == "call_function" and bool(
        schema is not None and schema.is_mutable)


def _node_args(node) -> list:
    from torch.fx import Node
    out = []

    def walk(a):
        if isinstance(a, Node):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            for x in a:
                walk(x)
        elif isinstance(a, dict):
            for x in a.values():
                walk(x)
    walk(node.args)
    walk(node.kwargs)
    return out


def _storage(node):
    val = node_val(node)
    if not isinstance(val, torch.Tensor):
        return None
    try:
        from torch.multiprocessing.reductions import StorageWeakRef
        return StorageWeakRef(val.untyped_storage())
    except Exception:  # noqa: BLE001 - a value without storage
        return None


class Walker:
    """One pass over a traced program, accumulating findings and costs."""

    def __init__(self, program, active_mesh=None):
        self.p = program
        self.active_mesh = active_mesh
        self.findings: list[Finding] = []
        self.costs: list[CollectiveCost] = []
        self.order = {n: i for i, n in enumerate(program.graph.nodes)}

    # -- plumbing ---------------------------------------------------------

    def _where(self, node=None, event=None) -> str:
        if event is not None:
            return f"{event.site} ({event.where})" if event.where \
                else event.site
        if node is None:
            return self.p.name
        src = source_line(node)
        loc = f"{node.name} [{op_name(node)}]"
        return f"{loc} ({src})" if src else loc

    def _emit(self, rule, severity, message, node=None, event=None,
              hint="") -> None:
        self.findings.append(Finding(rule=rule, severity=severity,
                                     message=message,
                                     where=self._where(node, event),
                                     hint=hint))

    def _axis_sizes(self) -> dict:
        sizes: dict = {}
        if self.active_mesh is not None:
            sizes.update({k: int(v) for k, v in
                          dict(self.active_mesh.shape).items()})
        for e in self.p.events:
            if len(e.axes) == 1 and e.axes[0] not in sizes:
                sizes[e.axes[0]] = e.group_size
        return sizes

    # -- the replication analysis ------------------------------------------

    def vary(self, in_vary=None) -> dict:
        """Each node's varying axes, from the seeds and the noted
        collectives."""
        env: dict = {}
        seeds: dict = {}
        for node, axes in self.p.seeds:
            seeds[node] = seeds.get(node, EMPTY) | axes
        for node, v in zip(self.p.placeholders, in_vary or ()):
            if v:
                seeds[node] = seeds.get(node, EMPTY) | frozenset(v)
        joins: dict = {}
        for node, axes in self.p.joins:
            joins[node] = joins.get(node, EMPTY) | axes
        outs: dict = {}
        for e in self.p.events:
            for o in e.outs:
                if o is not None:
                    outs.setdefault(o, []).append(e)
        for node in self.p.graph.nodes:
            if node.op == "output":
                continue
            v = EMPTY
            for a in _node_args(node):
                v |= env.get(a, EMPTY)
            v |= seeds.get(node, EMPTY)
            for e in outs.get(node, ()):
                ins = EMPTY
                for i in e.ins:
                    if i is not None:
                        ins |= env.get(i, EMPTY)
                axes = frozenset(e.axes)
                if e.prim in ("psum", "pmin", "pmax", "all_gather"):
                    v = (ins or v) - axes
                elif e.prim in ("all_to_all", "reduce_scatter",
                                "pbroadcast"):
                    v = v | ins | axes
            env[node] = v - joins.get(node, EMPTY)
        return env

    def check_replication(self, in_vary=None, placeholder_vary=None) -> None:
        env = self.vary(in_vary)
        sizes = self._axis_sizes()
        replica = {a for a in REPLICA_AXES if sizes.get(a, 2) > 1}
        declared: dict = {}
        for node, axes in self.p.seeds:
            if node.op == "placeholder":
                declared[node] = declared.get(node, EMPTY) | axes
        for node, v in zip(self.p.placeholders, in_vary or ()):
            if v:
                declared[node] = declared.get(node, EMPTY) | frozenset(v)
        seen: set = set()

        def missing_reduce(node, missing, what):
            val = node_val(node)
            shape = tuple(getattr(val, "shape", ()))
            self._emit(
                "unreduced-gradient.missing-reduce", Severity.ERROR,
                f"{what} (shape {shape}) still varies over mesh axis(es) "
                f"{missing} but lands in replicated state — a "
                f"cross-coordinate reduction is missing on this path (each "
                f"coordinate would keep only its own partial value, e.g. "
                f"an unsynced gradient)", node,
                hint=f"sum (model_sum / axis_mean / all_reduce) over "
                     f"{missing} before the update, or declare the buffer "
                     f"sharded over it")

        def claim(node, target, what):
            base = self.base(target)
            allowed = declared.get(base, EMPTY) if base is not None \
                else EMPTY
            missing = sorted(a for a in env.get(node, EMPTY) - allowed
                             if a in replica)
            key = (base if base is not None else node, tuple(missing))
            if not missing or key in seen:
                return
            seen.add(key)
            missing_reduce(node, missing, what)

        for node in self.p.graph.nodes:
            if is_mutation(node) and node.args:
                base = self.base(node.args[0])
                if base is not None and base.op == "placeholder":
                    claim(node, node.args[0],
                          f"in-place update '{op_name(node)}' of input "
                          f"'{base.name}'")
        out = next(n for n in self.p.graph.nodes if n.op == "output")
        for i, o in enumerate(_node_args(out)):
            claim(o, o, f"output {i}")
        # the claimed values: a replicated leaf's gradient, over its
        # sharded stage's axis
        for node, axes, what in self.p.claims:
            missing = sorted(a for a in env.get(node, EMPTY) & axes
                             if sizes.get(a, 2) > 1)
            if missing and (node, tuple(missing)) not in seen:
                seen.add((node, tuple(missing)))
                missing_reduce(node, missing, what or node.name)

    def base(self, node):
        """The storage owner a node's value aliases: through views and
        in-place results to a placeholder or a fresh value."""
        seen = 0
        while node is not None and seen < 10000:
            seen += 1
            name = op_name(node) if node.op == "call_function" else ""
            if node.op == "call_function" and (name in VIEW_OPS
                                               or is_mutation(node)) \
                    and node.args:
                from torch.fx import Node
                nxt = node.args[0]
                if not isinstance(nxt, Node):
                    return node
                node = nxt
                continue
            return node
        return node

    # -- the collective checks ---------------------------------------------

    def check_collectives(self) -> None:
        sizes = dict(self.active_mesh.shape) if self.active_mesh is not None \
            else None
        for e in self.p.events:
            if e.prim not in RENDEZVOUS_PRIMS:
                continue
            if sizes is not None:
                self._check_axes(e, sizes)
            if e.prim == "ppermute":
                self._check_perm(e)
            if e.prim in ("psum", "reduce_scatter") and e.dtype is not None \
                    and is_low_precision(e.dtype):
                self._emit(
                    "dtype-drift.low-precision-reduction", Severity.WARNING,
                    f"'{e.prim}' reduces {e.dtype} operands across "
                    f"coordinates — cross-coordinate accumulation in "
                    f"sub-fp32 loses increments as the axis (or value "
                    f"magnitude) grows", event=e,
                    hint="accumulate in float32: cast before the reduction "
                         "and back after (the loss/grad paths already do)")
            self._record_cost(e)

    def _check_axes(self, e, sizes) -> None:
        for ax in e.axes:
            width = sizes.get(ax)
            if width is None or (width == 1 < e.group_size
                                 and len(e.axes) == 1):
                self._emit(
                    "mesh-axis.unknown-axis", Severity.ERROR,
                    f"collective '{e.prim}' ({e.site}) names axis '{ax}' "
                    f"over {e.group_size} coordinates, which the active "
                    f"mesh does not bind (axes: "
                    f"{ {k: int(v) for k, v in sizes.items()} })", event=e,
                    hint="fix the axis name, or launch on a mesh that has "
                         "this axis at this width")
            elif len(e.axes) == 1 and e.group_size > 1 \
                    and e.prim not in ("send", "recv") \
                    and int(width) != e.group_size and not e.ranks:
                self._emit(
                    "mesh-axis.mesh-mismatch", Severity.ERROR,
                    f"collective '{e.prim}' ({e.site}) runs over "
                    f"{e.group_size} coordinates of axis '{ax}', but the "
                    f"active mesh has {ax}={int(width)}", event=e,
                    hint="rebuild the step for the launch mesh (axis "
                         "widths are fixed when the stages are built)")

    def _check_perm(self, e) -> None:
        n = e.group_size
        if e.offset is not None and not (-n < e.offset < n):
            self._emit(
                "mesh-axis.perm-out-of-range", Severity.ERROR,
                f"permute over {e.axes} (size {n}) by offset {e.offset}: "
                f"the ring offset lies outside the axis", event=e,
                hint="ring offsets must lie in (-size, size); check the "
                     "chunk/ring size against the mesh")
            return
        if e.pairs is None:
            return
        srcs = [s for s, _ in e.pairs]
        dsts = [d for _, d in e.pairs]
        oob = [i for i in srcs + dsts if not (0 <= i < n)]
        if oob:
            self._emit(
                "mesh-axis.perm-out-of-range", Severity.ERROR,
                f"permute over {e.axes} (size {n}) names coordinate(s) "
                f"{sorted(set(oob))} outside [0, {n})", event=e,
                hint="ring permutations must index coordinates of the "
                     "named axis; check the chunk/ring size against the "
                     "mesh")
            return
        if not (len(e.pairs) == n and len(set(srcs)) == n
                and len(set(dsts)) == n):
            self._emit(
                "ppermute-deadlock.partial-perm", Severity.ERROR,
                f"permute over {e.axes} (size {n}) is not a full bijection "
                f"({len(set(srcs))} distinct sources, {len(set(dsts))} "
                f"distinct destinations, {n} needed)", event=e,
                hint="send a (possibly dummy) chunk from every coordinate")

    def _record_cost(self, e) -> None:
        if e.summary or e.prim == "recv":
            return
        n = e.group_size
        self.costs.append(CollectiveCost(
            prim=e.prim, axes=tuple(e.axes), group_size=n,
            bytes_per_call=e.payload,
            ici_bytes=int(e.payload * _ici_factor(e.prim, n)),
            trips=1, where=self._where(event=e)))

    # -- dtype drift: unrolled low-precision running sums -------------------

    def check_carry(self) -> None:
        depth: dict = {}
        flagged: set = set()
        for node in self.p.graph.nodes:
            if node.op != "call_function" or op_name(node) not in (
                    "aten.add", "aten.add_"):
                continue
            val = node_val(node)
            if not isinstance(val, torch.Tensor) \
                    or not is_low_precision(val.dtype):
                continue
            # an accumulation step: one operand a running sum whose
            # addend does not depend on it (a residual stream's addend
            # does: that is a chain of layers, not a sum)
            best = 0
            for acc, other in ((node.args[0], node.args[1]),
                               (node.args[1], node.args[0])):
                if acc in depth and not self._depends(other, acc):
                    best = max(best, depth[acc])
            depth[node] = best + 1
            if depth[node] >= CARRY_STEPS and not (flagged & set(_node_args(node))):
                flagged.add(node)
                self._emit(
                    "dtype-drift.low-precision-carry", Severity.WARNING,
                    f"a running sum accumulates in {val.dtype} over "
                    f"{depth[node]} steps: a sum in sub-fp32 silently drops "
                    f"increments (bf16 has 8 mantissa bits — sums stall "
                    f"near 256x the step size)", node,
                    hint="carry the accumulator as float32 and cast at the "
                         "edges")
            elif depth[node] >= CARRY_STEPS:
                flagged.add(node)

    def _depends(self, node, on) -> bool:
        """Whether ``node``'s value depends on ``on``'s (a backward walk
        bounded by ``on``'s position)."""
        from torch.fx import Node
        if not isinstance(node, Node) or not isinstance(on, Node):
            return False
        stop = self.order.get(on, 0)
        stack, seen = [node], set()
        while stack:
            n = stack.pop()
            if n is on:
                return True
            if n in seen or self.order.get(n, 0) < stop:
                continue
            seen.add(n)
            stack.extend(_node_args(n))
        return False

    # -- donation: stale aliases of in-place writes --------------------------

    def check_donation(self, arg_positions=None) -> None:
        nodes = list(self.p.graph.nodes)
        writes = []            # (order, storage, written-through chain)
        for node in nodes:
            if not is_mutation(node) or not node.args:
                continue
            st = _storage(node.args[0])
            if st is None:
                continue
            chain = set()
            n = node.args[0]
            while n is not None and n.op == "call_function" and (
                    op_name(n) in VIEW_OPS or is_mutation(n)):
                chain.add(n)
                n = n.args[0] if n.args else None
            writes.append((self.order[node], st, chain, node))
        flagged: set = set()
        if writes:
            for user in nodes:
                if user.op != "call_function":
                    continue
                uo = self.order[user]
                for v in _node_args(user):
                    if v in flagged or v.op != "call_function" \
                            or op_name(v) not in VIEW_OPS:
                        continue
                    vo = self.order.get(v, 0)
                    sv = _storage(v)
                    for wo, st, chain, w in writes:
                        if vo < wo < uo and sv == st and v not in chain \
                                and v is not w and user is not w:
                            flagged.add(v)
                            self._emit(
                                "donation.read-after-donate",
                                Severity.ERROR,
                                f"'{op_name(user)}' reads '{v.name}', an "
                                f"alias of storage that '{op_name(w)}' "
                                f"({w.name}) has since overwritten in "
                                f"place — it holds the new bytes where the "
                                f"old value was taken", user,
                                hint="read the updated value the write "
                                     "returns, or take a copy (clone) "
                                     "before the write")
                            break
        # one buffer at two argument positions of a program writing it
        for leaf_id, positions in (arg_positions or {}).items():
            if len(positions) < 2:
                continue
            ph = self.p.placeholders[positions[0]] \
                if positions[0] < len(self.p.placeholders) else None
            if ph is None:
                continue
            st = _storage(ph)
            if any(st is not None and st == s for _, s, _, _ in writes):
                self._emit(
                    "donation.double-donation", Severity.ERROR,
                    f"the same buffer is passed at argument positions "
                    f"{positions} of '{self.p.name}', which writes it in "
                    f"place — the aliased position reads bytes the write "
                    f"replaces", None,
                    hint="pass distinct buffers, or drop the aliased "
                         "argument")


def run_rules(program, active_mesh=None, arg_ranges=None, arg_vary=None,
              arg_positions=None):
    """Run every lint pass over a traced program; returns (findings,
    costs).

    ``arg_ranges``/``arg_vary`` are per-placeholder contract annotations
    (from ``analysis.spec`` args, see ``analyze``): value intervals engage
    the scatter-bounds interval pass; declared variance engages the
    sharded-state pass — the replication inference runs twice, and a
    missing-reduction finding present ONLY under the declared shards is
    re-tagged ``sharded-state.missing-gather``. ``arg_positions`` maps a
    tensor seen at several argument positions to them (the
    double-donation check).
    """
    w = Walker(program, active_mesh)
    w.check_collectives()
    w.check_replication(in_vary=arg_vary)
    w.check_carry()
    w.check_donation(arg_positions)
    findings, costs = w.findings, w.costs

    if arg_vary and any(arg_vary):
        base = Walker(program, active_mesh)
        base.check_replication()
        base_keys = {(f.rule, f.where) for f in base.findings}
        retagged = []
        for f in findings:
            if (f.rule == "unreduced-gradient.missing-reduce"
                    and (f.rule, f.where) not in base_keys):
                f = dataclasses.replace(
                    f, rule="sharded-state.missing-gather",
                    message=("a buffer DECLARED coordinate-sharded (a ZeRO "
                             "param/opt-state shard in a replicated-shape "
                             "buffer) flows into this value without a "
                             "gather/reduce: " + f.message),
                    hint="gather the shard (or sum the partial) over the "
                         "declared axis before it meets replicated state — "
                         "gather-before-use / reduce-before-update")
            retagged.append(f)
        findings = retagged

    # the bounds pass always runs — even with no declared contracts an
    # index op must surface as unproven rather than analyze vacuously
    # clean (an empty report is a proof)
    from simple_distributed_machine_learning_tpu_torch.analysis.bounds import (
        check_bounds,
    )
    findings = findings + check_bounds(program, list(arg_ranges or ()))
    return findings, costs


def check_ranks(programs: list, name: str = "ranks") -> list[Finding]:
    """The cross-rank checks over the traced steps of every rank of one
    run (``programs[r]`` rank ``r``'s): every send must meet a receive on
    its peer with the same tag and payload and every receive a send
    (``ppermute-deadlock.partial-perm``), and the members of each process
    group must issue the same sequence of group collectives
    (``ppermute-deadlock.branch-divergent``)."""
    out: list[Finding] = []
    sends: dict = {}
    recvs: dict = {}
    for r, prog in enumerate(programs):
        for e in prog.events:
            if e.prim == "send":
                sends.setdefault((r, e.peer, e.tag), []).append(e)
            elif e.prim == "recv":
                recvs.setdefault((e.peer, r, e.tag), []).append(e)
    for key in sorted(set(sends) | set(recvs)):
        s, d, tag = key
        ns, nr = len(sends.get(key, ())), len(recvs.get(key, ()))
        if ns != nr:
            e = (sends.get(key) or recvs.get(key))[0]
            out.append(Finding(
                rule="ppermute-deadlock.partial-perm",
                severity=Severity.ERROR,
                message=(f"rank {s} sends {ns} message(s) with tag {tag} to "
                         f"rank {d}, which receives {nr} — an unmatched "
                         f"send never completes and an unmatched receive "
                         f"waits forever: the permutation is not a "
                         f"bijection"),
                where=f"{e.site} ({e.where})",
                hint="send a (possibly dummy) chunk from every coordinate "
                     "of the ring and receive on every one"))
    groups: dict = {}
    for r, prog in enumerate(programs):
        for e in prog.events:
            if e.ranks and e.prim not in ("send", "recv"):
                groups.setdefault(e.ranks, {}).setdefault(r, []).append(
                    (e.prim, e.axes, e.payload))
    for ranks, by_rank in groups.items():
        seqs = [tuple(by_rank.get(r, ())) for r in ranks
                if r < len(programs)]
        if any(sq != seqs[0] for sq in seqs[1:]):
            out.append(Finding(
                rule="ppermute-deadlock.branch-divergent",
                severity=Severity.ERROR,
                message=(f"the ranks {list(ranks)} of one process group "
                         f"issue different collective sequences "
                         f"({[len(sq) for sq in seqs]} calls) — a member "
                         f"waits in a rendezvous the others never join"),
                where=name,
                hint="make every member issue the same collective sequence "
                     "(dummy calls on non-participating branches)"))
    return out
