"""The serving-program registry of the port's program linter
(``analysis/programs.py``: ``build_registry``, ``lint_serve``,
``lint_engine``, ``check_builder_memo``) and its bounds pass, the cases of
the JAX ``tests/test_analysis_serve.py`` on the port's own traced
programs, on the CPU.

Four contracts, as in JAX:

1. the registry lints CLEAN on both K/V layouts — and not vacuously: the
   interval pass PROVES every index op (zero ``unproven-promise``) and
   every program traces (zero ``trace.failed``);
2. contract violations the host-side pool guards against are flagged when
   declared possible — block-table entries past the pool, positions past
   ``max_len`` — each as a ``scatter-bounds`` ERROR;
3. the build memo and the retrace policy are machine-checked;
4. on every fused layout the K/V bytes the traced K4 nodes' launch specs
   derive equal the byte model's rows (no ``kernel-hbm.mismatch``).

The JAX registry itself runs once, in a child interpreter
(``tests/_jax_lint_reference.py``: jax 0.9 needs a ``jax.core`` shim the
pytest process must not see): under jax 0.9 it flags
``scatter-bounds.out-of-range`` on every paged layout and
``kernel-hbm.mismatch`` on both fused ones, where the recorded contract
(``test_analysis_serve.py::test_registry_clean_both_layouts``) is clean —
the port is held to the contract. Trace-only: nothing launches.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu_torch.analysis import (
    _unwrap_specs,
    analyze,
    spec,
)
from simple_distributed_machine_learning_tpu_torch.analysis.bounds import (
    Interval,
    _cmp_iv,
    _floordiv_iv,
    _mod_iv,
)
from simple_distributed_machine_learning_tpu_torch.analysis.programs import (
    ServeSpec,
    build_registry,
    check_builder_memo,
    default_registry_reports,
    hbm_tick_costs,
    lint_engine,
    lint_serve,
)
from simple_distributed_machine_learning_tpu_torch.analysis.trace import (
    abstractify,
    all_primitives,
    trace_program,
)
from simple_distributed_machine_learning_tpu_torch.models.gpt import (
    DECODE_BUILDERS,
    GPTConfig,
    make_gpt_stages,
    make_paged_decode_step,
)

CFG = GPTConfig(vocab=32, seq_len=24, d_model=16, n_heads=2, n_layers=2)
BUCKETS = (4, 6, 9)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def stages():
    return make_gpt_stages(0, CFG, 1, device="cpu")[0]


def _specs():
    return [
        ServeSpec(CFG, n_slots=3, max_len=16, kv_layout="paged",
                  block_size=4, prefill_chunk=3, prompt_lens=BUCKETS),
        ServeSpec(CFG, n_slots=3, max_len=16, kv_layout="paged",
                  block_size=8, prefill_chunk=None, prompt_lens=BUCKETS),
        ServeSpec(CFG, n_slots=3, max_len=16, kv_layout="dense",
                  prompt_lens=BUCKETS),
    ]


def _draft():
    dcfg = dataclasses.replace(CFG, n_layers=1)
    return make_gpt_stages(1, dcfg, 1, device="cpu")[0], dcfg


# ---- 1. the registry lints clean ------------------------------------------

@pytest.mark.parametrize("i", range(3))
def test_registry_clean_both_layouts(stages, i):
    report = lint_serve(stages, _specs()[i], device="cpu")
    assert report.ok(fail_on="warning"), report.format()
    rules = {f.rule for f in report.findings}
    assert "scatter-bounds.unproven-promise" not in rules
    assert "trace.failed" not in rules


def test_registry_covers_every_decode_builder(stages):
    """The paged + dense registries, speculative and with adapters,
    enumerate a program of every ``DECODE_BUILDERS`` entry (plus the
    composite ticks)."""
    dst, dcfg = _draft()
    names = set()
    for s in _specs():
        for extra in ({}, dict(spec_k=4, draft_cfg=dcfg),
                      dict(n_adapters=4, adapter_rank=2)):
            programs, _ = build_registry(
                stages, dataclasses.replace(s, **extra), device="cpu",
                draft_stages=dst if extra.get("spec_k") else None)
            names.update(p.name for p in programs)
    assert {"cached_decoder", "slot_prefill", "slot_decode",
            "paged_prefill_chunk", "paged_decode", "paged_block_copy",
            "adapter_bank_update", "slot_propose", "paged_propose",
            "slot_verify", "paged_verify", "dense_spec_tick",
            "paged_spec_tick", "dense_tick", "paged_tick"} <= names
    builders = {"cached_decoder": "make_cached_decoder",
                "slot_prefill": "make_slot_prefill",
                "slot_decode": "make_slot_decode_step",
                "paged_prefill_chunk": "make_paged_prefill_chunk",
                "paged_decode": "make_paged_decode_step",
                "paged_block_copy": "make_paged_block_copy",
                "adapter_bank_update": "make_adapter_bank_update",
                "slot_propose": "make_slot_propose",
                "slot_verify": "make_slot_verify_step",
                "paged_verify": "make_paged_verify_step",
                "dense_spec_tick": "make_slot_spec_tick",
                "paged_spec_tick": "make_paged_spec_tick"}
    assert set(builders.values()) == set(DECODE_BUILDERS)


def test_trace_reaches_serve_primitives(stages):
    """The trace reaches the index-bearing ops the serve programs emit,
    the paged-attention kernel node of a fused layout included, and no
    program fails to trace."""
    prims = set()
    fused = dataclasses.replace(_specs()[0], attn_kernel="fused")
    for s in _specs() + [fused]:
        programs, _ = build_registry(stages, s, device="cpu")
        for prog in programs:
            args, kwargs, _, _, _ = _unwrap_specs(prog.args, {})
            prims |= all_primitives(trace_program(prog.fn, *args, **kwargs))
    assert {"aten.index_put_", "aten.index", "aten.gather",
            "aten.argmax", "aten.cat", "aten.arange", "aten.copy_",
            "sdml.paged_attention"} <= prims, sorted(prims)


def test_hbm_table_present_and_ranked(stages):
    report = lint_serve(stages, _specs()[0], device="cpu")
    ops = {h.op for h in report.hbm}
    assert {"decode.kv_gather", "decode.kv_scatter",
            "prefill.kv_scatter", "cow.block_copy"} <= ops
    gather = next(h for h in report.hbm if h.op == "decode.kv_gather")
    scatter = next(h for h in report.hbm if h.op == "decode.kv_scatter")
    assert gather.bytes_per_tick == scatter.bytes_per_tick * 16
    assert "HBM bytes per serve tick" in report.format()


@pytest.fixture(scope="module")
def registry():
    return default_registry_reports("cpu")


@pytest.fixture(scope="module")
def jax_registry():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_jax_lint_reference.py"),
         "serve"], capture_output=True, text=True, env=env, timeout=600,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_default_registry_clean_where_jax09_is_off_contract(registry,
                                                             jax_registry):
    """The CI sweep's nine layouts, named as JAX names them: the port is
    ERROR- and WARNING-free on every one (the recorded contract); the
    shimmed JAX run flags the paged layouts (jax 0.9, off contract)."""
    assert [r.name for r in registry] == list(jax_registry)
    for r in registry:
        assert r.ok(fail_on="warning"), r.format()
        off = set(jax_registry[r.name])
        paged = "paged" in r.name.split("[")[1].split()[0]
        fused = "kernel=fused" in r.name
        assert off == ({"scatter-bounds.out-of-range"} if paged else set()) \
            | ({"kernel-hbm.mismatch"} if fused else set()), r.name


def test_kernel_rows_reconcile_on_every_fused_layout(registry):
    """The traced K4 nodes' launch specs derive exactly the byte model's
    ``decode.kv_gather`` (and ``verify.kv_gather``) rows."""
    fused = [r for r in registry if "kernel=fused" in r.name]
    assert len(fused) == 2
    for r in fused:
        rows = {(h.program, h.op): h.bytes_per_tick for h in r.hbm}
        assert rows[("paged_decode", "kernel.kv_stream")] \
            == rows[("paged_decode", "decode.kv_gather")] > 0
        if "spec_k" in r.name:
            assert rows[("paged_verify", "kernel.kv_stream")] \
                == rows[("paged_verify", "verify.kv_gather")] > 0


def test_hbm_prefill_chunk_matches_registry_resolution():
    for s in (_specs()[0], _specs()[1],
              ServeSpec(CFG, n_slots=2, max_len=16, block_size=4)):
        row = next(h for h in hbm_tick_costs(s)
                   if h.op == "prefill.kv_scatter")
        assert f"{s.resolved_chunk}-token" in row.note, (row.note, s)
    assert ServeSpec(CFG, n_slots=2, max_len=16,
                     block_size=4).resolved_chunk == 8


# ---- 2. contract violations are flagged -----------------------------------

def _paged_decode_args(stages, tables_hi, pos_hi, S=2, ml=16, bs=4):
    nb = -(-ml // bs) * S
    params = abstractify([s.params for s in stages])
    shape = (CFG.n_layers, nb + 1, CFG.n_heads, bs,
             CFG.d_model // CFG.n_heads)
    kc = abstractify(torch.empty(shape))
    vc = abstractify(torch.empty(shape))
    return [params, kc, vc,
            spec((S,), torch.int32, 0, CFG.vocab - 1),
            spec((S,), torch.int32, 0, pos_hi),
            spec((S, -(-ml // bs)), torch.int32, 0, tables_hi),
            spec((S, 2), torch.int64), spec((S,), torch.float32),
            spec((S,), torch.int32, 0, CFG.vocab),
            spec((S,), torch.float32)], nb


def test_oob_table_and_position_flagged(stages):
    step = make_paged_decode_step(stages, CFG, 16, 4, device="cpu")
    args, nb = _paged_decode_args(stages, tables_hi=None, pos_hi=15)
    args[5] = spec((2, 4), torch.int32, 0, nb)
    assert analyze(step, *args).ok(fail_on="warning")
    args[5] = spec((2, 4), torch.int32, 0, nb + 1)
    report = analyze(step, *args)
    oob = [f for f in report.findings
           if f.rule == "scatter-bounds.out-of-range"]
    assert oob and not report.ok(), report.format()
    args[5] = spec((2, 4), torch.int32, 0, nb)
    args[4] = spec((2,), torch.int32, 0, 16)
    report = analyze(step, *args)
    assert not report.ok(), report.format()


def test_unbounded_inputs_warn_on_unproven_indices(stages):
    step = make_paged_decode_step(stages, CFG, 16, 4, device="cpu")
    args, _ = _paged_decode_args(stages, tables_hi=None, pos_hi=15)
    args[5] = spec((2, 4), torch.int32)           # tables: no contract
    report = analyze(step, *args)
    assert any(f.rule == "scatter-bounds.unproven-promise"
               for f in report.findings), report.format()
    assert report.ok()        # WARNING: unproven, not proven-broken


def test_fused_kernel_node_takes_the_table_contract(stages):
    """The K4 node of a fused decode reads its tables' interval from the
    graph: one past the pool is ``kernel-oob`` inside the kernel, beside
    the scatter's ``scatter-bounds`` ERROR."""
    step = make_paged_decode_step(stages, CFG, 16, 4, kernel="fused",
                                  device="cpu")
    args, nb = _paged_decode_args(stages, tables_hi=None, pos_hi=15)
    args[5] = spec((2, 4), torch.int32, 0, nb)
    assert analyze(step, *args).ok(fail_on="warning")
    args[5] = spec((2, 4), torch.int32, 0, nb + 1)
    rules = {f.rule for f in analyze(step, *args).findings}
    assert {"kernel-oob.index-map", "scatter-bounds.out-of-range"} <= rules


def test_double_donation_flagged():
    """One buffer at two argument positions of a program that writes it
    in place: the aliased position reads bytes the write replaces."""
    def inner_(a, b):
        a.add_(b)
        return a

    x = spec((4,), torch.float32)
    t = abstractify(torch.empty(4))
    report = analyze(inner_, t, t)
    assert any(f.rule == "donation.double-donation"
               for f in report.findings), report.format()
    clean = analyze(inner_, x, spec((4,), torch.float32))
    assert not any(f.rule == "donation.double-donation"
                   for f in clean.findings), clean.format()


def test_no_contracts_at_all_still_runs_bounds(stages):
    step = make_paged_decode_step(stages, CFG, 16, 4, device="cpu")
    args, _ = _paged_decode_args(stages, tables_hi=None, pos_hi=15)
    plain = [abstractify(torch.empty(a.shape, dtype=a.dtype))
             if hasattr(a, "lo") else a for a in args]
    report = analyze(step, *plain)
    assert any(f.rule == "scatter-bounds.unproven-promise"
               for f in report.findings), report.format()
    assert report.ok(), report.format()


# ---- 3. build memo + retrace policy ---------------------------------------

def test_real_builders_are_memoized(stages):
    extra = {
        "make_slot_propose": lambda m: m(stages, CFG, 16, 4, device="cpu"),
        "make_slot_verify_step": lambda m: m(stages, CFG, 16, 4,
                                             device="cpu"),
        "make_paged_verify_step": lambda m: m(stages, CFG, 16, 4, 4,
                                              device="cpu"),
        "make_slot_spec_tick": lambda m: m(stages, CFG, stages, CFG, 16, 4,
                                           device="cpu"),
        "make_paged_spec_tick": lambda m: m(stages, CFG, stages, CFG, 16,
                                            4, 4, device="cpu"),
    }
    for name, make in DECODE_BUILDERS.items():
        if name in extra:
            def build(_f=extra[name], _m=make):
                return _f(_m)
        elif name == "make_cached_decoder":
            def build(_m=make):
                return _m(stages, CFG, 4, 4, device="cpu")
        elif name in ("make_paged_block_copy", "make_adapter_bank_update"):
            build = make
        elif "paged" in name:
            def build(_m=make):
                return _m(stages, CFG, 16, 4, device="cpu")
        else:
            def build(_m=make):
                return _m(stages, CFG, 16, device="cpu")
        assert check_builder_memo(name, build) == [], name


def test_memo_rebuilds_for_other_stages_and_config(stages):
    """The memo keys on the stages by identity and on the static config:
    other weights or another block size build another program."""
    other = make_gpt_stages(3, CFG, 1, device="cpu")[0]
    a = make_paged_decode_step(stages, CFG, 16, 4, device="cpu")
    assert make_paged_decode_step(other, CFG, 16, 4, device="cpu") is not a
    assert make_paged_decode_step(stages, CFG, 16, 8, device="cpu") is not a
    assert make_paged_decode_step(stages, CFG, 16, 4, device="cpu") is a


def test_unbounded_retrace_flagged_bounded_clean(stages):
    unbounded = ServeSpec(CFG, n_slots=2, max_len=16, kv_layout="dense")
    report = lint_serve(stages, unbounded, device="cpu")
    assert any(f.rule == "retrace-explosion.unbounded-trace-key"
               for f in report.findings), report.format()
    assert report.ok()
    bounded = ServeSpec(CFG, n_slots=2, max_len=16, kv_layout="dense",
                        prompt_lens=BUCKETS)
    assert lint_serve(stages, bounded, device="cpu").ok(fail_on="warning")
    chunked = ServeSpec(CFG, n_slots=2, max_len=16, kv_layout="paged",
                        block_size=4, prefill_chunk=4)
    report = lint_serve(stages, chunked, device="cpu")
    assert report.ok()
    assert [f.where for f in report.findings
            if f.rule == "retrace-explosion.unbounded-trace-key"] \
        == ["make_cached_decoder"]


def test_lint_serve_requires_the_draft_build():
    _, dcfg = _draft()
    s = ServeSpec(CFG, n_slots=2, max_len=16, kv_layout="dense",
                  prompt_lens=BUCKETS, spec_k=4, draft_cfg=dcfg)
    with pytest.raises(ValueError, match="draft_stages"):
        lint_serve(None, s, device="cpu")


def test_registry_clean_tp2(stages):
    """TP-sharded serving programs on a model mesh of two coordinates
    sharing the CPU: the mesh-axis rule reads the noted model sums, the
    bounds pass walks the head-sharded pools — clean on both layouts, and
    TP without the mesh is refused."""
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    cfg2 = dataclasses.replace(CFG, n_tensor_parallel=2)
    mesh = make_mesh(1, n_model=2, devices=["cpu"] * 2)
    for s in (ServeSpec(cfg2, n_slots=3, max_len=16, kv_layout="paged",
                        block_size=4, prefill_chunk=3, prompt_lens=BUCKETS,
                        attn_kernel="fused"),
              ServeSpec(cfg2, n_slots=3, max_len=16, kv_layout="dense",
                        prompt_lens=BUCKETS)):
        report = lint_serve(stages, s, mesh=mesh, device="cpu")
        assert report.ok(fail_on="warning"), report.format()
        assert any(c.prim == "psum" and c.axes == ("model",)
                   and c.group_size == 2 for c in report.costs)
    with pytest.raises(ValueError, match="mesh"):
        lint_serve(stages, ServeSpec(cfg2, n_slots=3, max_len=16,
                                     kv_layout="dense",
                                     prompt_lens=BUCKETS), device="cpu")


# ---- engine + CLI wiring --------------------------------------------------

def test_engine_lint_true_constructs_and_gates(stages, monkeypatch):
    from simple_distributed_machine_learning_tpu_torch.serve import (
        InferenceEngine,
    )
    eng = InferenceEngine(stages, CFG, n_slots=2, max_len=16, block_size=4,
                          prefill_chunk=3, attn_kernel="fused", lint=True,
                          device="cpu")
    assert lint_engine(eng, prompt_lens=BUCKETS).ok()
    h = eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=3, seed=1)
    eng.drain()
    assert len(h.tokens) == 3
    monkeypatch.setenv("SDML_LINT_INJECT", "unit")
    with pytest.raises(RuntimeError, match="preflight found ERROR"):
        InferenceEngine(stages, CFG, n_slots=2, max_len=16, block_size=4,
                        prefill_chunk=3, lint=True, device="cpu")


def test_serve_cli_gate_exit_codes(monkeypatch):
    """``--serve`` exits 1 under the gate drill (its clean exit 0 is
    ``tests/test_torch_protocol.py``'s ``--serve --hostlint`` case)."""
    from simple_distributed_machine_learning_tpu_torch.analysis.__main__ import (  # noqa: E501
        main,
    )
    monkeypatch.setenv("SDML_LINT_INJECT", "unit")
    assert main(["--serve", "--device", "cpu"]) == 1


# ---- bounds arithmetic unit checks ----------------------------------------

def test_interval_arithmetic_corners():
    assert _floordiv_iv(Interval(-5, 11), Interval(4, 4)) == Interval(-2, 2)
    assert _mod_iv(Interval(-5, 11), Interval(4, 4)) == Interval(0, 3)
    assert _cmp_iv("lt", Interval(0, 3), Interval(4, 9)) == Interval(1, 1)
    assert _cmp_iv("lt", Interval(4, 9), Interval(0, 4)) == Interval(0, 0)
    assert _cmp_iv("lt", Interval(0, 5), Interval(3, 4)) == Interval(0, 1)
    assert _cmp_iv("ge", Interval(0, 5), Interval(0, 0)) == Interval(1, 1)


def test_narrowing_cast_drops_the_proof():
    """int32 -> int8 WRAPS past 127: the declared interval must not
    survive the cast and falsely certify the index — a fitting cast keeps
    the proof."""
    def f(x, i):
        return x[i.to(torch.int8).long()]

    x = spec((100,), torch.float32)
    wrapping = analyze(f, x, spec((1,), torch.int32, 0, 200))
    assert any(f_.rule == "scatter-bounds.unproven-promise"
               for f_ in wrapping.findings), wrapping.format()
    fitting = analyze(f, x, spec((1,), torch.int32, 0, 90))
    assert fitting.ok(fail_on="warning"), fitting.format()


def test_bounds_prove_simple_program():
    def f(table, idx):
        return table[torch.div(idx, 4, rounding_mode="floor")]

    t = spec((3,), torch.int32, 0, 2)
    good = analyze(f, t, spec((3,), torch.int64, 0, 11))
    assert good.ok(fail_on="warning"), good.format()
    bad = analyze(f, t, spec((3,), torch.int64, 0, 12))
    assert any(f_.rule == "scatter-bounds.out-of-range"
               for f_ in bad.findings), bad.format()


def test_half_declared_contract_degrades_to_unproven():
    def f(x, i):
        return x[i]

    x = spec((4, 8), torch.float32)
    half = analyze(f, x, spec((3,), torch.int64, lo=0))
    assert half.ok(), half.format()
    assert any(f_.rule == "scatter-bounds.unproven-promise"
               for f_ in half.findings), half.format()
    beyond = analyze(f, x, spec((3,), torch.int64, lo=10))
    assert any(f_.rule == "scatter-bounds.out-of-range"
               for f_ in beyond.findings), beyond.format()


@pytest.mark.parametrize("op", ["amin", "amax", "sum"])
def test_scatter_variant_ops_checked(op):
    """``scatter_reduce`` (min/max/sum) and ``index_put_`` with
    accumulation hit the same bounds check as a plain scatter."""
    def f(x, i, _op=op):
        return x.scatter_reduce(0, i, torch.ones(3), _op)

    def g(x, i):
        return x.index_put_((i,), torch.ones(3), accumulate=True)

    x = spec((4,), torch.float32)
    for fn in (f, g):
        bad = analyze(fn, x, spec((3,), torch.int64, 0, 9))
        assert any(f_.rule == "scatter-bounds.out-of-range"
                   for f_ in bad.findings), (op, bad.format())
        good = analyze(fn, x, spec((3,), torch.int64, 0, 3))
        assert good.ok(fail_on="warning"), (op, good.format())
