"""The kernel linter of the PyTorch port (``analysis/kernels.py``), its
fixtures and the kernel half of the serve registry.

The JAX linter's tests are red on this tree as whole files (its trace
module does not import), so the port is held against the verdicts they
record:

- the interval pins of ``tests/test_analysis_serve.py::
  test_interval_arithmetic_corners``;
- the four kernel corner tests (``test_analysis_serve.py:718-820``),
  written as the port's ``LaunchSpec``s. Their ``pallas_call``s name no
  dimension semantics, so their grid is sequential (``arbitrary``): here
  a loop inside one block;
- every kernel fixture's verdict as ``tests/test_analysis.py:57-110``
  records it (family, ERROR vs WARNING, the clean twins clean at
  ``fail_on="warning"``);
- the ``--serve-kernel`` gate's exit codes (``test_serve_kernel_cli_gate``).

On the port only: the access lint's retargeting to 16-byte vectors (the
JAX fixture's own f32 dh 4 / block 128 shapes lint clean on the card),
K4's spec as a CPU engine tick records it, the registry's derived K/V
bytes equal to ``hbm_tick_costs``, and K4's K > 8 reread, which the
reconciliation reports (``kernel-hbm.mismatch``) and this file pins.
"""

import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu_torch.analysis import (
    bounds,
    kernels,
    programs,
)
from simple_distributed_machine_learning_tpu_torch.analysis.__main__ import (
    main,
)
from simple_distributed_machine_learning_tpu_torch.analysis.bounds import (
    Interval,
    _cmp_iv,
    _floordiv_iv,
    _mod_iv,
    spec,
)
from simple_distributed_machine_learning_tpu_torch.analysis.fixtures import (
    FIXTURES,
    _paged_spec,
)
from simple_distributed_machine_learning_tpu_torch.analysis.kernels import (
    LaunchSpec,
    Operand,
    cast,
)
from simple_distributed_machine_learning_tpu_torch.analysis.report import (
    Severity,
)
from simple_distributed_machine_learning_tpu_torch.models.gpt import (
    make_gpt_stages,
)
from simple_distributed_machine_learning_tpu_torch.serve import (
    InferenceEngine,
)

F32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs (tiny models)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kernel_findings(spec_):
    return [f for f in kernels.lint(spec_) if f.family.startswith("kernel-")]


def _rows(name, n_rows, index_map, output=False):
    return Operand(name, (n_rows, 8), (1, 8), F32, index_map, output=output)


# ---- the interval lattice -------------------------------------------------

def test_interval_arithmetic_corners():
    assert _floordiv_iv(Interval(-5, 11), Interval(4, 4)) == Interval(-2, 2)
    assert _mod_iv(Interval(-5, 11), Interval(4, 4)) == Interval(0, 3)
    assert _cmp_iv("lt", Interval(0, 3), Interval(4, 9)) == Interval(1, 1)
    assert _cmp_iv("lt", Interval(4, 9), Interval(0, 4)) == Interval(0, 0)
    assert _cmp_iv("lt", Interval(0, 5), Interval(3, 4)) == Interval(0, 1)
    assert _cmp_iv("ge", Interval(0, 5), Interval(0, 0)) == Interval(1, 1)


# The JAX lattice itself, on the same inputs. ``analysis/trace.py`` reads
# ``jax.core.Jaxpr``/``ClosedJaxpr``, which this jax keeps only under
# ``jax.extend.core``: with those two names patched in, the JAX ``bounds``
# and ``kernels`` modules import and their pure functions run. The JAX
# linter then runs too, but on this jax it reads only the scratch dtypes:
# the ``pallas_call``'s compiler params are keyed ``mosaic_tpu`` (it reads
# ``mosaic``, so every axis looks ``arbitrary`` and the race check has no
# parallel axis) and its ``BlockMapping``s carry no ``array_shape_dtype``
# (so the index-map and tile checks get no operand). Its verdicts on
# kernel_oob_index_map, kernel_grid_race and kernel_bad_tile are therefore
# "clean", against the ERROR/WARNING its own tests record; only the
# dtype-drift pair can be compared live, and is, below.

JANALYSIS = "simple_distributed_machine_learning_tpu.analysis"
ENDS = (-np.inf, -7, -1, 0, 1, 3, 4, 11, np.inf)
GRID_IVS = [(lo, hi) for i, lo in enumerate(ENDS) for hi in ENDS[i:]]


@pytest.fixture(scope="module")
def jax_lint():
    """The JAX ``analysis.bounds`` and ``analysis.fixtures`` modules,
    imported with ``jax.core.Jaxpr``/``ClosedJaxpr`` patched in; every
    module this imports is removed again after this module's tests."""
    import importlib
    import sys

    import jax.core
    import jax.extend.core as jex

    import simple_distributed_machine_learning_tpu.analysis as janalysis
    before = set(sys.modules)
    with pytest.MonkeyPatch.context() as mp:
        for name in ("Jaxpr", "ClosedJaxpr"):
            mp.setattr(jax.core, name, getattr(jex, name), raising=False)
        try:
            yield (importlib.import_module(f"{JANALYSIS}.bounds"),
                   importlib.import_module(f"{JANALYSIS}.fixtures"))
        finally:
            for mod in set(sys.modules) - before:
                if mod.startswith(JANALYSIS + "."):
                    del sys.modules[mod]
                    sub = mod[len(JANALYSIS) + 1:]
                    if "." not in sub and hasattr(janalysis, sub):
                        delattr(janalysis, sub)


def _same(port_fn, jax_fn):
    """``port_fn()`` and ``jax_fn()`` (the same values, each in its own
    module's ``Interval``) give the same interval, or raise the same
    exception type (a point at infinity has no integer floor)."""
    def outcome(fn):
        try:
            r = fn()
        except Exception as e:              # noqa: BLE001
            return type(e)
        return tuple("nan" if v != v else v for v in (r.lo, r.hi))

    return outcome(port_fn) == outcome(jax_fn)


@pytest.mark.parametrize("fn", ["_mul_iv", "_div_iv", "_floordiv_iv",
                                "_mod_iv", "_rem_iv"])
def test_interval_ops_equal_the_jax_lattice(jax_lint, fn):
    jb = jax_lint[0]
    port, ref = getattr(bounds, fn), getattr(jb, fn)
    for a in GRID_IVS:
        for b in GRID_IVS:
            pa, pb = Interval(*a), Interval(*b)
            ja, jb_ = jb.Interval(*a), jb.Interval(*b)
            assert _same(lambda: port(pa, pb), lambda: ref(ja, jb_)), (a, b)


@pytest.mark.parametrize("prim", ["lt", "le", "gt", "ge", "eq", "ne"])
def test_comparisons_equal_the_jax_lattice(jax_lint, prim):
    jb = jax_lint[0]
    for a in GRID_IVS:
        for b in GRID_IVS:
            assert _same(
                lambda: _cmp_iv(prim, Interval(*a), Interval(*b)),
                lambda: jb._cmp_iv(prim, jb.Interval(*a), jb.Interval(*b)),
            ), (prim, a, b)


def test_index_verdicts_equal_the_jax_lattice(jax_lint):
    jb = jax_lint[0]
    verdicts = set()
    for a in GRID_IVS:
        for hi in (0, 3, 10):
            got = bounds._index_verdict(Interval(*a), hi)
            assert got == jb._index_verdict(jb.Interval(*a), hi), (a, hi)
            verdicts.add(got)
    assert verdicts == {"ok", "oob", "unproven"}


@pytest.mark.parametrize("name", ["kernel_f16_accumulator",
                                  "kernel_f32_accumulator"])
def test_scratch_dtype_verdicts_equal_the_jax_linter(jax_lint, name):
    want = [(f.rule, f.severity.name)
            for f in getattr(jax_lint[1], name)().findings]
    got = [(f.rule, f.severity.name)
           for f in FIXTURES[name].build("cpu").findings]
    assert got == want


# ---- the four kernel corners ----------------------------------------------

def test_kernel_floordiv_and_rem_index_maps_prove_clean():
    """i//2 and i%3 over 6 trips stay inside a 3-row operand."""
    s = LaunchSpec("corner", "test", grid=(), loop=(6,), operands=(
        _rows("x", 3, lambda i: (i // 2, 0)),
        _rows("y", 3, lambda i: (i % 3, 0)),
        _rows("o", 3, lambda i: (i % 3, 0), output=True)))
    assert not _kernel_findings(s)


def test_kernel_oob_floordiv_index_map_is_proved_escaping():
    """8 trips with rows i//2 over a 3-row operand REACH row 3: a finite
    counterexample, so kernel-oob (ERROR), not merely unproven."""
    s = LaunchSpec("corner", "test", grid=(), loop=(8,), operands=(
        _rows("x", 3, lambda i: (i // 2, 0)),
        _rows("o", 8, lambda i: (i % 8, 0), output=True)))
    found = kernels.lint_report([s])
    assert any(f.rule == "kernel-oob.index-map" for f in found.findings)
    assert not found.ok()


@pytest.mark.parametrize("contract,rule", [
    ((0, 4), None),
    (None, "kernel-unproven.index-map"),
    ((0, 9), "kernel-oob.index-map"),
], ids=["proven", "unproven", "escaping"])
def test_kernel_table_contract_seeds_the_proof(contract, rule):
    """A block-table lookup is only provable when the caller DECLARES the
    table's range; without it the same map is unproven, and a contract
    that admits escape is an ERROR."""
    tbl = spec((4,), torch.int32, *(contract or (None, None)))
    s = LaunchSpec("corner", "test", grid=(), loop=(4,), operands=(
        _rows("x", 5, lambda i, t: (t[i], 0)),
        _rows("o", 4, lambda i, t: (i, 0), output=True)),
        tables=(("tbl", tbl),))
    rules = [f.rule for f in _kernel_findings(s)]
    assert rules == ([] if rule is None else [rule])


def test_kernel_narrowing_cast_drops_the_proof():
    """An i32 -> i8 cast forgets the interval when the axis provably
    overflows int8; an axis that fits keeps its proof."""
    def build(n):
        return LaunchSpec("corner", "test", grid=(), loop=(n,), operands=(
            _rows("x", n, lambda i: (cast(cast(i, torch.int8),
                                          torch.int32), 0)),
            _rows("o", n, lambda i: (i, 0), output=True)))

    assert any(f.rule == "kernel-unproven.index-map"
               for f in _kernel_findings(build(300)))
    assert not _kernel_findings(build(4))
    assert cast(300, torch.int8) == 44                 # it wraps


def test_a_parallel_axis_needs_an_affine_output_map():
    """On the card every grid axis is parallel: the corner's i%3 output
    map over a 6-cell grid cannot be proven injective."""
    s = LaunchSpec("corner", "test", grid=(6,), operands=(
        _rows("x", 3, lambda i: (i % 3, 0)),
        _rows("o", 3, lambda i: (i % 3, 0), output=True)))
    assert [f.rule for f in kernels.lint(s)] == ["kernel-race.unproven-map"]


# ---- the fixtures ---------------------------------------------------------

@pytest.mark.parametrize("name", [
    "kernel_oob_index_map", "kernel_grid_race", "kernel_bad_tile",
    "kernel_f16_accumulator",
])
def test_seeded_defect_is_flagged(name):
    fx = FIXTURES[name]
    assert fx.defect
    report = fx.build("cpu")
    assert fx.family in {f.family for f in report.findings}, report.format()
    assert not report.ok(fail_on="warning")


def test_new_family_defect_severities():
    for name in ("kernel_oob_index_map", "kernel_grid_race"):
        assert FIXTURES[name].build("cpu").errors, name
    for name in ("kernel_bad_tile", "kernel_f16_accumulator"):
        report = FIXTURES[name].build("cpu")
        assert not report.errors and report.warnings, report.format()


@pytest.mark.parametrize("name", [
    "kernel_clean_paged", "kernel_clean_grid", "kernel_packed_tile",
    "kernel_f32_accumulator",
])
def test_clean_fixtures_pass(name):
    report = FIXTURES[name].build("cpu")
    assert report.ok(fail_on="warning"), report.format()


def test_the_tpu_tile_shape_is_clean_on_the_card():
    """The JAX kernel_bad_tile shapes (f32, dh 4, block 128) read 16 bytes
    per row, one whole vector: no waste on the card. Only a narrower row
    (int8 dh 4) wastes 4x."""
    assert not kernels.lint(_paged_spec(0, dh=4, bs=128))
    rules = [f.rule for f in kernels.lint(
        _paged_spec(0, dh=4, bs=128, dtype=torch.int8))]
    assert rules == ["kernel-tile.pad-waste"] * 2


# ---- K4's recorded spec ---------------------------------------------------

def _engine(**kw):
    cfg, _ = programs.registry_config()
    stages = make_gpt_stages(0, cfg, 1, device="cpu")[0]
    eng = InferenceEngine(stages, cfg, n_slots=3, block_size=4,
                          prefill_chunk=3, attn_kernel="fused",
                          device="cpu", **kw)
    eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=4)
    return cfg, eng


def test_a_cpu_decode_tick_records_k4_specs():
    cfg, eng = _engine()
    got = programs.tick_launches(eng)["paged_decode"]
    assert len(got) == cfg.n_layers
    sspec = programs.engine_spec(eng)
    NB = sspec.blocks_per_seq
    for s in got:
        assert s.kernel == "paged_attention"
        assert s.grid == (3, cfg.n_heads, 1) and s.loop == (NB,)
        assert s.operand("k").shape[0] == sspec.nb + 1
        assert kernels.lint(s.with_contracts(
            **programs.kernel_contracts(sspec))) == []
    rows = kernels.kernel_hbm_costs(
        [s.with_contracts(**programs.kernel_contracts(sspec)) for s in got])
    model = next(h for h in programs.hbm_tick_costs(sspec)
                 if h.op == "decode.kv_gather")
    assert rows[0].op == "kernel.kv_stream"
    assert rows[0].bytes_per_tick == model.bytes_per_tick


def test_recording_costs_nothing_outside_a_recorder():
    cfg, eng = _engine()
    assert kernels._recording is None
    with kernels.record_launches() as outer:
        with kernels.record_launches() as inner:
            eng.step()
            eng.step()
        assert kernels._recording is outer
    assert kernels._recording is None
    assert outer == [] and len(inner) % cfg.n_layers == 0 and inner


# ---- the registry ---------------------------------------------------------

@pytest.fixture(scope="module")
def registry():
    return programs.kernel_registry_reports("cpu")


def test_registry_is_kernel_clean_with_derived_bytes_equal_to_the_model(
        registry):
    assert len(registry) == 9
    fused = 0
    for r in registry:
        assert r.ok(fail_on="warning"), r.format()
        derived = {h.program: h.bytes_per_tick for h in r.hbm
                   if h.op == "kernel.kv_stream"}
        model = {(h.program, h.op): h.bytes_per_tick for h in r.hbm}
        if derived:
            fused += 1
            assert derived["paged_decode"] == model[
                ("paged_decode", "decode.kv_gather")]
        if "paged_verify" in derived:
            assert derived["paged_verify"] == model[
                ("paged_verify", "verify.kv_gather")]
    assert fused == 2
    assert registry[-1].name.startswith("serve[degraded fallback")


def test_registry_int8_bytes_count_the_scale_planes(registry):
    r = next(r for r in registry if "cache=int8" in r.name)
    cfg, _ = programs.registry_config()
    dh = cfg.d_model // cfg.n_heads
    row = 2 * cfg.n_heads * (dh * 1 + 4)          # K+V data and scales
    kv = next(h for h in r.hbm if h.op == "kernel.kv_stream")
    assert kv.bytes_per_tick == 4 * cfg.n_layers * 24 * row == 9216


def test_k4_rereads_kv_per_query_group_beyond_eight_queries():
    """At spec_k 12 K4's grid holds two query groups per (slot, head), and
    each reads the slot's K/V: the derived verify bytes are twice the
    model's, and the reconciliation reports it (ROADMAP Queue B: share one
    K/V read between query groups)."""
    cfg, draft_cfg = programs.registry_config()
    stages = make_gpt_stages(0, cfg, 1, device="cpu")[0]
    draft = make_gpt_stages(1, draft_cfg, 1, device="cpu")[0]
    sspec = programs.ServeSpec(cfg, n_slots=2, kv_layout="paged",
                               block_size=4, prefill_chunk=3,
                               prompt_lens=(4,), spec_k=12,
                               draft_cfg=draft_cfg, attn_kernel="fused")
    r = programs.kernel_report(stages, sspec, draft_stages=draft,
                               device="cpu")
    derived = next(h.bytes_per_tick for h in r.hbm
                   if h.op == "kernel.kv_stream"
                   and h.program == "paged_verify")
    model = next(h.bytes_per_tick for h in r.hbm
                 if h.op == "verify.kv_gather")
    assert derived == 2 * model
    bad = [f for f in r.findings if f.rule == "kernel-hbm.mismatch"]
    assert len(bad) == 1 and "paged_verify" in bad[0].message
    assert bad[0].severity == Severity.ERROR


# ---- the CLI --------------------------------------------------------------

def test_serve_kernel_cli_gate(monkeypatch, capsys):
    assert main(["--serve-kernel", "--device", "cpu"]) == 0
    assert "9 layouts kernel-clean" in capsys.readouterr().out
    monkeypatch.setenv("SDML_LINT_INJECT", "drill")
    assert main(["--serve-kernel", "--device", "cpu"]) == 1


@pytest.mark.parametrize("argv,rc", [
    (["--fixture", "kernel_grid_race"], 1),
    (["--fixture", "kernel_clean_grid"], 0),
    (["--fixture", "kernel_bad_tile"], 1),
    (["--fixture", "kernel_bad_tile", "--fail-on", "error"], 0),
    (["--fixture", "protocol_clean_fleet", "--costs"], 0),
    (["--list"], 0),
], ids=["race", "clean-grid", "tile", "tile-error-gate", "protocol", "list"])
def test_cli_fixture_modes_exit_as_the_jax_cli(argv, rc, capsys):
    assert main(argv + ["--device", "cpu"]) == rc
    out = capsys.readouterr().out
    if argv[0] == "--list":
        assert "kernel_grid_race" in out and "kernel-race" in out
    else:
        assert out.startswith("analysis: ")


def test_cli_fixtures_self_test_passes(capsys):
    assert main(["--fixtures", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("-> OK") == len(FIXTURES) + 2
    assert out.rstrip().endswith("fixture self-test: OK")


def test_kernel_modes_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--serve-kernel"])
