"""The port's program linter (``analysis/{trace,rules,bounds}.py``,
``analysis/fixtures.py``, ``analysis/preflight.py``) against the JAX
package's, on the CPU.

The JAX linter reads ``jax.core.Jaxpr``, which jax 0.9 no longer exports,
so its side runs once per module in a child interpreter
(``tests/_jax_lint_reference.py``) that sets ``jax.core.Jaxpr`` to the
``jax.extend.core`` type before the import and prints JSON — never in this
process, where the patch would reach a later JAX test file of the same
worker. Under jax 0.9 eighteen of the JAX fixtures meet their contract and
eight do not (``ROADMAP.md``, the shim finding):

- where the JAX run meets its contract, the port's (rule, severity) set
  equals the JAX run's;
- where jax 0.9 breaks it, the port meets the contract the JAX tests
  record (``tests/test_analysis.py``: each defect fixture flags its
  family, each clean twin is clean) — :data:`OFF_CONTRACT` names each
  case with the JAX run's verdict beside it.

The dryrun steps: ``dryrun_reports(2|4|8)`` is ERROR-free and its
stage-hop bytes are held to the JAX cost tables (768/384/1280 B at 2
coordinates, 1280/640/1280 B at 4) by the exact ratio of the two
schedules' hop counts (:func:`_hop_ratio`): the JAX GPipe scan permutes
the whole stage axis on each of its M + S - 1 ticks (1F1B: M + 2S - 1),
one row per tick in its per-device table, where the port bills each of
its D·M·(S-1) hops per direction. Nothing here launches a kernel.
"""

import json
import os
import subprocess
import sys
from fractions import Fraction

import pytest
import torch

from simple_distributed_machine_learning_tpu_torch.analysis import (
    analyze,
    spec,
)
from simple_distributed_machine_learning_tpu_torch.analysis.fixtures import (
    FIXTURES,
)
from simple_distributed_machine_learning_tpu_torch.analysis.preflight import (
    dryrun_reports,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "_jax_lint_reference.py")

#: the program fixtures of this slice (the kernel and protocol fixtures
#: are pinned in tests/test_torch_kernel_lint.py)
PROGRAM_FIXTURES = (
    "partial_ppermute", "dropped_grad_sync", "wrong_axis_name",
    "bf16_psum_accumulator", "read_after_donate", "oob_block_table",
    "cow_read_after_donate", "unmemoized_retrace",
    "dropped_gather_before_use", "clean_grad_sync", "clean_cow_tick",
    "clean_gather_before_use", "clean_pipeline_step")

#: fixture -> (the contract's rule set, the shimmed JAX run's) where jax
#: 0.9 breaks the JAX fixture
OFF_CONTRACT = {
    "dropped_grad_sync": ({("unreduced-gradient.missing-reduce", "ERROR")},
                          set()),
    "read_after_donate": ({("donation.read-after-donate", "ERROR")}, set()),
    "cow_read_after_donate": ({("donation.read-after-donate", "ERROR")},
                              {("scatter-bounds.out-of-range", "ERROR")}),
    "clean_cow_tick": (set(), {("scatter-bounds.out-of-range", "ERROR")}),
    "dropped_gather_before_use": (
        {("sharded-state.missing-gather", "ERROR")}, set()),
}


def _child(part: str):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, CHILD, part], capture_output=True,
                         text=True, env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_fixtures():
    return {k: {tuple(x) for x in v} for k, v in _child("fixtures").items()}


@pytest.fixture(scope="module")
def jax_dryrun():
    return _child("dryrun")


def _rules(report) -> set:
    return {(f.rule, str(f.severity)) for f in report.findings}


@pytest.fixture(scope="module")
def port_fixtures():
    return {name: FIXTURES[name].build("cpu") for name in PROGRAM_FIXTURES}


# -- the fixtures -------------------------------------------------------------

@pytest.mark.parametrize("name", list(FIXTURES))
def test_every_fixture_meets_its_contract(name, port_fixtures):
    """All 26 fixtures: a defect flags (at WARNING or worse) a finding of
    its family, a clean twin has no finding at all."""
    fx = FIXTURES[name]
    report = port_fixtures.get(name) or fx.build("cpu")
    if fx.defect:
        assert not report.ok(fail_on="warning"), report.format()
        assert any(f.family == fx.family for f in report.findings), \
            report.format()
    else:
        assert report.ok(fail_on="warning"), report.format()


@pytest.mark.parametrize("name", [n for n in PROGRAM_FIXTURES
                                  if n not in OFF_CONTRACT])
def test_rule_ids_equal_the_jax_run(name, port_fixtures, jax_fixtures):
    """Where the shimmed JAX run meets its contract, the port flags the
    same (rule, severity) set."""
    assert _rules(port_fixtures[name]) == jax_fixtures[name], \
        port_fixtures[name].format()


@pytest.mark.parametrize("name", sorted(OFF_CONTRACT))
def test_off_contract_jax_cases_follow_the_recorded_contract(
        name, port_fixtures, jax_fixtures):
    """jax 0.9 breaks these JAX fixtures (the shim finding): the JAX run
    gives the second set, the recorded contract the first — the port
    gives the contract's."""
    contract, under_jax09 = OFF_CONTRACT[name]
    assert jax_fixtures[name] == under_jax09
    assert _rules(port_fixtures[name]) == contract, \
        port_fixtures[name].format()


def test_partial_permute_names_the_unmatched_send(port_fixtures):
    (f,) = port_fixtures["partial_ppermute"].findings
    assert "rank 3 sends 1 message(s) with tag 7 to rank 0" in f.message


def test_self_test_passes():
    from simple_distributed_machine_learning_tpu_torch.analysis.fixtures import (  # noqa: E501
        self_test,
    )
    ok, text = self_test("cpu")
    assert ok, text
    assert text.count("-> OK") == len(FIXTURES) + 2


# -- the dryrun steps ------------------------------------------------------------

def _topology(name: str):
    """(D, S, M, schedule) of a dryrun report from its name."""
    inner = name[name.index("[") + 1:-1].split()
    dims = dict(kv.split("=") for kv in inner[1:])
    return (int(dims["dp"]), int(dims["pp"]), 2,
            "1f1b" if name.startswith("1f1b") else "gpipe")


def _hop_ratio(name: str) -> Fraction:
    """Port stage-hop bytes over JAX's for one step: D·M·(S-1) hops per
    direction against M + S - 1 (GPipe) or M + 2S - 1 (1F1B) ticks."""
    D, S, M, sched = _topology(name)
    ticks = M + S - 1 if sched == "gpipe" else M + 2 * S - 1
    return Fraction(D * M * (S - 1), ticks)


def _by_prim(report) -> dict:
    out: dict = {}
    for c in report.costs:
        out[c.prim] = out.get(c.prim, 0) + c.total_bytes
    return out


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_reports_clean_and_held_to_the_jax_tables(n, jax_dryrun):
    reports = dryrun_reports(n, "cpu")
    theirs = {name: (rules, costs) for name, rules, costs
              in jax_dryrun[str(n)]}
    assert [r.name for r in reports] == list(theirs)
    for r in reports:
        assert r.ok(fail_on="warning"), r.format()
        rules, costs = theirs[r.name]
        ours = _by_prim(r)
        if rules:
            # jax 0.9's own vma check refuses these steps (the JAX run
            # ends in unreduced-gradient.trace-error); the contract is
            # clean, and the port's hop bytes follow the hop count
            assert rules == ["unreduced-gradient.trace-error"]
            D, S, M, _ = _topology(r.name)
            assert ours["ppermute"] == 2 * D * M * (S - 1) * 2 * 16 * 4
            continue
        assert set(costs) == {"ppermute"}
        assert ours["ppermute"] == costs["ppermute"] * _hop_ratio(r.name)


def test_dryrun_pins_the_jax_byte_tables(jax_dryrun):
    """The JAX tables the port is held to (ISSUE pins): train / eval /
    1F1B at 2 and 4 coordinates."""
    got = {n: [c.get("ppermute") for _, _, c in jax_dryrun[n]]
           for n in ("2", "4")}
    assert got == {"2": [768, 384, 1280], "4": [1280, 640, 1280]}


def test_data_parallel_gradient_sum_billed():
    """The port's table has what JAX's leaves implicit: the gradient sum
    over the data axis, one psum row per parameter leaf (2·(D-1)/D of its
    bytes, 1x at D = 2), and the loss numerator/denominator sums."""
    (r,) = [r for r in dryrun_reports(4, "cpu") if r.name.startswith("1f1b")]
    # MLP 16 -> 16 -> 10 over two stages: 16·16+16 + 16·10+10 floats
    assert _by_prim(r)["psum"] == (272 + 170) * 4 + 2 * 4


# -- the replication rule on the real pipeline ------------------------------

def test_dropped_data_sum_in_the_pipeline_is_flagged(monkeypatch):
    """The rule reads the real pipeline: with the data-group gradient sum
    cut out of ``Pipeline._reduce_grads`` (each replica's gradient alone
    updates the shared parameters), the dp=2 train step flags the missing
    reduction that the unmodified step does not."""
    from simple_distributed_machine_learning_tpu_torch.analysis.fixtures import (  # noqa: E501
        clean_pipeline_step,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        pipeline as pl,
    )
    assert clean_pipeline_step("cpu").ok(fail_on="warning")

    def first_replica_only(self, params, per_replica):
        return [g for s, p in enumerate(params) if p is not None
                for g in per_replica[0][s]]
    monkeypatch.setattr(pl.Pipeline, "_reduce_grads", first_replica_only)
    rules = {f.rule for f in clean_pipeline_step("cpu").findings}
    assert "unreduced-gradient.missing-reduce" in rules


def test_trace_failure_becomes_a_finding():
    """An unknown mesh axis at trace time is ``mesh-axis.unknown-axis``
    (the JAX mapping); any other trace error ``trace.failed``."""
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    mesh = make_mesh(1, n_data=2, devices=["cpu"] * 2)

    def wrong_axis(x):
        return x * mesh.view(0, 0, "tensor").size

    def broken(x):
        return x @ torch.zeros(3, 5)

    x = spec((4, 4), torch.float32)
    assert {f.rule for f in analyze(wrong_axis, x).findings} \
        == {"mesh-axis.unknown-axis"}
    assert {f.rule for f in analyze(broken, x).findings} == {"trace.failed"}


def test_ring_offset_outside_the_axis_flagged():
    """A noted ring offset must lie inside the axis."""
    from simple_distributed_machine_learning_tpu_torch.analysis import trace
    from simple_distributed_machine_learning_tpu_torch.analysis.rules import (
        run_rules,
    )

    def hop(x):
        trace.note_collective("ppermute", "seq", 2, [x], [x], site="hop",
                              offset=2)
        return x + 1

    prog = trace.trace_program(hop, spec((3,), torch.float32))
    rules = {f.rule for f in run_rules(prog)[0]}
    assert rules == {"mesh-axis.perm-out-of-range"}


# -- the kernels trace as graph nodes -------------------------------------------

def test_flash_training_traces_k1_k3_as_nodes():
    """The flash GPT's train step traces K1 once per layer and K2/K3 once
    per layer in its backward, as ``sdml::`` custom-op nodes with their
    launch specs noted — and launches nothing."""
    from simple_distributed_machine_learning_tpu_torch.analysis import trace
    from simple_distributed_machine_learning_tpu_torch.analysis.preflight import (  # noqa: E501
        abstract_batch,
    )
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.ops import (
        flash_attention as fa,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (  # noqa: E501
        Pipeline,
    )
    from simple_distributed_machine_learning_tpu_torch.train.optimizer import (
        adamw,
    )
    from simple_distributed_machine_learning_tpu_torch.train.step import (
        make_train_step,
    )
    cfg = GPTConfig(vocab=32, seq_len=16, d_model=16, n_heads=2,
                    n_layers=2, attn_impl="flash")
    stages, wire, out = make_gpt_stages(0, cfg, 1, device="cpu")
    pipe = Pipeline(stages, None, wire, out, device="cpu",
                    compute_dtype=torch.bfloat16)
    opt = adamw(1e-3)
    params = pipe.init_params()
    x, t = abstract_batch(pipe, 4, (16,))
    before = (fa.flash_forward.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    from simple_distributed_machine_learning_tpu_torch.analysis import (
        _unwrap_specs,
    )
    args, _, _, _, _ = _unwrap_specs(
        (params, opt.init(params), x, t, 0), {})
    prog = trace.trace_program(make_train_step(pipe, opt), *args)
    ops = [trace.op_name(n) for n in prog.graph.nodes]
    assert [ops.count(f"sdml.{k}") for k in
            ("flash_forward", "flash_dq", "flash_dkv")] == [2, 2, 2]
    assert sorted(s.kernel for s in prog.launches) == sorted(
        ["flash_forward"] * 2 + ["flash_dq"] * 2 + ["flash_dkv"] * 2)
    assert (fa.flash_forward.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == before
    report = analyze(make_train_step(pipe, opt), params, opt.init(params),
                     x, t, 0)
    assert report.ok(fail_on="warning"), report.format()


def test_flash_launch_specs_lint_clean():
    """K1-K3's launch specs (grid ``(B·H, ceil(T/64))``, the other side's
    tiles as the loop) prove every window in bounds, race-free and f32."""
    from simple_distributed_machine_learning_tpu_torch.analysis import kernels
    from simple_distributed_machine_learning_tpu_torch.ops.flash_attention import (  # noqa: E501
        launch_spec,
    )
    for shape, dt in (((2, 8, 256, 64), torch.bfloat16),
                      ((1, 2, 200, 40), torch.float32)):
        q = torch.empty(shape, dtype=dt, device="meta")
        for k in ("flash_forward", "flash_dq", "flash_dkv"):
            spec_ = launch_spec(k, q)
            assert spec_.grid == (shape[0] * shape[1], -(-shape[2] // 64))
            assert kernels.lint(spec_) == [], k
