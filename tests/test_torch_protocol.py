"""The port's serve-protocol model checker against the JAX package's
(``tests/test_protocol_model.py``'s pins, held on the port).

- The statespace corners: dedup soundness, depth-bound honesty, the state
  cap, shortest counterexamples, byte-identical reruns.
- The proof: the clean 2-pool model proves every invariant to depth 8
  (982 states, 2216 transitions); each seeded defect yields its
  invariant's counterexample, whose exported schedule parses with the
  port's ``FaultPlan``. Every report is byte-identical to the JAX
  checker's, and so is the CLI's output.
- The committed drills: the double-serve export is byte-equal to what the
  port renders, ``drill_coverage`` counts the ``.chaos`` files, and both
  drills replay on the port's ``ServeFleet`` exactly once, with the JAX
  fleet's tokens, replica losses and handoffs from the same weights.
- ``abstract_recover`` against the port's ``recover_state``, and the
  journal-grammar lint on the port's writers and readers.
"""

import dataclasses
import io
import os
import subprocess
import sys
import time
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest

from simple_distributed_machine_learning_tpu.analysis import (
    protocol as jprotocol,
)
from simple_distributed_machine_learning_tpu.analysis.__main__ import (
    main as jax_main,
)
from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.resilience import (
    faults as jfaults,
)
from simple_distributed_machine_learning_tpu.serve import (
    engine_factory as jax_factory,
)
from simple_distributed_machine_learning_tpu.serve.engine import (
    InferenceEngine as JaxEngine,
)
from simple_distributed_machine_learning_tpu.serve.fleet import (
    ServeFleet as JaxFleet,
)
from simple_distributed_machine_learning_tpu_torch.analysis.__main__ import (
    main,
)
from simple_distributed_machine_learning_tpu_torch.analysis.hostlint import (
    lint_journal_grammar,
)
from simple_distributed_machine_learning_tpu_torch.analysis.protocol import (
    CLEAN,
    DROPPED_TOMBSTONE,
    INVARIANTS,
    LEGACY_ORDER,
    SKIPPED_REFUND,
    UNGATED_BOARDING,
    abstract_recover,
    check_protocol,
    export_fault_plan,
    load_drill,
    render_drill,
)
from simple_distributed_machine_learning_tpu_torch.analysis.report import (
    Severity,
)
from simple_distributed_machine_learning_tpu_torch.analysis.statespace import (  # noqa: E501
    Violation,
    explore,
)
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.resilience import faults
from simple_distributed_machine_learning_tpu_torch.serve import (
    ServeFleet,
    engine_factory,
)
from simple_distributed_machine_learning_tpu_torch.serve.journal import (
    recover_state,
)
from simple_distributed_machine_learning_tpu_torch.serve.request import DONE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRILLS = os.path.join(REPO, "tests", "data", "protocol_drills")
DEFECTS = [(DROPPED_TOMBSTONE, "double-serve"),
           (LEGACY_ORDER, "lost-request"),
           (SKIPPED_REFUND, "refcount"),
           (UNGATED_BOARDING, "boarding-gate")]
DEFECT_IDS = ["dropped-tombstone", "legacy-order", "skipped-refund",
              "ungated-boarding"]
# the JAX twin of each config, by name
JAX_CFG = {id(CLEAN): jprotocol.CLEAN,
           id(DROPPED_TOMBSTONE): jprotocol.DROPPED_TOMBSTONE,
           id(LEGACY_ORDER): jprotocol.LEGACY_ORDER,
           id(SKIPPED_REFUND): jprotocol.SKIPPED_REFUND,
           id(UNGATED_BOARDING): jprotocol.UNGATED_BOARDING}
# tests/test_protocol_model.py's fleet drill shape
FLEET_KW = dict(vocab=32, seq_len=48, d_model=32, n_heads=2, n_layers=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs: its models are
    tiny, and under a multi-process test run more threads only contend
    for the same cores. Restored afterwards."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_leftover_plan(monkeypatch):
    monkeypatch.setattr(JaxEngine, "kv_drift", lambda self: (0, 0))
    faults.uninstall()
    jfaults.uninstall()
    yield
    faults.uninstall()
    jfaults.uninstall()


# ---- 1. statespace corners ------------------------------------------------

def test_dedup_diamond_explores_join_once():
    def trans(s):
        if s == "i":
            return [(("a",), "A"), (("b",), "B")]
        if s in ("A", "B"):
            return [(("join",), "T")]
        if s == "T":
            return [(("tail",), "Z")]
        return []
    res = explore("i", trans, {}, depth=10)
    assert res.states == 5                 # i, A, B, T, Z — not 6
    assert res.dedup_hits == 1             # the second edge into T
    assert res.transitions == 5
    assert res.complete


def test_ghost_state_differences_are_not_deduped():
    def trans(s):
        path, count = s
        if path == "i":
            return [(("cheap",), ("T", count)), (("costly",), ("T", count + 1))]
        return []
    res = explore(("i", 0), trans, {}, depth=3)
    assert res.states == 3 and res.dedup_hits == 0


def test_depth_bound_honesty():
    def unbounded(s):
        return [(("inc",), s + 1)]
    res = explore(0, unbounded, {}, depth=4)
    v = res.verdict(["inv"])
    assert "proved to depth 4" in v and "deeper schedules unexplored" in v
    assert not res.complete

    def finite(s):
        return [(("inc",), s + 1)] if s < 2 else []
    res2 = explore(0, finite, {}, depth=10)
    v2 = res2.verdict(["inv"])
    assert res2.complete
    assert "proved to depth 10" in v2 and "state space exhausted" in v2
    for verdict in (v, v2):
        assert "proved" not in verdict.replace("proved to depth", "")


def test_state_cap_is_never_a_proof():
    def unbounded(s):
        return [(("inc",), s + 1)]
    res = explore(0, unbounded, {}, depth=100, max_states=5)
    assert res.truncated and not res.complete
    v = res.verdict(["inv"])
    assert "inconclusive" in v and "nothing proved" in v
    assert "proved to depth" not in v


def test_bfs_counterexample_is_shortest():
    def trans(s):
        return [(("inc",), s + 1), (("double",), s * 2)] if s < 40 else []
    res = explore(1, trans, {"small": lambda s: None if s < 4 else f"s={s}"},
                  depth=12)
    [v] = res.violations
    assert v.depth == 2 and v.trace == (("double",), ("double",))
    assert "violated at depth 2" in v.render()


def test_reports_are_byte_identical_across_runs():
    a = check_protocol(DROPPED_TOMBSTONE)
    b = check_protocol(DROPPED_TOMBSTONE)
    assert a.verdict == b.verdict
    assert a.format() == b.format()
    assert ([v.render() for v in a.exploration.violations]
            == [v.render() for v in b.exploration.violations])


# ---- 2. the proof, and parity with the JAX checker -------------------------

def test_clean_model_proves_to_depth_8_fast():
    assert CLEAN.depth >= 8
    assert CLEAN.n_prefill >= 1 and CLEAN.n_decode >= 1
    assert CLEAN.crash_budget >= 1 and CLEAN.handoff_budget >= 1
    t0 = time.monotonic()
    report = check_protocol(CLEAN)
    assert time.monotonic() - t0 < 60
    assert report.findings == []
    assert report.ok(fail_on="warning")
    assert report.verdict.startswith(f"proved to depth {CLEAN.depth}")
    assert (report.exploration.states, report.exploration.transitions) == (
        982, 2216)
    for inv in INVARIANTS:
        assert inv in report.verdict


@pytest.mark.parametrize("cfg", [CLEAN] + [c for c, _ in DEFECTS],
                         ids=["clean"] + DEFECT_IDS)
def test_report_is_byte_identical_to_jax(cfg):
    """The port's report text, verdict and counterexample traces equal
    the JAX checker's on the same config, byte for byte."""
    ours = check_protocol(cfg)
    ref = jprotocol.check_protocol(JAX_CFG[id(cfg)])
    assert ours.format() == ref.format(costs=False)
    assert ours.verdict == ref.verdict
    assert cfg.summary() == JAX_CFG[id(cfg)].summary()
    assert ([v.trace for v in ours.exploration.violations]
            == [v.trace for v in ref.exploration.violations])
    assert ([v.render() for v in ours.exploration.violations]
            == [v.render() for v in ref.exploration.violations])
    ex, rx = ours.exploration, ref.exploration
    assert (ex.states, ex.transitions, ex.dedup_hits, ex.depth_reached,
            ex.complete) == (rx.states, rx.transitions, rx.dedup_hits,
                             rx.depth_reached, rx.complete)


@pytest.mark.parametrize("cfg,invariant", DEFECTS, ids=DEFECT_IDS)
def test_defect_config_yields_counterexample(cfg, invariant):
    report = check_protocol(cfg)
    assert not report.ok(fail_on="error")
    assert f"protocol.{invariant}" in {f.rule for f in report.findings}
    v = next(v for v in report.exploration.violations
             if v.invariant == invariant)
    assert v.trace and v.depth == len(v.trace)
    plan, note = export_fault_plan(v)
    if plan is not None:
        # every exported schedule installs as-is with the port's parser
        assert faults.FaultPlan.parse(plan).specs
    else:
        assert "model-only" in note or "no schedulable" in note or \
            "no crash" in note


@pytest.mark.parametrize("argv,env", [
    (["--serve-protocol"], None),
    (["--serve-protocol", "--depth", "6", "--fail-on", "warning"], None),
    (["--serve-protocol", "--depth", "5"], "drill"),
], ids=["depth8", "depth6-warning", "inject"])
def test_cli_output_and_exit_code_match_jax(argv, env, monkeypatch):
    """``--serve-protocol`` prints the JAX CLI's report, model,
    invariants, verdict and closing line, with its exit code, the
    ``SDML_LINT_INJECT`` gate drill included."""
    if env is not None:
        monkeypatch.setenv("SDML_LINT_INJECT", env)
    outs = []
    for fn in (main, jax_main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = fn(argv)
        outs.append((rc, buf.getvalue()))
    assert outs[0] == outs[1]
    assert outs[0][0] == (2 if env else 0)


@pytest.mark.parametrize("flag,item", [
    (["--hostlint"], "item 7.2, hostlint"),
    (["--serve"], "item 7.4"),
    (["--dryrun", "8"], "item 7.4"),
])
def test_unported_cli_modes_name_their_item(flag, item):
    with pytest.raises(SystemExit, match=rf"ROADMAP\.md, Queue A: {item}"):
        main(flag)


# ---- 3. counterexamples -> chaos drills -----------------------------------

def test_exported_drill_file_matches_model():
    """The committed double-serve drill is the port's export, byte for
    byte: the rendered file and its schedule line."""
    report = check_protocol(DROPPED_TOMBSTONE)
    v = next(v for v in report.exploration.violations
             if v.invariant == "double-serve")
    path = os.path.join(DRILLS, "dropped_handoff_double_serve.chaos")
    with open(path, encoding="utf-8") as f:
        assert render_drill(v, DROPPED_TOMBSTONE) == f.read()
    assert load_drill(path) == export_fault_plan(v)[0]


def test_render_load_drill_round_trip(tmp_path):
    report = check_protocol(DROPPED_TOMBSTONE)
    v = report.exploration.violations[0]
    text = render_drill(v, DROPPED_TOMBSTONE)
    p = tmp_path / "x.chaos"
    p.write_text(text)
    plan, _ = export_fault_plan(v)
    assert load_drill(str(p)) == plan
    assert v.invariant in text and "model config:" in text


def test_mid_handoff_crash_exports_handoff_site():
    v = Violation(invariant="double-serve", message="m",
                  trace=(("handoff_begin", 0, 0), ("crash", 0, "mid-handoff")),
                  depth=2)
    plan, _ = export_fault_plan(v)
    assert plan == "replica-kill@fleet.handoff,rank=0"
    [spec] = faults.FaultPlan.parse(plan).specs
    assert (spec.kind, spec.site, spec.rank) == \
        ("replica-kill", "fleet.handoff", 0)


def test_host_crash_counterexamples_are_model_only():
    v = Violation(invariant="lost-request", message="m",
                  trace=(("submit_journal", 0), ("crash_host",)), depth=2)
    plan, note = export_fault_plan(v)
    assert plan is None
    assert "whole-host crash" in note


# ---- 4. abstract recovery vs the port's fold ------------------------------

def _submit(rid, max_new):
    return {"ev": "submit", "rid": rid, "prompt": [1, 2], "max_new": max_new,
            "temp": 0.0, "top_k": None, "top_p": None, "eos": None,
            "seed": 0, "cls": None, "prio": 0, "ttft_dl": None, "dl": None,
            "t": 0.0}


def _tok(rid, tok):
    # deliberately tick-less and time-less: the old journal grammar
    return {"ev": "tok", "rid": rid, "tok": tok, "kd": [0, 0]}


def _snap(rid, state, toks, max_new):
    # deliberately why-less: a snap record from before the field
    ev = _submit(rid, max_new)
    ev.update({"ev": "snap", "state": state, "reason": None,
               "toks": toks, "kd": None, "ftt": None, "dt": None})
    return ev


OLD_GRAMMAR_JOURNAL = [
    _submit(0, 4), _tok(0, 9), _tok(0, 9),
    {"ev": "handoff", "rid": 0},                       # tombstoned: gone
    _submit(1, 3), _tok(1, 5),                         # in flight, 1/3
    _snap(2, "queued", [5, 6], 2),                     # not-acked: promotes
    _submit(3, 4), _tok(3, 7),
    {"ev": "done", "rid": 3, "reason": "eos"},         # acknowledged done
    {"ev": "handoff", "rid": 4},
    _snap(4, "queued", [8], 4),                        # adopted back: lives
    _submit(5, 4),
    {"ev": "shed", "rid": 5, "reason": "overload"},
    {"ev": "restart", "n": 1},                         # observability-only
]


def test_abstract_recover_matches_recover_state_on_old_journals():
    """The model's fold and the port's ``recover_state`` agree rid for rid
    (the tombstone drop, the snap resurrection after a handoff back, the
    journaled-but-not-acked DONE promotion), as the JAX pair does."""
    real = recover_state(OLD_GRAMMAR_JOURNAL)
    model = abstract_recover(OLD_GRAMMAR_JOURNAL)
    assert set(real) == set(model) == {1, 2, 3, 4, 5}
    to_model = {"queued": "q", "active": "a", "done": "d", "shed": "s"}
    for rid, r in real.items():
        st, ntok = model[rid]
        assert to_model[r.state] == st, f"rid {rid}"
        assert len(r.tokens) == ntok, f"rid {rid}"
    assert model[2] == ("d", 2)
    assert model[4][0] == "q"
    assert model == jprotocol.abstract_recover(OLD_GRAMMAR_JOURNAL)


# ---- 5. journal-grammar lint ----------------------------------------------

def test_journal_grammar_clean_on_repo():
    """Every kind the port's ``serve/`` writers emit has a reader in its
    ``recover_state`` or telemetry report — and the writers emit the
    protocol's whole grammar."""
    assert lint_journal_grammar() == []


def test_journal_grammar_flags_unread_event_kind(tmp_path):
    w = tmp_path / "writer.py"
    w.write_text('def log_promote(j, rid):\n'
                 '    j.append({"ev": "promote", "rid": rid})\n')
    r = tmp_path / "reader.py"
    r.write_text('def recover(evs):\n'
                 '    for ev in evs:\n'
                 '        kind = ev["ev"]\n'
                 '        if kind == "submit":\n'
                 '            pass\n'
                 '        elif kind in ("tok", "done"):\n'
                 '            pass\n')
    findings = lint_journal_grammar([str(w)], [str(r)], repo=str(tmp_path))
    assert [f.rule for f in findings] == ["journal-grammar.unread-event"]
    assert findings[0].severity is Severity.ERROR
    assert "'promote'" in findings[0].message
    assert findings[0].where == "writer.py:2"

    r2 = tmp_path / "reader2.py"
    r2.write_text('def report(evs):\n'
                  '    return [e for e in evs if e.get("ev") == "promote"]\n')
    assert lint_journal_grammar([str(w)], [str(r), str(r2)],
                                repo=str(tmp_path)) == []


def test_serve_protocol_cli_runs_without_jax():
    """The port's ``--serve-protocol`` runs (and proves) in a process
    where jax is blocked."""
    prog = (
        "import sys\n"
        "for m in [k for k in sys.modules"
        " if k == 'jax' or k.startswith(('jax.', 'jaxlib'))]:\n"
        "    del sys.modules[m]\n"
        "class B:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'jax' or name.startswith(('jax.', 'jaxlib')):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, B())\n"
        "try:\n"
        "    import jax\n"
        "except ImportError:\n"
        "    pass\n"
        "else:\n"
        "    print('BLOCKER INERT'); sys.exit(3)\n"
        "from simple_distributed_machine_learning_tpu_torch.analysis."
        "__main__ import main\n"
        "rc = main(['--serve-protocol', '--depth', '6'])\n"
        "assert not [k for k in sys.modules if k.startswith(('jax', "
        "'simple_distributed_machine_learning_tpu.'))], 'leaked'\n"
        "sys.exit(rc)\n"
    )
    proc = subprocess.run([sys.executable, "-c", prog], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "proved to depth 6" in proc.stdout


# ---- 6. the drills, on the port's fleet -----------------------------------

def test_drill_coverage_learns_exported_chaos_drills(tmp_path):
    """``tests/data/protocol_drills/*.chaos`` is a coverage source: with
    them counted the port has no gap, and a root holding only the
    handoff-kill drill covers the ``replica-kill@fleet.handoff`` pair that
    a root without it misses."""
    assert faults.drill_coverage() == []
    args = dict(kinds=("replica-kill",), sites=("fleet.handoff",),
                pairs={"replica-kill": "fleet.handoff"})
    d = tmp_path / "tests" / "data" / "protocol_drills"
    (tmp_path / "tests").mkdir()
    assert faults.drill_coverage(str(tmp_path), **args) != []
    d.mkdir(parents=True)
    with open(os.path.join(DRILLS, "handoff_kill.chaos"),
              encoding="utf-8") as f:
        (d / "handoff_kill.chaos").write_text(f.read())
    assert faults.drill_coverage(str(tmp_path), **args) == []


@pytest.fixture(scope="module")
def fleet_model():
    """tests/test_protocol_model.py's drill model in both packages (the
    port's weights carried over from the JAX build), and its prompt."""
    jcfg = jgpt.GPTConfig(**FLEET_KW)
    jst = jgpt.make_gpt_stages(jax.random.key(0), jcfg, 2)[0]
    nparams = jax.tree.map(np.asarray, [s.params for s in jst])
    cfg = tgpt.GPTConfig(**FLEET_KW)
    tst = tgpt.make_gpt_stages(0, cfg, 2, device="cpu")[0]
    tst = [dataclasses.replace(s, params=p)
           for s, p in zip(tst, params_from_numpy(nparams, "cpu"))]
    prompt = np.asarray(
        jax.random.randint(jax.random.key(3), (4,), 0, jcfg.vocab), np.int32)
    return dict(jcfg=jcfg, jst=jst, cfg=cfg, tst=tst, prompt=prompt)


def _replay(fleet_cls, factory, fmod, plan_text, prompt, journal_dir):
    """The drill at tests/test_protocol_model.py's shape: 1 prefill + 2
    decode replicas, one 4-token request, the plan installed for up to 80
    fleet ticks, then 10 settle ticks. Returns what the caller saw and
    the fleet's counts."""
    fleet = fleet_cls(factory, journal_dir, n_replicas=3,
                      prefill_replicas=1, journal_sync=False)
    got = []
    h = fleet.submit(prompt, max_new_tokens=4, seed=3,
                     on_token=lambda req, tok: got.append(int(tok)))
    fmod.install(fmod.FaultPlan.parse(plan_text))
    for _ in range(80):
        fleet.step()
        if h.state == DONE:
            break
    fmod.uninstall()
    for _ in range(10):                      # settle: nothing replays after
        fleet.step()
    fleet.close()
    return dict(state=h.state, tokens=[int(t) for t in h.tokens], got=got,
                handoffs=fleet.handoffs, losses=fleet.replica_losses)


@pytest.mark.parametrize("drill,plan_text,losses", [
    ("handoff_kill.chaos", "replica-kill@fleet.handoff,rank=0", 1),
    ("dropped_handoff_double_serve.chaos",
     "replica-kill@fleet.tick,rank=1;replica-kill@fleet.tick,rank=0,after=1",
     2),
], ids=["handoff-kill", "dropped-handoff-double-serve"])
def test_drill_replays_exactly_once_like_the_jax_fleet(fleet_model, tmp_path,
                                                       drill, plan_text,
                                                       losses):
    """Each committed drill on the port's ``ServeFleet`` serves its
    request exactly once (the caller's stream is the handle's, 4 tokens),
    with the JAX fleet's tokens, replica losses and handoffs."""
    m = fleet_model
    assert load_drill(os.path.join(DRILLS, drill)) == plan_text
    kw = dict(n_slots=2, block_size=4, prefill_chunk=3)
    ours = _replay(ServeFleet, engine_factory(m["tst"], m["cfg"],
                                              device="cpu", **kw),
                   faults, plan_text, m["prompt"], str(tmp_path / "t"))
    ref = _replay(JaxFleet, jax_factory(m["jst"], m["jcfg"], **kw), jfaults,
                  plan_text, m["prompt"], str(tmp_path / "j"))
    assert ours["state"] == DONE
    assert ours["got"] == ours["tokens"] and len(ours["tokens"]) == 4
    assert ours == ref
    assert ours["losses"] == losses
    if drill == "handoff_kill.chaos":
        assert ours["handoffs"] >= 1
    else:
        assert ours["handoffs"] == 0
