"""The run-report CLI and the metric-help catalog of the PyTorch port,
against the JAX package's modules.

- On one directory written by a JAX ``run_scenario(..., outdir=,
  trace=True)``, the port's ``collect`` and ``render`` equal the JAX
  module's.
- On the directory the port's own run writes, the ``--json`` document
  equals the JAX one's except the fields named in ``EXPECTED_DIFF``.
- The port's Prometheus exposition carries a ``# HELP`` line for every
  instrument it emits that the JAX catalog documents.

The JAX engine's metered tick calls its analyzer's byte model
(``kv_drift``), whose module does not import on this tree; the JAX side
runs with that one method patched to ``(0, 0)``.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.resilience import (
    faults as jfaults,
)
from simple_distributed_machine_learning_tpu.resilience import (
    scenarios as jscen,
)
from simple_distributed_machine_learning_tpu.serve.engine import (
    InferenceEngine as JaxEngine,
)
from simple_distributed_machine_learning_tpu.telemetry import (
    catalog as jcatalog,
)
from simple_distributed_machine_learning_tpu.telemetry import (
    report as jreport,
)
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.resilience import faults
from simple_distributed_machine_learning_tpu_torch.resilience import (
    scenarios as tscen,
)
from simple_distributed_machine_learning_tpu_torch.telemetry import (
    catalog as tcatalog,
)
from simple_distributed_machine_learning_tpu_torch.telemetry import (
    report as treport,
)

KW = dict(vocab=32, seq_len=48, d_model=32, n_heads=2, n_layers=2)
SCENARIOS = ("crash-serve", "disagg-prefill-heavy")

# fields of the --json document where the port's own run differs from the
# JAX run's, each with its reason
EXPECTED_DIFF = {
    # each run's own directory, and the wall-clock stamp append_jsonl puts
    # on every metrics.jsonl record
    ("dir",): "the run's directory",
    ("serve", "time"): "wall clock of the write",
    ("scenarios", 0, "time"): "wall clock of the write",
    # sampled requests draw from each package's own generator, so their
    # journaled `tok`/`kd` numbers (and with them the journal's size)
    # differ; greedy ones and every count are equal
    ("serve", "journal_bytes"): "the journal's sampled tok/kd",
    # the JAX engine's kv_drift is patched to (0, 0) (its byte model does
    # not import on this tree), so its KV-drift gauges read 0
    ("serve", "kv_bytes_predicted"): "the JAX side's patched kv_drift",
    ("serve", "kv_drift_bytes"): "the JAX side's patched kv_drift",
}


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


@pytest.fixture(scope="module")
def model():
    jcfg = jgpt.GPTConfig(**KW)
    jst = jgpt.make_gpt_stages(jax.random.key(0), jcfg, 2)[0]
    nparams = jax.tree.map(np.asarray, [s.params for s in jst])
    tcfg = tgpt.GPTConfig(**KW)
    tst = tgpt.make_gpt_stages(0, tcfg, 2, device="cpu")[0]
    tst = [dataclasses.replace(s, params=p)
           for s, p in zip(tst, params_from_numpy(nparams, "cpu"))]
    return jcfg, jst, tcfg, tst


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.setattr(JaxEngine, "kv_drift", lambda self: (0, 0))
    faults.uninstall()
    jfaults.uninstall()
    yield
    faults.uninstall()
    jfaults.uninstall()


def _diff(a, b, path=()):
    """Paths where two JSON values differ (a key missing on one side
    counts)."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = []
        for k in sorted(set(a) | set(b), key=str):
            if k not in a or k not in b:
                out.append(path + (k,))
            else:
                out += _diff(a[k], b[k], path + (k,))
        return out
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [p for i, (u, v) in enumerate(zip(a, b))
                for p in _diff(u, v, path + (i,))]
    return [] if a == b else [path]


@pytest.mark.parametrize("name", SCENARIOS)
def test_collect_and_render_equal_the_jax_module(model, tmp_path, name):
    jcfg, jst, _, _ = model
    d = str(tmp_path / "jax")
    jscen.run_scenario(name, jst, jcfg, outdir=d, trace=True)
    ours = treport.collect(d)
    assert ours == jreport.collect(d)
    text = treport.render(ours)
    assert text == jreport.render(jreport.collect(d))
    assert f"scenario {name} [PASS]" in text
    assert f"attribution [{name}]" in text


@pytest.mark.parametrize("name", SCENARIOS)
def test_port_written_report_equals_the_jax_one(model, tmp_path, capsys,
                                                name):
    jcfg, jst, tcfg, tst = model
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jscen.run_scenario(name, jst, jcfg, outdir=jd, trace=True)
    tscen.run_scenario(name, tst, tcfg, outdir=td, trace=True, device="cpu")
    assert jreport.main(["--dir", jd, "--json"]) == 0
    jdoc = json.loads(capsys.readouterr().out)
    assert treport.main(["--dir", td, "--json"]) == 0
    tdoc = json.loads(capsys.readouterr().out)
    assert set(_diff(jdoc, tdoc)) <= set(EXPECTED_DIFF)
    assert tdoc["scenarios"][0]["slo_ok"]
    assert tdoc["attribution"] == jdoc["attribution"]
    assert tdoc["timelines"] == jdoc["timelines"]
    assert tdoc["traces"] == jdoc["traces"]
    assert tdoc["journals"] == jdoc["journals"]


def test_prometheus_help_lines_cover_the_catalog(model, tmp_path):
    """Every instrument the port emits that the JAX catalog documents has
    a ``# HELP`` line; the fleet's read as the JAX package's."""
    _, _, tcfg, tst = model
    d = tmp_path / "run"
    tscen.run_scenario("handoff-replica-loss", tst, tcfg, outdir=str(d),
                       trace=True, device="cpu")
    prom = (d / "metrics.prom").read_text()
    emitted = {line.split()[2] for line in prom.splitlines()
               if line.startswith("# TYPE ")}
    helped = {line.split()[2]: line.split(None, 3)[3]
              for line in prom.splitlines() if line.startswith("# HELP ")}
    jax_help = jcatalog.metric_help()
    documented = emitted & set(jax_help)
    assert {"serve_fleet_replicas", "serve_fleet_handoffs_total",
            "serve_fleet_migrations_total", "serve_ttft_component_ms",
            "serve_slo_burn_rate", "serve_ttft_ms"} <= documented
    assert documented <= set(helped)
    for name in ("serve_fleet_replicas", "serve_fleet_migrations_total",
                 "serve_ttft_component_ms"):
        assert helped[name] == " ".join(jax_help[name].split()), name
    assert set(helped) <= set(tcatalog.metric_help())


def test_catalog_parses_the_port_sources():
    ours = tcatalog.metric_help()
    assert "serve_route_alert_demotions_total" in ours
    assert "serve_pool_queue_depth" in ours
    assert ours["serve_fleet_replicas"] == jcatalog.metric_help()[
        "serve_fleet_replicas"]
    # bullets without an em dash carry no help text
    assert tcatalog._parse_doc("- ``x`` (gauge) no dash") == {}
