"""Per-request TTFT attribution in the PyTorch port, against the JAX
package's module and scenarios.

The unit folds (``tests/test_attribution.py``) run on the same rows
through both modules and must agree exactly. Every scenario of the
Motivation table, traced in the port, must give the JAX block's
``requests``, ``recovered``, slowest rid, its ``ttft_ms`` and
``components_ms`` exactly (both packages round the same sums on the
virtual clock), with every fold's drift within ``DRIFT_TOL_MS``.

Model: ``tests/test_scenarios.py``'s, 2 stages, weights from
``jax.random.key(0)`` carried into the port. The JAX engine's metered
tick calls its analyzer's byte model (``kv_drift``), whose module does not
import on this tree; the JAX side runs with that one method patched to
``(0, 0)``.
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
    attribution as jatt,
)
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.resilience import faults
from simple_distributed_machine_learning_tpu_torch.resilience import (
    scenarios as tscen,
)
from simple_distributed_machine_learning_tpu_torch.serve import ServeTrace
from simple_distributed_machine_learning_tpu_torch.telemetry import (
    attribution as tatt,
)
from simple_distributed_machine_learning_tpu_torch.telemetry.registry import (  # noqa: E501
    MetricsRegistry,
)

KW = dict(vocab=32, seq_len=48, d_model=32, n_heads=2, n_layers=2)

# scenario -> (requests, recovered, top-slow rid, its ttft_ms, components)
PINS = {
    "crash-serve": (16, 1, 3, 23.16, {"queue": 1.16, "prefill": 22.0}),
    "overload-shed": (11, 0, 2, 351.149, {"queue": 333.15,
                                          "prefill": 18.0}),
    "fleet-replica-loss": (16, 0, 3, 22.16, {"queue": 1.16,
                                             "prefill": 21.0}),
    "hot-prefix-skew": (18, 0, 3, 42.62, {"queue": 34.397,
                                          "prefill": 8.224}),
    "fleet-autoscale-diurnal": (50, 0, 47, 138.614, {"queue": 112.614,
                                                     "prefill": 26.0}),
    "disagg-prefill-heavy": (16, 0, 11, 74.719, {"queue": 3.719,
                                                 "prefill": 71.0}),
    "handoff-replica-loss": (16, 0, 3, 25.16, {"queue": 6.16,
                                               "prefill": 19.0}),
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


def _row(ev, t, rid=0, inc=0, **kw):
    return {"ev": ev, "t": t, "rid": rid, "inc": inc, **kw}


# -- the fold, on the same rows through both modules ----------------------------

UNIT_TIMELINES = {
    "queue-prefill-decode": [
        _row("submit", 0.0, cls="x", prompt_len=4),
        _row("admit", 0.010),
        _row("first_token", 0.030, ttft_ms=30.0),
        _row("tick", 0.040),
        _row("done", 0.050, tokens=3, reason="length"),
    ],
    "gate-chunks-preempt": [
        _row("submit", 0.0, cls="x", prompt_len=8),
        _row("gate", 0.005),
        _row("admit", 0.009),
        _row("prefill_chunk", 0.012),
        _row("preempt", 0.020),
        _row("readmit", 0.024),
        _row("admit", 0.026),
        _row("first_token", 0.040, ttft_ms=40.0),
    ],
    "crash-incarnations": [
        _row("submit", 0.0, cls="x", prompt_len=4),
        _row("admit", 0.002),
        _row("crash", 0.010),
        {"ev": "restart", "t": 0.011, "inc": 1},
        _row("readmit", 0.015, inc=1),
        _row("admit", 0.016, inc=1),
        _row("first_token", 0.020, inc=1, ttft_ms=20.0),
    ],
    "handoff": [
        _row("submit", 0.0, cls="x", prompt_len=4),
        _row("admit", 0.004),
        _row("migrate", 0.010),
        _row("readmit", 0.012),
        _row("admit", 0.013),
        _row("first_token", 0.020, ttft_ms=20.0),
    ],
    "shed": [
        _row("submit", 0.0, cls="x", prompt_len=4),
        _row("shed", 0.001, reason="deadline"),
    ],
}

UNIT_COMPONENTS = {
    "queue-prefill-decode": {"queue": 10.0, "prefill": 20.0},
    "gate-chunks-preempt": {"queue": 7.0, "prefetch": 4.0, "prefill": 25.0,
                            "preempt": 4.0},
    "crash-incarnations": {"queue": 2.0, "prefill": 12.0, "crash": 6.0},
    "handoff": {"queue": 4.0, "prefill": 13.0, "handoff": 3.0},
    "shed": None,
}


@pytest.mark.parametrize("name", sorted(UNIT_TIMELINES))
def test_fold_equals_the_jax_module(name):
    rows = UNIT_TIMELINES[name]
    ours, ref = tatt.fold_request(rows), jatt.fold_request(rows)
    assert ours == ref
    want = UNIT_COMPONENTS[name]
    if want is None:
        assert ours is None
        return
    assert ours["components_ms"] == want
    assert sum(want.values()) == ours["ttft_ms"]
    assert abs(ours["drift_ms"]) <= tatt.DRIFT_TOL_MS


def test_fold_drift_raises_in_both_modules():
    rows = [_row("submit", 0.0, cls="x", prompt_len=4),
            _row("admit", 0.010),
            _row("first_token", 0.030, ttft_ms=99.0)]
    with pytest.raises(tatt.AttributionError, match="drift"):
        tatt.fold_request(rows)
    with pytest.raises(jatt.AttributionError):
        jatt.fold_request(rows)
    assert issubclass(tatt.AttributionError, ValueError)
    assert tatt.COMPONENTS == jatt.COMPONENTS
    assert tatt.DRIFT_TOL_MS == jatt.DRIFT_TOL_MS


def test_attribute_aggregates_and_registers_histograms():
    rows = [
        _row("submit", 0.0, rid=0, cls="a", prompt_len=4),
        _row("admit", 0.010, rid=0),
        _row("first_token", 0.030, rid=0, ttft_ms=30.0),
        _row("submit", 0.001, rid=1, cls="a", prompt_len=4),
        _row("admit", 0.002, rid=1),
        _row("first_token", 0.041, rid=1, ttft_ms=40.0),
        _row("submit", 0.002, rid=2, cls="b", prompt_len=4),
        _row("shed", 0.003, rid=2, reason="class"),
    ]
    reg = MetricsRegistry()
    out = tatt.attribute(rows, registry=reg)
    assert out == jatt.attribute(rows)
    assert out["by_class"]["a"]["components_ms_mean"] == {
        "queue": 5.5, "prefill": 29.5}
    assert [a["rid"] for a in out["top_slow"]] == [1, 0]
    prom = reg.prometheus_text()
    assert 'serve_ttft_component_ms_count{component="queue"} 2' in prom
    assert 'serve_ttft_component_ms_count{component="prefill"} 2' in prom
    assert "# HELP serve_ttft_component_ms " in prom


# -- the scenario pins -----------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PINS))
def test_scenario_attribution_equals_the_jax_block(model, name):
    jcfg, jst, tcfg, tst = model
    jrep = jscen.run_scenario(name, jst, jcfg, trace=True)
    trep = tscen.run_scenario(name, tst, tcfg, trace=True, device="cpu")
    att = trep["attribution"]
    requests, recovered, rid, ttft, comps = PINS[name]
    assert (att["requests"], att["recovered"]) == (requests, recovered)
    top = att["top_slow"][0]
    assert (top["rid"], top["ttft_ms"], top["components_ms"]) == (
        rid, ttft, comps)
    assert att["max_abs_drift_ms"] <= tatt.DRIFT_TOL_MS
    for a in att["top_slow"]:
        assert abs(a["drift_ms"]) <= tatt.DRIFT_TOL_MS
    # the whole block, and the event count, as the JAX package's
    assert att == jrep["attribution"]
    assert trep["trace_events"] == jrep["trace_events"]


def test_crash_serve_recovered_rid_spans_both_incarnations(model):
    tr = ServeTrace()
    rep = tscen.run_scenario("crash-serve", model[3], model[2], trace=tr,
                             device="cpu")
    assert rep["attribution"]["max_abs_drift_ms"] == 0.0
    a0 = tatt.fold_request([r for r in tr.rows if r.get("rid") == 0])
    assert a0["incarnations"] == [0, 1] and a0["recovered"]
    assert sum(a0["components_ms"].values()) == pytest.approx(
        a0["ttft_ms"], abs=tatt.DRIFT_TOL_MS)


def test_attribution_block_deterministic(model):
    r1 = tscen.run_scenario("crash-serve", model[3], model[2], trace=True,
                            device="cpu")
    r2 = tscen.run_scenario("crash-serve", model[3], model[2], trace=True,
                            device="cpu")
    assert (json.dumps(r1["attribution"], sort_keys=True)
            == json.dumps(r2["attribution"], sort_keys=True))
