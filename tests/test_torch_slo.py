"""The port's streaming SLO engine and alert state machines.

The JAX package's unit pins (``tests/test_slo.py``'s alert, windowed
histogram and ``SLOEngine`` cases) held in the port, and every case also
driven through the JAX classes on the same observation sequence: the
journals, burn rates, states and summaries must be equal. Nothing here
reads a clock.
"""

import numpy as np
import pytest

from simple_distributed_machine_learning_tpu.telemetry import alerts as jal
from simple_distributed_machine_learning_tpu.telemetry import slo as jslo
from simple_distributed_machine_learning_tpu_torch.telemetry import (
    alerts as tal,
)
from simple_distributed_machine_learning_tpu_torch.telemetry import (
    slo as tslo,
)

BOTH = pytest.mark.parametrize("al,slo", [(tal, tslo), (jal, jslo)],
                               ids=["port", "jax"])


@BOTH
def test_alert_full_cycle_one_transition_per_evaluation(al, slo):
    a = al.Alert("k", pending_ticks=2, resolve_ticks=3)
    assert a.evaluate(1, True) == ("inactive", "pending")
    assert a.evaluate(2, True) == ("pending", "firing")
    assert a.fired_at == 2 and a.firing
    assert a.evaluate(3, True) is None
    # resolve needs resolve_ticks CONSECUTIVE clear evaluations
    assert a.evaluate(4, False) is None
    assert a.evaluate(5, True) is None
    assert a.evaluate(6, False) is None
    assert a.evaluate(7, False) is None
    assert a.evaluate(8, False) == ("firing", "resolved")
    assert a.resolved_at == 8 and not a.firing
    assert a.evaluate(9, False) == ("resolved", "inactive")


@BOTH
def test_alert_blip_never_pages_and_resolved_can_retrip(al, slo):
    a = al.Alert("k", pending_ticks=2, resolve_ticks=2)
    assert a.evaluate(1, True) == ("inactive", "pending")
    assert a.evaluate(2, False) == ("pending", "inactive")
    for t, b in ((3, True), (4, True), (5, False), (6, False)):
        a.evaluate(t, b)
    assert a.state == "resolved"
    assert a.evaluate(7, True) == ("resolved", "pending")


@BOTH
def test_alert_validation(al, slo):
    with pytest.raises(ValueError):
        al.Alert("k", pending_ticks=0)
    with pytest.raises(ValueError):
        al.Alert("k", resolve_ticks=0)


@BOTH
def test_alert_book_journals_context_and_replays_active_at(al, slo):
    book = al.AlertBook(pending_ticks=1, resolve_ticks=1)
    assert book.evaluate("a", 1, True, burn_fast=2.0) == {
        "tick": 1, "alert": "a", "from": "inactive", "to": "pending",
        "burn_fast": 2.0}
    book.evaluate("a", 2, True, burn_fast=3.0)
    book.evaluate("b", 2, True)
    assert book.firing() == ["a"]
    assert book.states() == {"a": "firing", "b": "pending"}
    assert book.active_at(1) == []
    assert book.active_at(2) == ["a"] == book.active_at(2.5)
    book.evaluate("a", 3, False)
    assert book.active_at(2) == ["a"]
    assert book.active_at(3) == [] == book.firing()


@BOTH
def test_window_histogram_quantiles_are_bucket_upper_bounds(al, slo):
    h = slo.WindowHistogram(bounds=(1.0, 2.0, 5.0, 10.0), window=2)
    for v in (0.5, 1.5, 7.0):
        h.observe(v)
    h.roll()
    assert h.n == 3
    assert h.quantile(0.5) == 2.0
    assert h.quantile(1.0) == 10.0
    h.observe(100.0)                              # overflow clamps
    h.roll()
    assert h.quantile(1.0) == 10.0
    h.roll()
    h.roll()
    assert h.n == 0 and h.quantile(0.5) is None


@BOTH
def test_window_histogram_validation(al, slo):
    with pytest.raises(ValueError):
        slo.WindowHistogram(window=0)
    with pytest.raises(ValueError):
        slo.WindowHistogram(bounds=(5.0, 1.0))
    with pytest.raises(ValueError):
        slo.WindowHistogram(bounds=(1.0, 1.0))


@BOTH
def test_objective_and_engine_validation(al, slo):
    with pytest.raises(ValueError):
        slo.SLOObjective("x", ttft_slo_ms=10.0, target=1.0)
    with pytest.raises(ValueError):
        slo.SLOObjective("x")
    obj = slo.SLOObjective("x", ttft_slo_ms=10.0)
    assert obj.budget == pytest.approx(0.1)
    with pytest.raises(ValueError):
        slo.SLOEngine([obj], fast_window=4, slow_window=2)
    with pytest.raises(ValueError):
        slo.SLOEngine([obj, slo.SLOObjective("x", tpot_slo_ms=5.0)])
    with pytest.raises(ValueError):
        slo.SLOEngine([obj], min_count=0)


@BOTH
def test_from_classes_none_when_nothing_to_track(al, slo):
    class TC:
        def __init__(self, name, ttft=None, tpot=None):
            self.name, self.ttft_slo_ms, self.tpot_slo_ms = name, ttft, tpot

    assert slo.SLOEngine.from_classes([TC("a"), TC("b")]) is None
    eng = slo.SLOEngine.from_classes([TC("a"), TC("b", ttft=50.0)])
    assert set(eng.objectives) == {"b"}


@BOTH
def test_tpot_samples_stay_out_of_the_burn_series(al, slo):
    eng = slo.SLOEngine([slo.SLOObjective("x", ttft_slo_ms=10.0,
                                          tpot_slo_ms=1.0)],
                        fast_window=2, slow_window=4)
    for _ in range(100):
        eng.observe_tpot("x", 99.0)
    assert eng.evaluate(1) == []
    assert eng.burn_rates() == {"x": 0.0}
    assert eng.window_quantiles()["x_tpot_p95_ms"] == 100.0
    eng.observe_ttft("x", 99.0)
    eng.evaluate(2)
    assert eng.burn_rates() == {"x": pytest.approx(10.0)}
    eng.observe_shed("x")
    eng.observe_ttft("x", 1.0)
    eng.evaluate(3)
    assert eng.burn_rates() == {"x": pytest.approx((2 / 3) / 0.1)}
    eng.observe_ttft("ghost", 1.0)
    eng.observe_shed("ghost")


@BOTH
def test_multi_window_condition_needs_both_windows(al, slo):
    eng = slo.SLOEngine([slo.SLOObjective("x", ttft_slo_ms=10.0)],
                        fast_window=1, slow_window=32, pending_ticks=1)
    for t in range(1, 20):
        eng.observe_ttft("x", 1.0)
        eng.evaluate(t)
    eng.observe_ttft("x", 99.0)
    assert eng.evaluate(20) == []


def _drive(slo, seed: int, registry=None):
    """A seeded observation stream (two classes and two replicas, TTFTs,
    TPOTs and sheds in bursts) through one engine; returns everything it
    reports."""
    rng = np.random.default_rng(seed)
    eng = slo.SLOEngine(
        [slo.SLOObjective("interactive", ttft_slo_ms=60.0,
                          tpot_slo_ms=40.0),
         slo.SLOObjective("batch", ttft_slo_ms=400.0, target=0.8)],
        fast_window=4, slow_window=12, pending_ticks=2, resolve_ticks=3,
        registry=registry)
    rows = []
    for tick in range(1, 81):
        hot = 20 <= tick < 35 or 55 <= tick < 60
        for _ in range(int(rng.integers(0, 4))):
            cls = "interactive" if rng.random() < 0.6 else "batch"
            rep = int(rng.integers(0, 2))
            ms = float(rng.exponential(150.0 if hot else 20.0))
            if rng.random() < (0.3 if hot else 0.02):
                eng.observe_shed(cls, replica=rep)
            else:
                eng.observe_ttft(cls, ms, replica=rep)
            eng.observe_tpot(cls, float(rng.exponential(10.0)))
        rows.append(eng.evaluate(tick))
        rows.append(eng.burn_rates())
    return {"rows": rows, "summary": eng.summary(),
            "firing_replicas": sorted(eng.firing_replicas())}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_equals_the_jax_engine_on_one_stream(seed):
    from simple_distributed_machine_learning_tpu.telemetry.registry import (
        MetricsRegistry as JaxRegistry,
    )
    from simple_distributed_machine_learning_tpu_torch.telemetry.registry import (  # noqa: E501
        MetricsRegistry,
    )
    treg, jreg = MetricsRegistry(), JaxRegistry()
    ours, ref = _drive(tslo, seed, treg), _drive(jslo, seed, jreg)
    assert ours == ref
    transitions = ours["summary"]["transitions"]
    assert any(t["to"] == "firing" for t in transitions)
    assert any(t["to"] == "resolved" for t in transitions)
    assert treg.snapshot() == {k: v for k, v in jreg.snapshot().items()
                               if k.startswith(("serve_slo_burn_rate",
                                                "serve_alerts_firing"))}
