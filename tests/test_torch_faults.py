"""The port's fault-injection module against the JAX package's.

The schedule grammar, its parse errors, ``FaultPlan.random`` and the
firing accounting (``check`` / ``fire`` / ``stats``) must equal the JAX
module's on the same strings, seeds and call sequences, so one
``--serve-chaos`` string means one schedule in both packages. The
process-global plan is uninstalled around every test.
"""

import pytest

from simple_distributed_machine_learning_tpu.resilience import (
    faults as jfaults,
)
from simple_distributed_machine_learning_tpu_torch.resilience import faults


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.uninstall()
    jfaults.uninstall()
    yield
    faults.uninstall()
    jfaults.uninstall()


GOOD = [
    "engine-crash@serve.tick=6",
    "slow-tick@serve.tick,dur=0.004,after=5,times=10",
    "engine-crash@serve.tick,after=3,times=2",
    "wedged-device@serve.admit=1;host-kill@serve.tick=4",
    "host-kill@train.step=6",
    "frozen-peer@watchdog.heartbeat,rank=1",
    "nan-grad@train.grad=12",
    "corrupt-batch@data.batch=3;preempt@train.sigterm=20",
    " replica-kill@fleet.tick=5,rank=1 ; ",
    "engine-crash@serve.tick,step=7,times=0",
]

BAD = [
    "",
    ";;",
    "engine-crash",
    "engine-crash@serve.tock=1",
    "engine-krash@serve.tick",
    "engine-crash@serve.tick,dur",
    "engine-crash@serve.tick,bogus=1",
    "engine-crash@serve.tick=x",
    "nan-grad@serve.tick",
    "engine-crash@fleet.tick",
    "slow-tick@serve.tick,after=-1",
]


@pytest.mark.parametrize("text", GOOD)
def test_parse_equals_the_jax_grammar(text):
    ours, ref = faults.FaultPlan.parse(text), jfaults.FaultPlan.parse(text)
    assert ([vars(s) for s in ours.specs]
            == [vars(s) for s in ref.specs])
    assert ours.stats() == ref.stats()


@pytest.mark.parametrize("text", BAD)
def test_parse_errors_equal_the_jax_messages(text):
    with pytest.raises(ValueError) as ref:
        jfaults.FaultPlan.parse(text)
    with pytest.raises(ValueError) as ours:
        faults.FaultPlan.parse(text)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (3, dict(n=5, sites=("serve.tick", "serve.admit"),
             kinds=("engine-crash", "slow-tick", "wedged-device"),
             max_step=40)),
    (11, dict(n=4, kinds=("nan-grad", "host-kill", "preempt"))),
])
def test_random_schedule_equals_the_jax_one(seed, kw):
    ours = faults.FaultPlan.random(seed, **kw)
    ref = jfaults.FaultPlan.random(seed, **kw)
    assert ours.stats() == ref.stats()
    assert ours.stats() == faults.FaultPlan.random(seed, **kw).stats()


def test_firing_accounting_equals_the_jax_module():
    """One call sequence through both modules' ``check``: the same specs
    fire at the same calls (``after``, ``times``, ``step``, ``rank``, the
    ``only``/``exclude`` filters), and ``stats`` agree at the end."""
    text = ("slow-tick@serve.tick,after=2,times=3;"
            "engine-crash@serve.tick=5;host-kill@serve.admit,times=0;"
            "replica-kill@fleet.tick,rank=1")
    ours, ref = faults.FaultPlan.parse(text), jfaults.FaultPlan.parse(text)
    calls = ([("serve.tick", dict(step=i)) for i in range(9)]
             + [("serve.admit", dict(step=i)) for i in range(3)]
             + [("fleet.tick", dict(step=1, rank=r)) for r in (0, 1, 1)]
             + [("serve.tick", dict(step=6, only=("slow-tick",))),
                ("serve.tick", dict(step=7, exclude=("slow-tick",)))])
    for site, ctx in calls:
        a = [s.kind for s in ours.check(site, **ctx)]
        b = [s.kind for s in ref.check(site, **ctx)]
        assert a == b, (site, ctx)
    assert ours.stats() == ref.stats()
    assert ours.stats()["fired"] == [3, 1, 3, 1]


def test_fire_applies_the_standard_effects():
    slept = []
    plan = faults.install(faults.FaultPlan.parse(
        "slow-tick@serve.tick=0,dur=0.25;engine-crash@serve.tick=1;"
        "wedged-device@serve.tick=2;host-kill@serve.admit=0",
        sleep=slept.append))
    assert [s.kind for s in faults.maybe_fire("serve.tick", step=0)] == [
        "slow-tick"]
    assert slept == [0.25]
    with pytest.raises(faults.EngineCrash, match="serve.tick"):
        faults.maybe_fire("serve.tick", step=1)
    with pytest.raises(faults.DeviceWedged):
        faults.maybe_fire("serve.tick", step=2)
    with pytest.raises(faults.HostLost):
        faults.maybe_fire("serve.admit", step=0)
    assert faults.active() is plan and plan.stats()["total_fired"] == 4
    faults.uninstall()
    assert faults.maybe_fire("serve.tick", step=1) == []
    assert faults.check("serve.tick", step=1) == []


def test_install_from_env(monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    assert faults.install_from_env() is None
    monkeypatch.setenv(faults.ENV_VAR, "engine-crash@serve.tick=2")
    plan = faults.install_from_env()
    assert faults.active() is plan and plan.specs[0].step == 2


def test_drill_coverage_finds_the_ports_serve_sites():
    """The port instruments the Trainer's four sites, the checkpoint
    writer's, the engine's two and the fleet's two, and its tests drill
    all nine, every kind the supervisors and the fleet act on and every
    pinned pair (the sentinel's numeric kinds and preempt on their
    sites); a site or kind with no drill, and an undrilled pinned pair,
    are reported."""
    assert faults.instrumented_sites() == (
        "train.step", "train.grad", "data.batch", "train.sigterm",
        "ckpt.write", "serve.tick", "serve.admit", "fleet.tick",
        "fleet.handoff")
    assert faults.drill_coverage() == []
    # (the undrilled pair is spelled in two pieces: written whole, this
    # file's own text would drill it)
    gaps = faults.drill_coverage(kinds=("engine-crash", "never-drilled"),
                                 sites=("serve.tick", "bench.probe"),
                                 pairs={"replica-kill": "train.step"})
    assert any("'never-drilled' is registered" in g for g in gaps)
    assert any("'bench.probe' is instrumented" in g for g in gaps)
    assert any("replica-kill" + "@train.step" in g for g in gaps)
    assert len(gaps) == 3
