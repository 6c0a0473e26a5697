"""The port's hostlint (``analysis/hostlint.py``) against the JAX
package's on the same seeded files, its retargeted rules on seeded
positives of their own, the port's tree clean, and the lint run with
torch and jax blocked.

The rules the port keeps as they are — the wall clock in ``serve/``, the
metric catalog, the journal grammar — must give the JAX rule's findings,
``(rule, line)`` for ``(rule, line)``, on the seeds of
``tests/test_analysis_serve.py`` (whose module is red on this tree, so
the seeds are restated here). The retargeted rules (builder table,
builder bypass, cache poke, compiled programs in ``serve/``) police the
port's own names, so they get seeds of their own.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu.analysis import (
    hostlint as jhost,
)
from simple_distributed_machine_learning_tpu_torch.analysis import (
    hostlint as thost,
)
from simple_distributed_machine_learning_tpu_torch.analysis.__main__ import (
    main,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOSTLINT = os.path.join(REPO, "simple_distributed_machine_learning_tpu_torch",
                        "analysis", "hostlint.py")


def _rl(findings):
    return sorted((f.rule, f.where.rsplit(":", 1)[-1]) for f in findings)


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


# ---- the rules kept as they are: equal to the JAX rule ---------------------

CLOCK_SEEDS = {
    "clocky": ("import time\n"
               "import random\n"
               "from datetime import datetime\n"
               "t0 = time.monotonic()\n"
               "jitter = random.random()\n"
               "stamp = datetime.now()\n"),
    "injected": ("import time\n"
                 "def tick(clock=time.monotonic):\n"
                 "    return clock()\n"),
    "slo_like": ("import time\n"
                 "def evaluate(tick):\n"
                 "    return time.monotonic()\n"),
    "aliases": ("import time as t\n"
                "import datetime as dt\n"
                "from time import perf_counter as pc\n"
                "from random import randint\n"
                "a = t.time_ns()\n"
                "b = dt.datetime.utcnow()\n"
                "c = pc()\n"
                "d = randint(0, 3)\n"
                "e = t.sleep\n"),
}


@pytest.mark.parametrize("seed", sorted(CLOCK_SEEDS))
@pytest.mark.parametrize("allow_jit,check_clock", [
    (False, None), (True, True), (True, None)])
def test_wall_clock_rule_equals_jax(tmp_path, seed, allow_jit, check_clock):
    """serve/ (raw jits refused, clock checked), the SLO pipeline (clock
    checked only) and any other module (neither)."""
    path = _write(tmp_path, seed + ".py", CLOCK_SEEDS[seed])

    def clock(findings):
        return _rl(f for f in findings
                   if f.rule == "hostlint.wall-clock-in-serve")
    want = clock(jhost._lint_call_sites(path, allow_jit=allow_jit,
                                        check_clock=check_clock))
    got = clock(thost._lint_call_sites(path, allow_jit=allow_jit,
                                       check_clock=check_clock))
    assert got == want
    if seed == "clocky" and (not allow_jit or check_clock):
        assert len(got) == 3


def test_wall_clock_pins_of_the_jax_tests(tmp_path):
    """The JAX tests' own assertions, on the port's rule: three reads in
    the seed, none through an injected clock, and the SLO pipeline's seed
    flagged with the clock on and the jit rule off, and not otherwise."""
    bad = _write(tmp_path, "clocky.py", CLOCK_SEEDS["clocky"])
    rules = [f for f in thost._lint_call_sites(bad, allow_jit=False)
             if f.rule == "hostlint.wall-clock-in-serve"]
    assert len(rules) == 3
    good = _write(tmp_path, "injected.py", CLOCK_SEEDS["injected"])
    assert not [f for f in thost._lint_call_sites(good, allow_jit=False)
                if f.rule == "hostlint.wall-clock-in-serve"]
    slo = _write(tmp_path, "slo_like.py", CLOCK_SEEDS["slo_like"])
    assert [f.rule for f in thost._lint_call_sites(
        slo, allow_jit=True, check_clock=True)] == [
        "hostlint.wall-clock-in-serve"]
    assert not thost._lint_call_sites(slo, allow_jit=True)


METRIC_SEED = ('DOCUMENTED = "serve_blocks_in_use"\n'
               'UNDOCUMENTED = "serve_bogus_flux_capacitor_total"\n'
               'NOT_A_METRIC = "some random string"\n'
               'ALSO_BOGUS = "train_flux_total"\n')


def test_metric_catalog_rule_equals_jax(tmp_path):
    path = _write(tmp_path, "metrics_like.py", METRIC_SEED)
    want = jhost.lint_metric_catalog(metric_files=[path])
    got = thost.lint_metric_catalog(metric_files=[path])
    assert _rl(got) == _rl(want)
    assert [f.rule for f in got] == ["metric-catalog.undocumented"] * 2
    assert "serve_bogus_flux_capacitor_total" in got[0].message
    assert got[0].severity is thost.Severity.ERROR
    # the port's own metric modules are documented
    assert thost.lint_metric_catalog() == []


WRITER = ('def log(j, rid):\n'
          '    j.append({"ev": "submit", "rid": rid})\n'
          '    j.append({"ev": "ghost", "rid": rid})\n'
          '    j.append({"ev": "done", "rid": rid})\n')
READER = ('def recover(records):\n'
          '    for r in records:\n'
          '        kind = r["ev"]\n'
          '        if kind == "submit":\n'
          '            pass\n'
          '        elif r.get("ev") in ("done", "restart"):\n'
          '            pass\n')


def test_journal_grammar_rule_equals_jax(tmp_path):
    w = _write(tmp_path, "writer.py", WRITER)
    r = _write(tmp_path, "reader.py", READER)
    want = jhost.lint_journal_grammar([w], [r], repo=str(tmp_path))
    got = thost.lint_journal_grammar([w], [r], repo=str(tmp_path))
    assert [(f.rule, f.where) for f in got] == [
        (f.rule, f.where) for f in want] == [
        ("journal-grammar.unread-event", "writer.py:3")]


# ---- the retargeted rules: seeded positives ---------------------------------

COMPILE_SPELLINGS = [
    "import torch\nstep = torch.compile(lambda x: x)\n",
    "from torch import compile\nstep = compile(lambda x: x)\n",
    "from torch import compile as q\nstep = q(lambda x: x)\n",
    "import torch as t\nstep = t.compile(lambda x: x)\n",
    "import torch\nstep = torch.jit.script(lambda x: x)\n",
    "from torch.jit import trace\nstep = trace(f, x)\n",
    "import torch.jit as tj\nstep = tj.script(f)\n",
    "from torch import jit\nstep = jit.trace(f, x)\n",
    "import torch\ng = torch.cuda.CUDAGraph()\n",
    "import torch\nwith torch.cuda.graph(g):\n    pass\n",
    "import torch.cuda as tc\ng = tc.CUDAGraph()\n",
    "from torch.cuda import CUDAGraph as G\ng = G()\n",
    "from torch.cuda import graphs\ng = graphs.CUDAGraph()\n",
    "import torch\ng = torch.cuda.graphs.make_graphed_callables(f, (x,))\n",
    "import torch\n@torch.compile\ndef f(x):\n    return x\n",
]


@pytest.mark.parametrize("src", COMPILE_SPELLINGS)
def test_compiled_programs_in_serve_are_flagged_in_every_spelling(
        tmp_path, src):
    """Each spelling is one finding in ``serve/`` and none elsewhere, as
    the JAX rule treats ``jax.jit``, ``from jax import jit [as q]``,
    ``import jax as j`` and ``pjit``."""
    path = _write(tmp_path, "site.py", src)
    got = [f for f in thost._lint_call_sites(path, allow_jit=False)
           if f.rule == "hostlint.raw-jit-in-serve"]
    assert len(got) == 1, [f.message for f in got]
    assert not thost._lint_call_sites(path, allow_jit=True)


def test_plain_torch_in_serve_is_not_a_compiled_program(tmp_path):
    path = _write(tmp_path, "site.py",
                  "import torch\n"
                  "x = torch.zeros(3).cuda()\n"
                  "torch.cuda.synchronize()\n"
                  "y = compile('1', 'f', 'eval')\n")
    assert thost._lint_call_sites(path, allow_jit=False) == []


def test_builder_bypass_and_cache_poke(tmp_path):
    path = _write(
        tmp_path, "site.py",
        "from simple_distributed_machine_learning_tpu_torch.models.gpt "
        "import _paged_decode_fwd\n"
        "from simple_distributed_machine_learning_tpu_torch.ops import "
        "flash_attention as fa\n"
        "rows = _paged_decode_fwd(1, 2, 3)\n"
        "fa._library.cache_clear()\n")
    got = _rl(thost._lint_call_sites(path, allow_jit=True))
    assert got == [("hostlint.builder-bypass", "3"),
                   ("hostlint.cache-poke", "4")]
    assert "make_paged_decode_step" in next(
        f.hint for f in thost._lint_call_sites(path, allow_jit=True)
        if f.rule == "hostlint.builder-bypass")
    # a parity test may call the private forwards; a kernel module owns
    # its memo
    assert _rl(thost._lint_call_sites(
        path, allow_jit=True, check_bypass=False, library_owner=True)) == []
    assert {"_paged_decode_fwd", "_slot_decode_fwd", "_paged_verify_fwd",
            "_paged_chunk_fwd"} <= set(thost._private_programs())


def test_builder_table_rule(tmp_path):
    """The port's table equals the JAX package's builders; a table that
    drops one, names an undefined one, or is missing is flagged."""
    from simple_distributed_machine_learning_tpu.models.gpt import (
        DECODE_BUILDERS as JAX_BUILDERS,
    )
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        DECODE_BUILDERS,
    )
    assert set(DECODE_BUILDERS) == set(JAX_BUILDERS) == set(
        thost.DECODE_BUILDER_NAMES) == set(jhost.DECODE_BUILDER_NAMES)
    assert thost.lint_builder_definitions() == []
    names = list(thost.DECODE_BUILDER_NAMES)
    defs = "".join(f"def {n}():\n    pass\n" for n in names[1:])
    table = "DECODE_BUILDERS = {%s}\n" % ", ".join(
        f"{n!r}: None" for n in names[1:] + ["make_ghost_step"])
    fake = _write(tmp_path, "gpt.py", defs + table)
    got = thost.lint_builder_definitions(fake, repo=str(tmp_path))
    assert {f.rule for f in got} == {"hostlint.unmemoized-builder"}
    msgs = " ".join(f.message for f in got)
    assert "'make_cached_decoder'" in msgs and "'make_ghost_step'" in msgs
    assert len(got) == 2
    none = _write(tmp_path, "gpt2.py", defs)
    assert "no DECODE_BUILDERS" in thost.lint_builder_definitions(
        none, repo=str(tmp_path))[0].message


def test_adapter_bank_update_equals_jax():
    """The builder the table needed: one bank row rewritten in place, as
    the JAX program's donated ``.at[idx].set``."""
    import jax.numpy as jnp

    from simple_distributed_machine_learning_tpu.models.gpt import (
        make_adapter_bank_update as jmake,
    )
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        make_adapter_bank_update,
    )
    rng = np.random.default_rng(0)
    keys = ("aq", "bq", "av", "bv")
    bank = {k: rng.standard_normal((3, 2, 4, 2)).astype(np.float32)
            for k in keys}
    ad = {k: rng.standard_normal((2, 4, 2)).astype(np.float32)
          for k in keys}
    want = jmake()({k: jnp.asarray(v) for k, v in bank.items()}, 1,
                   {k: jnp.asarray(v) for k, v in ad.items()})
    tb = {k: torch.from_numpy(v.copy()) for k, v in bank.items()}
    got = make_adapter_bank_update()(
        tb, 1, {k: torch.from_numpy(v) for k, v in ad.items()})
    assert got is tb
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---- the tree, the CLI, and no torch ---------------------------------------

def test_the_port_tree_lints_clean():
    report = thost.lint_repo()
    assert report.ok(fail_on="warning"), report.format()
    assert report.findings == []


def test_hostlint_cli_exit_codes_and_inject_drill(monkeypatch, capsys):
    """As JAX ``test_hostlint_cli_inject_drill``: clean is 0, the seeded
    ERROR trips the gate with 1."""
    monkeypatch.delenv("SDML_LINT_INJECT", raising=False)
    assert main(["--hostlint"]) == 0
    assert "analysis --hostlint: clean" in capsys.readouterr().out
    monkeypatch.setenv("SDML_LINT_INJECT", "drill")
    assert main(["--hostlint"]) == 1
    out = capsys.readouterr().out
    assert "injected.drill" in out and "FLAGGED" in out


BLOCKED = (
    "import sys, runpy\n"
    "for m in [k for k in sys.modules if k in ('jax', 'torch') or "
    "k.startswith(('jax.', 'jaxlib', 'torch.'))]:\n"
    "    del sys.modules[m]\n"
    "class B:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name in ('jax', 'torch') or name.startswith(\n"
    "                ('jax.', 'jaxlib', 'torch.')):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, B())\n"
    "for mod in ('jax', 'torch'):\n"
    "    try:\n"
    "        __import__(mod)\n"
    "    except ImportError:\n"
    "        pass\n"
    "    else:\n"
    "        print('BLOCKER INERT'); sys.exit(3)\n"
    "sys.argv = [sys.argv[1]]\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n"
)


@pytest.mark.parametrize("inject", [None, "drill"])
def test_hostlint_runs_without_torch_or_jax(inject):
    """The torch-free entry point, as JAX ``test_hostlint_runs_without_jax``
    runs its lint with jax blocked: the script loads ``report.py`` and the
    catalog by path."""
    env = {k: v for k, v in os.environ.items() if k != "SDML_LINT_INJECT"}
    if inject:
        env["SDML_LINT_INJECT"] = inject
    proc = subprocess.run([sys.executable, "-c", BLOCKED, HOSTLINT],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == (1 if inject else 0), (proc.stdout,
                                                     proc.stderr)
    assert ("FLAGGED" if inject else "analysis --hostlint: clean") in \
        proc.stdout
