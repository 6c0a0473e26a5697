"""The JAX program linter's verdicts, computed in a child interpreter.

The JAX package's ``analysis/trace.py`` reads ``jax.core.Jaxpr``, which jax
0.9 no longer exports. This script sets ``jax.core.Jaxpr`` and
``jax.core.ClosedJaxpr`` to the ``jax.extend.core`` types before anything
of the JAX package's analysis imports, runs the requested part of the JAX
linter on 8 virtual CPU devices, and prints one JSON object. It runs only
as a child process (``python tests/_jax_lint_reference.py PART``): the
shim must never reach a pytest worker, where a later JAX test file would
import ``analysis/trace.py`` through it and change what that file counts.

Parts:

- ``fixtures``: ``{name: [[rule, severity], ...]}`` for every fixture of
  ``analysis/fixtures.py`` except the protocol ones;
- ``dryrun``: ``{n: [[report name, [rules], {prim: bytes}]]}`` for n = 2,
  4 and 8 (``preflight.dryrun_reports``: findings and the cost table
  summed by primitive);
- ``serve``: ``{label: [rules]}`` for ``programs.default_registry_reports``;
- ``engine_spec``: ``{label: {field: value}}`` of ``programs.engine_spec``
  on the small live engines a JSON argument describes
  (``tests/test_torch_signatures.py``).
"""

from __future__ import annotations

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
from jax.extend import core as _jex_core  # noqa: E402

jax.config.update("jax_platforms", "cpu")
if not hasattr(jax.core, "Jaxpr"):
    jax.core.Jaxpr = _jex_core.Jaxpr
    jax.core.ClosedJaxpr = _jex_core.ClosedJaxpr


def fixtures() -> dict:
    from simple_distributed_machine_learning_tpu.analysis.fixtures import (
        FIXTURES,
    )
    out = {}
    for name, fx in FIXTURES.items():
        if name.startswith("protocol_"):
            continue
        try:
            rep = fx.build()
            out[name] = sorted({(f.rule, str(f.severity))
                                for f in rep.findings})
        except Exception as e:  # noqa: BLE001 - recorded, not fatal
            out[name] = [["raised", f"{type(e).__name__}: {e}"[:200]]]
    return out


def dryrun() -> dict:
    from simple_distributed_machine_learning_tpu.analysis.preflight import (
        dryrun_reports,
    )
    out = {}
    for n in (2, 4, 8):
        rows = []
        for rep in dryrun_reports(n):
            by_prim: dict = {}
            for c in rep.costs:
                by_prim[c.prim] = by_prim.get(c.prim, 0) + c.total_bytes
            rows.append([rep.name, sorted({f.rule for f in rep.findings}),
                         by_prim])
        out[str(n)] = rows
    return out


def serve() -> dict:
    from simple_distributed_machine_learning_tpu.analysis.programs import (
        default_registry_reports,
    )
    return {rep.name: sorted({f.rule for f in rep.findings})
            for rep in default_registry_reports()}


def engine_spec() -> dict:
    """The request is the JSON in ``sys.argv[2]``: ``{"model": GPTConfig
    keywords, "cases": [[label, engine keywords, prompt buckets or null],
    ...], "fields": [ServeSpec field or property, ...]}``."""
    from simple_distributed_machine_learning_tpu.analysis.programs import (
        engine_spec as spec_of,
    )
    from simple_distributed_machine_learning_tpu.models import gpt
    from simple_distributed_machine_learning_tpu.serve.engine import (
        InferenceEngine,
    )
    req = json.loads(sys.argv[2])
    cfg = gpt.GPTConfig(**req["model"])
    stages = gpt.make_gpt_stages(jax.random.key(0), cfg, 1)[0]
    out = {}
    for label, kw, lens in req["cases"]:
        spec = spec_of(InferenceEngine(stages, cfg, **kw),
                       None if lens is None else tuple(lens))
        out[label] = {f: (list(v) if isinstance(v, tuple) else v)
                      for f in req["fields"] for v in [getattr(spec, f)]}
    return out


if __name__ == "__main__":
    part = sys.argv[1]
    print(json.dumps({"fixtures": fixtures, "dryrun": dryrun,
                      "serve": serve, "engine_spec": engine_spec}[part]()))
