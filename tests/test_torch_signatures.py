"""Five public signatures of the port held to the JAX package's, on the CPU.

Each function takes the JAX parameter it lacked, in the JAX position, and
does with it what the JAX function does:

- ``resilience.make_elastic_trainer(..., opt=None, opt_factory=None)``: a
  fixed optimizer instance, the seventh positional argument, used as is
  (``opt_factory`` only when ``opt`` is None);
- ``CheckpointStore.restore_latest(..., src_pipe=None)``: the source layout
  of the generation, which may be any split of the model, not only the
  contiguous one the port derives itself;
- ``analysis.programs.engine_spec(engine, prompt_lens=None)``: the prompt
  buckets on the ``ServeSpec`` (the JAX side runs in the child of
  ``tests/_jax_lint_reference.py``: its ``analysis/programs.py`` does not
  import in a pytest worker under jax 0.9);
- ``models.lenet.make_lenet_stages(seed, n_stages=2)``: the reference's
  conv|fc split by default;
- ``train.make_scanned_train_step(pipe, opt, unroll=1, pool_steps=None)``:
  ``unroll`` taken and ignored (an eager loop has no scan), so any value
  gives the JAX scan's losses.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu.data.mnist import (
    Dataset as JDataset,
)
from simple_distributed_machine_learning_tpu.models import lenet as jlenet
from simple_distributed_machine_learning_tpu.models import mlp as jmlp
from simple_distributed_machine_learning_tpu.parallel.mesh import (
    make_mesh as jmake_mesh,
)
from simple_distributed_machine_learning_tpu.parallel.pipeline import (
    Pipeline as JPipeline,
    Stage as JStage,
)
from simple_distributed_machine_learning_tpu.resilience import (
    CheckpointStore as JStore,
    RestartPolicy as JPolicy,
    faults as jfaults,
    make_elastic_trainer as jmake_elastic_trainer,
    supervise as jsupervise,
)
from simple_distributed_machine_learning_tpu.train import (
    make_scanned_train_step as jmake_scanned_train_step,
    sgd as jsgd,
)
from simple_distributed_machine_learning_tpu.train import trainer as jtrainer
from simple_distributed_machine_learning_tpu_torch.analysis import programs
from simple_distributed_machine_learning_tpu_torch.data.mnist import Dataset
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.models import lenet
from simple_distributed_machine_learning_tpu_torch.models import mlp as tmlp
from simple_distributed_machine_learning_tpu_torch.parallel import (
    Pipeline,
    staging,
)
from simple_distributed_machine_learning_tpu_torch.resilience import (
    CheckpointStore,
    RestartPolicy,
    faults,
    make_elastic_trainer,
    supervise,
)
from simple_distributed_machine_learning_tpu_torch.serve import (
    InferenceEngine,
)
from simple_distributed_machine_learning_tpu_torch.train import (
    TrainConfig,
    make_scanned_train_step,
    sgd,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DIMS = [12, 16, 14, 16, 10]
TOL = dict(rtol=3e-5, atol=3e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs (tiny models)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.uninstall()
    jfaults.uninstall()
    yield
    faults.uninstall()
    jfaults.uninstall()


def _ds(cls):
    rng = np.random.RandomState(0)
    return cls(rng.randn(120, 12).astype(np.float32),
               rng.randint(0, 10, 120))


def _jax_layers():
    """The JAX package's seed-0 MLP layers, as numpy pytrees."""
    jst = jmlp.make_mlp_stages(jax.random.key(0), DIMS, 1)[0]
    return jax.tree.map(np.asarray, jst[0].params)


def _port_pipe(n=1):
    assert n == 1
    st, wd, od = tmlp.make_mlp_stages(0, DIMS, 1, device="cpu")
    st = [dataclasses.replace(
        st[0], params=params_from_numpy([_jax_layers()], "cpu")[0])]
    return Pipeline(st, None, wd, od, device="cpu")


def _jax_pipe(n):
    st, wd, od = jmlp.make_mlp_stages(jax.random.key(0), DIMS, n)
    return JPipeline(st, jmake_mesh(n_stages=n, n_data=1,
                                    devices=jax.devices()[:n]), wd, od)


def _cfg(epochs):
    return dict(epochs=epochs, batch_size=30, print_throughput=False)


# -- make_elastic_trainer(..., opt=) ------------------------------------------


def _never_called(pipe):
    raise AssertionError("opt_factory called while a fixed opt was given")


@pytest.mark.parametrize("positional", [False, True],
                         ids=["keyword", "positional"])
def test_elastic_trainer_takes_a_fixed_optimizer_as_jax_does(tmp_path,
                                                             positional):
    """A fixed SGD with momentum 0.9 (not the Trainer's default) through a
    host-kill at step 6: the port resumes and continues as the JAX
    supervisor does with the same optimizer. As the seventh positional
    argument the optimizer lands in ``opt``, as in JAX, and is never
    called as a factory (``opt_factory`` is ignored beside it)."""
    ds, jds = _ds(Dataset), _ds(JDataset)
    opt, jopt = sgd(0.05, 0.9), jsgd(0.05, 0.9)

    def build(n):
        args = (_port_pipe, n, store, ds, ds, TrainConfig(**_cfg(3)))
        if positional:
            return make_elastic_trainer(*args, opt, _never_called)
        return make_elastic_trainer(*args, opt=opt,
                                    opt_factory=_never_called)

    def jbuild(n):
        args = (_jax_pipe, n, jstore, jds, jds,
                jtrainer.TrainConfig(**_cfg(3)))
        if positional:
            return jmake_elastic_trainer(*args, jopt, _never_called)
        return jmake_elastic_trainer(*args, opt=jopt,
                                     opt_factory=_never_called)

    store = CheckpointStore(str(tmp_path / "port"), keep=8)
    assert build(1).opt is opt
    faults.install(faults.FaultPlan.parse("host-kill@train.step=6"))
    report = supervise(build, (1,), policy=RestartPolicy(max_restarts=2),
                       sleep=lambda s: None)
    faults.uninstall()
    jstore = JStore(str(tmp_path / "jax"), keep=8)
    jfaults.install(jfaults.FaultPlan.parse("host-kill@train.step=6"))
    jreport = jsupervise(jbuild, (1,), policy=JPolicy(max_restarts=2),
                         sleep=lambda s: None)

    assert report["completed"] and report["restarts"] == 1
    assert report["transitions"] == jreport["transitions"]
    assert report["attempts"][1]["resumed_step"] == 4
    ours = [h["train_loss"] for a in report["attempts"]
            for h in a["history"]]
    theirs = [h["train_loss"] for a in jreport["attempts"]
              for h in a["history"]]
    np.testing.assert_allclose(ours, theirs, **TOL)
    # the Trainer's default optimizer gives other losses: the fixed one ran
    default = make_elastic_trainer(_port_pipe, 1,
                                   CheckpointStore(str(tmp_path / "d")), ds,
                                   ds, TrainConfig(**_cfg(1)))
    default.fit()
    assert abs(default.history[0]["train_loss"] - ours[0]) > 1e-4


# -- CheckpointStore.restore_latest(src_pipe=) ----------------------------------


def test_restore_latest_takes_the_source_layout_of_an_uneven_split(tmp_path):
    """A generation written by a JAX pipeline split 1 | 3 layers (not the
    2 | 2 split a two-stage build makes) restores onto the port's one
    stage through ``src_pipe=`` to the JAX seed-0 weights exactly, as the
    JAX store restores it onto its own one stage; without ``src_pipe`` the
    port's contiguous derivation does not fit the buffer."""
    layers = jmlp.make_mlp_stages(jax.random.key(0), DIMS, 1)[0][0].params
    # the applies of a 1-layer hidden stage and a 3-layer last stage
    first = jmlp.make_mlp_stages(jax.random.key(0), DIMS, 4)[0][0]
    rest = jmlp.make_mlp_stages(jax.random.key(0), DIMS[1:], 1)[0][0]
    uneven = [JStage(first.apply, layers[:1], (DIMS[0],)),
              JStage(rest.apply, layers[1:], (DIMS[1],))]
    jsrc = JPipeline(uneven, jmake_mesh(n_stages=2, n_data=1,
                                        devices=jax.devices()[:2]),
                     max(DIMS), DIMS[-1])
    buf = jsrc.init_params()
    JStore(str(tmp_path)).save(buf, jsgd(0.1, 0.5).init(buf), 8,
                               extra={"epoch": 2, "n_stages": 2})

    jone = _jax_pipe(1)
    jst = JStore(str(tmp_path)).restore_latest(
        pipe=jone, opt_treedef_like=jsgd(0.1, 0.5).init(jone.init_params()),
        src_pipe=jsrc)
    pipe = _port_pipe()
    src = [staging.stage_meta(t) for t in params_from_numpy(
        [jax.tree.map(np.asarray, s.params) for s in uneven], "cpu")]
    opt_like = sgd(0.1, 0.5).init(pipe.init_params())
    st = CheckpointStore(str(tmp_path)).restore_latest(
        pipe=pipe, opt_treedef_like=opt_like, src_pipe=src)
    assert st["step"] == jst["step"] == 8
    assert st["entry"]["file"] == jst["entry"]["file"]
    for a, b in zip(st["params"][0].parameters(),
                    _port_pipe().init_params()[0].parameters()):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(np.asarray(jst["params"]),
                                  np.asarray(jone.init_params()))
    with pytest.raises(ValueError):
        CheckpointStore(str(tmp_path)).restore_latest(
            pipe=pipe, opt_treedef_like=opt_like)


# -- engine_spec(engine, prompt_lens) -------------------------------------------


#: (label, engine keywords, prompt buckets) of the engines both packages
#: build; the JAX side runs in the child
ENGINE_SPEC_MODEL = dict(vocab=32, seq_len=48, d_model=32, n_heads=2,
                         n_layers=2)
ENGINE_SPEC_CASES = (
    ("paged", dict(n_slots=3, kv_layout="paged", block_size=4,
                   prefill_chunk=3, attn_kernel="fused"), (5, 9, 17)),
    ("paged-no-buckets", dict(n_slots=2, kv_layout="paged", block_size=8),
     None),
    ("dense", dict(n_slots=2, kv_layout="dense"), (4, 12)),
)
#: the ServeSpec fields and properties compared
ENGINE_SPEC_FIELDS = ("n_slots", "max_len", "kv_layout", "block_size",
                      "n_blocks", "prefill_chunk", "prompt_lens", "spec_k",
                      "attn_kernel", "ml", "blocks_per_seq", "nb")


@pytest.fixture(scope="module")
def jax_engine_specs():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    req = json.dumps({"model": ENGINE_SPEC_MODEL,
                      "cases": [list(c) for c in ENGINE_SPEC_CASES],
                      "fields": list(ENGINE_SPEC_FIELDS)})
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_jax_lint_reference.py"),
         "engine_spec", req], capture_output=True, text=True, env=env,
        timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("label,kw,lens", ENGINE_SPEC_CASES,
                         ids=[c[0] for c in ENGINE_SPEC_CASES])
def test_engine_spec_declares_the_prompt_buckets_as_jax(jax_engine_specs,
                                                         label, kw, lens):
    """The live engine's ``ServeSpec`` with the buckets passed positionally
    equals the JAX one field for field; ``lint_engine`` goes through the
    same call."""
    cfg = tgpt.GPTConfig(**ENGINE_SPEC_MODEL)
    stages = tgpt.make_gpt_stages(0, cfg, 1, device="cpu")[0]
    engine = InferenceEngine(stages, cfg, device="cpu", **kw)
    spec = programs.engine_spec(engine, lens)
    got = {f: (list(v) if isinstance(v, tuple) else v)
           for f in ENGINE_SPEC_FIELDS for v in [getattr(spec, f)]}
    assert got == jax_engine_specs[label]
    assert programs.engine_spec(engine).prompt_lens is None


# -- make_lenet_stages(seed) ------------------------------------------------------


def test_lenet_defaults_to_the_reference_conv_fc_split():
    """``make_lenet_stages(seed)`` builds two stages, conv | fc, with the
    JAX builder's wire and output widths and leaf shapes."""
    st, wd, od = lenet.make_lenet_stages(0, device="cpu")
    jst, jwd, jod = jlenet.make_lenet_stages(jax.random.key(0))
    assert len(st) == len(jst) == 2
    assert (wd, od) == (jwd, jod)
    for s, j in zip(st, jst):
        assert s.in_shape == tuple(j.in_shape)
        assert sorted(tuple(p.shape) for p in s.params.parameters()) == \
            sorted(tuple(np.shape(a)) for a in jax.tree.leaves(j.params))


# -- make_scanned_train_step(..., unroll=) ----------------------------------------


@pytest.mark.parametrize("unroll", [1, 4])
def test_scanned_step_takes_unroll_and_gives_the_jax_losses(unroll):
    """``unroll`` in the JAX position (after ``opt``), ignored: the port's
    losses at ``unroll`` 1 and 4 equal each other exactly and the JAX
    scan's at the same ``unroll`` within the module's tolerance."""
    rng = np.random.RandomState(3)
    xs = rng.randn(6, 10, DIMS[0]).astype(np.float32)
    ts = rng.randint(0, DIMS[-1], (6, 10)).astype(np.int32)
    jpipe = _jax_pipe(1)
    jo = jsgd(0.1, 0.5)
    buf = jpipe.init_params()
    _, _, jl = jmake_scanned_train_step(jpipe, jo, unroll, 4)(
        buf, jo.init(buf), jnp.asarray(xs), jnp.asarray(ts),
        jax.random.key(0))
    losses = []
    for u in (1, unroll):
        pipe = _port_pipe()
        o = sgd(0.1, 0.5)
        params = pipe.init_params()
        _, _, tl = make_scanned_train_step(pipe, o, u, 4)(
            params, o.init(params), torch.from_numpy(xs),
            torch.from_numpy(ts))
        losses.append(tl.numpy())
    assert losses[0].shape == (4,)
    np.testing.assert_array_equal(losses[0], losses[1])
    np.testing.assert_allclose(losses[1], np.asarray(jl), **TOL)
