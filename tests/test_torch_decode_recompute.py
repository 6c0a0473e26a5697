"""The port's full-prefix decoder (``models/gpt.py::make_decoder``,
``generate``, ``decoder_from_pipeline``) against the JAX package's, and
against the port's own cached decoder (``tests/test_gpt.py``'s pins).

Both packages get the same weights: the JAX build of a tiny GPT (vocab 32,
seq 24, d 32, 2 heads, 2 layers, from ``jax.random.key(0)``) carried into
the port by ``interop.params_from_numpy``, and the same prompts, made from
a seed with numpy. Greedy tokens are equal across the packages on dense,
flash, MoE (4 experts, top-2) and MoE + flash builds, at 1 and 2 stages
and prompt lengths 1 and 6: the JAX flash kernel runs in Pallas interpret
mode, the port's K1 wrapper its plain version on the CPU. Sampled tokens
differ across packages by design (each its own generator); within the
port they equal the cached decoder's under the same key data, greedy and
sampled, with ``top_k`` and ``top_p``. The error texts are the JAX
package's. Also here: the small names the JAX package exports beside
them (``ops.losses.softmax_cross_entropy``/``accuracy``, the lazy
``make_mesh``, ``SimConfig.from_duration``,
``MetricsRegistry.instruments``).
"""

import dataclasses
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.ops import losses as jlosses
from simple_distributed_machine_learning_tpu.parallel.mesh import (
    make_mesh as jmake_mesh,
)
from simple_distributed_machine_learning_tpu.parallel.pipeline import (
    Pipeline as JPipeline,
)
from simple_distributed_machine_learning_tpu.serve.simulator import (
    SimConfig as JSimConfig,
)
from simple_distributed_machine_learning_tpu.telemetry.registry import (
    MetricsRegistry as JRegistry,
)
from simple_distributed_machine_learning_tpu_torch import models as tmodels
from simple_distributed_machine_learning_tpu_torch import ops as tops
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.ops import losses as tlosses
from simple_distributed_machine_learning_tpu_torch.ops.flash_attention import (
    flash_forward,
)
from simple_distributed_machine_learning_tpu_torch.ops.random import key_data
from simple_distributed_machine_learning_tpu_torch.parallel import (
    Pipeline,
    make_mesh,
)
from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (
    fused_reference,
)
from simple_distributed_machine_learning_tpu_torch.serve.simulator import (
    SimConfig,
)
from simple_distributed_machine_learning_tpu_torch.telemetry.registry import (
    MetricsRegistry,
)
from simple_distributed_machine_learning_tpu_torch.train import (
    make_train_step,
    sgd,
)

KW = dict(vocab=32, seq_len=24, d_model=32, n_heads=2, n_layers=2)
BUILDS = {
    "dense": {},
    "flash": dict(attn_impl="flash"),
    "moe": dict(n_experts=4, moe_top_k=2),
    "moe_flash": dict(n_experts=4, moe_top_k=2, attn_impl="flash"),
}
N_NEW = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs: its models are
    tiny, and under a multi-process test run more threads only contend
    for the same cores. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS: dict = {}


def _model(build="dense", n_stages=1):
    """``(jstages, stages, params, cfg)``: the JAX build and the port's
    stages carrying its weights, made once per module."""
    key = (build, n_stages)
    if key not in _MODELS:
        kw = dict(KW, **BUILDS[build])
        jst = jgpt.make_gpt_stages(jax.random.key(0), jgpt.GPTConfig(**kw),
                                   n_stages)[0]
        nparams = jax.tree.map(np.asarray, [s.params for s in jst])
        cfg = tgpt.GPTConfig(**kw)
        st = tgpt.make_gpt_stages(0, cfg, n_stages, device="cpu")[0]
        st = [dataclasses.replace(s, params=p)
              for s, p in zip(st, params_from_numpy(nparams, "cpu"))]
        _MODELS[key] = (jst, st, [s.params for s in st], cfg)
    return _MODELS[key]


def _prompt(b, t0, seed=1):
    return np.random.default_rng(seed).integers(
        0, KW["vocab"], (b, t0)).astype(np.int32)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


# -- across the packages -----------------------------------------------------


@pytest.mark.parametrize("t0", [1, 6])
@pytest.mark.parametrize("n_stages", [1, 2])
@pytest.mark.parametrize("build", list(BUILDS))
def test_make_decoder_greedy_tokens_equal_jax(build, n_stages, t0):
    """The port's full-prefix greedy decode gives the JAX decoder's exact
    tokens on every single-device build; on a flash build each token
    reruns K1's wrapper once per layer."""
    jst, st, params, cfg = _model(build, n_stages)
    prompt = _prompt(2, t0)
    want = jgpt.make_decoder(jst, t0, N_NEW)(
        [s.params for s in jst], jnp.asarray(prompt), jax.random.key(0))
    before = flash_forward.launches
    got = tgpt.make_decoder(st, t0, N_NEW, device="cpu")(params, prompt)
    assert got.dtype == torch.int32 and got.shape == (2, t0 + N_NEW)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert flash_forward.launches == before    # the CPU runs no kernel


@pytest.mark.parametrize("build", ["dense", "moe_flash"])
def test_generate_greedy_equals_jax(build):
    jst, st, _, cfg = _model(build, 2)
    prompt = _prompt(2, 5)
    want = jgpt.generate(jst, jnp.asarray(prompt), 7)
    got = tgpt.generate(st, torch.as_tensor(prompt), 7, device="cpu")
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_make_decoder_matches_stepwise_argmax():
    """The decode equals rolling the argmax one token at a time through
    ``fused_reference`` over the zero-padded buffer (pins the causal mask
    of the unwritten tail and the read at ``i - 1``)."""
    _, st, params, cfg = _model("dense", 1)
    prompt = _prompt(2, 6)
    out = _np(tgpt.generate(st, torch.as_tensor(prompt), 5, device="cpu"))
    assert out.shape == (2, 11)
    np.testing.assert_array_equal(out[:, :6], prompt)
    fused = fused_reference(st)
    buf = np.zeros((2, cfg.seq_len), np.int64)
    buf[:, :6] = prompt
    with torch.no_grad():
        for i in range(6, 11):
            logp = fused(params, torch.as_tensor(buf), None, True)
            buf[:, i] = torch.argmax(logp[:, i - 1], dim=-1).numpy()
    np.testing.assert_array_equal(out, buf[:, :11])


# -- within the port: cached equals recompute ----------------------------------


@pytest.mark.parametrize("n_stages,t0,n_new", [(1, 6, 10), (2, 6, 10),
                                               (2, 1, 8)])
def test_cached_decoder_greedy_equals_recompute(n_stages, t0, n_new):
    _, st, params, cfg = _model("dense", n_stages)
    prompt = _prompt(2, t0)
    want = tgpt.make_decoder(st, t0, n_new, device="cpu")(params, prompt)
    got = tgpt.make_cached_decoder(st, cfg, t0, n_new, device="cpu")(
        params, prompt)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("kw", [dict(temperature=1.0),
                                dict(temperature=0.8, top_k=3),
                                dict(temperature=0.8, top_p=0.5),
                                dict(temperature=0.8, top_k=5, top_p=0.9)],
                         ids=["plain", "top_k", "top_p", "top_k_top_p"])
def test_cached_decoder_sampling_equals_recompute(kw):
    """Both decoders split the key once per sampled token, in the same
    order and over the same counter ranges: the sampled tokens are
    identical, not just the greedy ones."""
    _, st, params, cfg = _model("dense", 2)
    prompt = _prompt(2, 5)
    want = tgpt.make_decoder(st, 5, 9, device="cpu", **kw)(
        params, prompt, key_data(7))
    got = tgpt.make_cached_decoder(st, cfg, 5, 9, device="cpu", **kw)(
        params, prompt, key_data(7))
    np.testing.assert_array_equal(_np(got), _np(want))
    other = tgpt.make_decoder(st, 5, 9, device="cpu", **kw)(
        params, prompt, key_data(8))
    assert not np.array_equal(_np(other), _np(want))


def test_generate_routes_by_cfg(monkeypatch):
    """``generate(cfg=)`` decodes through the cached decoder, without it
    through the full-prefix one, and both give the same tokens, greedy and
    sampled."""
    _, st, _, cfg = _model("dense", 1)
    prompt = torch.as_tensor(_prompt(2, 6))
    want = tgpt.generate(st, prompt, 5, device="cpu")
    want_s = tgpt.generate(st, prompt, 5, key_data(2), temperature=0.9,
                           top_k=4, device="cpu")

    def refused(*a, **k):
        raise AssertionError("the wrong decoder was built")

    monkeypatch.setattr(tgpt, "make_decoder", refused)
    got = tgpt.generate(st, prompt, 5, cfg=cfg, device="cpu")
    got_s = tgpt.generate(st, prompt, 5, key_data(2), temperature=0.9,
                          cfg=cfg, top_k=4, device="cpu")
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got_s), _np(want_s))
    monkeypatch.undo()
    monkeypatch.setattr(tgpt, "make_cached_decoder", refused)
    np.testing.assert_array_equal(
        _np(tgpt.generate(st, prompt, 5, device="cpu")), _np(want))


# -- decoder_from_pipeline -------------------------------------------------------


@pytest.mark.parametrize("n_stages", [1, 2])
def test_decoder_from_pipeline_reads_live_params(n_stages):
    """Decode from the training pipeline's live params: the tokens equal
    the JAX ``decoder_from_pipeline``'s on the same weights, a few SGD
    steps change them, and after training they equal the cached decoder
    run on the live params."""
    jst, st, _, cfg = _model("dense", n_stages)
    prompt = _prompt(2, 4)
    jpipe = JPipeline(jst, jmake_mesh(n_stages=n_stages, n_data=1,
                                      devices=jax.devices()[:n_stages]),
                      cfg.seq_len * cfg.d_model, (cfg.seq_len, cfg.vocab))
    want = jgpt.decoder_from_pipeline(jpipe, jgpt.GPTConfig(**KW), 4, 8)(
        jpipe.init_params(), jnp.asarray(prompt), jax.random.key(0))
    mesh = make_mesh(n_stages, devices=["cpu"] * n_stages)
    pipe = Pipeline(st, mesh, cfg.seq_len * cfg.d_model,
                    (cfg.seq_len, cfg.vocab))
    params = pipe.init_params()
    dec = tgpt.decoder_from_pipeline(pipe, cfg, 4, 8)
    out0 = _np(dec(params, prompt))
    np.testing.assert_array_equal(out0, np.asarray(want))
    rng = np.random.default_rng(2)
    x = rng.integers(0, cfg.vocab, (8, cfg.seq_len))
    y = np.roll(x, -1, 1)
    opt = sgd(0.5, momentum=0.9)
    state = opt.init(params)
    step = make_train_step(pipe, opt)
    for i in range(10):
        params, state, _ = step(params, state, torch.as_tensor(x),
                                torch.as_tensor(y), i)
    out1 = _np(dec(params, prompt))
    assert not np.array_equal(out0, out1), "decode ignored training updates"
    live = tgpt.make_cached_decoder(st, cfg, 4, 8, device="cpu")(
        list(params), prompt)
    np.testing.assert_array_equal(out1, _np(live))


def test_decoder_from_pipeline_refuses_sharded_stages_and_process_meshes():
    tp = tgpt.GPTConfig(**KW, n_tensor_parallel=2)
    st, wd, od = tgpt.make_gpt_stages(0, tp, 1, device="cpu")
    pipe = Pipeline(st, make_mesh(1, n_model=2, devices=["cpu"] * 2), wd, od)
    msg = ("decoder_from_pipeline needs unsharded stage params — gather "
           "tensor/expert shards into a dense build first")
    with pytest.raises(ValueError, match=msg):
        tgpt.decoder_from_pipeline(pipe, tp, 4, 4)
    ep = tgpt.GPTConfig(**KW, n_experts=4, n_expert_parallel=2)
    st, wd, od = tgpt.make_gpt_stages(0, ep, 1, device="cpu")
    pipe = Pipeline(st, make_mesh(1, n_expert=2, devices=["cpu"] * 2), wd,
                    od)
    with pytest.raises(ValueError, match=msg):
        tgpt.decoder_from_pipeline(pipe, ep, 4, 4)
    _, st, _, cfg = _model("dense", 1)
    spans = types.SimpleNamespace(stages=st, device=torch.device("cpu"),
                                  mesh=types.SimpleNamespace(distributed=True))
    with pytest.raises(ValueError, match="mesh spans processes"):
        tgpt.decoder_from_pipeline(spans, cfg, 4, 4)


# -- errors ----------------------------------------------------------------------


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


def test_error_texts_are_the_jax_packages():
    jst, st, params, cfg = _model("dense", 1)
    jparams = [s.params for s in jst]
    jprompt, prompt = jnp.asarray(_prompt(2, 4)), _prompt(2, 4)
    cases = [
        (lambda: jgpt.make_decoder(jst, 0, 4),
         lambda: tgpt.make_decoder(st, 0, 4, device="cpu"),
         "non-empty prompt"),
        (lambda: jgpt.make_decoder(jst, 20, 5),
         lambda: tgpt.make_decoder(st, 20, 5, device="cpu"),
         "exceeds the model's sequence length 24"),
        (lambda: jgpt.make_decoder(jst, 4, 4, temperature=1.0, top_k=0),
         lambda: tgpt.make_decoder(st, 4, 4, temperature=1.0, top_k=0,
                                   device="cpu"),
         "top_k=0 out of range"),
        (lambda: jgpt.make_decoder(jst, 4, 4, temperature=1.0, top_p=1.5),
         lambda: tgpt.make_decoder(st, 4, 4, temperature=1.0, top_p=1.5,
                                   device="cpu"),
         "top_p=1.5 out of range"),
        (lambda: jgpt.make_decoder(jst, 4, 4, top_k=3),
         lambda: tgpt.make_decoder(st, 4, 4, top_k=3, device="cpu"),
         "needs temperature > 0"),
        (lambda: jgpt.make_decoder(jst, 4, 4, temperature=1.0, top_k=33)(
            jparams, jprompt, jax.random.key(0)),
         lambda: tgpt.make_decoder(st, 4, 4, temperature=1.0, top_k=33,
                                   device="cpu")(params, prompt),
         "exceeds the row width 32"),
        (lambda: jgpt.generate(jst, jprompt, 2, temperature=0.5),
         lambda: tgpt.generate(st, torch.as_tensor(prompt), 2,
                               temperature=0.5, device="cpu"),
         "needs a PRNG key"),
    ]
    for jax_fn, port_fn, part in cases:
        theirs, ours = _error(jax_fn), _error(port_fn)
        assert part in ours and ours == theirs


def test_sharded_and_seq_builds_are_refused():
    """A build whose stages run mesh collectives (n_seq > 1, tensor or
    expert shards) cannot run in one fused forward; the JAX decoder fails
    there at trace time, the port at build time with a ValueError."""
    for kw, match in ((dict(n_seq=2, attn_impl="ring"), "n_seq=1 build"),
                      (dict(n_tensor_parallel=2), "unsharded stage params"),
                      (dict(n_experts=4, n_expert_parallel=2),
                       "unsharded stage params")):
        cfg = tgpt.GPTConfig(**KW, **kw)
        st = tgpt.make_gpt_stages(0, cfg, 1, device="cpu")[0]
        with pytest.raises(ValueError, match=match):
            tgpt.make_decoder(st, 4, 4, device="cpu")


def test_moe_cached_decoder_points_to_make_decoder():
    _, st, params, cfg = _model("moe", 1)
    with pytest.raises(ValueError, match="use make_decoder"):
        tgpt.make_cached_decoder(st, cfg, 4, 4, device="cpu")
    out = tmodels.make_decoder(st, 4, 4, device="cpu")(params, _prompt(1, 4))
    assert out.shape == (1, 8)


def test_entry_points_default_to_the_card():
    _, st, params, cfg = _model("dense", 1)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgpt.make_decoder(st, 4, 4)


# -- the small names -------------------------------------------------------------


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_softmax_cross_entropy_and_accuracy_equal_jax(reduction):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (4, 5))
    want = jlosses.softmax_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(targets), reduction)
    got = tops.softmax_cross_entropy(torch.as_tensor(logits),
                                     torch.as_tensor(targets), reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    acc = tlosses.accuracy(torch.as_tensor(logits), torch.as_tensor(targets))
    assert acc.dtype == torch.float32
    assert float(acc) == float(jlosses.accuracy(jnp.asarray(logits),
                                                jnp.asarray(targets)))


def test_models_exports_and_lazy_make_mesh():
    for name in ("generate", "make_decoder", "decoder_from_pipeline",
                 "make_slot_prefill", "make_slot_decode_step"):
        assert getattr(tmodels, name) is getattr(tgpt, name)
    code = ("import sys, simple_distributed_machine_learning_tpu_torch as p; "
            "assert not any(m.startswith(p.__name__ + '.') "
            "for m in sys.modules), 'a subpackage was imported'; "
            "from simple_distributed_machine_learning_tpu_torch.parallel "
            "import mesh; assert p.make_mesh is mesh.make_mesh; "
            "assert p.__all__ == ['make_mesh']; "
            "import pytest; pytest.raises(AttributeError, "
            "getattr, p, 'nope')")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("rate,duration", [(4.0, 2.5), (0.1, 1.0)])
def test_sim_config_from_duration_equals_jax(rate, duration):
    ours = SimConfig.from_duration(rate, duration, seed=3)
    theirs = JSimConfig.from_duration(rate, duration, seed=3)
    assert (ours.n_requests, ours.rate, ours.seed) == (
        theirs.n_requests, theirs.rate, theirs.seed)
    for cls in (SimConfig, JSimConfig):
        with pytest.raises(ValueError, match="duration_s must be > 0, got 0"):
            cls.from_duration(1.0, 0)


def test_registry_instruments_in_registration_order():
    out = []
    for cls in (MetricsRegistry, JRegistry):
        reg = cls()
        c = reg.counter("a_total")
        g = reg.gauge("b", labels={"k": "1"})
        h = reg.histogram("c_ms")
        assert reg.counter("a_total") is c
        assert reg.instruments() == [c, g, h]
        out.append([(i.name, i.kind) for i in reg.instruments()])
    assert out[0] == out[1]
