"""One-card GPT training in the port against the JAX package's trivial-mesh
training path, from the same weights and the same numpy batches.

The JAX side builds ``Pipeline`` on ``make_mesh(n_stages=1, n_data=1)``,
whose loss and gradients run through its fused single-device path, and its
``attn_impl="flash"`` blocks run the Pallas kernels in interpret mode; the
port's CPU run computes the flash kernels' plain versions through the same
autograd Function the card runs. The config makes T ragged against the
flash blocks (48 tokens, blocks of 16 over 64-row CUDA tiles).

Tolerances, each with its reason:

- f32 per-step losses within 1e-5 relative: both sum in f32 in another
  order, and three steps do not compound that past a few ulps;
- f32 parameters after 3 steps: SGD within 1e-6 (an update is lr times a
  gradient that agrees to float tolerance); AdamW within 5e-4, half its lr:
  Adam divides each gradient by its own running RMS, so an entry whose
  gradient is near zero moves by up to ~lr on f32 noise alone;
- the bf16 ``compute_dtype`` case: losses within 2^-8 relative (one bf16
  rounding of the log-probs' inputs), parameters within 2e-3 (SGD at lr
  0.1 on bf16 gradients that round at other places in each framework).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu import make_mesh
from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.parallel.pipeline import (
    Pipeline as JaxPipeline,
)
from simple_distributed_machine_learning_tpu.parallel.pipeline import (
    fused_reference as jfused_reference,
)
from simple_distributed_machine_learning_tpu.train import optimizer as jopt
from simple_distributed_machine_learning_tpu.train import schedules as jsched
from simple_distributed_machine_learning_tpu.train import step as jstep
from simple_distributed_machine_learning_tpu_torch import train as ttrain
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
    params_to_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.ops.layers import dropout
from simple_distributed_machine_learning_tpu_torch.parallel import (
    Pipeline,
    fused_reference,
)

SMALL = dict(vocab=64, seq_len=48, d_model=32, n_heads=2, n_layers=2,
             flash_block_q=16, flash_block_k=16)
BATCH = 4
# one forward in f32: both sum in f32 in another order
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _batches(seed, n):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 64, (n, BATCH, 48)).astype(np.float32)
    ts = rng.integers(0, 64, (n, BATCH, 48)).astype(np.int32)
    return xs, ts


def _pair(attn_impl="dense", compute_dtype=None, **cfg_kw):
    """The JAX trivial-mesh pipeline and the port's, on the same weights:
    ``(jpipe, tpipe)``."""
    cfg_kw = {**SMALL, **cfg_kw}
    jcfg = jgpt.GPTConfig(**cfg_kw, attn_impl=attn_impl)
    jst, wd, od = jgpt.make_gpt_stages(jax.random.key(0), jcfg, 1)
    jpipe = JaxPipeline(jst, make_mesh(n_stages=1, n_data=1), wd, od,
                        compute_dtype=None if compute_dtype is None
                        else jnp.bfloat16)
    nparams = jax.tree.map(np.asarray, [s.params for s in jst])
    tcfg = tgpt.GPTConfig(**cfg_kw, attn_impl=attn_impl)
    tst, twd, tod = tgpt.make_gpt_stages(0, tcfg, 1, device="cpu")
    assert (twd, tod) == (wd, od)
    tst = [dataclasses.replace(tst[0],
                               params=params_from_numpy(nparams, "cpu")[0])]
    tpipe = Pipeline(tst, None, twd, tod, compute_dtype=compute_dtype,
                     device="cpu")
    return jpipe, tpipe


def _max_param_diff(jpipe, buf, params) -> float:
    ref = jax.tree.leaves(jax.tree.map(np.asarray, jpipe.unpack(buf)))
    got = jax.tree.leaves(params_to_numpy(params))
    assert len(ref) == len(got)
    return max(float(np.abs(a - b).max()) for a, b in zip(ref, got))


def _train_both(jpipe, tpipe, jo, to, n_steps=3):
    xs, ts = _batches(0, n_steps)
    buf = jpipe.init_params()
    state = jo.init(buf)
    jstep_fn = jstep.make_train_step(jpipe, jo)
    jl = []
    for i in range(n_steps):
        buf, state, loss = jstep_fn(buf, state, jnp.asarray(xs[i]),
                                    jnp.asarray(ts[i]), jax.random.key(1))
        jl.append(float(loss))
    params = tpipe.init_params()
    tstate = to.init(params)
    tstep_fn = ttrain.make_train_step(tpipe, to)
    tl = []
    for i in range(n_steps):
        params, tstate, loss = tstep_fn(params, tstate,
                                        torch.from_numpy(xs[i]),
                                        torch.from_numpy(ts[i]))
        tl.append(float(loss))
    return np.array(jl), np.array(tl), _max_param_diff(jpipe, buf, params)


@pytest.mark.parametrize("opt,param_atol", [("sgd", 1e-6), ("adamw", 5e-4)])
@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_training_matches_jax(attn_impl, opt, param_atol):
    jpipe, tpipe = _pair(attn_impl)
    if opt == "sgd":
        jo, to = jopt.sgd(0.1, momentum=0.5), ttrain.sgd(0.1, momentum=0.5)
    else:
        jo, to = jopt.adamw(1e-3), ttrain.adamw(1e-3)
    jl, tl, dparam = _train_both(jpipe, tpipe, jo, to)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert jl[-1] < jl[0]
    assert dparam <= param_atol, dparam


def test_training_bf16_compute_matches_jax():
    jpipe, tpipe = _pair("flash", compute_dtype=torch.bfloat16)
    jl, tl, dparam = _train_both(jpipe, tpipe, jopt.sgd(0.1, momentum=0.5),
                                 ttrain.sgd(0.1, momentum=0.5))
    np.testing.assert_allclose(tl, jl, rtol=2.0 ** -8)
    assert dparam <= 2e-3, dparam


def test_bf16_token_ids_are_rounded_only_by_jax():
    """The port's one known departure from the JAX package: with a bf16
    ``compute_dtype`` JAX casts the float token ids to bf16 before its
    embedding gather, so an id above 256 that bf16 cannot hold is rounded
    to even (and one rounded past the last row is clamped by the gather);
    the port embeds the exact id. At vocab 512 the JAX log-probs equal the
    port's on the ids so rounded, within one bf16 ulp at |logp| < 16
    (2^-4), and the loss within 2^-8 relative; on the exact ids they lie
    far outside that. The port's float ids embed exactly as integer ids."""
    jpipe, tpipe = _pair("flash", compute_dtype=torch.bfloat16, vocab=512)
    rng = np.random.default_rng(7)
    x = rng.integers(0, 512, (BATCH, 48)).astype(np.float32)
    t = torch.from_numpy(rng.integers(0, 512, (BATCH, 48)).astype(np.int32))
    rounded = np.minimum(np.asarray(
        jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)), 511)
    assert (rounded != x).any()
    jloss, jlogp = jpipe.loss_and_logits(jpipe.init_params(), jnp.asarray(x),
                                         jnp.asarray(t.numpy()),
                                         jax.random.key(0), True)
    jlogp = np.asarray(jlogp)
    params = tpipe.init_params()
    with torch.no_grad():
        loss_r, logp_r = tpipe.loss_and_logits(
            params, torch.from_numpy(rounded), t, deterministic=True)
        _, logp_x = tpipe.loss_and_logits(params, torch.from_numpy(x), t,
                                          deterministic=True)
        _, logp_i = tpipe.loss_and_logits(params, torch.from_numpy(x).long(),
                                          t, deterministic=True)
    np.testing.assert_allclose(float(loss_r), float(jloss), rtol=2.0 ** -8)
    np.testing.assert_allclose(logp_r.numpy(), jlogp, rtol=0, atol=2.0 ** -4)
    assert np.abs(logp_x.numpy() - jlogp).max() > 2.0 ** -4 * 8
    assert torch.equal(logp_x, logp_i)


def test_scanned_step_over_a_pool_matches_jax():
    """``pool_steps`` runs 5 steps over a pool of 2 batches, reading batch
    ``t % 2`` at step ``t``, and returns the per-step losses."""
    jpipe, tpipe = _pair("flash")
    xs, ts = _batches(1, 2)
    jo, to = jopt.adamw(1e-3), ttrain.adamw(1e-3)
    buf = jpipe.init_params()
    buf, _, jl = jstep.make_scanned_train_step(jpipe, jo, pool_steps=5)(
        buf, jo.init(buf), jnp.asarray(xs), jnp.asarray(ts),
        jax.random.key(0))
    params = tpipe.init_params()
    params, _, tl = ttrain.make_scanned_train_step(tpipe, to, pool_steps=5)(
        params, to.init(params), torch.from_numpy(xs), torch.from_numpy(ts))
    assert tl.shape == (5,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    assert _max_param_diff(jpipe, buf, params) <= 5e-4


def test_eval_step_matches_jax_with_n_valid():
    """Rows at or past ``n_valid`` weigh nothing; ``correct`` is an exact
    integer count."""
    jpipe, tpipe = _pair("flash")
    xs, ts = _batches(2, 1)
    js, jc = jstep.make_eval_step(jpipe)(
        jpipe.init_params(), jnp.asarray(xs[0]), jnp.asarray(ts[0]),
        jax.random.key(0), 3)
    ts_, tc = ttrain.make_eval_step(tpipe)(
        tpipe.init_params(), torch.from_numpy(xs[0]),
        torch.from_numpy(ts[0]), n_valid=3)
    np.testing.assert_allclose(float(ts_), float(js), rtol=1e-5)
    assert int(tc) == int(jc)
    full, _ = ttrain.make_eval_step(tpipe)(tpipe.init_params(),
                                           torch.from_numpy(xs[0]),
                                           torch.from_numpy(ts[0]))
    assert float(full) > float(ts_)


def test_fused_reference_and_logits_match_jax():
    """The stages' composition and the pipeline's per-token log-probs (and
    loss) equal the JAX package's ``fused_reference`` and
    ``loss_and_logits`` on the same weights, f32, deterministic."""
    jpipe, tpipe = _pair("flash")
    xs, ts = _batches(4, 1)
    jref = jfused_reference(jpipe.stages)(
        [s.params for s in jpipe.stages], jnp.asarray(xs[0]),
        jax.random.key(0), True)
    params = tpipe.init_params()
    with torch.no_grad():
        ref = fused_reference(tpipe.stages)(params, torch.from_numpy(xs[0]),
                                            deterministic=True)
        loss, logp = tpipe.loss_and_logits(params, torch.from_numpy(xs[0]),
                                           torch.from_numpy(ts[0]),
                                           deterministic=True)
    jloss, jlogp = jpipe.loss_and_logits(jpipe.init_params(),
                                         jnp.asarray(xs[0]),
                                         jnp.asarray(ts[0]),
                                         jax.random.key(0), True)
    assert logp.shape == (BATCH, 48, 64)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), **F32_TOL)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), **F32_TOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_grad_norm_output_matches_jax():
    jpipe, tpipe = _pair("flash")
    xs, ts = _batches(3, 1)
    jo, to = jopt.sgd(0.1), ttrain.sgd(0.1)
    buf = jpipe.init_params()
    *_, jn = jstep.make_train_step(jpipe, jo, with_grad_norm=True)(
        buf, jo.init(buf), jnp.asarray(xs[0]), jnp.asarray(ts[0]),
        jax.random.key(0))
    params = tpipe.init_params()
    *_, tn = ttrain.make_train_step(tpipe, to, with_grad_norm=True)(
        params, to.init(params), torch.from_numpy(xs[0]),
        torch.from_numpy(ts[0]))
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)


def _opt_pair(name):
    sched = (jsched.warmup_cosine(0.05, 2, 6), ttrain.warmup_cosine(0.05, 2, 6))
    return {
        "sgd": (jopt.sgd(0.1), ttrain.sgd(0.1)),
        "sgd-momentum": (jopt.sgd(0.1, momentum=0.5),
                         ttrain.sgd(0.1, momentum=0.5)),
        "sgd-schedule": (jopt.sgd(sched[0], momentum=0.9),
                         ttrain.sgd(sched[1], momentum=0.9)),
        "adamw": (jopt.adamw(1e-2), ttrain.adamw(1e-2)),
        "adamw-schedule": (jopt.adamw(sched[0], weight_decay=0.1),
                           ttrain.adamw(sched[1], weight_decay=0.1)),
        "clipped": (jopt.clip_by_global_norm(jopt.adamw(1e-2), 0.5),
                    ttrain.clip_by_global_norm(ttrain.adamw(1e-2), 0.5)),
    }[name]


@pytest.mark.parametrize("name", ["sgd", "sgd-momentum", "sgd-schedule",
                                  "adamw", "adamw-schedule", "clipped"])
def test_optimizers_match_jax_step_by_step(name):
    """Six updates of three O(1) parameter tensors from the same
    gradients, compared after every update within 5e-6: the same
    elementwise arithmetic, but the schedules and Adam's bias corrections
    evaluate in f64 here and in f32 in JAX, and ``1 - b2**t`` cancels to
    ~0.006 by step 6, so JAX's f32 ``b2**t`` (ulp 6e-8) carries ~1e-5
    relative into an update of up to lr = 0.05."""
    jo, to = _opt_pair(name)
    rng = np.random.default_rng(4)
    shapes = [(5, 3), (3,), (2, 2, 2)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jp = [jnp.asarray(a) for a in p0]
    tp = [torch.from_numpy(a.copy()) for a in p0]
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(6):
        g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        jp, js = jo.update([jnp.asarray(a) for a in g], js, jp)
        tp, ts = to.update([torch.from_numpy(a) for a in g], ts, tp)
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=5e-6)


@pytest.mark.parametrize("name", ["constant", "cosine", "warmup_cosine",
                                  "step_decay"])
def test_schedules_match_jax(name):
    args = {"constant": (0.3,), "cosine": (0.3, 7, 0.1),
            "warmup_cosine": (0.3, 3, 10, 0.05),
            "step_decay": (0.3, 3, 0.5)}[name]
    js, ts = getattr(jsched, name)(*args), getattr(ttrain, name)(*args)
    for t in range(14):
        np.testing.assert_allclose(ts(t), float(js(jnp.int32(t))),
                                   rtol=1e-6)


def test_dropout_identity_and_statistics():
    """``rate == 0`` or ``deterministic`` is the identity; otherwise about
    ``1 - rate`` of the entries survive, scaled so the mean is kept. The
    bits differ from ``jax.random`` by design, so this is statistical:
    with 200k entries the kept fraction's standard error is ~0.001."""
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    assert dropout(gen, x, 0.0) is x
    assert dropout(gen, x, 0.5, deterministic=True) is x
    y = dropout(gen, x, 0.25)
    kept = float((y != 0).float().mean())
    assert abs(kept - 0.75) < 0.005
    assert abs(float(y.mean()) - 1.0) < 0.01
    assert torch.all((y == 0) | torch.isclose(y, torch.tensor(4.0 / 3.0)))


def test_dropout_in_the_training_forward_draws_from_the_key():
    """With ``dropout_rate > 0`` a training forward depends on the key and
    repeats with it; a deterministic forward equals the dropout-free
    model's."""
    _, tpipe = _pair("flash", dropout_rate=0.3)
    _, plain = _pair("flash")
    xs, ts = _batches(5, 1)
    x, t = torch.from_numpy(xs[0]), torch.from_numpy(ts[0])
    params = tpipe.init_params()
    with torch.no_grad():
        a = tpipe.loss(params, x, t, key=7)
        assert float(a) == float(tpipe.loss(params, x, t, key=7))
        assert float(a) != float(tpipe.loss(params, x, t, key=8))
        det = tpipe.loss(params, x, t, deterministic=True)
        assert float(det) == float(plain.loss(plain.init_params(), x, t))


def test_init_params_survives_training():
    _, tpipe = _pair("dense")
    xs, ts = _batches(6, 1)
    opt = ttrain.sgd(0.1)
    params = tpipe.init_params()
    before = params_to_numpy(tpipe.init_params())
    ttrain.make_train_step(tpipe, opt)(params, opt.init(params),
                                       torch.from_numpy(xs[0]),
                                       torch.from_numpy(ts[0]))
    after = params_to_numpy(tpipe.init_params())
    for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(after)):
        np.testing.assert_array_equal(a, b)
    trained = jax.tree.leaves(params_to_numpy(params))
    assert any(not np.array_equal(a, b)
               for a, b in zip(jax.tree.leaves(before), trained))


def test_multi_stage_pipeline_raises_with_roadmap_item():
    """Several stages run over a stage mesh; a stage count that does not
    match the mesh raises, a data axis beside the stages runs (the GPT's
    loss over two replicas is the one-replica loss at two microbatches),
    and a sequence axis builds (ROADMAP item 6d.2 is ported): a dense
    build's per-token output on it must split over its chunks, with the
    JAX ``Pipeline``'s text."""
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        make_mesh as tmake_mesh,
    )
    cfg = tgpt.GPTConfig(**SMALL)
    stages, wd, od = tgpt.make_gpt_stages(0, cfg, 2, device="cpu")
    with pytest.raises(ValueError, match="2 stages but mesh stage axis is 1"):
        Pipeline(stages, None, wd, od, device="cpu")
    with pytest.raises(ValueError, match="1 stages but mesh stage axis is 2"):
        Pipeline(stages[:1], tmake_mesh(2, devices=["cpu"] * 2), wd, od)
    seq = tmake_mesh(n_stages=2, n_seq=2, devices=["cpu"] * 4)
    assert seq.shape["seq"] == 2
    with pytest.raises(ValueError, match="token axis 7 not divisible by "
                                         "seq axis size 2"):
        Pipeline(stages, seq, wd, (7, cfg.vocab))
    two = Pipeline(stages, tmake_mesh(2, n_data=2, devices=["cpu"] * 4),
                   wd, od)
    one = Pipeline(stages, tmake_mesh(2, devices=["cpu"] * 2), wd, od,
                   n_microbatches=2)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, cfg.vocab, (4, cfg.seq_len))
                         .astype(np.float32))
    t = torch.from_numpy(rng.integers(0, cfg.vocab, (4, cfg.seq_len)))
    with torch.no_grad():
        assert float(two.loss(two.init_params(), x, t, 5)) == float(
            one.loss(one.init_params(), x, t, 5))
    assert Pipeline(stages, tmake_mesh(2, devices=["cpu"] * 2), wd,
                    od).n_stages == 2


def test_pipeline_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: device=None is valid here")
    cfg = tgpt.GPTConfig(**SMALL)
    stages, wd, od = tgpt.make_gpt_stages(0, cfg, 1, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Pipeline(stages, None, wd, od)


@pytest.mark.parametrize("kw", [
    dict(flash_block_q=0),
    dict(flash_block_k=0),
    dict(n_seq=2),
    dict(n_seq=2, attn_impl="flash"),
    dict(attn_impl="ulysses", n_seq=2, n_heads=3),
    dict(n_expert_parallel=2),
    dict(n_experts=3, n_expert_parallel=2),
    dict(n_tensor_parallel=0),
    dict(n_tensor_parallel=3),
    dict(n_tensor_parallel=4, d_model=6, mlp_ratio=1),
    dict(n_tensor_parallel=2, attn_impl="flash"),
    dict(n_tensor_parallel=2, n_experts=2),
    dict(attn_impl="sparse"),
    dict(overlap="all"),
], ids=["block_q", "block_k", "n_seq-dense", "n_seq-flash", "ulysses-heads",
        "ep-without-experts", "ep-indivisible", "tp-zero", "tp-heads",
        "tp-mlp", "tp-flash", "tp-moe", "attn_impl", "overlap"])
def test_bad_configs_raise_in_both_packages(kw):
    with pytest.raises(ValueError):
        jgpt.GPTConfig(**kw)
    with pytest.raises(ValueError):
        tgpt.GPTConfig(**kw)
