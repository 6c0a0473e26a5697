"""The port's beam-search decoder against the JAX package's, and against
itself (``tests/test_beam.py``'s pins).

Both packages get the same weights: the JAX build of the tiny GPT (vocab
32, seq 24, d 32, 2 heads, 2 layers) carried into the port by
``interop.params_from_numpy``, and the same prompts. Across packages the
beam tokens are equal and the scores agree within 1e-5 relative (f32;
the frameworks sum in other orders), at beam sizes 1, 2, 4 and the full
vocab, with and without EOS. Within the port: ``beam_size=1`` is greedy,
a score is the model's own log-prob of its tokens (teacher-forced
through ``fused_reference``), full width is the exhaustive argmax, EOS
freezes and pads, batch rows are independent.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.models.beam import (
    make_beam_decoder as jax_beam,
)
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.models import (
    make_beam_decoder,
)
from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (
    fused_reference,
)

KW = dict(vocab=32, seq_len=24, d_model=32, n_heads=2, n_layers=2)
CFG = tgpt.GPTConfig(**KW)
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs: its models are
    tiny, and under a multi-process test run more threads only contend
    for the same cores. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """``(stages, params, jstages, jcfg)``: the port's stages carrying the
    JAX build's weights (2 stages, ``jax.random.key(0)``)."""
    jcfg = jgpt.GPTConfig(**KW)
    jst = jgpt.make_gpt_stages(jax.random.key(0), jcfg, 2)[0]
    nparams = jax.tree.map(np.asarray, [s.params for s in jst])
    tst = tgpt.make_gpt_stages(0, CFG, 2, device="cpu")[0]
    tst = [dataclasses.replace(s, params=p)
           for s, p in zip(tst, params_from_numpy(nparams, "cpu"))]
    return tst, [s.params for s in tst], jst, jcfg


def _prompt(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG.vocab, shape).astype(
        np.int32)


def _beam(stages, t0, n_new, **kw):
    return make_beam_decoder(stages, CFG, t0, n_new, device="cpu", **kw)


def _logp(stages, params, rows, pos=None):
    """Log-probs [B, T, V] (or at ``pos``) of token rows through the port's
    training forward, teacher-forced."""
    buf = np.zeros((rows.shape[0], CFG.seq_len), np.float32)
    buf[:, :rows.shape[1]] = rows
    with torch.no_grad():
        out = fused_reference(stages)(params, torch.from_numpy(buf),
                                      None, True).numpy()
    return out if pos is None else out[:, pos]


def _seq_logprob(stages, params, seq, prompt_len):
    logp = _logp(stages, params, np.asarray(seq))
    return sum(float(logp[b, pos, int(seq[b, pos + 1])])
               for b in range(seq.shape[0])
               for pos in range(prompt_len - 1, seq.shape[1] - 1))


# -- the JAX decoder, from the same weights ----------------------------------

@pytest.mark.parametrize("eos", [None, "emitted"], ids=["no-eos", "eos"])
@pytest.mark.parametrize("beam_size", [1, 2, 4, 32])
def test_matches_the_jax_decoder(model, beam_size, eos):
    """Tokens equal and scores within 1e-5 relative, three prompts of 5
    tokens and 9 new; with EOS, an id the no-EOS run emits mid-stream, so
    the freeze-and-pad path runs."""
    stages, params, jst, jcfg = model
    prompt = _prompt(1, (3, 5))
    jparams = [s.params for s in jst]
    eos_id = None
    if eos is not None:
        base, _ = _beam(stages, 5, 9, beam_size=beam_size)(params, prompt)
        eos_id = int(base[0, 5 + 3])
    toks, scores = _beam(stages, 5, 9, beam_size=beam_size, eos_id=eos_id)(
        params, prompt, key=None)
    jt, js = jax_beam(jst, jcfg, 5, 9, beam_size=beam_size, eos_id=eos_id)(
        jparams, jnp.asarray(prompt), jax.random.key(0))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), rtol=REL,
                               atol=0)
    assert toks.dtype == torch.int32 and scores.dtype == torch.float32
    if eos_id is not None:
        assert (toks[0, 5 + 3:] == eos_id).all()


# -- tests/test_beam.py's pins, in the port -----------------------------------

def test_beam_size_1_is_greedy(model):
    stages, params, _, _ = model
    prompt = _prompt(1, (3, 5))
    want = tgpt.make_cached_decoder(stages, CFG, 5, 9, device="cpu")(
        params, prompt)
    got, _ = _beam(stages, 5, 9, beam_size=1)(params, prompt)
    assert torch.equal(got, want)


def test_beam_scores_are_true_cumulative_logprobs(model):
    stages, params, _, _ = model
    prompt = _prompt(2, (2, 4))
    toks, scores = _beam(stages, 4, 8, beam_size=3)(params, prompt)
    toks = toks.numpy()
    for b in range(2):
        want = _seq_logprob(stages, params, toks[b:b + 1], 4)
        np.testing.assert_allclose(float(scores[b]), want, rtol=2e-4,
                                   atol=2e-4)


def test_full_width_beam_is_exhaustive_argmax(model):
    """beam_size = vocab and n_new = 2: every 2-token continuation survives
    the first expansion, so the answer is the true argmax over all
    vocab^2 continuations (brute force through the fused forward). Ties in
    the top-K break toward the lower index, as ``lax.top_k`` does."""
    stages, params, _, _ = model
    V, t0 = CFG.vocab, 4
    prompt = _prompt(3, (1, t0))
    toks, score = _beam(stages, t0, 2, beam_size=V)(params, prompt)
    first = _logp(stages, params, prompt.astype(np.float32), t0 - 1)[0]
    ext = np.concatenate([np.repeat(prompt, V, axis=0),
                          np.arange(V)[:, None]], axis=1)
    second = _logp(stages, params, ext.astype(np.float32), t0)     # [V, V]
    table = first[:, None] + second
    b1, b2 = np.unravel_index(np.argmax(table), table.shape)
    np.testing.assert_array_equal(toks.numpy()[0, t0:], [b1, b2])
    np.testing.assert_allclose(float(score[0]), table[b1, b2], rtol=2e-4,
                               atol=2e-4)


def test_beam_validation(model):
    stages, _, _, _ = model
    with pytest.raises(ValueError, match="beam_size"):
        _beam(stages, 4, 4, beam_size=0)
    with pytest.raises(ValueError, match="exceeds the model's sequence"):
        _beam(stages, 20, 9)
    with pytest.raises(ValueError, match="eos_id"):
        _beam(stages, 4, 4, eos_id=CFG.vocab)
    with pytest.raises(ValueError, match="eos_id"):
        _beam(stages, 4, 4, eos_id=-1)
    with pytest.raises(ValueError, match="single-device"):
        make_beam_decoder(stages, dataclasses.replace(
            CFG, n_seq=2, attn_impl="ring"), 4, 4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_beam_decoder(stages, CFG, 4, 4)


def test_beam_eos_terminates_greedy_path(model):
    """beam_size=1 with eos_id: tokens match greedy decoding up to and
    including the first eos, then eos-pad; the score freezes at the
    finished prefix's log-prob (teacher-forced)."""
    stages, params, _, _ = model
    prompt = _prompt(4, (2, 5))
    greedy = tgpt.make_cached_decoder(stages, CFG, 5, 8, device="cpu")(
        params, prompt).numpy()
    eos = int(greedy[0, 5 + 2])
    toks, scores = _beam(stages, 5, 8, beam_size=1, eos_id=eos)(params,
                                                                 prompt)
    toks = toks.numpy()
    for b in range(2):
        want = greedy[b, 5:]
        hits = np.where(want == eos)[0]
        cut = int(hits[0]) + 1 if len(hits) else 8
        np.testing.assert_array_equal(toks[b, 5:5 + cut], want[:cut])
        assert (toks[b, 5 + cut:] == eos).all()
        ref = _seq_logprob(stages, params, toks[b:b + 1, :5 + cut], 5)
        np.testing.assert_allclose(float(scores[b]), ref, rtol=2e-4,
                                   atol=2e-4)


def test_beam_eos_unfinished_beams_keep_searching(model):
    stages, params, _, _ = model
    prompt = _prompt(5, (2, 4))
    base_t, base_s = _beam(stages, 4, 6, beam_size=3)(params, prompt)
    unused = [v for v in range(CFG.vocab) if v not in base_t][0]
    got_t, got_s = _beam(stages, 4, 6, beam_size=3, eos_id=unused)(params,
                                                                    prompt)
    assert torch.equal(got_t, base_t)
    assert torch.equal(got_s, base_s)


def test_beam_prompt_batch_matches_individual(model):
    stages, params, _, _ = model
    prompt = _prompt(6, (3, 5))
    dec = _beam(stages, 5, 6, beam_size=3)
    toks_b, scores_b = dec(params, prompt)
    for b in range(3):
        t1, s1 = dec(params, prompt[b:b + 1])
        assert torch.equal(toks_b[b], t1[0])
        np.testing.assert_allclose(float(scores_b[b]), float(s1[0]),
                                   rtol=1e-5, atol=1e-5)
