"""The port's stage-sharded KV-cache decoder (``models/pp_decode.py``)
against the JAX package's ``make_pp_decoder`` and the port's own
``make_cached_decoder``, on ``tests/test_pp_decode.py``'s model.

Greedy tokens are compared exactly, across packages too (the same weights,
the same math in f32); sampled streams only within the port, since the
two packages' generators differ by design.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu import make_mesh as jmake_mesh
from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.models.pp_decode import (
    make_pp_decoder as jmake_pp_decoder,
)
from simple_distributed_machine_learning_tpu.parallel.pipeline import (
    Pipeline as JPipeline,
)
from simple_distributed_machine_learning_tpu_torch import train as ttrain
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.models import (
    make_pp_decoder,
)
from simple_distributed_machine_learning_tpu_torch.ops.random import key_data
from simple_distributed_machine_learning_tpu_torch.parallel import (
    Pipeline,
    make_mesh,
)

CFG = dict(vocab=32, seq_len=24, d_model=32, n_heads=2, n_layers=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs: its models are
    tiny, and under a multi-process test run more threads only contend
    for the same cores. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(S):
    """``(jax stages, jax pipe, port stages, port pipe)`` on one set of
    weights (the JAX builder's)."""
    jst, wd, od = jgpt.make_gpt_stages(jax.random.key(0),
                                       jgpt.GPTConfig(**CFG), S)
    jpipe = JPipeline(jst, jmake_mesh(n_stages=S, n_data=1,
                                      devices=jax.devices()[:S]), wd, od)
    tst = tgpt.make_gpt_stages(0, tgpt.GPTConfig(**CFG), S, device="cpu")[0]
    nparams = jax.tree.map(np.asarray, [s.params for s in jst])
    tst = [dataclasses.replace(s, params=p)
           for s, p in zip(tst, params_from_numpy(nparams, "cpu"))]
    tpipe = Pipeline(tst, make_mesh(S, devices=["cpu"] * S), wd, od)
    return jst, jpipe, tst, tpipe


def _prompt(seed, b, t0):
    return np.random.default_rng(seed).integers(0, CFG["vocab"],
                                                 (b, t0)).astype(np.int32)


def test_greedy_tokens_equal_jax_and_the_cached_decoder():
    _, jpipe, tst, tpipe = _setup(2)
    prompt = _prompt(1, 4, 5)
    want = np.asarray(jmake_pp_decoder(jpipe, jgpt.GPTConfig(**CFG), 5, 9)(
        jpipe.init_params(), jnp.asarray(prompt), jax.random.key(3)))
    params = tpipe.init_params()
    got = make_pp_decoder(tpipe, tgpt.GPTConfig(**CFG), 5, 9)(
        params, prompt, key_data(3))
    cached = tgpt.make_cached_decoder(tst, tgpt.GPTConfig(**CFG), 5, 9,
                                      device="cpu")(params, prompt,
                                                    key_data(3))
    assert got.shape == (4, 14) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, cached)


def test_ragged_stages_keep_caches_of_their_own_depth():
    """Three stages over four blocks (2 + 1 + 1): each stage's cache has
    its own depth, and the tokens are the cached decoder's."""
    _, _, tst, tpipe = _setup(3)
    assert [len(s.params["blocks"]) for s in tst] == [2, 1, 1]
    prompt = _prompt(2, 2, 6)
    params = tpipe.init_params()
    got = make_pp_decoder(tpipe, tgpt.GPTConfig(**CFG), 6, 8)(params, prompt)
    want = tgpt.make_cached_decoder(tst, tgpt.GPTConfig(**CFG), 6, 8,
                                    device="cpu")(params, prompt)
    assert torch.equal(got, want)


def test_bf16_cache_matches_f32():
    _, _, _, tpipe = _setup(2)
    prompt = _prompt(1, 2, 5)
    params = tpipe.init_params()
    f32 = make_pp_decoder(tpipe, tgpt.GPTConfig(**CFG), 5, 7)(params, prompt)
    bf16 = make_pp_decoder(tpipe, tgpt.GPTConfig(**CFG), 5, 7,
                           cache_dtype=torch.bfloat16)(params, prompt)
    assert torch.equal(bf16, f32)


def test_sampled_stream_equals_the_cached_decoder():
    """temperature + top-k: one key split per sampled token, as the cached
    decoder splits it."""
    _, _, tst, tpipe = _setup(2)
    prompt = _prompt(2, 2, 4)
    params = tpipe.init_params()
    kw = dict(temperature=0.8, top_k=5)
    got = make_pp_decoder(tpipe, tgpt.GPTConfig(**CFG), 4, 8, **kw)(
        params, prompt, key_data(11))
    want = tgpt.make_cached_decoder(tst, tgpt.GPTConfig(**CFG), 4, 8,
                                    device="cpu", **kw)(params, prompt,
                                                        key_data(11))
    assert torch.equal(got, want)
    greedy = make_pp_decoder(tpipe, tgpt.GPTConfig(**CFG), 4, 8)(params,
                                                                 prompt)
    assert not torch.equal(got, greedy)


def test_decoder_reads_the_live_parameters():
    """Decoding follows training updates made in place on the stages'
    modules."""
    _, _, _, tpipe = _setup(2)
    prompt = _prompt(4, 2, 4)
    dec = make_pp_decoder(tpipe, tgpt.GPTConfig(**CFG), 4, 6)
    params = tpipe.init_params()
    out0 = dec(params, prompt, key_data(0))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 32, (8, 24)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 32, (8, 24)))
    opt = ttrain.sgd(0.5, momentum=0.9)
    state = opt.init(params)
    step = ttrain.make_train_step(tpipe, opt)
    for i in range(10):
        params, state, _ = step(params, state, x, y, i)
    assert not torch.equal(out0, dec(params, prompt, key_data(0)))


def test_validation_is_the_jax_decoders():
    """``tests/test_pp_decode.py``'s messages."""
    _, _, _, tpipe = _setup(2)
    cfg = tgpt.GPTConfig(**CFG)
    with pytest.raises(ValueError, match="exceeds the model's sequence"):
        make_pp_decoder(tpipe, cfg, 20, 9)
    with pytest.raises(ValueError, match="non-empty prompt"):
        make_pp_decoder(tpipe, cfg, 0, 4)
    wrong = tgpt.GPTConfig(vocab=32, seq_len=64, d_model=32, n_heads=2,
                           n_layers=4)
    with pytest.raises(ValueError, match="does not match the stages'"):
        make_pp_decoder(tpipe, wrong, 4, 4)
    with pytest.raises(ValueError, match="prompt length 3 != built 4"):
        make_pp_decoder(tpipe, cfg, 4, 4)(tpipe.init_params(),
                                         _prompt(0, 1, 3))
