"""The full-prefix decoder on the card: ``make_decoder`` on a flash build
launches K1 once per layer per decoded token, and its log-probs match the
dense-attention forward's on the same buffer.

These tests import torch and the port only, so they run on a GPU machine
without JAX; the repo's ``tests/conftest.py`` sets JAX up, so skip it there:

    python -m pytest --noconftest -m cuda tests/test_torch_decode_cuda.py

Without a card they skip. K1 f32 agrees with its plain version within
1e-5, so two layers and the head keep the teacher-forced log-probs of the
flash decode within ``LOGP_TOL`` = 1e-4 of the dense forward's; a decoded
token is the dense argmax, or within that tolerance of it (random weights
give near ties).
"""

import pytest
import torch

from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.ops.flash_attention import (
    flash_forward,
)
from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (
    fused_reference,
)

KW = dict(vocab=256, seq_len=64, d_model=64, n_heads=4, n_layers=2)
T0, N_NEW = 8, 16
LOGP_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [{}, dict(n_experts=4, moe_top_k=2)],
                         ids=["dense_mlp", "moe"])
def test_card_make_decoder_launches_k1_and_matches_dense(extra):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 has no CPU mode")
    cfg = tgpt.GPTConfig(**KW, **extra, attn_impl="flash")
    stages = tgpt.make_gpt_stages(0, cfg, 1)[0]
    dense = tgpt.make_gpt_stages(
        0, tgpt.GPTConfig(**KW, **extra, attn_impl="dense"), 1)[0]
    params = [s.params for s in stages]
    prompt = torch.randint(0, cfg.vocab, (2, T0),
                           generator=torch.Generator().manual_seed(1))
    dec = tgpt.make_decoder(stages, T0, N_NEW)
    before = flash_forward.launches
    toks = dec(params, prompt)
    assert flash_forward.launches - before == cfg.n_layers * N_NEW
    assert toks.is_cuda and toks.shape == (2, T0 + N_NEW)
    assert torch.equal(toks[:, :T0].cpu().long(), prompt)
    fused, flash = fused_reference(dense), fused_reference(stages)
    rows, flash_rows = [], []
    with torch.no_grad():
        for i in range(T0, T0 + N_NEW):       # each step's own buffer
            buf = torch.zeros((2, cfg.seq_len), dtype=torch.int64,
                              device="cuda")
            buf[:, :i] = toks[:, :i]
            rows.append(fused(params, buf, None, True)[:, i - 1])
            flash_rows.append(flash(params, buf, None, True)[:, i - 1])
    rows, flash_rows = torch.stack(rows, 1), torch.stack(flash_rows, 1)
    assert float((rows - flash_rows).abs().max()) <= LOGP_TOL
    picked = rows.gather(-1, toks[:, T0:].long()[..., None])[..., 0]
    assert float((rows.max(-1).values - picked).max()) <= LOGP_TOL
