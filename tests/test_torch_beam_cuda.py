"""The beam-search decoder on the card: its tokens equal the CPU's.

These tests import torch and the port only, so they run on a GPU machine
without JAX; the repo's ``tests/conftest.py`` sets JAX up, so skip it there:

    python -m pytest --noconftest -m cuda tests/test_torch_beam_cuda.py

Without a card they skip. Beam search is plain torch math (no hand
kernel), so the card and the CPU differ only in summation order: the
scores are held within 1e-5 relative, and the tokens equal unless the
two runs' answers score within that tolerance of each other (a near-tie
in the beam's ranking, which the assertion message shows).
"""

import copy

import pytest
import torch

from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.models import (
    make_beam_decoder,
)
from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (
    fused_reference,
)

CFG = tgpt.GPTConfig(vocab=256, seq_len=48, d_model=64, n_heads=4,
                     n_layers=2)
T0, N_NEW = 8, 16


def _score(stages, params, seq, eos_id) -> float:
    """The teacher-forced log-prob of ``seq``'s generated suffix, through
    its first ``eos_id`` (the eos-padded tail scores 0)."""
    x = torch.zeros((1, CFG.seq_len), device=seq.device)
    x[0, :seq.shape[0]] = seq
    with torch.no_grad():
        logp = fused_reference(stages)(params, x, None, True)[0]
    end = seq.shape[0]
    hits = (seq[T0:] == eos_id).nonzero() if eos_id is not None else []
    if len(hits):
        end = T0 + int(hits[0]) + 1
    pos = torch.arange(T0 - 1, end - 1, device=seq.device)
    return float(logp[pos, seq[pos + 1].long()].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("eos_id", [None, 7])
@pytest.mark.parametrize("beam_size", [1, 4])
def test_card_beam_equals_cpu(beam_size, eos_id):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this is the card's beam search")
    stages = tgpt.make_gpt_stages(0, CFG, 1, device="cpu")[0]
    params = [s.params for s in stages]
    card = [copy.deepcopy(p).to("cuda") for p in params]
    prompt = torch.randint(0, CFG.vocab, (4, T0),
                           generator=torch.Generator().manual_seed(1))
    cpu_t, cpu_s = make_beam_decoder(stages, CFG, T0, N_NEW, beam_size,
                                     eos_id=eos_id, device="cpu")(params,
                                                                  prompt)
    card_t, card_s = make_beam_decoder(stages, CFG, T0, N_NEW, beam_size,
                                       eos_id=eos_id, device="cuda")(
        card, prompt)
    card_t, card_s = card_t.cpu(), card_s.cpu()
    torch.testing.assert_close(card_s, cpu_s, rtol=1e-5, atol=0)
    for b in range(prompt.shape[0]):
        if torch.equal(card_t[b], cpu_t[b]):
            continue
        # a near-tie: on the card, the CPU's answer scores within the
        # tolerance of the card's own
        ours = _score(stages, card, card_t[b].cuda(), eos_id)
        theirs = _score(stages, card, cpu_t[b].cuda(), eos_id)
        assert abs(ours - theirs) <= 1e-5 * abs(ours), (
            b, card_t[b].tolist(), cpu_t[b].tolist(), ours, theirs)
