"""The grid fixture's CUDA kernel (F1) against its plain version on the
card.

These tests import torch and the port only, so they run on a GPU machine
without JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_*_cuda.py``). Without a card every test here skips.
Tolerance 0: the clean variants are bit-equal (f32 and f16 doubling is
exact), and the racing variant's row 0 holds, element by element, one
grid cell's ``2·x`` (cells race on the card, in no order) while the rows
no cell maps to stay NaN.
"""

import pytest
import torch

from simple_distributed_machine_learning_tpu_torch.analysis.fixtures import (
    grid_input,
    grid_scratch,
    grid_scratch_reference,
)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scratch", [torch.float32, torch.float16])
def test_clean_kernel_is_bit_equal_to_the_plain_version(card, scratch):
    x = grid_input(card)
    n0 = grid_scratch.launches
    got = grid_scratch(x, racing=False, scratch_dtype=scratch)
    torch.cuda.synchronize()
    assert grid_scratch.launches == n0 + 1
    assert torch.equal(got, grid_scratch_reference(x, racing=False,
                                                   scratch_dtype=scratch))


@pytest.mark.cuda
def test_racing_kernel_writes_row_zero_only(card):
    x = grid_input(card)
    got = grid_scratch(x, racing=True)
    torch.cuda.synchronize()
    assert torch.isnan(got[1:]).all()
    assert ((got[0][None] == 2 * x).any(dim=0)).all()
