"""The grid fixture's kernel F1 of the PyTorch port against the JAX
fixture's own Pallas kernel.

``analysis/fixtures.py::_grid_kernel_report`` hands its ``pallas_call``
(with ``interpret=True``) to ``analysis.analyze``, whose trace module does
not import on this tree. The JAX side here patches the package attribute
``analyze`` in-process with a capture that CALLS the fixture's function on
a seeded input, so the fixture's own kernel runs in interpret mode. The
port's wrapper, given a CPU tensor, computes its plain version. Both get
the same (4, 128) f32 input from a numpy seed; the tolerance is 0 (bit
equality, NaN rows included):

- clean f32 and f16 scratch: ``2·x`` and ``f32(f16(x)·2)`` exactly;
- racing: row 0 is the last grid cell's ``2·x[3]`` (a sequential grid:
  the last writer wins) and rows 1-3 are never written (NaN) in both.

The CUDA kernel runs only on the card: ``tests/test_torch_grid_kernel_cuda.py``
and ``chip_smoke.py`` phase 14.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simple_distributed_machine_learning_tpu.analysis as janalysis
from simple_distributed_machine_learning_tpu.analysis import (
    fixtures as jfixtures,
)
from simple_distributed_machine_learning_tpu_torch.analysis import kernels
from simple_distributed_machine_learning_tpu_torch.analysis.fixtures import (
    grid_input,
    grid_scratch,
    grid_scratch_reference,
    grid_scratch_spec,
)

VARIANTS = {
    "kernel_clean_grid": (False, torch.float32),
    "kernel_f32_accumulator": (False, torch.float32),
    "kernel_f16_accumulator": (False, torch.float16),
    "kernel_grid_race": (True, torch.float32),
}


@pytest.fixture(scope="module")
def jax_outputs():
    """Each JAX grid fixture's kernel output on ``grid_input()``'s
    values, through the fixture's own interpret-mode ``pallas_call``."""
    x = grid_input("cpu").numpy()
    out = {}

    def capture(fn, *args, name=None, **kw):
        out[name.removeprefix("fixture:")] = np.asarray(fn(jnp.asarray(x)))
        return janalysis.Report(name=name)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(janalysis, "analyze", capture, raising=False)
        for name in VARIANTS:
            getattr(jfixtures, name)()
    return x, out


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_plain_version_is_bit_equal_to_the_jax_fixture(jax_outputs, name):
    x, ref = jax_outputs
    racing, scratch = VARIANTS[name]
    ours = grid_scratch(torch.from_numpy(x), racing=racing,
                        scratch_dtype=scratch, device="cpu").numpy()
    np.testing.assert_array_equal(ours, ref[name])


def test_clean_variants_compute_twice_x_in_their_scratch(jax_outputs):
    x, ref = jax_outputs
    np.testing.assert_array_equal(ref["kernel_clean_grid"], 2 * x)
    want16 = (x.astype(np.float16) * np.float16(2)).astype(np.float32)
    np.testing.assert_array_equal(ref["kernel_f16_accumulator"], want16)
    assert not np.array_equal(want16, 2 * x)           # f16 really rounds


def test_racing_variant_last_cell_wins_and_other_rows_stay_nan(jax_outputs):
    x, ref = jax_outputs
    ours = grid_scratch_reference(torch.from_numpy(x), racing=True).numpy()
    for out in (ours, ref["kernel_grid_race"]):
        np.testing.assert_array_equal(out[0], 2 * x[3])
        assert np.isnan(out[1:]).all()


def test_output_rows_come_from_the_linted_index_map():
    clean = grid_scratch_spec(4, 128, racing=False)
    race = grid_scratch_spec(4, 128, racing=True)
    assert [kernels.concrete(clean, "out", i) for i in range(4)] == [
        (i, 0) for i in range(4)]
    assert {kernels.concrete(race, "out", i) for i in range(4)} == {(0, 0)}
    assert [f.rule for f in kernels.lint(race)] == [
        "kernel-race.parallel-overwrite"]
    assert kernels.lint(clean) == []


def test_wrapper_records_its_spec_on_the_plain_path():
    x = grid_input("cpu")
    with kernels.record_launches() as log:
        grid_scratch(x, racing=True, device="cpu")
        grid_scratch(x, racing=False, scratch_dtype=torch.float16,
                     device="cpu")
    assert [s.kernel for s in log] == ["grid_scratch"] * 2
    assert log[1].scratch == (torch.float16,)
    grid_scratch(x, racing=False, device="cpu")         # no recorder open
    assert len(log) == 2
    assert grid_scratch.launches == 0                   # no kernel ran


def test_wrapper_raises_on_a_cuda_request_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        grid_scratch(grid_input("cpu"), racing=False)
    with pytest.raises(ValueError, match="float32"):
        grid_scratch(grid_input("cpu").double(), racing=False, device="cpu")
    with pytest.raises(ValueError, match="scratch_dtype"):
        grid_scratch(grid_input("cpu"), racing=False,
                     scratch_dtype=torch.bfloat16, device="cpu")
