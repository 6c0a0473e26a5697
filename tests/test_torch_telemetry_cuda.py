"""The training telemetry on the card: ``Telemetry.on_step`` fences the
card before it closes a window, and ``device_memory_stats`` reads the
caching allocator.

These tests import torch and the port only, so they run on a GPU machine
without JAX; the repo's ``tests/conftest.py`` sets JAX up, so skip it there:

    python -m pytest --noconftest -m cuda tests/test_torch_*_cuda.py

Without a card every test here skips.
"""

import json
import time

import pytest
import torch

from simple_distributed_machine_learning_tpu_torch.telemetry import (
    METRICS_FILE,
    Telemetry,
)
from simple_distributed_machine_learning_tpu_torch.telemetry.memory import (
    device_memory_stats,
    live_array_bytes,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this is the card's telemetry path")
    return torch.device("cuda")


@pytest.mark.cuda
def test_on_step_fences_the_card_before_closing_a_window(cuda_device,
                                                         tmp_path):
    """A window closes only after the card has run the step's work: a
    ~50 ms busy loop on the card, enqueued in microseconds, is inside the
    recorded window."""
    tele = Telemetry(str(tmp_path), every=1)
    x = torch.ones(1, device=cuda_device)
    torch.cuda.synchronize()
    tele.on_step(x, force_fence=True)          # the compile window
    tele.mark()
    t0 = time.perf_counter()
    torch.cuda._sleep(int(5e7))                # ~50 ms at ~1 GHz clocks
    enqueued_s = time.perf_counter() - t0
    tele.on_step(x, examples=1)
    assert tele.timer.steps == 1
    assert tele.timer.quantile_ms(0.5) > 10.0 > enqueued_s * 1e3


@pytest.mark.cuda
def test_device_memory_stats_read_the_allocator(cuda_device, tmp_path):
    held = torch.empty(64 << 20, dtype=torch.uint8, device=cuda_device)
    stats = device_memory_stats()
    dev = stats[str(cuda_device.index or 0)]
    assert dev["peak_bytes_in_use"] >= dev["bytes_in_use"] >= held.numel()
    assert dev["bytes_reserved"] >= dev["bytes_in_use"]
    assert live_array_bytes() >= held.numel()
    tele = Telemetry(str(tmp_path))
    rec = tele.on_epoch(1)
    assert rec["device_memory"][str(cuda_device.index or 0)][
        "bytes_in_use"] >= held.numel()
    with open(tmp_path / METRICS_FILE) as f:
        assert "device_memory" in json.loads(f.readline())
    prom = (tmp_path / "metrics.prom").read_text()
    assert 'device_bytes_in_use{device="0"}' in prom
