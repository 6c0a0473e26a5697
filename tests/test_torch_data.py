"""The port's data pipeline against the JAX package's: the same arrays, bit
for bit, from the same seeds and files (both are numpy code; the port keeps
its own copy)."""

import gzip
import struct

import numpy as np
import pytest

from simple_distributed_machine_learning_tpu.data import mnist as jmnist
from simple_distributed_machine_learning_tpu.data import text as jtext
from simple_distributed_machine_learning_tpu_torch.data import mnist as tmnist
from simple_distributed_machine_learning_tpu_torch.data import text as ttext
from simple_distributed_machine_learning_tpu_torch.utils.metrics import (
    Throughput,
)


def _same_dataset(a, b):
    assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_mnist_is_bit_equal(seed):
    for a, b in zip(tmnist.synthetic_mnist(130, 70, seed),
                    jmnist.synthetic_mnist(130, 70, seed)):
        _same_dataset(a, b)


def test_load_mnist_synthetic_fallback_is_the_reference_sizing():
    tr, te = tmnist.load_mnist("/nonexistent", subset_divisor=100)
    jtr, jte = jmnist.load_mnist("/nonexistent", subset_divisor=100)
    assert tr.x.shape == (600, 28, 28, 1) and te.x.shape == (100, 28, 28, 1)
    _same_dataset(tr, jtr)
    _same_dataset(te, jte)
    with pytest.raises(FileNotFoundError):
        tmnist.load_mnist("/nonexistent", synthetic_ok=False)


@pytest.mark.parametrize("shuffle_seed", [None, 7, 5 * 100003 + 2])
@pytest.mark.parametrize("batch_size", [60, 32])
def test_batches_order_padding_and_shuffle_are_equal(batch_size,
                                                     shuffle_seed):
    ds = tmnist.synthetic_mnist(150, 10, seed=1)[0]
    ours = list(tmnist.batches(ds, batch_size, shuffle_seed=shuffle_seed))
    ref = list(jmnist.batches(ds, batch_size, shuffle_seed=shuffle_seed))
    pre = list(tmnist.prefetch_batches(ds, batch_size,
                                       shuffle_seed=shuffle_seed))
    jpre = list(jmnist.prefetch_batches(ds, batch_size,
                                        shuffle_seed=shuffle_seed))
    assert len(ours) == len(ref) == len(pre) == len(jpre) \
        == -(-150 // batch_size)
    for a, b, c, d in zip(ours, ref, pre, jpre):
        assert a.n_valid == b.n_valid == c.n_valid == d.n_valid
        for got in (a, c, d):
            np.testing.assert_array_equal(got.x, b.x)
            np.testing.assert_array_equal(got.y, b.y)
    # the ragged tail is zero-padded to a full batch
    tail = ours[-1]
    assert len(tail.x) == batch_size and tail.n_valid == 150 % batch_size
    assert not tail.x[tail.n_valid:].any()
    # pad_last=False drops it instead
    assert len(list(tmnist.batches(ds, batch_size, pad_last=False))) \
        == 150 // batch_size


def _write_idx(path, arr, gz):
    header = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_idx_files_read_equally(tmp_path, gz, monkeypatch):
    """Both packages' numpy IDX parsers give the same arrays. Where the JAX
    package's native C++ codec is built (raw files only; the port has no
    native codec yet), it scales pixels by ``x * (1/255)`` in f32 where
    numpy divides by 255, so its pixels sit within one f32 ulp of these."""
    from simple_distributed_machine_learning_tpu.data import native_loader
    rng = np.random.default_rng(2)
    suffix = ".gz" if gz else ""
    sizes = {"train": 40, "t10k": 20}
    for split, n in sizes.items():
        _write_idx(tmp_path / f"{split}-images-idx3-ubyte{suffix}",
                   rng.integers(0, 256, (n, 28, 28)), gz)
        _write_idx(tmp_path / f"{split}-labels-idx1-ubyte{suffix}",
                   rng.integers(0, 10, (n,)), gz)
    path = str(tmp_path / f"train-images-idx3-ubyte{suffix}")
    np.testing.assert_array_equal(tmnist._read_idx(path),
                                  jmnist._read_idx(path))
    ours = tmnist.load_idx_mnist(str(tmp_path))
    native = jmnist.load_idx_mnist(str(tmp_path))
    with monkeypatch.context() as m:
        m.setattr(native_loader, "available", lambda: False)
        ref = jmnist.load_idx_mnist(str(tmp_path))
    for a, b, c in zip(ours, ref, native):
        _same_dataset(a, b)
        np.testing.assert_array_max_ulp(a.x, c.x, maxulp=1)
        np.testing.assert_array_equal(a.y, c.y)
    assert ours[0].x.shape == (40, 28, 28, 1) and ours[0].x.max() <= 1.0
    # load_mnist keeps the first tenth of each split, as the reference does
    tr, te = tmnist.load_mnist(str(tmp_path))
    assert len(tr.x) == 4 and len(te.x) == 2
    np.testing.assert_array_equal(tr.x, ours[0].x[:4])


def test_idx_files_under_mnist_raw_are_found(tmp_path):
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(3)
    for split, n in {"train": 10, "t10k": 10}.items():
        _write_idx(raw / f"{split}-images-idx3-ubyte",
                   rng.integers(0, 256, (n, 28, 28)), False)
        _write_idx(raw / f"{split}-labels-idx1-ubyte",
                   rng.integers(0, 10, (n,)), False)
    assert tmnist.load_idx_mnist(str(tmp_path)) is not None
    assert tmnist.load_idx_mnist(str(tmp_path / "MNIST")) is None


@pytest.mark.parametrize("seed", [0, 4])
def test_synthetic_tokens_are_bit_equal(seed):
    a = ttext.synthetic_tokens(12, 16, 32, seed=seed)
    b = jtext.synthetic_tokens(12, 16, 32, seed=seed)
    for got, ref in zip(a, b):
        assert got.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(a.x[:, 1:], a.y[:, :-1])


def test_byte_corpus_is_equal_and_holds_out_the_boundary(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_bytes(bytes(range(256)) * 3)
    ours = ttext.byte_corpus(str(path), 16)
    ref = jtext.byte_corpus(str(path), 16)
    for a, b in zip(ours, ref):
        for got, want in zip(a, b):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="max_seqs"):
        ttext.byte_corpus(str(path), 16, max_seqs=1)
    path.write_bytes(b"tiny")
    with pytest.raises(ValueError, match="held-out"):
        ttext.byte_corpus(str(path), 16)


def test_throughput_counts_samples_and_steps():
    meter = Throughput()
    meter.update(60)
    meter.update(40)
    assert meter._samples == 100 and meter._steps == 2
    assert meter.samples_per_sec > 0 and meter.steps_per_sec > 0
    meter.reset()
    assert meter._samples == 0 and meter.samples_per_sec == 0.0
