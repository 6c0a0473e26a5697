"""The port's native loader (``data/native_loader.py``: the repo's
``native/data_loader.cpp`` built into the port's ``_build/``) against the
JAX package's module, on the CPU, where ``g++`` exists.

The codec's arrays equal the JAX codec's bit for bit and sit within one
f32 ulp of numpy's ``x / 255``; the prefetcher's batches equal the JAX
prefetcher's and the port's Python ``batches`` bit for bit (custom order,
ragged tail, shuffle), so a Trainer fed either way has a bit-identical
trajectory. The fallback stays visible: a failed build keeps its error
text and the counters say what the native code did.
"""

import gzip
import re
import struct
import subprocess

import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu.data import mnist as jmnist
from simple_distributed_machine_learning_tpu.data import (
    native_loader as jnative,
)
from simple_distributed_machine_learning_tpu_torch.data import mnist as tmnist
from simple_distributed_machine_learning_tpu_torch.data import (
    native_loader as native,
)
from simple_distributed_machine_learning_tpu_torch.models import lenet
from simple_distributed_machine_learning_tpu_torch.parallel import Pipeline
from simple_distributed_machine_learning_tpu_torch.train import (
    TrainConfig,
    Trainer,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs: its models are
    tiny, and under a multi-process test run more threads only contend
    for the same cores. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_idx(path, arr_u8, gz=False):
    header = struct.pack(">I", 0x00000800 | arr_u8.ndim) + struct.pack(
        ">" + "I" * arr_u8.ndim, *arr_u8.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(header + arr_u8.astype(np.uint8).tobytes())


def test_available_here_and_built_into_the_port_not_native(tmp_path,
                                                          monkeypatch):
    assert native.available(), native.build_error()
    assert native.build_error() is None
    assert native.library_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build" and \
        native.BUILD_DIR.parent.name == \
        "simple_distributed_machine_learning_tpu_torch"
    # a fresh build (another build directory) writes nothing under native/
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert native.available() and native.library_path().exists()
    assert re.fullmatch(r"libsdml_data-[0-9a-f]{16}\.so",
                        native.library_path().name)
    root = native.SOURCE.parents[1]
    status = subprocess.run(["git", "status", "--porcelain", "native/"],
                            cwd=root, capture_output=True, text=True,
                            check=True).stdout
    assert status == ""


def test_a_failed_build_keeps_its_error_and_falls_back(tmp_path,
                                                       monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert not native.available()
    assert "g++ failed" in native.build_error()
    assert native.idx_read_native(str(bad)) is None
    with pytest.raises(RuntimeError, match="native loader unavailable"):
        native.NativePrefetcher(np.zeros((2, 3), np.float32),
                                np.zeros(2, np.int32), 1)
    ds = tmnist.Dataset(np.arange(12, dtype=np.float32).reshape(6, 2),
                        np.arange(6, dtype=np.int32))
    before = native.NativePrefetcher.batches
    got = list(tmnist.prefetch_batches(ds, 4, shuffle_seed=3))
    want = list(tmnist.batches(ds, 4, shuffle_seed=3))
    assert native.NativePrefetcher.batches == before   # numpy assembled
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.x, w.x)


@pytest.mark.parametrize("shape", [(5, 28, 28), (7,), (3, 4, 5, 6)])
def test_idx_codec_equals_the_jax_codec(tmp_path, shape):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, size=shape, dtype=np.uint8)
    path = str(tmp_path / "a-idx-ubyte")
    _write_idx(path, arr)
    files = native.idx_read_native.files
    ours = native.idx_read_native(path)
    assert native.idx_read_native.files == files + 1
    theirs = jnative.idx_read_native(path)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    if len(shape) == 1:                 # labels keep their raw values
        np.testing.assert_array_equal(ours, arr.astype(np.float32))
    else:
        np.testing.assert_array_max_ulp(
            ours, tmnist._read_idx(path).astype(np.float32) / 255.0,
            maxulp=1)
    with pytest.raises(IOError, match="failed with code -1"):
        native.idx_read_native(str(tmp_path / "missing"))


def _ds(n, feat=(4, 3), seed=1):
    rng = np.random.default_rng(seed)
    return tmnist.Dataset(rng.normal(size=(n,) + feat).astype(np.float32),
                          rng.integers(0, 10, size=n).astype(np.int32))


@pytest.mark.parametrize("n,batch,order", [
    (25, 10, None),                         # ragged tail: 5 valid rows
    (6, 3, [5, 4, 3, 2, 1, 0]),             # custom order
    (30, 10, None),                         # no tail
    (7, 8, [6, 0, 5, 1, 4, 2, 3]),          # one padded batch, out of order
])
def test_prefetcher_equals_the_jax_prefetcher(n, batch, order):
    ds = _ds(n)
    order = None if order is None else np.asarray(order)
    made = native.NativePrefetcher.batches
    pf = native.NativePrefetcher(ds.x, ds.y, batch, order=order, depth=3)
    ours = list(pf)
    pf.close()
    pf.close()                              # idempotent
    assert list(pf) == []                   # closed: nothing more
    jpf = jnative.NativePrefetcher(ds.x, ds.y, batch, order=order)
    theirs = list(jpf)
    jpf.close()
    assert len(ours) == len(theirs) == pf.n_batches == -(-n // batch)
    assert native.NativePrefetcher.batches == made + len(ours)
    idx = np.arange(n) if order is None else order
    for i, ((x, y, nv), (jx, jy, jnv)) in enumerate(zip(ours, theirs)):
        assert nv == jnv == min(batch, n - i * batch)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        rows = idx[i * batch:i * batch + nv]
        np.testing.assert_array_equal(x[:nv], ds.x[rows])
        np.testing.assert_array_equal(y[:nv], ds.y[rows])
        assert not x[nv:].any() and not y[nv:].any()   # zero-padded
    with pytest.raises(ValueError, match="row indices"):
        native.NativePrefetcher(ds.x, ds.y, batch, order=np.arange(n - 1))


@pytest.mark.parametrize("shuffle_seed", [None, 7, 3 * 100003 + 1])
def test_prefetch_batches_equal_python_batches_and_the_jax_ones(
        shuffle_seed):
    ds = tmnist.synthetic_mnist(130, 10, seed=2)[0]
    made = native.NativePrefetcher.batches
    ours = list(tmnist.prefetch_batches(ds, 60, shuffle_seed=shuffle_seed))
    assert native.NativePrefetcher.batches == made + 3
    want = list(tmnist.batches(ds, 60, shuffle_seed=shuffle_seed))
    theirs = list(jmnist.prefetch_batches(ds, 60, shuffle_seed=shuffle_seed))
    for a, b, c in zip(ours, want, theirs, strict=True):
        assert a.n_valid == b.n_valid == c.n_valid
        for got in (a, c):
            assert got.x.dtype == b.x.dtype and got.y.dtype == b.y.dtype
            np.testing.assert_array_equal(got.x, b.x)
            np.testing.assert_array_equal(got.y, b.y)


def test_trainer_trajectory_is_bit_identical_either_feed(monkeypatch,
                                                         capsys):
    """LeNet, 2 shuffled epochs with a ragged tail: the native feed and
    the Python feed give the same console and the same parameters."""
    train, test = tmnist.synthetic_mnist(n_train=150, n_test=30, seed=3)
    cfg = TrainConfig(epochs=2, batch_size=60, log_interval=1, shuffle=True,
                      seed=5, print_throughput=False)

    def run():
        stages, wd, od = lenet.make_lenet_stages(0, 1, device="cpu")
        t = Trainer(Pipeline(stages, None, wd, od, device="cpu"), train,
                    test, cfg)
        t.fit()
        return t, capsys.readouterr().out

    made = native.NativePrefetcher.batches
    fed, out = run()
    assert native.NativePrefetcher.batches == made + 6
    monkeypatch.setattr(native, "available", lambda: False)
    plain, plain_out = run()
    assert native.NativePrefetcher.batches == made + 6
    assert out == plain_out and out.count("Train Epoch") == 6
    for a, b in zip(fed.params[0].parameters(), plain.params[0].parameters(),
                    strict=True):
        assert torch.equal(a, b)
