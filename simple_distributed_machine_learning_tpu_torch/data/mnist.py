"""MNIST data pipeline (port of ``data/mnist.py``): the reference's
dataset with a hermetic synthetic fallback.

The reference trains on MNIST train+test cut to 1/10 (6000 / 1000
samples), batch 60, no shuffle, pixels scaled to [0, 1]. The loader reads
standard IDX files from disk when present (``train-images-idx3-ubyte``
etc., optionally .gz) and otherwise generates a deterministic synthetic
10-class digit-like set of the same shapes from a numpy seed — the same
arrays, bit for bit, as the JAX package's ``synthetic_mnist``.

Layout is NHWC ``[N, 28, 28, 1]`` float32 in [0, 1]. Raw IDX files go
through the native C++ codec (``data/native_loader.py``, which scales by
``x * (1/255)`` in f32, within one ulp of numpy's ``x / 255``) and
:func:`prefetch_batches` assembles batches on the native prefetcher's
thread, as in the JAX package; without a toolchain both fall back to
numpy (``native_loader.build_error()`` says why).
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Iterator, NamedTuple

import numpy as np

IMG_SHAPE = (28, 28, 1)


class Dataset(NamedTuple):
    x: np.ndarray  # [N, 28, 28, 1] float32
    y: np.ndarray  # [N] int32


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find(root: str, stem: str) -> str | None:
    for name in (stem, stem + ".gz"):
        for sub in ("", "MNIST/raw"):
            p = os.path.join(root, sub, name)
            if os.path.exists(p):
                return p
    return None


def load_idx_mnist(root: str) -> tuple[Dataset, Dataset] | None:
    """Load real MNIST from IDX files under ``root``; None if absent.

    Non-gzip files go through the native C++ IDX codec
    (``native/data_loader.cpp``) when the toolchain is available — it returns
    images already normalized to [0, 1] float32 — with the pure-NumPy parser
    as fallback (and for .gz files, which the native codec does not decode).
    """
    from simple_distributed_machine_learning_tpu_torch.data import (
        native_loader,
    )

    paths = {k: _find(root, s) for k, s in {
        "train_x": "train-images-idx3-ubyte",
        "train_y": "train-labels-idx1-ubyte",
        "test_x": "t10k-images-idx3-ubyte",
        "test_y": "t10k-labels-idx1-ubyte",
    }.items()}
    if any(v is None for v in paths.values()):
        return None

    native_ok = native_loader.available()

    def imgs(p):
        if native_ok and not p.endswith(".gz"):
            return native_loader.idx_read_native(p)[..., None]
        return (_read_idx(p).astype(np.float32) / 255.0)[..., None]

    def labels(p):
        if native_ok and not p.endswith(".gz"):
            return native_loader.idx_read_native(p).astype(np.int32)
        return _read_idx(p).astype(np.int32)

    train = Dataset(imgs(paths["train_x"]), labels(paths["train_y"]))
    test = Dataset(imgs(paths["test_x"]), labels(paths["test_y"]))
    return train, test


def synthetic_mnist(n_train: int = 60000, n_test: int = 10000,
                    seed: int = 0) -> tuple[Dataset, Dataset]:
    """Deterministic MNIST-shaped 10-class task.

    Each class is a smooth random 28×28 prototype; samples are the prototype
    under small random shifts plus pixel noise, clipped to [0, 1]. Learnable
    by a conv net but not trivially linearly separable — adequate for loss
    curves, tests, and throughput benchmarks without network access.
    """
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(10, 32, 32)).astype(np.float32)
    # smooth prototypes: blur by box filter passes
    for _ in range(3):
        base = (base + np.roll(base, 1, 1) + np.roll(base, -1, 1)
                + np.roll(base, 1, 2) + np.roll(base, -1, 2)) / 5.0
    base = (base - base.min((1, 2), keepdims=True))
    base = base / base.max((1, 2), keepdims=True)

    def gen(n, rng):
        labels = (np.arange(n) % 10).astype(np.int32)  # balanced, fixed order
        dx = rng.integers(0, 5, size=n)
        dy = rng.integers(0, 5, size=n)
        imgs = np.empty((n, 28, 28), np.float32)
        for i in range(n):
            p = base[labels[i]]
            imgs[i] = p[dx[i]:dx[i] + 28, dy[i]:dy[i] + 28]
        imgs += rng.normal(scale=0.15, size=imgs.shape).astype(np.float32)
        np.clip(imgs, 0.0, 1.0, out=imgs)
        return Dataset(imgs[..., None], labels)

    return gen(n_train, rng), gen(n_test, rng)


def load_mnist(root: str = "data", subset_divisor: int = 10,
               synthetic_ok: bool = True) -> tuple[Dataset, Dataset]:
    """Reference-equivalent dataset: real MNIST if on disk, else synthetic;
    both splits cut to their first ``1/subset_divisor`` (reference ``:91-92``)."""
    loaded = load_idx_mnist(root)
    if loaded is None:
        if not synthetic_ok:
            raise FileNotFoundError(
                f"MNIST IDX files not found under {root!r} and synthetic "
                f"fallback disabled")
        # generate only the post-subset sizes (synthetic data has no
        # "real prefix" to preserve; generating 70k then slicing 10% away
        # would waste a 70k-iteration python loop and ~220 MB transients)
        loaded = synthetic_mnist(n_train=60000 // max(subset_divisor, 1),
                                 n_test=10000 // max(subset_divisor, 1))
        return loaded
    train, test = loaded
    if subset_divisor > 1:
        train = Dataset(train.x[: len(train.x) // subset_divisor],
                        train.y[: len(train.y) // subset_divisor])
        test = Dataset(test.x[: len(test.x) // subset_divisor],
                       test.y[: len(test.y) // subset_divisor])
    return train, test


class Batch(NamedTuple):
    x: np.ndarray
    y: np.ndarray
    n_valid: int  # <= len(x): trailing rows are padding


def batches(ds: Dataset, batch_size: int, pad_last: bool = True,
            shuffle_seed: int | None = None) -> Iterator[Batch]:
    """Batches in fixed order (the reference's default — no shuffle,
    ``:94-95``) or a seeded permutation (``shuffle_seed``: deterministic and
    reproducible per epoch, unlike the reference's implicit global RNG).

    The pipeline is a compiled static-shape program, so a ragged final batch
    (the reference's test set: 1000 = 16·60 + 40) is zero-padded to full size
    and carries ``n_valid`` for masked loss/accuracy accumulation.
    """
    n = len(ds.x)
    # mask into RandomState's 32-bit range: callers derive epoch seeds by
    # multiplication (trainer: seed * 100003 + epoch) which overflows it
    order = (np.random.RandomState(shuffle_seed % 2**32).permutation(n)
             if shuffle_seed is not None else None)
    for start in range(0, n, batch_size):
        idx = (order[start:start + batch_size] if order is not None
               else slice(start, start + batch_size))
        x = ds.x[idx]
        y = ds.y[idx]
        n_valid = len(x)
        if n_valid < batch_size:
            if not pad_last:
                return
            pad = batch_size - n_valid
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
            y = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)])
        yield Batch(x, y, n_valid)


def prefetch_batches(ds: Dataset, batch_size: int,
                     shuffle_seed: int | None = None) -> Iterator[Batch]:
    """Like :func:`batches` (pad_last semantics) but batch assembly runs on
    the native C++ prefetcher thread (``native/data_loader.cpp``) when the
    toolchain is available, overlapping gather/pad with the device step.
    Falls back to the pure-Python iterator otherwise.

    ``shuffle_seed``: seeded epoch shuffle. The permutation is handed to the
    native prefetcher as its gather order (it assembles batches by index on
    its own thread), so no shuffled copy of the dataset is ever
    materialized; the Python fallback (:func:`batches`) gathers per batch
    with the identical permutation RNG.
    """
    from simple_distributed_machine_learning_tpu_torch.data import (
        native_loader,
    )

    if not native_loader.available():
        yield from batches(ds, batch_size, pad_last=True,
                           shuffle_seed=shuffle_seed)
        return
    order = (np.random.RandomState(
                 shuffle_seed % 2**32).permutation(len(ds.x))
             if shuffle_seed is not None else None)
    pf = native_loader.NativePrefetcher(ds.x, ds.y, batch_size, order=order)
    try:
        for bx, by, n_valid in pf:
            yield Batch(bx, by.astype(ds.y.dtype, copy=False), n_valid)
    finally:
        pf.close()
