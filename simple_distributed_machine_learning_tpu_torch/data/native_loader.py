"""ctypes bindings for the native C++ data loader (port of
``data/native_loader.py``; the port keeps its own copy).

The library is the repo's ``native/data_loader.cpp`` (a plain C ABI: the
IDX codec and a background batch prefetcher), compiled with ``g++`` and
the flags of ``native/Makefile`` at first use into the git-ignored
``simple_distributed_machine_learning_tpu_torch/_build/``, named by a hash
of the source and the flags: an unchanged source is built once per
checkout, an edited one never loads a stale binary, and nothing is
written under ``native/``. A ``flock`` serialises concurrent builders and
the library is renamed into place whole, so no process loads a
half-written one. Nothing compiles at import.

Without a toolchain :func:`available` is False and ``data/mnist.py`` runs
its numpy paths, as the JAX package does — but never silently:
:func:`build_error` keeps the compiler's text, and two counters say what
the native code did (``idx_read_native.files``: IDX files parsed;
``NativePrefetcher.batches``: batches assembled).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG / "_build"
SOURCE = _PKG.parent / "native" / "data_loader.cpp"
# native/Makefile's CXXFLAGS, then its link line's -shared ... -lpthread
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

_lib = None    # None = not attempted; False = attempted and unavailable
_error: str | None = None


def library_path() -> Path:
    """Where the library built from :data:`SOURCE` lives: ``_build/``,
    named by the hash of the source and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsdml_data-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile :data:`SOURCE` unless this hash is built already; the
    library's path. Raises with the compiler's output on failure."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libsdml_data.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if out.exists():
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = ["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE), "-lpthread"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            os.unlink(tmp)
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL | None:
    global _lib, _error
    if _lib is not None:
        return _lib or None  # False (cached failure) -> None
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError) as e:
        _lib, _error = False, str(e)
        return None
    lib.idx_read.argtypes = [ctypes.c_char_p,
                             ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                             ctypes.POINTER(ctypes.c_int64),
                             ctypes.POINTER(ctypes.c_int)]
    lib.idx_read.restype = ctypes.c_int
    lib.idx_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.idx_free.restype = None
    lib.prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    lib.prefetcher_create.restype = ctypes.c_void_p
    lib.prefetcher_next.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.POINTER(ctypes.c_int32)]
    lib.prefetcher_next.restype = ctypes.c_int64
    lib.prefetcher_num_batches.argtypes = [ctypes.c_void_p]
    lib.prefetcher_num_batches.restype = ctypes.c_int64
    lib.prefetcher_destroy.argtypes = [ctypes.c_void_p]
    lib.prefetcher_destroy.restype = None
    _lib = lib
    return lib


def available() -> bool:
    """Whether the native library built and loaded (built at the first
    call of a process whose checkout has not built this source yet)."""
    return _load() is not None


def build_error() -> str | None:
    """The build's or the load's error text when :func:`available` is
    False; None otherwise."""
    _load()
    return _error


def idx_read_native(path: str) -> np.ndarray | None:
    """Parse an IDX file via the C++ codec. None if native lib unavailable.
    Images come back as float32 scaled by ``x * (1/255)``, labels as their
    raw values in float32."""
    lib = _load()
    if lib is None:
        return None
    data = ctypes.POINTER(ctypes.c_float)()
    dims = (ctypes.c_int64 * 4)()
    ndim = ctypes.c_int()
    rc = lib.idx_read(path.encode(), ctypes.byref(data), dims,
                      ctypes.byref(ndim))
    if rc != 0:
        raise IOError(f"idx_read({path!r}) failed with code {rc}")
    shape = tuple(dims[i] for i in range(ndim.value))
    n = int(np.prod(shape))
    out = np.ctypeslib.as_array(data, shape=(n,)).reshape(shape).copy()
    lib.idx_free(data)
    idx_read_native.files += 1
    return out


idx_read_native.files = 0


class NativePrefetcher:
    """Background-thread batch assembly over (x, y) arrays.

    Iterates ``(x_batch, y_batch, n_valid)`` in ``order``; the final ragged
    batch arrives zero-padded, mirroring ``mnist.batches(pad_last=True)``.
    The C++ thread reads ``self.x``, ``self.y`` and the order through raw
    pointers, so all three stay referenced here until :meth:`close`.
    ``NativePrefetcher.batches`` counts the batches handed out, over every
    instance.
    """

    batches = 0

    def __init__(self, x: np.ndarray, y: np.ndarray, batch: int,
                 order: np.ndarray | None = None, depth: int = 2):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_error}")
        self._lib = lib
        self._h = None
        self.x = np.ascontiguousarray(x, np.float32).reshape(len(x), -1)
        y2 = np.ascontiguousarray(y, np.int32)
        self.y = y2.reshape(len(y2), -1)
        self.batch = batch
        self.row_x = self.x.shape[1]
        self.row_y = self.y.shape[1]
        self._x_shape = x.shape[1:]
        self._y_shape = y.shape[1:]
        self._order = (np.arange(len(x), dtype=np.int64) if order is None
                       else np.ascontiguousarray(order, np.int64))
        if self._order.shape != (len(self.x),):
            raise ValueError(f"order must hold {len(self.x)} row indices, "
                             f"got shape {self._order.shape}")
        self._h = lib.prefetcher_create(
            self.x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.y.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(self.x), self.row_x, self.row_y, batch,
            self._order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            depth)
        self.n_batches = lib.prefetcher_num_batches(self._h)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
        bx = np.empty((self.batch, self.row_x), np.float32)
        by = np.empty((self.batch, self.row_y), np.int32)
        while self._h:
            n_valid = self._lib.prefetcher_next(
                self._h,
                bx.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                by.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if n_valid < 0:
                return
            NativePrefetcher.batches += 1
            yield (bx.reshape((self.batch,) + self._x_shape).copy(),
                   by.reshape((self.batch,) + self._y_shape).copy(),
                   int(n_valid))

    def close(self) -> None:
        if self._h:
            self._lib.prefetcher_destroy(self._h)
            self._h = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass
