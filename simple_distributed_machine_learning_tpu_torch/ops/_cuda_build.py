"""Build a kernel source with ``nvcc`` into a shared library and load it.

The port's CUDA kernels have a plain C interface and are bound with
``ctypes`` (no PyTorch headers, so a build takes seconds). A library is
built at first use, from the sources in the checkout alone, into
``simple_distributed_machine_learning_tpu_torch/_build/`` (git-ignored),
named by a hash of its sources, the ``csrc`` headers they include
(``#include "x.cuh"``, followed through headers) and the flags: an
unchanged source is built once per checkout, and a changed source or
header can never load a stale binary.

Nothing here runs at import: machines without ``nvcc`` (the CPU test
runs) import the package freely and fail only if they ask for a kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG / "_build"
CSRC = Path(__file__).resolve().parent / "csrc"

# sm_90a, not sm_90: wgmma/setmaxnreg exist only for the "a" target, and
# later versions of these kernels will want them
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")


@dataclasses.dataclass
class BuiltLibrary:
    """A loaded kernel library and how it came to be."""
    lib: ctypes.CDLL
    path: Path
    build_s: float          # 0.0 when an earlier build of the same hash loaded
    log: str                # nvcc's output (``-Xptxas -v``: registers, smem)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels are built from source at first use")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _hashed_files(sources: list[str]) -> list[Path]:
    """``sources`` under ``ops/csrc``, then every ``csrc`` header they
    include, directly or through another header, each once."""
    files, todo = [], [CSRC / s for s in sources]
    while todo:
        p = todo.pop(0)
        if p in files:
            continue
        files.append(p)
        for inc in _INCLUDE.findall(p.read_bytes()):
            if (CSRC / inc.decode()).is_file():
                todo.append(CSRC / inc.decode())
    return files


def library_path(name: str, sources: list[str]) -> Path:
    """Where the library built from ``sources`` lives: ``_build/`` named
    by the hash of the sources, their headers and the flags."""
    digest = hashlib.sha256()
    for p in _hashed_files(sources):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str, sources: list[str]) -> BuiltLibrary:
    """Compile ``sources`` (file names under ``ops/csrc``) into one shared
    library and load it. Raises with nvcc's output if the build fails."""
    paths = [CSRC / s for s in sources]
    out = library_path(name, sources)
    log, build_s = "", 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name, then rename: a concurrent process
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, paths)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_s = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{name}:\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, out)
    return BuiltLibrary(ctypes.CDLL(str(out)), out, build_s, log)
