"""Build a kernel source with ``nvcc`` into a shared library and load it.

The port's CUDA kernels have a plain C interface and are bound with
``ctypes`` (no PyTorch headers, so a build takes seconds). A library is
built at first use, from the sources in the checkout alone, into
``simple_distributed_machine_learning_tpu_torch/_build/`` (git-ignored),
named by a hash of its sources and flags: an unchanged source is built
once per checkout, and a changed one can never load a stale binary.

Nothing here runs at import: machines without ``nvcc`` (the CPU test
runs) import the package freely and fail only if they ask for a kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
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


def build(name: str, sources: list[str]) -> BuiltLibrary:
    """Compile ``sources`` (file names under ``ops/csrc``) into one shared
    library and load it. Raises with nvcc's output if the build fails."""
    paths = [CSRC / s for s in sources]
    digest = hashlib.sha256()
    for p in paths:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
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
