"""The JAX CLI's serving paths over several processes, in a child.

The JAX engine's per-tick ``kv_drift`` (``serve/engine.py``) imports
``analysis/programs.py``, which jax 0.9 cannot import (``abstractify``,
ROADMAP standing notes), so an unmodified JAX CLI dies at its first
metered tick. This script sets ``InferenceEngine.kv_drift`` to ``(0, 0)``
— as the port's parity tests patch it in-process — and then runs the JAX
CLI's ``main`` on its arguments, one process of a launch:

    JAX_PLATFORMS=cpu python tests/_jax_serve_ranks.py --rank 0 \\
        --world_size 2 --master_port P --model gpt --serve-sim 4

It runs only as a child process: the patch must never reach a pytest
worker, where a later JAX test file would serve through it.
"""

from __future__ import annotations

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("XLA_FLAGS", None)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from simple_distributed_machine_learning_tpu import cli  # noqa: E402
from simple_distributed_machine_learning_tpu.serve import (  # noqa: E402
    InferenceEngine,
)

InferenceEngine.kv_drift = lambda self: (0, 0)

if __name__ == "__main__":
    cli.main(sys.argv[1:])
