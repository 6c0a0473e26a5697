"""The ``Stage`` container (port of ``parallel/pipeline.py:62-100``).

The GPipe ``Pipeline`` waits for the training slice; serving needs only
the stage list a model builder returns.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage.

    ``apply(params, x) -> y`` runs the stage on real activations: ``x``
    has per-sample shape ``in_shape`` (token ids for the first stage);
    the last stage returns log-probabilities. ``params`` is the stage's
    ``nn.Module`` parameter tree (``models/gpt.py::GPT``), whose
    ``state_dict`` keys are the JAX stage tree's paths. The JAX package's
    ``shards``/``expert_shards`` (tensor and expert parallelism) wait for
    the slices that port those axes.
    """
    apply: Callable[..., Any]
    params: Any
    in_shape: tuple[int, ...]
