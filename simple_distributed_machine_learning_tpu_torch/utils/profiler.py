"""Profiling hooks (port of ``utils/profiler.py``, on ``torch.profiler``).

Captures any training window as a Chrome trace (``chrome://tracing``,
Perfetto, TensorBoard's profiler plugin): host ops, and with a card the
CUDA kernels by their ``__global__`` names — the tool for seeing where a
step's device time goes, and whether the device idles between launches.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile

import torch


def _capturing() -> bool:
    """Whether a profiler session is live in this process (the autograd
    profiler's own flag, which every ``torch.profiler`` session sets)."""
    return bool(torch._C._autograd._profiler_enabled())


@contextlib.contextmanager
def trace(logdir: str | None = None, enabled: bool = True):
    """``with trace('/tmp/tb') as d: step(...)`` → a ``*.pt.trace.json``
    Chrome trace in ``d`` (``None``: ``sdml_trace`` under the temporary
    directory).

    Records CPU activity, and CUDA activity when a card is present. Yields
    the logdir (``None`` when no trace is being captured) so tooling can
    hand the path on. Hardened so the profiler can never take a run down
    or leak a started capture:

    - ``enabled=False`` touches nothing (no directory creation) and yields
      ``None``;
    - an uncreatable ``logdir`` degrades to disabled with a stderr note
      instead of raising — a full disk must not kill the training it was
      profiling;
    - a nested ``trace()`` (a capture already running) yields ``None`` and
      leaves the outer capture alone: a second ``torch.profiler`` session
      would tear the first one down;
    - stop runs once, only if start succeeded, and a stop failure is
      reported on stderr and swallowed, so the body's own exception — the
      one that matters — propagates.
    """
    if not enabled:
        yield None
        return
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "sdml_trace")
    try:
        os.makedirs(logdir, exist_ok=True)
    except OSError as e:
        print(f"profiler: cannot create trace dir {logdir!r} ({e}); "
              f"tracing disabled for this window", file=sys.stderr)
        yield None
        return
    if _capturing():
        print("profiler: a capture is already running; continuing under "
              "it untraced", file=sys.stderr)
        yield None
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(logdir))
    try:
        prof.start()
    except RuntimeError as e:
        print(f"profiler: start failed ({e}); continuing untraced",
              file=sys.stderr)
        yield None
        return
    try:
        yield logdir
    finally:
        # one stop, and only while the session is live: stopping a
        # torch.profiler session twice crashes the process
        if _capturing():
            try:
                prof.stop()
            except (RuntimeError, OSError) as e:
                print(f"profiler: stop failed ({e}); the trace in "
                      f"{logdir!r} may be incomplete", file=sys.stderr)


def annotate(name: str):
    """Named region on the trace timeline: the host interval of the Python
    block, and the ops it dispatches nest under it."""
    return torch.profiler.record_function(name)


def annotate_scope(name: str):
    """Named region for the ops of a block. PyTorch runs eagerly, so one
    ``record_function`` covers both what the JAX package splits into a
    host annotation and a ``named_scope`` inside a compiled program."""
    return torch.profiler.record_function(name)
