"""Memory telemetry: live-tensor byte totals and per-device memory stats
(port of ``telemetry/memory.py``; the record keys are the JAX package's).

Two complementary sources, both sampled per epoch (they walk every live
object / query the allocator — not per-step material):

- a ``gc`` walk over every ``torch.Tensor`` the process still references,
  each storage counted once (views and parameters that share a storage
  are one buffer) — the counterpart of the JAX walk over
  ``jax.live_arrays()``: the *program's* footprint (params, optimizer
  state, batches), on the card and on the CPU alike;
- ``torch.cuda.memory_stats(i)`` — the *caching allocator's* view
  (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_reserved``) per
  initialised card; without CUDA nothing, as XLA:CPU reports nothing —
  the number an OOM postmortem needs.
"""

from __future__ import annotations

import gc

import torch


def live_array_bytes() -> int:
    """Total bytes of the storages of every live ``torch.Tensor`` in the
    process, each storage counted once."""
    seen: set[tuple[str, int]] = set()
    total = 0
    for obj in gc.get_objects():
        # type(), not isinstance(): isinstance reads __class__, which some
        # deprecated module proxies answer with a warning
        if not issubclass(type(obj), torch.Tensor):
            continue
        try:
            storage = obj.untyped_storage()
            key = (str(storage.device), storage.data_ptr())
            if key[1] == 0 or key in seen:
                continue
            seen.add(key)
            total += int(storage.nbytes())
        except Exception:  # noqa: BLE001 - freed/meta/sparse tensors mid-walk
            continue
    return total


def device_memory_stats() -> dict[str, dict]:
    """``device index -> {bytes_in_use, peak_bytes_in_use, bytes_reserved}``
    from the caching allocator of every card this process initialised;
    ``{}`` without CUDA."""
    out: dict[str, dict] = {}
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if stats:
            out[str(i)] = {
                "bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                              0)),
                "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                                   0)),
                "bytes_reserved": int(stats.get("reserved_bytes.all.current",
                                                0)),
            }
    return out


def sample(registry=None) -> dict:
    """One memory sample: returns the epoch-record block and mirrors it into
    ``registry`` gauges (``live_array_bytes``; ``device_bytes_in_use`` and
    ``device_peak_bytes_in_use`` labeled per device) when one is given."""
    live = live_array_bytes()
    per_dev = device_memory_stats()
    if registry is not None:
        registry.gauge("live_array_bytes").set(live)
        for dev, stats in per_dev.items():
            for key, gname in (("bytes_in_use", "device_bytes_in_use"),
                               ("peak_bytes_in_use",
                                "device_peak_bytes_in_use")):
                if key in stats:
                    registry.gauge(gname, labels={"device": dev}) \
                        .set(stats[key])
    rec = {"live_array_bytes": live}
    if per_dev:
        rec["device_memory"] = per_dev
    return rec
