"""Validated checkpoint retention: manifest + checksums, latest-VALID pick
(port of ``resilience/store.py``).

``train/checkpoint.py`` writes one atomic ``.npz`` per save; the Trainer
keeps exactly one (``state.npz``, overwritten per epoch). That is enough for
"resume after a clean stop" but not for elastic restart, where the newest
file may be the one the crash corrupted (torn filesystem, bad disk, a
checkpoint from the very write that killed the host). The store keeps a
short history of *numbered* checkpoints plus a JSONL manifest recording each
file's sha256, size and topology, so restore picks the newest checkpoint
that still *verifies* — a corrupt checkpoint is never selected, it is
skipped with a warning on stderr and the previous generation restores
instead.

Layout under ``dir`` (the JAX package's, so a store written by either
package restores in the other)::

    ckpt-00000042.npz            one atomic save per training epoch
    ckpt-00000042.npz.meta.json  human-readable sidecar (checkpoint.py's)
    MANIFEST.jsonl               appended per save; atomically rewritten on
                                 GC and when a re-saved step supersedes its
                                 own stale entry (one entry per file)

Manifest entries record ``extra`` verbatim — the elastic supervisor stores
``n_stages`` there, which is how a restore onto a *different* topology knows
which source layout to repack from. The port runs one process, so every
``save`` writes.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import Any

MANIFEST = "MANIFEST.jsonl"


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


class CheckpointStore:
    """Retained, checksum-validated checkpoints in one directory."""

    def __init__(self, dir: str, keep: int = 3) -> None:
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.dir = dir
        self.keep = keep
        os.makedirs(dir, exist_ok=True)

    # -- write side --------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.dir, MANIFEST)

    def save(self, params, opt_state, step: int, extra: dict | None = None
             ) -> str:
        """One retained checkpoint generation: atomic ``.npz`` write (via
        ``save_checkpoint``), checksum, manifest append, history GC.
        ``params`` is what ``save_checkpoint`` takes (the stage modules).
        Returns the path."""
        from simple_distributed_machine_learning_tpu_torch.train.checkpoint import (  # noqa: E501
            save_checkpoint,
        )
        path = os.path.join(self.dir, f"ckpt-{step:08d}.npz")
        save_checkpoint(path, params, opt_state, step, extra=extra)
        entry = {
            "file": os.path.basename(path),
            "step": int(step),
            "sha256": _sha256(path),
            "bytes": os.path.getsize(path),
            "extra": dict(extra or {}),
        }
        # drop any stale entry for the same FILE first (a restarted attempt
        # re-saving the same step overwrote it on disk): two entries naming
        # one file would let _gc unlink it out from under the live one
        stale = [e for e in self.entries() if e["file"] == entry["file"]]
        if stale:
            self._rewrite([e for e in self.entries()
                           if e["file"] != entry["file"]] + [entry])
        else:
            with open(self._manifest_path(), "a") as f:
                f.write(json.dumps(entry) + "\n")
        self._gc()
        return path

    def _rewrite(self, entries: list[dict]) -> None:
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            for e in entries:
                f.write(json.dumps(e) + "\n")
        os.replace(tmp, self._manifest_path())

    def _gc(self) -> None:
        """Drop generations beyond ``keep`` (oldest first): delete their
        files, then atomically rewrite the manifest without them. A crash
        between the two leaves dangling manifest entries — harmless, the
        validator skips entries whose file is gone."""
        entries = self.entries()
        if len(entries) <= self.keep:
            return
        dead, live = entries[:-self.keep], entries[-self.keep:]
        live_files = {e["file"] for e in live}
        for e in dead:
            if e["file"] in live_files:
                continue   # a live entry still references this file
            for suffix in ("", ".meta.json"):
                try:
                    os.unlink(os.path.join(self.dir, e["file"] + suffix))
                except OSError:
                    pass
        self._rewrite(live)

    # -- read side ---------------------------------------------------------

    def entries(self) -> list[dict]:
        """Manifest entries, oldest first. Unparseable lines (a crash mid-
        append tears at most the last one) are skipped, not fatal."""
        path = self._manifest_path()
        if not os.path.exists(path):
            return []
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                    if "file" in e and "sha256" in e:
                        out.append(e)
                except (json.JSONDecodeError, TypeError):
                    continue
        return out

    def validate(self, entry: dict) -> bool:
        """Does this entry's file still verify? Existence, size and sha256
        — content-level truncation/corruption detection, not just mtime."""
        path = os.path.join(self.dir, entry["file"])
        try:
            if os.path.getsize(path) != entry["bytes"]:
                return False
            return _sha256(path) == entry["sha256"]
        except OSError:
            return False

    def latest_valid(self) -> dict | None:
        """The newest entry whose checkpoint verifies (None if none do).
        Invalid generations are skipped with a stderr warning — a corrupt
        checkpoint is NEVER selected for restore, the previous valid one
        is."""
        for entry in reversed(self.entries()):
            if self.validate(entry):
                return {**entry, "path": os.path.join(self.dir,
                                                      entry["file"])}
            sys.stderr.write(
                f"[resilience] skipping corrupt/missing checkpoint "
                f"{os.path.join(self.dir, entry['file'])} (checksum or "
                f"size mismatch) — falling back to an earlier one\n")
        return None

    def restore_latest(self, pipe=None,
                       opt_treedef_like: Any = None) -> dict | None:
        """``restore_checkpoint`` of :meth:`latest_valid` onto ``pipe``
        (None when the store is empty); the returned dict gains the
        manifest ``entry``. A generation written at another stage count
        (its ``extra["n_stages"]``) is repacked from that many contiguous
        stages of the same model (``train/checkpoint.py::split_layout``)."""
        from simple_distributed_machine_learning_tpu_torch.train.checkpoint import (  # noqa: E501
            restore_checkpoint,
            split_layout,
        )
        entry = self.latest_valid()
        if entry is None:
            return None
        src_pipe = None
        if pipe is not None:
            src_n = int(entry["extra"].get("n_stages", len(pipe.metas)))
            if src_n != len(pipe.metas):
                src_pipe = split_layout(pipe, src_n)
        st = restore_checkpoint(entry["path"], pipe=pipe,
                                opt_treedef_like=opt_treedef_like,
                                src_pipe=src_pipe)
        st["entry"] = entry
        return st
