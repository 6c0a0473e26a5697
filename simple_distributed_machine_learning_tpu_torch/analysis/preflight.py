"""Preflight validators (port of ``analysis/preflight.py``'s pure half).

:func:`validate_tp_overlap` checks a tensor-parallel/overlap spec before
the model is built, so an invalid combination (a width that does not
divide the heads, a chunk count that does not divide the model axis)
exits with one clear message instead of a stack trace. Pure Python, the
JAX function's checks and texts word for word. The tracer half
(``lint_step``, ``lint_trainer``: the program linter over the exact
step a launch will run) is ROADMAP.md, Queue A, item 7.4.
"""

from __future__ import annotations


def validate_tp_overlap(tp: int, overlap: str, n_devices: int | None = None,
                        cfg=None, batch: int | None = None, n_micro: int = 1,
                        ) -> tuple[list[str], list[str]]:
    """Validate a tensor-parallel/overlap spec BEFORE building the model.

    Returns ``(errors, warnings)``: errors make the combo untraceable or
    wrong (exit with the message); warnings mean the ring schedule silently
    degrades to the monolithic collective (``ring_psum``'s divisibility
    fallback) — the run is correct but measures nothing new.

    ``cfg`` is a ``GPTConfig``-shaped object (``d_model``/``n_heads``/
    ``mlp_ratio``/``seq_len``/``attn_impl``/``n_experts`` attributes);
    ``batch``/``n_micro`` let the token-axis chunking of the scattered MLP
    (``matmul_reducescatter`` rows) be checked too.
    """
    errors: list[str] = []
    warnings: list[str] = []
    if tp < 1:
        errors.append(f"--tp must be >= 1, got {tp}")
        return errors, warnings
    if overlap not in ("none", "ring", None):
        errors.append(f"--overlap must be none|ring, got {overlap!r}")
    if overlap == "ring" and tp < 2:
        errors.append("--overlap ring needs --tp >= 2 (there is no "
                      "collective to schedule on an unsharded row)")
    if n_devices is not None and tp > n_devices:
        errors.append(f"--tp {tp} needs {tp} devices, have {n_devices}")
    if cfg is not None and tp > 1:
        heads = getattr(cfg, "n_heads", None)
        d_model = getattr(cfg, "d_model", None)
        ratio = getattr(cfg, "mlp_ratio", 4)
        if heads is not None and heads % tp:
            errors.append(
                f"--tp {tp} does not divide n_heads={heads}: attention "
                f"shards by head, so heads per shard must be integral")
        if d_model is not None and (ratio * d_model) % tp:
            errors.append(
                f"--tp {tp} does not divide the MLP hidden width "
                f"{ratio}*{d_model}={ratio * d_model}: the column-parallel "
                f"chunk count must divide the model axis")
        if getattr(cfg, "attn_impl", "dense") not in ("dense", None) and tp > 1:
            errors.append(
                f"--tp shards attention by head with dense local math; "
                f"attn={getattr(cfg, 'attn_impl', None)!r} is not "
                f"composable with it")
        if getattr(cfg, "n_experts", 0) and tp > 1:
            errors.append("--tp cannot combine with MoE experts (a stage is "
                          "tensor- OR expert-sharded, not both)")
        if overlap == "ring":
            if d_model is not None and d_model % tp:
                warnings.append(
                    f"ring overlap: d_model={d_model} not divisible by "
                    f"tp={tp} — the attention projection's ring_psum falls "
                    f"back to the monolithic psum (correct, no overlap)")
            seq_len = getattr(cfg, "seq_len", None)
            if batch is not None and seq_len is not None:
                tokens = (batch // max(1, n_micro)) * seq_len
                if tokens % tp:
                    warnings.append(
                        f"ring overlap: {tokens} tokens per microbatch not "
                        f"divisible by tp={tp} — the scattered MLP falls "
                        f"back to allgather + monolithic psum")
    return errors, warnings
