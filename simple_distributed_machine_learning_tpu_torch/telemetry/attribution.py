"""Per-request latency attribution: where did this request's TTFT go?

Port of ``telemetry/attribution.py`` (a module without JAX; the port keeps
its own copy, fold for fold, so both packages round the same sums).

``serve/tracing.py`` writes a per-request timeline (one JSONL row per
event, engine timestamps the serving layer already read); this module
folds each completed request's rows into an **additive** decomposition of
its latency — a cursor walk over the event boundaries where every elapsed
span is assigned to exactly one component, so the components sum to the
observed TTFT *by construction* (telescoping), and the fold asserts the
reconciliation against the ``first_token`` row's independently-computed
``ttft_ms`` (drift beyond float rounding raises :class:`AttributionError`
— a test failure, never a silently-wrong autopsy).

Span → component (by the event OPENING the span):

==================  =============  ========================================
previous event      component      the time is spent...
==================  =============  ========================================
``submit``          ``queue``      waiting for a slot
``gate``            ``prefetch``   blocked on an in-flight host->HBM upload
``admit``           ``prefill``    building K/V (incl. inter-chunk waits)
``prefill_chunk``   ``prefill``    (same span, later chunks)
``preempt``         ``preempt``    evicted, waiting to re-board + rebuild
``crash``           ``crash``      engine died; journal recovery + re-queue
``migrate``         ``handoff``    adopted across replicas (fleet handoff)
``readmit``         (cause's)      still the crash/handoff gap until board
``first_token`` /   ``decode``     decode-tick cadence (TPOT side)
``tick``/``resume``
==================  =============  ========================================

A recovered rid's rows span engine incarnations (``inc``); the fold joins
them — one attribution covers both lives, with ``crash`` holding the
crash+readmit gap. The TTFT side covers ``submit``→``first_token``; the
decode side (``first_token``→``done``) aggregates separately.

Registry instruments (when :func:`attribute` is given a ``registry``):

- ``serve_ttft_component_ms{component=...}`` (histogram) — one
  observation per attributed request per non-zero TTFT component: the
  fleet-wide answer to "is TTFT going to queueing or to prefill".
"""

from __future__ import annotations

import collections

#: |computed - journaled| TTFT tolerance (ms): timeline rows round ``t``
#: to 6 decimals and ``ttft_ms`` to 3, so honest folds drift < 0.0025 ms.
DRIFT_TOL_MS = 0.005

#: attribution components, render order (docs table + report autopsy).
COMPONENTS = ("queue", "prefetch", "prefill", "preempt", "crash",
              "handoff", "decode")

# event opening a span -> component the span's time belongs to, before
# the first token (readmit resolved dynamically from its cause).
_PRE_TTFT = {"submit": "queue", "gate": "prefetch", "admit": "prefill",
             "prefill_chunk": "prefill", "preempt": "preempt",
             "crash": "crash", "migrate": "handoff"}
# after the first token everything is decode cadence except interruptions.
_POST_TTFT = {"first_token": "decode", "tick": "decode", "resume": "decode",
              "preempt": "preempt", "admit": "preempt",
              "prefill_chunk": "preempt", "gate": "prefetch",
              "crash": "crash", "migrate": "handoff"}


class AttributionError(ValueError):
    """A fold whose components do not reconcile with the journaled TTFT
    — the timeline is corrupt or the component map missed an event."""


def fold_request(rows: list[dict]) -> dict | None:
    """Fold ONE rid's timeline rows (file order = chronological) into an
    attribution record, or None when the request never reached its first
    token (shed / still in flight — nothing to decompose)."""
    ft_row = next((r for r in rows if r["ev"] == "first_token"), None)
    if ft_row is None or ft_row.get("ttft_ms") is None:
        return None
    submit = next((r for r in rows if r["ev"] == "submit"), None)
    pre = collections.defaultdict(float)
    post = collections.defaultdict(float)
    cursor = comp = None
    seen_ft = False
    done_row = None
    incs = sorted({r["inc"] for r in rows})
    for row in rows:
        ev, t = row["ev"], row["t"]
        if ev == "restart":              # rid-less supervisor row; the
            continue                     # per-rid crash row marks the gap
        if cursor is not None and comp is not None:
            (post if seen_ft else pre)[comp] += (t - cursor) * 1e3
        if ev == "first_token":
            # the span ENDING here was still prefill; spans after it are
            # decode cadence — flip before the component lookup
            seen_ft = True
        if ev == "readmit":
            # still the crash/handoff gap until the request re-boards
            comp = comp if comp in ("crash", "handoff") else "queue"
        else:
            comp = (_POST_TTFT if seen_ft else _PRE_TTFT).get(ev, comp)
        cursor = t
        if ev in ("done", "shed"):
            done_row = row
            break
    ttft_ms = ft_row["ttft_ms"]
    total = sum(pre.values())
    drift = total - ttft_ms
    if abs(drift) > DRIFT_TOL_MS:
        raise AttributionError(
            f"rid {ft_row['rid']}: TTFT components sum to {total:.6f} ms "
            f"but the timeline journaled ttft_ms={ttft_ms} "
            f"(drift {drift:+.6f} ms > {DRIFT_TOL_MS}) — the attribution "
            f"fold and the engine's own TTFT no longer agree")
    components = {c: round(pre[c], 3) for c in COMPONENTS if pre.get(c)}
    out = {
        "rid": ft_row["rid"],
        "cls": submit.get("cls") if submit is not None else None,
        "prompt_len": (submit.get("prompt_len")
                       if submit is not None else None),
        "ttft_ms": ttft_ms,
        "components_ms": components,
        "drift_ms": round(drift, 6),
        "incarnations": incs,
        "recovered": len(incs) > 1,
    }
    if done_row is not None and seen_ft:
        out["decode_ms"] = round(sum(post.values()), 3)
        out["decode_components_ms"] = {
            c: round(post[c], 3) for c in COMPONENTS if post.get(c)}
        out["tokens"] = done_row.get("tokens")
        out["finish"] = done_row.get("reason")
    return out


def attribute(rows: list[dict], *, top_k: int = 5,
              registry=None) -> dict:
    """Fold a whole timeline (all rids) and aggregate per class.

    Returns the deterministic ``attribution`` block ``run_scenario``
    lands in the scenario record: per-class component means, the top-K
    slow-request autopsy list (sorted by TTFT desc, rid asc — the table
    ``telemetry.report`` renders), and the worst reconciliation drift
    seen (pinned ≤ :data:`DRIFT_TOL_MS` by the fold itself)."""
    by_rid: dict = collections.OrderedDict()
    for row in rows:
        rid = row.get("rid")
        if rid is None:
            continue
        by_rid.setdefault(rid, []).append(row)
    atts = []
    for rid_rows in by_rid.values():
        att = fold_request(rid_rows)
        if att is not None:
            atts.append(att)
    by_class: dict = {}
    for att in atts:
        cls = att["cls"] or "none"
        agg = by_class.setdefault(
            cls, {"n": 0, "ttft_ms_sum": 0.0,
                  "components": collections.defaultdict(float)})
        agg["n"] += 1
        agg["ttft_ms_sum"] += att["ttft_ms"]
        for c, ms in att["components_ms"].items():
            agg["components"][c] += ms
    classes = {
        cls: {
            "n": agg["n"],
            "ttft_ms_mean": round(agg["ttft_ms_sum"] / agg["n"], 3),
            "components_ms_mean": {
                c: round(agg["components"][c] / agg["n"], 3)
                for c in COMPONENTS if agg["components"].get(c)},
        }
        for cls, agg in sorted(by_class.items())
    }
    top = sorted(atts, key=lambda a: (-a["ttft_ms"], a["rid"]))[:top_k]
    if registry is not None:
        hists = {}
        for att in atts:
            for c, ms in sorted(att["components_ms"].items()):
                h = hists.get(c)
                if h is None:
                    h = hists[c] = registry.histogram(
                        "serve_ttft_component_ms",
                        labels={"component": c})
                h.observe(ms)
    return {
        "requests": len(atts),
        "recovered": sum(1 for a in atts if a["recovered"]),
        "by_class": classes,
        "top_slow": top,
        "max_abs_drift_ms": round(
            max((abs(a["drift_ms"]) for a in atts), default=0.0), 6),
    }
