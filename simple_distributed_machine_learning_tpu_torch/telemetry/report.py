"""The run-report CLI: one human summary from a telemetry directory.

Port of ``telemetry/report.py`` (stdlib-only in both packages; the port
keeps its own copy, block for block, so the two render the same
directory identically).

``python -m simple_distributed_machine_learning_tpu_torch.telemetry.report
--dir DIR`` renders everything a run left behind — ``metrics.jsonl``
(serve / scenario / epoch records), the request journal(s), the
request-scoped trace timeline(s) and any post-mortem bundles — as one
summary: per-class SLO attainment, the shed breakdown, the SLO alert
transition log (``kind: "slo_alert"`` records — the burn-rate state
machine's journal) and the per-scenario TTFT attribution block with its
top-K slow-request autopsy table, the restart
timeline (journal ``restart`` events with their monotonic ticks), TTFT /
TPOT quantiles, KV-drift, the multi-tenant adapter block (bank residency
bytes, swaps, adapter-affinity routing hits, per-tenant completions and
the per-journal tenant split), the disaggregated-pool block (per-role replica/
queue/slot gauges plus the host offload tier's demote/promote/prefetch
counters and the per-journal snap-cause split), the training-resilience
block (the self-healing sentinel's anomaly/rollback/quarantine counters
and per-event timeline from the epoch records), and the bundle inventory. ``--json`` emits the
same content as one machine-readable object.

This module is deliberately stdlib-only (``json``/``os``/``glob``/
``argparse``) — the artifacts are plain JSONL and parsing them is the
whole job; no device, registry or engine state is touched. (Running it
via ``python -m`` still executes the package ``__init__``, which imports
torch — import :func:`collect`/:func:`render` directly for a torch-free
consumer.) Blocks of optional features (the host tier, adapters, the
training sentinel, and KV drift, which the port records only once the
analyzer is ported) render from their records when a directory holds
them and are otherwise absent. Exit codes: 0 on success, 2 when the directory is missing or
holds nothing reportable.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def _read_jsonl(path: str) -> list[dict]:
    """Valid JSON-object lines of ``path`` (torn/corrupt lines skipped —
    a report renders what survived, it does not police durability)."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out


def _fmt(v, nd: int = 3):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{round(v, nd):g}"
    return str(v)


def collect(outdir: str) -> dict:
    """Gather every artifact in ``outdir`` into one report dict — the
    single source both renderers (text and ``--json``) consume."""
    metrics = _read_jsonl(os.path.join(outdir, "metrics.jsonl"))
    serve = [r for r in metrics if r.get("kind") == "serve"]
    scenarios = [r for r in metrics if r.get("kind") == "scenario"]
    epochs = [r for r in metrics if r.get("kind") == "epoch"]
    # SLO alert transitions (one joinable row each, telemetry/alerts.py)
    # and the per-scenario TTFT attribution blocks (telemetry/
    # attribution.py) — both land in metrics.jsonl via run_scenario
    slo_alerts = [r for r in metrics if r.get("kind") == "slo_alert"]
    attribution = {r.get("scenario"): r["attribution"]
                   for r in scenarios if r.get("attribution")}

    journals = {}
    for path in sorted(glob.glob(os.path.join(outdir, "journal*.jsonl"))):
        events = _read_jsonl(path)
        counts: dict[str, int] = {}
        snap_why: dict[str, int] = {}
        adapters: dict[str, int] = {}
        for ev in events:
            counts[ev.get("ev", "?")] = counts.get(ev.get("ev", "?"), 0) + 1
            if ev.get("ev") == "snap":
                # migration cause ("failure" vs "handoff"); reason-less
                # snaps predate the field and count as "-"
                why = ev.get("why") or "-"
                snap_why[why] = snap_why.get(why, 0) + 1
            if ev.get("ev") == "submit" and ev.get("adp"):
                # tenant split: the adp field is absent for base-model
                # requests and in pre-adapter journals
                adapters[ev["adp"]] = adapters.get(ev["adp"], 0) + 1
        journals[os.path.basename(path)] = {
            "events": len(events),
            "by_kind": dict(sorted(counts.items())),
            "snap_why": dict(sorted(snap_why.items())),
            "adapters": dict(sorted(adapters.items())),
            "restarts": [
                {"n": ev.get("n"), "cause": ev.get("cause"),
                 "degraded": ev.get("degraded"), "tick": ev.get("tick")}
                for ev in events if ev.get("ev") == "restart"],
        }

    timelines = {}
    for path in sorted(glob.glob(
            os.path.join(outdir, "request_timeline*.jsonl"))):
        rows = _read_jsonl(path)
        timelines[os.path.basename(path)] = {
            "events": len(rows),
            "requests": len({r.get("rid") for r in rows
                             if r.get("rid") is not None}),
            "incarnations": len({r.get("inc", 0) for r in rows}),
        }

    traces = {}
    for path in sorted(glob.glob(os.path.join(outdir, "serve_trace*.json"))):
        try:
            with open(path) as f:
                doc = json.load(f)
            traces[os.path.basename(path)] = {
                "events": len(doc.get("traceEvents", []))}
        except (OSError, json.JSONDecodeError):
            traces[os.path.basename(path)] = {"events": None,
                                              "error": "unparseable"}

    bundles = []
    for path in sorted(glob.glob(os.path.join(outdir, "postmortem-*.json"))):
        try:
            with open(path) as f:
                b = json.load(f)
            bundles.append({
                "file": os.path.basename(path),
                "trigger": b.get("trigger"), "cause": b.get("cause"),
                "tick": b.get("tick"), "restarts": b.get("restarts"),
                "flight_rows": len(b.get("flight", [])),
                "requests": len(b.get("requests", [])),
            })
        except (OSError, json.JSONDecodeError):
            bundles.append({"file": os.path.basename(path),
                            "error": "unparseable"})

    # the training-resilience block (self-healing sentinel): counters are
    # cumulative WITHIN one process but reset when the run restarts
    # (graceful-preempt resume, a supervisor restart) — so totals are
    # summed across process generations (a counter DROPPING marks a new
    # generation), not read off the newest record, or a resumed clean run
    # would report "0 anomalies" above a non-empty anomaly timeline.
    sent_recs = [r for r in epochs if r.get("rollbacks") is not None]
    sentinel = None
    if sent_recs:
        generations: list[list[dict]] = [[]]
        prev = -1
        for r in sent_recs:
            v = r.get("anomalies", 0) or 0
            if generations[-1]:
                # primary boundary signal: the per-sentinel run id each
                # record carries; fallback for id-less records is a counter
                # DROP (which misses a resumed run that re-accumulates past
                # the previous generation before its first record — hence
                # the id)
                pk = generations[-1][-1].get("sentinel_run")
                key = r.get("sentinel_run")
                if (key != pk) if (key is not None or pk is not None) \
                        else v < prev:
                    generations.append([])
            generations[-1].append(r)
            prev = v

        def total(key):
            return sum(g[-1].get(key, 0) or 0 for g in generations)

        by_kind: dict[str, int] = {}
        for g in generations:
            for kind, n in (g[-1].get("by_kind") or {}).items():
                by_kind[kind] = by_kind.get(kind, 0) + int(n)
        # quarantine totals: a PERSISTENT journal (on disk next to the
        # checkpoints) carries the previous generation's count forward on
        # reload, so consecutive persistent generations dedup against the
        # predecessor's last value; an in-memory generation restarted from
        # zero contributes its whole count
        quarantined = 0
        prev_last = 0
        prev_persistent = False
        for g in generations:
            last = g[-1].get("quarantined_batches", 0) or 0
            persistent = bool(g[-1].get("quarantine_persistent"))
            carried = prev_last if (persistent and prev_persistent) else 0
            quarantined += max(0, last - carried)
            prev_last, prev_persistent = last, persistent
        sentinel = {
            "anomalies": total("anomalies"),
            "by_kind": by_kind,
            "rollbacks": total("rollbacks"),
            "quarantined_batches": quarantined,
            "snapshot_ring_bytes": sent_recs[-1].get(
                "snapshot_ring_bytes", 0),
            "events": [e for r in sent_recs
                       for e in (r.get("anomaly_events") or [])],
        }

    return {
        "dir": outdir,
        "serve": serve[-1] if serve else None,
        "scenarios": scenarios,
        "slo_alerts": slo_alerts,
        "attribution": attribution,
        "epochs": len(epochs),
        "last_epoch": epochs[-1] if epochs else None,
        "sentinel": sentinel,
        "journals": journals,
        "timelines": timelines,
        "traces": traces,
        "postmortems": bundles,
    }


def render(report: dict) -> str:
    """The human rendering of :func:`collect`'s output."""
    lines = [f"run report: {report['dir']}"]
    s = report["serve"]
    if s:
        lines.append(
            f"  serve: {s.get('requests_submitted', 0)} submitted, "
            f"{s.get('requests_completed', 0)} completed, "
            f"{s.get('tokens_generated', 0)} tokens "
            f"({_fmt(s.get('tokens_per_sec'))} tok/s)")
        lines.append(
            f"  latency: ttft p50/p95 {_fmt(s.get('ttft_ms_p50'))}/"
            f"{_fmt(s.get('ttft_ms_p95'))} ms, tpot p50/p95 "
            f"{_fmt(s.get('tpot_ms_p50'))}/{_fmt(s.get('tpot_ms_p95'))} ms, "
            f"occupancy {_fmt(s.get('slot_occupancy_mean'))}")
        if "restarts" in s:
            lines.append(
                f"  resilience: {s['restarts']} restart(s), "
                f"{s.get('recovered_requests', 0)} recovered, "
                f"{s.get('shed_total', 0)} shed {s.get('shed_by_reason', {})}"
                f", degraded={s.get('degraded', 0)}")
        if "fleet_replicas" in s:
            lines.append(
                f"  fleet: {s['fleet_replicas']} replica(s) in rotation, "
                f"{s.get('fleet_replica_losses', 0)} loss(es), "
                f"{s.get('fleet_migrations', 0)} migration(s), "
                f"{s.get('route_affinity_hits', 0)} affinity hit(s), "
                f"{s.get('fleet_scale_outs', 0)} scale-out(s), "
                f"{s.get('fleet_retired', 0)} retired, "
                f"{s.get('fleet_handoffs', 0)} handoff(s)")
        for pool, blk in sorted((s.get("pools") or {}).items()):
            lines.append(
                f"  pool {pool}: {blk.get('replicas', 0)} replica(s), "
                f"queue depth {blk.get('queue_depth', 0)}, "
                f"{blk.get('slots_active', 0)} slot(s) active")
        if "host_blocks" in s:
            lines.append(
                f"  host tier: {s['host_blocks']} block(s) resident "
                f"({s.get('host_bytes_resident', 0)} bytes), "
                f"{s.get('host_inflight_blocks', 0)} in flight, "
                f"{s.get('host_demotes', 0)} demote(s), "
                f"{s.get('host_promotes', 0)} promote(s), "
                f"{s.get('host_evictions', 0)} eviction(s), prefetch "
                f"{s.get('host_prefetch_hits', 0)} hit(s)/"
                f"{s.get('host_prefetch_misses', 0)} miss(es), "
                f"{s.get('host_transfer_bytes', 0)} bytes transferred")
        if "kv_drift_bytes" in s:
            ok = "OK" if s["kv_drift_bytes"] == 0 else "NONZERO"
            lines.append(
                f"  kv drift: live-vs-model {s['kv_drift_bytes']} bytes "
                f"[{ok}] (predicted {s.get('kv_bytes_predicted')}, "
                f"resident {s.get('kv_bytes_resident', 'n/a')})")
        if "adapter_resident_bytes" in s:
            lines.append(
                f"  adapters: {s['adapter_resident_bytes']} bytes "
                f"resident (bank), {s.get('adapter_swaps', 0)} swap(s), "
                f"{s.get('route_adapter_affinity_hits', 0)} "
                f"adapter-affinity hit(s)")
            for tenant, n in sorted(
                    (s.get("per_adapter_completed") or {}).items()):
                lines.append(f"    tenant {tenant}: {n} completed")
        for cls, blk in sorted((s.get("per_class") or {}).items()):
            lines.append(
                f"  class {cls}: {blk.get('completed', 0)} completed, "
                f"{blk.get('shed', 0)} shed, ttft p95 "
                f"{_fmt(blk.get('ttft_ms_p95'))} ms, tpot p95 "
                f"{_fmt(blk.get('tpot_ms_p95'))} ms")
    for scen in report["scenarios"]:
        verdict = "PASS" if scen.get("slo_ok") else "FAIL"
        lines.append(
            f"  scenario {scen.get('scenario')} [{verdict}]: "
            f"{scen.get('completed')}/{scen.get('n_requests')} completed, "
            f"{scen.get('shed', 0)} shed"
            + (f", {scen['restarts']} restart(s)"
               if "restarts" in scen else ""))
        fl = scen.get("fleet")
        if fl:
            split = (f" = {fl['prefill_replicas']} prefill + "
                     f"{fl.get('replicas', 0) - fl['prefill_replicas']} "
                     f"decode" if fl.get("prefill_replicas") else "")
            lines.append(
                f"    fleet: {fl.get('replicas')} replica(s){split} "
                f"(route {fl.get('route')}), "
                f"{fl.get('replica_losses', 0)} loss(es), "
                f"{fl.get('migrations', 0)} migration(s), "
                f"{fl.get('affinity_hits', 0)} affinity hit(s), "
                f"{fl.get('scale_outs', 0)} scale-out(s), "
                f"{fl.get('retired', 0)} retired"
                + (f", {fl['handoffs']} handoff(s)"
                   if "handoffs" in fl else ""))
        ht = scen.get("host_tier")
        if ht:
            lines.append(
                f"    host tier: {ht.get('host_cache_blocks')} block "
                f"capacity, {ht.get('demotes', 0)} demote(s), "
                f"{ht.get('promotes', 0)} promote(s), "
                f"{ht.get('host_evictions', 0)} eviction(s), prefetch "
                f"{ht.get('prefetch_hits', 0)} hit(s)/"
                f"{ht.get('prefetch_misses', 0)} miss(es), "
                f"{ht.get('transfer_bytes', 0)} bytes transferred")
        for cls, att in sorted((scen.get("slo") or {}).items()):
            gates = [f"{k.split('_')[0]} {_fmt(att[k])}"
                     for k in ("ttft_attainment", "tpot_attainment")
                     if k in att]
            lines.append(f"    {cls}: attainment {', '.join(gates)} "
                         f"[{'ok' if att.get('ok') else 'MISS'}]")
    for rec in report.get("slo_alerts") or []:
        lines.append(
            f"  alert {rec.get('alert')}: {rec.get('from')} -> "
            f"{rec.get('to')} @tick {rec.get('tick')} (burn fast/slow "
            f"{_fmt(rec.get('burn_fast'))}/{_fmt(rec.get('burn_slow'))})"
            + (f" [{rec['scenario']}]" if rec.get("scenario") else ""))
    for scen_name, att in sorted((report.get("attribution") or {}).items()):
        lines.append(
            f"  attribution [{scen_name}]: {att.get('requests', 0)} "
            f"request(s) folded, {att.get('recovered', 0)} recovered, "
            f"max drift {_fmt(att.get('max_abs_drift_ms'), 6)} ms")
        for cls, blk in sorted((att.get("by_class") or {}).items()):
            comps = ", ".join(
                f"{c} {_fmt(v)}" for c, v in
                (blk.get("components_ms_mean") or {}).items())
            lines.append(
                f"    class {cls}: mean ttft "
                f"{_fmt(blk.get('ttft_ms_mean'))} ms = {comps}")
        top = att.get("top_slow") or []
        if top:
            lines.append("    top slow requests (TTFT autopsy):")
            lines.append(f"      {'rid':>5}  {'class':<12} "
                         f"{'ttft_ms':>9}  components")
            for a in top:
                comps = " ".join(
                    f"{c}={_fmt(v)}" for c, v in
                    (a.get("components_ms") or {}).items())
                lines.append(
                    f"      {a.get('rid'):>5}  {str(a.get('cls')):<12} "
                    f"{_fmt(a.get('ttft_ms')):>9}  {comps}"
                    + (" [recovered]" if a.get("recovered") else ""))
    for name, j in report["journals"].items():
        lines.append(f"  journal {name}: {j['events']} events "
                     f"{j['by_kind']}")
        why = {k: v for k, v in (j.get("snap_why") or {}).items()
               if k != "-"}
        if why:
            lines.append(f"    snap cause: {why}")
        if j.get("adapters"):
            lines.append(f"    tenants: {j['adapters']}")
        for r in j["restarts"]:
            lines.append(
                f"    restart #{r['n']} @tick {_fmt(r['tick'])} "
                f"cause {r['cause']} degraded={r['degraded']}")
    for name, t in report["timelines"].items():
        lines.append(f"  timeline {name}: {t['events']} events over "
                     f"{t['requests']} request(s), "
                     f"{t['incarnations']} incarnation(s)")
    for name, t in report["traces"].items():
        lines.append(f"  trace {name}: {_fmt(t.get('events'))} Chrome "
                     f"events" + (" [UNPARSEABLE]" if t.get("error")
                                  else ""))
    for b in report["postmortems"]:
        if b.get("error"):
            lines.append(f"  postmortem {b['file']}: UNPARSEABLE")
        else:
            lines.append(
                f"  postmortem {b['file']}: {b['trigger']} @tick "
                f"{_fmt(b['tick'])} ({b['cause']}), "
                f"{b['flight_rows']} flight rows, "
                f"{b['requests']} request states")
    if report["epochs"]:
        le = report["last_epoch"]
        lines.append(
            f"  training: {report['epochs']} epoch record(s), last: "
            f"step p50 {_fmt(le.get('step_time_ms_p50'))} ms"
            + (f", bubble model {_fmt(le.get('bubble_fraction'))}"
               if le.get("bubble_fraction") is not None else "")
            + (f" measured {_fmt(le.get('bubble_fraction_measured'))}"
               f" drift {_fmt(le.get('bubble_drift'))}"
               if le.get("bubble_drift") is not None else ""))
    sent = report.get("sentinel")
    if sent:
        ok = "OK" if sent["anomalies"] == sent["rollbacks"] == 0 else \
            "SELF-HEALED"
        lines.append(
            f"  self-healing: {sent['anomalies']} anomal"
            f"{'y' if sent['anomalies'] == 1 else 'ies'} {sent['by_kind']}"
            f", {sent['rollbacks']} rollback(s), "
            f"{sent['quarantined_batches']} quarantined batch(es), ring "
            f"{sent['snapshot_ring_bytes']} bytes [{ok}]")
        for e in sent["events"]:
            lines.append(
                f"    anomaly @step {e.get('step')} [{e.get('kind')}] "
                f"epoch {e.get('epoch')} batch {e.get('batch')} value "
                f"{_fmt(e.get('value'))} -> rollback + quarantine")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m simple_distributed_machine_learning_tpu_torch."
             "telemetry.report",
        description="Render one run summary from a telemetry directory "
                    "(metrics.jsonl + journal + trace + post-mortems).")
    ap.add_argument("--dir", required=True,
                    help="the run's --telemetry-dir")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as one JSON object instead of "
                         "the human rendering")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.dir):
        print(f"report: no such directory: {args.dir}", file=sys.stderr)
        return 2
    report = collect(args.dir)
    # "reportable" = ANY artifact family present — a crash can die before
    # metrics.jsonl exists while the trace/timeline/bundles (exactly the
    # forensic case) are already on disk
    if (report["serve"] is None and not report["scenarios"]
            and not report["epochs"] and not report["journals"]
            and not report["timelines"] and not report["traces"]
            and not report["postmortems"]):
        print(f"report: nothing reportable under {args.dir} "
              f"(no metrics.jsonl records, journals or traces)",
              file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(render(report))
    return 0


if __name__ == "__main__":                      # pragma: no cover - CLI
    sys.exit(main())
