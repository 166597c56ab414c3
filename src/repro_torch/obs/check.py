"""Trace-derived invariant checks: `python -m repro_torch.obs.check`.

Port of `repro.obs.check`.

The observability plane is only trustworthy if it can be cross-examined.
These checks replay nothing -- they audit the *artifacts* (trace JSONL,
metrics JSON, audit JSONL) against invariants the simulators are
supposed to guarantee:

1. **Latency decomposition** -- every trace record's spans tile
   ``[arrival, complete]`` contiguously and their durations sum to the
   end-to-end latency within float tolerance.
2. **Gate consistency** -- a record is on-device iff its timeline has no
   uplink/cloud spans, and (confidence criterion) the recorded verdict
   matches ``confidence >= p_tar``.
3. **Conservation** -- requests are conserved across churn/shedding:
   completed == expected, the live per-cell counters sum to the same
   total, and the offload counters match what telemetry stored.
4. **Trace accounting** -- the sink saw exactly as many records as the
   emitters counted (and, when unsampled, as many as the counters say
   completed, with the offloaded records' `payload_nbytes` summing to
   the uplink byte counters).
5. **Audit causality** (optional) -- a canary rollback is reconstructible
   from the audit log alone: canary start -> QoS trip on a canary cell
   with over-cap (or, for floor SLOs like coverage, under-floor)
   evidence -> rollback restoring the incumbent version.
6. **Calibration sketch** (optional, ``--calibration``) -- the
   reliability sketch's gated+ungated totals equal the request
   counters, and on an unsampled trace the merged sketch reproduces
   `repro_torch.core.metrics.ece` from the raw gate confidences.

Each check returns a list of human-readable error strings; the CLI
prints a summary and exits non-zero if any check fails. CI runs this
against the artifacts `benchmarks/run.py --emit-obs` writes.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

from .metrics import MetricsRegistry
from .trace import read_jsonl


def _tol(latency_s: float, rel: float) -> float:
    return rel * max(1.0, abs(latency_s)) + 1e-9


def check_span_telescoping(records: Sequence[Dict],
                           rel_tol: float = 1e-6) -> List[str]:
    """Spans tile [arrival, complete]; durations sum to latency."""
    errors = []
    for r in records:
        if r.get("kind") != "request":
            continue
        rid, spans = r.get("req_id"), r.get("spans") or []
        tol = _tol(r["latency_s"], rel_tol)
        if not spans:
            errors.append(f"req {rid}: no spans")
            continue
        if abs(spans[0]["start_s"] - r["arrival_s"]) > tol:
            errors.append(f"req {rid}: first span starts at "
                          f"{spans[0]['start_s']}, arrival {r['arrival_s']}")
        if abs(spans[-1]["end_s"] - r["complete_s"]) > tol:
            errors.append(f"req {rid}: last span ends at "
                          f"{spans[-1]['end_s']}, complete {r['complete_s']}")
        for a, b in zip(spans, spans[1:]):
            if abs(a["end_s"] - b["start_s"]) > tol:
                errors.append(f"req {rid}: gap between {a['name']} and "
                              f"{b['name']}: {a['end_s']} != {b['start_s']}")
        total = 0.0
        for s in spans:
            d = s["end_s"] - s["start_s"]
            if d < -tol:
                errors.append(f"req {rid}: span {s['name']} has negative "
                              f"duration {d}")
            total += d
        if abs(total - r["latency_s"]) > tol:
            errors.append(f"req {rid}: span durations sum to {total}, "
                          f"latency is {r['latency_s']}")
    return errors


def check_gate_consistency(records: Sequence[Dict],
                           conf_tol: float = 1e-6) -> List[str]:
    """Trace gate verdict agrees with the timeline and the threshold."""
    errors = []
    for r in records:
        if r.get("kind") != "request":
            continue
        rid = r.get("req_id")
        names = {s["name"] for s in r.get("spans") or []}
        offloaded_spans = bool(names & {"uplink", "cloud"})
        if r["on_device"] == offloaded_spans:
            errors.append(f"req {rid}: on_device={r['on_device']} but spans "
                          f"{'include' if offloaded_spans else 'lack'} "
                          "uplink/cloud")
        gate = r.get("gate")
        if not gate or gate.get("confidence") is None:
            continue
        if gate.get("criterion") not in (None, "confidence"):
            continue
        conf, p_tar = float(gate["confidence"]), float(gate["p_tar"])
        # tolerance: the fleet gate compares in float32; exact-boundary
        # verdicts may legitimately differ from the float64 replay
        if r["on_device"] and conf < p_tar - conf_tol:
            errors.append(f"req {rid}: on-device but confidence {conf} < "
                          f"p_tar {p_tar}")
        if not r["on_device"] and conf >= p_tar + conf_tol:
            errors.append(f"req {rid}: offloaded but confidence {conf} >= "
                          f"p_tar {p_tar}")
    return errors


def check_conservation(metrics: MetricsRegistry) -> List[str]:
    """Requests conserved across churn/shedding; offload counters match
    what telemetry stored. Applies to whichever stacks (serving/fleet)
    published their gauges into this registry."""
    errors = []
    expected = metrics.gauge_value("fleet_requests_expected")
    completed = metrics.gauge_value("fleet_requests_completed")
    if expected is not None:
        if completed != expected:
            errors.append(f"fleet: completed {completed} != expected "
                          f"{expected}")
        served = metrics.counter_total("fleet_requests_total")
        if served != expected:
            errors.append(f"fleet: per-cell served counters sum to {served}, "
                          f"expected {expected}")
        off_tel = metrics.gauge_value("fleet_offloaded_telemetry")
        off_ctr = metrics.counter_total("fleet_offloaded_total")
        if off_tel is not None and off_ctr != off_tel:
            errors.append(f"fleet: gate-verdict offload counter {off_ctr} != "
                          f"telemetry offload count {off_tel}")
    srv = metrics.gauge_value("serving_requests")
    if srv is not None:
        ctr = metrics.counter_total("serving_requests_total")
        if ctr != srv:
            errors.append(f"serving: completion counters sum to {ctr}, "
                          f"telemetry has {srv}")
        rate = metrics.gauge_value("serving_offload_rate")
        off = metrics.counter_total("serving_requests_total", path="cloud")
        if rate is not None and abs(off - rate * srv) > 0.5:
            errors.append(f"serving: offloaded counter {off} != "
                          f"offload_rate*requests {rate * srv:.1f}")
    return errors


def check_trace_counts(records: Sequence[Dict],
                       metrics: MetricsRegistry) -> List[str]:
    """The sink saw every record the emitters counted; unsampled traces
    account for every completed request."""
    errors = []
    by_source: Dict[str, int] = {}
    offloaded: Dict[str, int] = {}
    for r in records:
        if r.get("kind") != "request":
            continue
        src = r.get("source", "?")
        by_source[src] = by_source.get(src, 0) + 1
        if not r["on_device"]:
            offloaded[src] = offloaded.get(src, 0) + 1
    for src, n in sorted(by_source.items()):
        ctr = metrics.counter_total("trace_records_total", source=src)
        if ctr and ctr != n:
            errors.append(f"{src}: trace file holds {n} records, emitters "
                          f"counted {ctr}")
        every = metrics.gauge_value("trace_sample_every", source=src)
        if every != 1:
            continue  # sampled: per-record invariants only
        total = {"fleet": "fleet_requests_total",
                 "serving": "serving_requests_total"}.get(src)
        if total is not None:
            want = metrics.counter_total(total)
            if want and n != want:
                errors.append(f"{src}: unsampled trace holds {n} records, "
                              f"{want} requests completed")
        off_ctr = {"fleet": "fleet_offloaded_total"}.get(src)
        if off_ctr is not None:
            want = metrics.counter_total(off_ctr)
            if want != offloaded.get(src, 0):
                errors.append(f"{src}: trace shows {offloaded.get(src, 0)} "
                              f"offloads, counters say {want}")
    return errors


def check_uplink_bytes(records: Sequence[Dict],
                       metrics: MetricsRegistry) -> List[str]:
    """On an UNSAMPLED trace, the per-request `payload_nbytes` of the
    offloaded records sum exactly to the byte counters the stacks
    maintain (`serving_uplink_bytes_total`; `fleet_uplink_bytes_total`
    summed over cells) -- the wire-pricing analogue of request
    conservation. Sampled traces are skipped: a stride of the records
    cannot reproduce a total."""
    errors = []
    by_source: Dict[str, float] = {}
    for r in records:
        if r.get("kind") != "request" or r["on_device"]:
            continue
        pn = r.get("payload_nbytes")
        if pn is None:
            return []  # legacy trace (pre-codec): nothing to audit
        src = r.get("source", "?")
        by_source[src] = by_source.get(src, 0.0) + float(pn)
    counters = {"fleet": "fleet_uplink_bytes_total",
                "serving": "serving_uplink_bytes_total"}
    for src, total in sorted(by_source.items()):
        if metrics.gauge_value("trace_sample_every", source=src) != 1:
            continue
        name = counters.get(src)
        if name is None:
            continue
        want = metrics.counter_total(name)
        if abs(want - total) > 0.5:
            errors.append(f"{src}: trace payloads sum to {total:.0f} bytes, "
                          f"{name} counted {want:.0f}")
    return errors


def check_calibration(sketch,
                      metrics: Optional[MetricsRegistry] = None,
                      trace_records: Optional[Sequence[Dict]] = None,
                      ece_tol: float = 1e-9) -> List[str]:
    """Calibration-sketch invariants.

    1. **Totals conserved** -- gated + ungated sketch counts equal the
       request counters the stacks maintain (`fleet_requests_total`
       per cell, or `serving_requests_total` for the event runtime).
    2. **ECE reproduction** -- on an UNSAMPLED trace, the merged
       sketch's ECE equals `repro_torch.core.metrics.ece` recomputed from the
       raw per-request gate confidences/correctness in the trace
       (counts must match exactly; the float sums differ only by
       accumulation order, hence `ece_tol`).
    """
    errors: List[str] = []
    if metrics is not None:
        if metrics.counter_total("fleet_requests_total") > 0:
            for cell in sketch.cells():
                want = metrics.counter_total("fleet_requests_total",
                                             cell=cell)
                got = sketch.total_count(cell)
                if want and got != want:
                    errors.append(
                        f"calibration: cell {cell} sketch total {got} != "
                        f"fleet_requests_total {want:.0f}")
        elif metrics.counter_total("serving_requests_total") > 0:
            want = metrics.counter_total("serving_requests_total")
            got = sketch.total_count()
            if got != want:
                errors.append(
                    f"calibration: sketch total {got} != "
                    f"serving_requests_total {want:.0f}")
    if trace_records is not None:
        unsampled = metrics is None or all(
            metrics.gauge_value("trace_sample_every", source=s) in (None, 1)
            for s in {r.get("source", "?") for r in trace_records
                      if r.get("kind") == "request"}
        )
        if unsampled:
            conf, correct = [], []
            for r in trace_records:
                if r.get("kind") != "request":
                    continue
                gate = r.get("gate")
                if not gate or gate.get("confidence") is None \
                        or gate.get("correct") is None:
                    continue
                conf.append(float(gate["confidence"]))
                correct.append(int(gate["correct"]))
            if conf:
                import numpy as np

                from repro_torch.core.metrics import ece as _ece

                want = float(_ece(np.asarray(conf),
                                  np.asarray(correct, bool)))
                got = sketch.ece()
                n_trace, n_sketch = len(conf), sketch.gated_count()
                if n_trace != n_sketch:
                    errors.append(
                        f"calibration: trace holds {n_trace} gated "
                        f"records, sketch accumulated {n_sketch}")
                elif abs(got - want) > ece_tol:
                    errors.append(
                        f"calibration: sketch ECE {got!r} != "
                        f"core.metrics.ece {want!r} on the unsampled trace")
    return errors


def verify_rollback_chain(audit_records: Sequence[Dict]) -> Dict:
    """Reconstruct a canary rollback from the audit log alone.

    Returns ``{"ok": bool, "why": str, "canary": rec, "trips": [rec],
    "rollback": rec}`` -- ok only when the log shows, in time order, a
    canary start, at least one QoS trip on a canary cell whose evidence
    puts the metric value over its cap, and a rollback of that bank
    version restoring the incumbent version the canary recorded."""
    out: Dict = {"ok": False, "why": "", "canary": None, "trips": [],
                 "rollback": None}
    canaries = [r for r in audit_records if r["action"] == "rollout_canary"]
    if not canaries:
        out["why"] = "no rollout_canary record"
        return out
    ca = canaries[0]
    out["canary"] = ca
    version = ca["evidence"].get("bank_version")
    incumbent = ca["evidence"].get("incumbent_version")
    cells = set(ca["evidence"].get("cells") or ())
    trips = [r for r in audit_records
             if r["action"] == "qos_trip" and r["t_s"] >= ca["t_s"]
             and r["evidence"].get("cell") in cells]
    out["trips"] = trips
    if not trips:
        out["why"] = f"no qos_trip on canary cells {sorted(cells)}"
        return out
    for tr in trips:
        ev = tr["evidence"]
        if not ({"metric", "value", "cap"} <= set(ev)):
            out["why"] = f"trip at t={tr['t_s']} lacks metric/value/cap"
            return out
        # direction-aware: floor SLOs (e.g. coverage) record op="<" and
        # trip when the value drops BELOW the cap; caps default to ">"
        op = ev.get("op", ">")
        violated = ev["value"] < ev["cap"] if op == "<" \
            else ev["value"] > ev["cap"]
        if not violated:
            out["why"] = (f"trip at t={tr['t_s']}: value {ev['value']} not "
                          f"{'under' if op == '<' else 'over'} cap "
                          f"{ev['cap']}")
            return out
    rollbacks = [r for r in audit_records
                 if r["action"] == "rollout_rollback"
                 and r["evidence"].get("bank_version") == version]
    if not rollbacks:
        out["why"] = f"no rollout_rollback for bank_version {version}"
        return out
    rb = rollbacks[0]
    out["rollback"] = rb
    if rb["t_s"] < trips[0]["t_s"]:
        out["why"] = "rollback precedes first trip"
        return out
    if rb["evidence"].get("restored_version") != incumbent:
        out["why"] = (f"rollback restored "
                      f"{rb['evidence'].get('restored_version')}, canary "
                      f"recorded incumbent {incumbent}")
        return out
    out["ok"] = True
    out["why"] = (f"canary v{version} tripped on cells "
                  f"{sorted({t['evidence']['cell'] for t in trips})}, "
                  f"rolled back to v{incumbent} at t={rb['t_s']}s")
    return out


def run_checks(trace_records: Optional[Sequence[Dict]] = None,
               metrics: Optional[MetricsRegistry] = None,
               audit_records: Optional[Sequence[Dict]] = None,
               require_rollback_chain: bool = False,
               calibration=None,
               rel_tol: float = 1e-6) -> List[str]:
    errors = []
    if trace_records is not None:
        errors += check_span_telescoping(trace_records, rel_tol=rel_tol)
        errors += check_gate_consistency(trace_records)
        if metrics is not None:
            errors += check_trace_counts(trace_records, metrics)
            errors += check_uplink_bytes(trace_records, metrics)
    if metrics is not None:
        errors += check_conservation(metrics)
    if calibration is not None:
        errors += check_calibration(calibration, metrics=metrics,
                                    trace_records=trace_records)
    if require_rollback_chain:
        if audit_records is None:
            errors.append("rollback chain required but no audit log given")
        else:
            chain = verify_rollback_chain(audit_records)
            if not chain["ok"]:
                errors.append(f"rollback chain broken: {chain['why']}")
    return errors


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.check",
        description="Verify trace/metrics/audit artifacts against the "
                    "observability invariants.")
    ap.add_argument("--trace", help="trace JSONL file")
    ap.add_argument("--metrics", help="metrics JSON export")
    ap.add_argument("--audit", help="audit JSONL file")
    ap.add_argument("--require-rollback-chain", action="store_true",
                    help="fail unless the audit log reconstructs a full "
                         "canary rollback")
    ap.add_argument("--calibration",
                    help="reliability-sketch JSON artifact: verify totals "
                         "against counters and ECE against the trace")
    ap.add_argument("--tol", type=float, default=1e-6,
                    help="relative float tolerance for span sums")
    args = ap.parse_args(argv)
    if not (args.trace or args.metrics or args.audit or args.calibration):
        ap.error("give at least one of "
                 "--trace/--metrics/--audit/--calibration")

    traces = read_jsonl(args.trace) if args.trace else None
    metrics = MetricsRegistry.read_json(args.metrics) if args.metrics else None
    audit = read_jsonl(args.audit) if args.audit else None
    sketch = None
    if args.calibration:
        from .calibration import ReliabilitySketch

        sketch = ReliabilitySketch.load(args.calibration)

    errors = run_checks(traces, metrics, audit,
                        require_rollback_chain=args.require_rollback_chain,
                        calibration=sketch,
                        rel_tol=args.tol)
    n_tr = 0 if traces is None else len(traces)
    print(f"repro_torch.obs.check: {n_tr} trace records, "
          f"{0 if audit is None else len(audit)} audit records, "
          f"metrics={'yes' if metrics is not None else 'no'}")
    if args.audit and args.require_rollback_chain and not errors:
        print("rollback chain:", verify_rollback_chain(audit)["why"])
    if errors:
        for e in errors[:50]:
            print("FAIL:", e)
        if len(errors) > 50:
            print(f"... and {len(errors) - 50} more")
        return 1
    print("all invariants hold")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
