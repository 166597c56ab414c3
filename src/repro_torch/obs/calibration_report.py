"""Calibration drift report: deployed reliability vs fit-time promises.

Port of `repro.obs.calibration_report`.

``python -m repro_torch.obs.calibration_report`` reads the reliability-sketch
artifacts a run emitted (`ReliabilitySketch.save`), renders one
reliability diagram per context regime, and -- when the deployed
`PlanBank` artifact is given -- diffs each regime's DEPLOYED windowed
ECE against the fit-time validation ECE frozen into the bank's
``metadata["fit_ece"]`` by `repro_torch.core.bank.fit_bank`. A regime whose
deployed ECE exceeds its fit-time ECE by more than ``--drift-cap`` is
flagged: the expert no longer keeps the calibration promise it shipped
with (input drift, a poisoned candidate, a stale calibrator).

Multiple ``--sketch`` files merge exactly (the sketch is a sum), so one
report can span the serving and fleet stacks. An optional every-request
trace cross-checks the sketch: the ECE recomputed from the raw gate
records must match the merged sketch to round-off.

Output: a human-readable report on stdout; ``--out`` additionally
writes the full report as JSON (the CI artifact the poisoned-canary
assertion reads).
"""
from __future__ import annotations

import argparse
import json
import math
from typing import Dict, List, Optional

from .calibration import (
    GLOBAL_CONTEXT,
    ReliabilitySketch,
    block_coverage,
    block_ece,
    block_reliability,
    merge_sketches,
)

_BAR = 24  # diagram bar width (characters)


def _fit_lookup(fit_ece: Dict, default_context: Optional[str], ctx: str,
                branch: int) -> Optional[float]:
    """Fit-time val ECE for (context, branch), if the bank recorded one.
    The non-contextual serving stack keys everything by
    `GLOBAL_CONTEXT`; that resolves to the bank's default context (the
    plan a context-free deployment actually gates with)."""
    key = ctx
    if key not in fit_ece and ctx == GLOBAL_CONTEXT:
        key = default_context
    per_branch = fit_ece.get(key)
    if per_branch is None:
        return None
    v = per_branch.get(str(branch))
    return None if v is None else float(v)


def build_report(sketch: ReliabilitySketch,
                 bank_meta: Optional[dict] = None,
                 trace_records: Optional[list] = None,
                 drift_cap: float = 0.05) -> dict:
    """The report as plain data; `main` renders + serializes it."""
    fit_ece = {} if bank_meta is None else bank_meta.get("fit_ece", {})
    default_context = None if bank_meta is None else bank_meta.get(
        "default_context")
    regimes: Dict[str, dict] = {}
    flags: List[str] = []
    for ctx in sketch.contexts():
        blk = sketch.merged_block(context=ctx)
        count = float(blk[0].sum())
        if count <= 0:
            continue
        branches = sorted(
            {b for _, k, b in sketch.keys() if k == ctx},
            key=lambda b: -float(sketch.merged_block(context=ctx,
                                                     branch=b)[0].sum()),
        )
        branch = branches[0]
        deployed = block_ece(blk)
        fit = _fit_lookup(fit_ece, default_context, ctx, branch)
        drift = None if fit is None else deployed - fit
        drifted = drift is not None and drift > drift_cap
        regimes[ctx] = {
            "count": int(count),
            "branch": int(branch),
            "ece": deployed,
            "coverage": block_coverage(blk),
            "bins": block_reliability(blk),
            "fit_ece": fit,
            "drift": drift,
            "drifted": drifted,
        }
        if drifted:
            flags.append(
                f"regime {ctx!r} drifted: deployed ECE {deployed:.4f} vs "
                f"fit-time {fit:.4f} (+{drift:.4f} > cap {drift_cap:.4f})"
            )
    report = {
        "n_bins": sketch.n_bins,
        "drift_cap": float(drift_cap),
        "cells": {
            str(c): {
                "ece": sketch.ece(cell=c),
                "brier": sketch.brier(cell=c),
                "gated": sketch.gated_count(c),
                "ungated": sketch.ungated_count(c),
            }
            for c in sketch.cells()
        },
        "regimes": regimes,
        "global": {"ece": sketch.ece(), "coverage": sketch.coverage()},
        "flags": flags,
        "flagged": bool(flags),
    }
    if trace_records is not None:
        conf, cor = [], []
        for r in trace_records:
            g = r.get("gate")
            if g and g.get("correct") is not None:
                conf.append(float(g["confidence"]))
                cor.append(float(g["correct"]))
        report["trace"] = {"gate_records": len(conf)}
        if conf:
            import numpy as np

            from repro_torch.core.metrics import ece as _ece

            t_ece = float(_ece(np.asarray(conf), np.asarray(cor)))
            report["trace"]["ece"] = t_ece
            report["trace"]["matches_sketch"] = (
                len(conf) == sum(sketch.gated_count(c)
                                 for c in sketch.cells())
                and abs(t_ece - sketch.ece()) <= 1e-9
            )
    return report


def _render(report: dict) -> str:
    out: List[str] = []
    g = report["global"]
    out.append(
        f"calibration report: global ECE {g['ece']:.4f}, "
        f"coverage {g['coverage']:.4f}" if not math.isnan(g["ece"])
        else "calibration report: empty sketch"
    )
    for ctx, reg in sorted(report["regimes"].items()):
        head = (f"\nregime {ctx!r} (branch {reg['branch']}, "
                f"n={reg['count']}): ECE {reg['ece']:.4f}")
        if reg["fit_ece"] is not None:
            head += (f", fit {reg['fit_ece']:.4f}, "
                     f"drift {reg['drift']:+.4f}")
            head += "  ** DRIFTED **" if reg["drifted"] else "  ok"
        out.append(head)
        for b in reg["bins"]:
            bar = "#" * max(1, round(b["accuracy"] * _BAR))
            out.append(
                f"  ({b['lo']:.2f},{b['hi']:.2f}]  conf {b['mean_conf']:.3f}"
                f"  acc {b['accuracy']:.3f}  {bar:<{_BAR}}"
                f" n={b['count']:<6d} resid {b['residual']:+.3f}"
            )
    if "trace" in report:
        t = report["trace"]
        out.append(f"\ntrace cross-check: {t['gate_records']} gate records"
                   + ("" if "ece" not in t else
                      f", ECE {t['ece']:.4f}, "
                      + ("matches sketch" if t["matches_sketch"]
                         else "DOES NOT match sketch")))
    out.append("")
    if report["flags"]:
        out.append("FLAGS:")
        out.extend(f"  - {f}" for f in report["flags"])
    else:
        out.append("no drifted regimes")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.calibration_report",
        description="Reliability diagrams per regime + fit-vs-deployed "
                    "ECE drift flags from sketch artifacts.",
    )
    ap.add_argument("--sketch", nargs="+", required=True,
                    help="reliability-sketch JSON artifact(s); several merge")
    ap.add_argument("--bank", default=None,
                    help="deployed PlanBank JSON (for fit-time ECE diffs)")
    ap.add_argument("--trace", default=None,
                    help="every-request trace JSONL (sketch cross-check)")
    ap.add_argument("--drift-cap", type=float, default=0.05,
                    help="flag a regime when deployed - fit ECE exceeds this")
    ap.add_argument("--out", default=None, help="write the report JSON here")
    args = ap.parse_args(argv)

    sketch = merge_sketches(ReliabilitySketch.load(p) for p in args.sketch)
    bank_meta = None
    if args.bank is not None:
        with open(args.bank) as f:
            d = json.load(f)
        bank_meta = dict(d.get("metadata", {}))
        bank_meta.setdefault("default_context", d.get("default_context"))
    trace = None
    if args.trace is not None:
        from . import read_jsonl

        trace = read_jsonl(args.trace)
    report = build_report(sketch, bank_meta=bank_meta, trace_records=trace,
                          drift_cap=args.drift_cap)
    print(_render(report))
    if args.out is not None:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
    return 1 if report["flagged"] else 0


if __name__ == "__main__":  # pragma: no cover - CLI entry
    raise SystemExit(main())
