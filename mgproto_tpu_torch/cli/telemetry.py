"""The telemetry command, trimmed to the trust gate (counterpart of
mgproto_tpu/cli/telemetry.py).

    python -m mgproto_tpu_torch.cli.telemetry check --trust trust_report.json

`check --trust FILE` re-derives every verdict of a trust-matrix report
(trust/matrix.py) from its raw numbers (`trust_gates`) and exits 0 when
all pass, 1 otherwise. The port writes no telemetry directory, so every
other gate of `check` (a telemetry directory against a baseline, and
`--drift-drill`, `--autoscale`, `--tenants`, `--weakscale`, `--quant`,
`--stall-report`) and `summarize` raise NotPortedError naming ROADMAP A
item 7; online/drill.py's `drift_drill_gates` gates the drift drill
without this command.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

REFUSED_LABEL = "A9 (obs and telemetry)"
# the JAX command's other gate files: parsed, then refused
OTHER_GATES = ("drift_drill", "autoscale", "tenants", "weakscale", "quant", "stall_report",
               "stall_baseline")


def _refuse(what: str):
    from mgproto_tpu_torch.cli.common import NotPortedError

    raise NotPortedError(f"{what} is not ported: the port writes no telemetry; ROADMAP "
                         f"{REFUSED_LABEL}, item 7")


def trust_gates(record: Dict[str, Any]) -> Dict[str, Any]:
    """Gate a trust-matrix report, re-derived from its RAW numbers (outcome
    counts, correct-on-answered counts, per-sample served scores), never
    from its stored rates or AUROCs:

      * every ID x OoD pair's AUROC re-derived from the raw scores matches
        the recorded value (tamper bound) and clears the report's floor;
      * OoD traffic abstains at least as often as clean ID, per pair;
      * along every corruption family's ladder, abstention rises
        monotonically (within monotone_tol) and ends at or above the
        clean-ID rate;
      * accuracy over answered outcomes holds above the floor at every
        severity (vacuously at full abstention);
      * the clean-ID served-score sketch sits on the calibration's (px
        divergence under the limit);
      * zero dropped requests, zero steady-state recompiles, not degraded."""
    from mgproto_tpu_torch.trust.auroc import binary_auroc

    rows: List[Dict[str, Any]] = []

    def gate(key, ok, why="", baseline_v=None, value=None):
        rows.append({"key": key, "ok": bool(ok), "why": "" if ok else why,
                     "baseline": baseline_v, "value": value, "direction": "trust"})

    def abstain_rate(cell) -> Optional[float]:
        """Abstention over the gated outcomes, from the raw counts."""
        oc = cell.get("outcomes") or {}
        gated = (oc.get("predict") or 0) + (oc.get("abstain") or 0)
        return (oc.get("abstain") or 0) / gated if gated else None

    cfg = record.get("config") or {}
    gate("trust.schema",
         bool(record.get("trust_report")) and bool(record.get("id"))
         and bool(record.get("pairs")) and bool(record.get("ladder")),
         "not a trust report (missing trust_report/id/pairs/ladder)")
    gate("trust.zero_steady_recompiles", record.get("steady_state_recompiles") == 0,
         f"serving recompiled in steady state: {record.get('steady_state_recompiles')}")
    gate("trust.not_degraded", record.get("degraded") is False,
         "engine served in degraded mode — the matrix measured an ungated path")

    # zero dropped: every cell answered exactly what was submitted
    dropped = []
    id_cell = record.get("id") or {}
    all_cells = [("id", id_cell)]
    all_cells += [(f"ood:{p.get('pair')}", p) for p in record.get("pairs") or []]
    for kind, rows_k in (record.get("ladder") or {}).items():
        all_cells += [(f"{kind}:{c.get('severity')}", c) for c in rows_k]
    for name, cell in all_cells:
        if not (cell.get("submitted") == cell.get("returned") == cell.get("n")) \
                or not cell.get("n"):
            dropped.append(name)
    gate("trust.zero_dropped", not dropped,
         f"cells with submitted != returned (or empty): {dropped}")

    div = id_cell.get("px_divergence")
    limit = cfg.get("px_divergence_limit")
    gate("trust.calibration_matches_serving",
         isinstance(div, (int, float)) and isinstance(limit, (int, float)) and div <= limit,
         f"clean-ID served-score divergence {div} vs limit {limit} — the serving path is "
         "not the distribution the calibration measured",
         baseline_v=limit, value=div)

    # per-pair AUROC, re-derived from the raw scores
    id_scores = id_cell.get("scores") or []
    rtol = cfg.get("auroc_rederive_tol", 1e-9)
    floor = cfg.get("auroc_floor")
    id_rate = abstain_rate(id_cell)
    for p in record.get("pairs") or []:
        name = p.get("pair")
        scores = p.get("scores") or []
        recorded = p.get("auroc")
        derived = binary_auroc(id_scores, scores) if id_scores and scores else None
        gate(f"trust.auroc_rederives[{name}]",
             isinstance(recorded, (int, float)) and derived is not None
             and abs(derived - recorded) <= rtol,
             f"recorded AUROC {recorded} vs re-derived {derived} — the stored value does "
             "not follow from the raw scores",
             baseline_v=recorded, value=derived)
        gate(f"trust.auroc_floor[{name}]",
             derived is not None and isinstance(floor, (int, float)) and derived >= floor,
             f"re-derived AUROC {derived} < committed floor {floor}",
             baseline_v=floor, value=derived)
        ood_rate = abstain_rate(p)
        gate(f"trust.ood_abstains_more[{name}]",
             id_rate is not None and ood_rate is not None and ood_rate >= id_rate,
             f"OoD abstention {ood_rate} < ID abstention {id_rate}",
             baseline_v=id_rate, value=ood_rate)

    # the corruption ladder: monotone abstention and the answered-accuracy
    # floor, from the raw counts
    tol = cfg.get("monotone_tol", 0.0)
    acc_floor = cfg.get("answered_accuracy_floor")
    for kind, rows_k in sorted((record.get("ladder") or {}).items()):
        rates = [abstain_rate(c) for c in rows_k]
        mono = (
            bool(rates) and all(r is not None for r in rates)
            and id_rate is not None
            and all(b >= a - tol for a, b in zip(rates, rates[1:]))
            # the tol absorbs between-rung sampling noise only: the heaviest
            # rung must never abstain less than clean traffic
            and rates[-1] >= id_rate
        )
        gate(f"trust.abstention_monotone[{kind}]", mono,
             f"abstention along severities {rates} (clean ID {id_rate}) is not monotone "
             f"within tol {tol}, or the heaviest rung abstains LESS than clean traffic — "
             "degradation is not graceful",
             baseline_v=id_rate, value=rates)
        accs, acc_ok = [], bool(rows_k)
        for c in rows_k:
            answered = c.get("answered") or 0
            correct = c.get("correct_answered")
            if answered == 0:
                accs.append(None)  # full abstention: the risk is vacuous
                continue
            if not isinstance(correct, (int, float)):
                acc_ok = False
                accs.append(None)
                continue
            acc = correct / answered
            accs.append(round(acc, 4))
            if not (isinstance(acc_floor, (int, float)) and acc >= acc_floor):
                acc_ok = False
        gate(f"trust.answered_accuracy_floor[{kind}]", acc_ok,
             f"accuracy-on-answered {accs} drops below the committed floor {acc_floor} "
             "somewhere on the ladder",
             baseline_v=acc_floor, value=accs)
    return {"ok": all(r["ok"] for r in rows), "checked": len(rows),
            "failed": sum(not r["ok"] for r in rows), "rows": rows}


def _print_gate_result(result: Dict[str, Any], json_mode: bool) -> None:
    """Render one gate-suite result ({ok, checked, failed, rows})."""
    if json_mode:
        print(json.dumps(result, indent=2))
        return
    width = max(len(r["key"]) for r in result["rows"])
    for r in result["rows"]:
        status = "ok  " if r["ok"] else "FAIL"
        detail = f" ({r['why']})" if r["why"] else ""
        print(f"{status} {r['key']:<{width}}{detail}")
    print(f"{result['checked']} checked, {result['failed']} failed")


def check_main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mgproto_tpu_torch.cli.telemetry check",
        description="Gate a trust-matrix report (exit 0 = every gate passes, 1 = a gate "
                    "failed); the JAX command's other gates are not ported")
    p.add_argument("dir", nargs="?", default=None,
                   help="telemetry dir: not ported (the port writes no telemetry)")
    p.add_argument("--baseline", default=None, help="not ported (A9): refused")
    p.add_argument("--trust", default=None, metavar="FILE",
                   help="gate a trust-matrix report (trust/matrix.py): per-pair OoD AUROC "
                        "re-derived from raw scores >= the report's floor, abstention "
                        "monotone in corruption severity, answered-accuracy >= floor at "
                        "every severity, calibration-vs-serving sketch agreement, zero "
                        "dropped requests, zero steady-state recompiles — exit 1 on any "
                        "failure")
    for dest in OTHER_GATES:
        p.add_argument("--" + dest.replace("_", "-"), dest=dest, default=None, metavar="FILE",
                       help="not ported (A9): refused")
    p.add_argument("--write-baseline", action="store_true", help="not ported (A9): refused")
    p.add_argument("--fleet-gates", action="store_true", help="not ported (A9): refused")
    p.add_argument("--json", action="store_true",
                   help="emit the check result as one JSON object")
    args = p.parse_args(argv)
    for dest in OTHER_GATES:
        if getattr(args, dest) is not None:
            _refuse("check --" + dest.replace("_", "-"))
    if args.dir is not None or args.baseline is not None or args.write_baseline \
            or args.fleet_gates:
        _refuse("check of a telemetry directory against a baseline")
    if args.trust is None:
        raise SystemExit("check needs --trust FILE (the only gate the port has)")
    try:
        with open(args.trust) as f:
            record = json.load(f)
    except (OSError, ValueError) as e:
        raise SystemExit(f"cannot read trust report {args.trust}: {e}")
    result = trust_gates(record)
    _print_gate_result(result, args.json)
    return 0 if result["ok"] else 1


def main(argv: Optional[list] = None) -> Optional[int]:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "check":
        return check_main(argv[1:])
    if argv and argv[0] == "fleet":
        _refuse("fleet")
    _refuse("summarize")


if __name__ == "__main__":
    raise SystemExit(main())
