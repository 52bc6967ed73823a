"""The online-learning command (counterpart of mgproto_tpu/cli/online.py).

`drill` runs the seeded, virtual-clock drift drill (online/drill.py):
class-conditional traffic through the real serving plane, a hermetic EM
bootstrap, an injected shift (`--drift-kind shift`) or a new class claiming
a padded slot (`--drift-kind new_class`), and the online plane (trusted
capture -> consolidation -> drift monitor -> recalibrate + blue/green
republish) closing the loop. It prints one JSON record and exits 1 when a
gate of `drift_drill_gates` fails:

    python -m mgproto_tpu_torch.cli.online drill --device cuda --out drill.json

`--device` is the port's own flag (default cuda); the others are the JAX
command's. `status` renders a telemetry directory's drift section:

    python -m mgproto_tpu_torch.cli.online status <telemetry dir> [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional


def drill_main(argv=None) -> int:
    from mgproto_tpu_torch.online.drill import DEFAULT_PHASES, run_drill

    p = argparse.ArgumentParser(
        prog="python -m mgproto_tpu_torch.cli.online drill",
        description="Seeded drift drill: inject shift, detect via p(x), correct via "
                    "recalibrate + blue/green republish")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--drift-kind", choices=("shift", "new_class"), default="shift")
    p.add_argument("--drift-at", type=int, default=120,
                   help="request index at which the distribution shifts")
    p.add_argument("--drift-magnitude", type=float, default=0.25)
    p.add_argument("--phases", default=DEFAULT_PHASES, help="comma list of DURxRPS storm phases")
    p.add_argument("--capture-percentile", type=float, default=10.0)
    p.add_argument("--poison-rate", type=float, default=None,
                   help="low-p(x) mislabeled chaos fraction (default: "
                        "MGPROTO_CHAOS_ONLINE_POISON_RATE)")
    p.add_argument("--class-bucket", type=int, default=8)
    p.add_argument("--accuracy-window", type=int, default=40)
    p.add_argument("--out", default="", help="write the record here too")
    p.add_argument("--device", default="cuda",
                   help="torch device of the drill's model (the port's flag)")
    args = p.parse_args(argv)
    record = run_drill(
        seed=args.seed, drift_kind=args.drift_kind, drift_at=args.drift_at,
        drift_magnitude=args.drift_magnitude, phases=args.phases,
        capture_percentile=args.capture_percentile, poison_rate=args.poison_rate,
        class_bucket=args.class_bucket, accuracy_window=args.accuracy_window,
        device=args.device,
    )
    line = json.dumps(record, sort_keys=True)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if record["gates"]["ok"] else 1


def status_main(argv=None) -> int:
    """Render a telemetry directory's drift section (`cli.telemetry
    summarize`'s), as the JAX command does; --json prints it as JSON."""
    from mgproto_tpu_torch.cli.telemetry import _fmt, summarize

    p = argparse.ArgumentParser(prog="python -m mgproto_tpu_torch.cli.online status",
                                description="Render a telemetry dir's online-learning drift "
                                            "section")
    p.add_argument("dir", help="telemetry dir (or a run dir containing telemetry/)")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    if not os.path.isdir(args.dir):
        raise SystemExit(f"not a directory: {args.dir}")
    drift = summarize(args.dir).get("drift")
    if drift is None:
        # a session always pre-registers the online family
        raise SystemExit(f"no online_*/drift_* series under {args.dir} (pre-online "
                         "telemetry dir?)")
    if args.json:
        print(json.dumps(drift, indent=2))
        return 0
    width = max(len(k) for k in drift)
    for k, v in drift.items():
        if isinstance(v, dict):
            v = " ".join(f"{kk}={_fmt(vv)}" for kk, vv in sorted(v.items())) or "-"
        print(f"{k:<{width}}  {_fmt(v)}")
    return 0


def main(argv: Optional[list] = None) -> Optional[int]:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "drill":
        return drill_main(argv[1:])
    if argv and argv[0] == "status":
        return status_main(argv[1:])
    p = argparse.ArgumentParser(description="Online MGProto driver (subcommands: drill, status)")
    p.parse_args(argv if argv else ["--help"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
