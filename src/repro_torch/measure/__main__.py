"""Measurement & validation command line.

    python -m repro_torch.measure run --grid table2 --dtype bf16 \\
        --store measurements/h100.jsonl      # --backend cuda --machine h100
    python -m repro_torch.measure fit --store measurements/h100.jsonl \\
        --template h100 --name h100-fit --out measurements/ \\
        --on-nonpositive drop
    python -m repro_torch.measure validate --store measurements/h100.jsonl \\
        --machine measurements/h100-fit.json --json report.json
    python -m repro_torch.measure report --json report.json

``run`` measures a named grid with one timing backend, by default the CUDA
kernels on the card (``--device cpu`` times their plain versions on the
host; ``--backend simulated --truth NAME`` replays the closed-loop oracle),
``fit`` solves the vectorized least-squares rate fit from the stored
samples and persists the spec, ``validate`` re-predicts every sample and
reports per-cell error + MAPE (exit 1 if the report is not finite),
``report`` renders a persisted report.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch import measure


def _load_machine(tag: str):
    """A registry name, or a manifest path (anything ending in .json)."""
    if tag.endswith(".json"):
        from repro_torch.machines import MachineSpec
        return MachineSpec.from_manifest(tag)
    from repro_torch.machines import resolve
    return resolve(tag)


def cmd_run(args) -> int:
    timing = {"warmup": args.warmup, "rounds": args.rounds}
    mks = measure.DEFAULT_FIT_MKS
    if args.mks:
        mks = [tuple(int(x) for x in mk.split("x"))
               for mk in args.mks.split(",")]
    res = measure.run_campaign(
        args.grid, machine=_load_machine(args.machine),
        harness=args.backend, store=args.store, dtype=args.dtype,
        variant=args.variant, micro_kernels=mks, policy=args.policy,
        timing=timing, truth=args.truth, device=args.device,
        progress=(lambda s: print(f"  {s.cell:<35} {s.seconds:.3e}s "
                                  f"({s.rounds} rounds)"))
        if args.verbose else None)
    print(f"{args.grid}: {len(res.samples)} samples via {res.harness} on "
          f"{res.machine} ({res.measured_seconds:.3g}s measured) -> "
          f"{args.store}")
    return 0


def cmd_fit(args) -> int:
    try:
        spec, report = measure.fit_from_store(
            args.store, _load_machine(args.template), name=args.name,
            date=args.date, per_mk_arith=args.per_mk_arith,
            register=args.register, manifest_dir=args.out,
            on_nonpositive=args.on_nonpositive,
            weighting=args.weighting, robust=args.robust,
            trim_fraction=args.trim_fraction, max_drift=args.max_drift,
            allow_stale=args.allow_stale)
    except measure.CalibrationDriftError as e:
        print(json.dumps(e.as_dict(), indent=1, sort_keys=True))
        print(str(e), file=sys.stderr)
        return 1
    print(f"fitted {spec.name} from {report.samples} samples "
          f"(residual RMS {report.residual_rms_s:.3e}s)")
    if report.robust:
        print(f"  robust={report.robust}: {len(report.outliers)} sample(s) "
              f"down-weighted {report.outliers}")
    import math as _math
    for col, x in zip(report.columns, report.inverse_rates):
        if _math.isnan(x):
            tag = (f"dropped -> "
                   f"{'free' if args.on_nonpositive == 'free' else 'template rate'}")
        else:
            unit = "B/s" if col.startswith("rate:") else "ops/s"
            tag = f"{1.0 / x:.4g} {unit}"
        print(f"  {col:<28} {tag}")
    if args.out:
        print(f"manifest written to {args.out}/{spec.name}.json")
    return 0


def cmd_validate(args) -> int:
    report = measure.validate_spec(_load_machine(args.machine), args.store,
                                   allow_stale=args.allow_stale)
    print(report.table(limit=args.limit))
    for field in ("dtype", "micro_kernel"):
        groups = report.breakdown(field)
        if len(groups) > 1:
            print(f"by {field}:")
            for key, g in groups.items():
                print(f"  {key:<12} {g['cells']:>3} cells  "
                      f"MAPE {g['mape_pct']:6.2f}%  "
                      f"bias {g['bias_pct']:+6.2f}%")
    if args.json:
        report.save(args.json)
        print(f"report written to {args.json}")
    if not report.finite:
        print("validation MAPE is not finite", file=sys.stderr)
        return 1
    return 0


def cmd_report(args) -> int:
    report = measure.ValidationReport.load(args.json)
    print(report.table(limit=args.limit))
    print(json.dumps(report.summary(), indent=1, sort_keys=True))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.measure")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="measure a campaign grid into a store")
    r.add_argument("--grid", default="smoke",
                   choices=measure.grid_names())
    r.add_argument("--backend", default="cuda",
                   choices=measure.harness_names(),
                   help="timing backend (harness)")
    r.add_argument("--machine", default="h100",
                   help="registry name or manifest path to plan against")
    r.add_argument("--store", required=True, help="JSONL sample store path")
    r.add_argument("--dtype", default=None)
    r.add_argument("--variant", default=None,
                   help="BLIS loop-order variant (default B3A2C0)")
    r.add_argument("--mks", default=None,
                   help="comma-separated micro-kernels, e.g. 4x24,8x12")
    r.add_argument("--policy", default="analytic",
                   choices=["analytic", "padded"])
    r.add_argument("--truth", default=None,
                   help="ground-truth machine for --backend simulated")
    r.add_argument("--device", default=None,
                   help="device of the cuda/reference harness operands "
                        "(default cuda; cpu times the plain versions)")
    r.add_argument("--rounds", type=int, default=3)
    r.add_argument("--warmup", type=int, default=1)
    r.add_argument("--verbose", action="store_true")
    r.set_defaults(fn=cmd_run)

    f = sub.add_parser("fit", help="least-squares rate fit from a store")
    f.add_argument("--store", required=True)
    f.add_argument("--template", required=True,
                   help="geometry template: registry name or manifest path")
    f.add_argument("--name", default=None)
    f.add_argument("--date", default=None,
                   help="calibration date recorded in provenance")
    f.add_argument("--per-mk-arith", action="store_true",
                   help="fit a per-micro-kernel arithmetic-rate table "
                        "(paper 4's refinement)")
    f.add_argument("--register", action="store_true")
    f.add_argument("--out", default=None,
                   help="directory to persist the fitted manifest into")
    f.add_argument("--weighting", default="relative",
                   choices=["relative", "absolute"],
                   help="solve in relative-error or absolute-seconds space")
    f.add_argument("--on-nonpositive", default="raise",
                   choices=["raise", "drop", "free"],
                   help="columns the measurements assign no cost: fail, "
                        "keep template rates, or mark the term free")
    f.add_argument("--robust", default=None, choices=["huber", "trim"],
                   help="outlier-resistant solve (corrupted field samples)")
    f.add_argument("--trim-fraction", type=float, default=0.1,
                   help="fraction --robust trim discards (default 0.1)")
    f.add_argument("--max-drift", type=float, default=None,
                   help="refuse to fit when the median measured/predicted "
                        "ratio vs the template deviates from 1 by more "
                        "than this (e.g. 0.25)")
    f.add_argument("--allow-stale", action="store_true")
    f.set_defaults(fn=cmd_fit)

    v = sub.add_parser("validate",
                       help="predicted-vs-measured accuracy report")
    v.add_argument("--store", required=True)
    v.add_argument("--machine", required=True,
                   help="registry name or fitted manifest path")
    v.add_argument("--json", default=None, help="persist the report here")
    v.add_argument("--limit", type=int, default=None)
    v.add_argument("--allow-stale", action="store_true")
    v.set_defaults(fn=cmd_validate)

    p = sub.add_parser("report", help="render a persisted validation report")
    p.add_argument("--json", required=True)
    p.add_argument("--limit", type=int, default=20)
    p.set_defaults(fn=cmd_report)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except RuntimeError as e:       # e.g. no CUDA device, no nvcc
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
