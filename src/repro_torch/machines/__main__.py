"""Machine-zoo command line.

    python -m repro_torch.machines validate [--dir DIR]  # schema-check
    python -m repro_torch.machines list [PATTERN]        # registered machines
    python -m repro_torch.machines show NAME             # one manifest
    python -m repro_torch.machines calibrate [--name N --date D --out DIR]

``validate`` passes over the port's zoo (``h100.json`` included): every
``zoo/*.json`` must parse against the ``repro.machines/v1`` schema (level
names, rate keys, dtype tables) and round-trip losslessly, or it fails.
``calibrate`` runs the paper's §3.2 micro-experiments on the host CPU.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from repro_torch import machines
from repro_torch.machines.spec import MachineSpec, SpecValidationError


def cmd_validate(args) -> int:
    directory = args.dir or machines.zoo_dir()
    paths = sorted(glob.glob(os.path.join(directory, "*.json")))
    if not paths:
        print(f"no manifests found under {directory}", file=sys.stderr)
        return 1
    failures = 0
    for path in paths:
        rel = os.path.relpath(path, directory)
        try:
            spec = MachineSpec.from_manifest(path)
            # the manifest must also round-trip losslessly
            if MachineSpec.from_json(spec.to_json()) != spec:
                raise SpecValidationError("to_json/from_json round-trip "
                                          "drift")
            print(f"  OK   {rel:<24} {spec.name} "
                  f"(levels={'/'.join(spec.levels)}, "
                  f"dtypes={','.join(sorted(spec.arith_rate))})")
        except (SpecValidationError, json.JSONDecodeError, OSError) as e:
            failures += 1
            print(f"  FAIL {rel:<24} {e}", file=sys.stderr)
    print(f"{len(paths) - failures}/{len(paths)} manifests valid")
    return 1 if failures else 0


def cmd_list(args) -> int:
    for name in machines.list_machines(args.pattern):
        spec = machines.get(name)
        src = machines.source_of(name) or "?"
        print(f"  {name:<20} [{src}] levels={'/'.join(spec.levels)} "
              f"dtypes={','.join(sorted(spec.arith_rate))}")
    return 0


def cmd_show(args) -> int:
    json.dump(machines.get(args.name).to_json(), sys.stdout, indent=1)
    print()
    return 0


def cmd_calibrate(args) -> int:
    spec = machines.Calibrator.measure_host(
        args.name, date=args.date, register=True, manifest_dir=args.out)
    print(f"calibrated {spec.name}: "
          f"{json.dumps(spec.provenance['calibration']['measured'])}")
    if args.grid or args.store:
        # the full §3.2-and-beyond loop: measure a GEMM campaign against the
        # seed spec's geometry and fit every rate at once
        # (repro_torch.measure).
        import tempfile

        from repro_torch import measure

        store = measure.SampleStore(
            args.store or os.path.join(tempfile.mkdtemp(prefix="calib-"),
                                       "samples.jsonl"))
        if args.grid:
            camp = measure.run_campaign(args.grid, machine=spec,
                                        harness="host-numpy",
                                        dtype=args.dtype, store=store)
            print(f"measured {len(camp.samples)} samples "
                  f"({args.grid}, host-numpy) -> {store.path}")
        spec, fit = measure.fit_from_store(
            store, spec, name=args.name, date=args.date, register=True,
            manifest_dir=args.out, on_nonpositive="free")
        report = measure.validate_spec(spec, store)
        print(f"fitted {spec.name} from {fit.samples} samples "
              f"(residual RMS {fit.residual_rms_s:.3e}s"
              + (f", free columns {fit.dropped}" if fit.dropped else "")
              + f"); validation MAPE {report.mape:.1f}%")
    if args.out:
        print(f"manifest written to "
              f"{os.path.join(args.out, spec.name + '.json')}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.machines")
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("validate", help="schema-check every zoo manifest")
    v.add_argument("--dir", default=None)
    v.set_defaults(fn=cmd_validate)
    ls = sub.add_parser("list", help="registered machines")
    ls.add_argument("pattern", nargs="?", default=None)
    ls.set_defaults(fn=cmd_list)
    sh = sub.add_parser("show", help="print one machine's manifest")
    sh.add_argument("name")
    sh.set_defaults(fn=cmd_show)
    ca = sub.add_parser("calibrate",
                        help="run the paper's 3.2 micro-experiments on this "
                             "host and register the spec; with --grid/"
                             "--store, follow with a measured-GEMM campaign "
                             "and a full rate fit (repro_torch.measure)")
    ca.add_argument("--name", default="host-cpu")
    ca.add_argument("--date", default=None,
                    help="calibration date recorded in provenance")
    ca.add_argument("--out", default=None,
                    help="directory to persist the manifest into")
    ca.add_argument("--grid", default=None,
                    help="measurement-campaign grid (smoke|table2|mobilenet)"
                         " to run with the host-numpy harness before fitting")
    ca.add_argument("--store", default=None,
                    help="sample store to measure into / fit from "
                         "(temp file when omitted with --grid)")
    ca.add_argument("--dtype", default="f32",
                    help="campaign dtype (default f32: host BLAS)")
    ca.set_defaults(fn=cmd_calibrate)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
