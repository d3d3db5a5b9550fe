#!/usr/bin/env python3
"""Write the H100 manifest fitted by ``chip_smoke.py`` as a zoo entry.

    python tools/measured_manifest.py \\
        --runs chiprun_out/run1 chiprun_out/run2 \\
        --names "chip run 1, PR 21" "chip run 2, PR 21" --commit <sha>

Each ``--runs`` directory is one ``chip_smoke.py --out`` directory; the
last one's fitted manifest (``h100-fit.json``, phase 4) becomes
``src/repro_torch/machines/zoo/h100-measured.json`` (``--out``) under the
name ``h100-measured``.  Its provenance names the runs, the commit they
ran on and the card with its power limit, and records every fitted
column's value in each run and its spread, (max - min) / mean: one run's
fit is one draw.  The data-sheet ``h100`` entry stays as it is.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ZOO = os.path.join(HERE, "..", "src", "repro_torch", "machines", "zoo")


def measured_manifest(runs, names, commit) -> dict:
    fits = []
    for d in runs:
        with open(os.path.join(d, "phase4.json")) as f:
            fits.append(json.load(f))
    with open(os.path.join(runs[-1], "h100-fit.json")) as f:
        doc = json.load(f)
    spread = {}
    for row in fits[-1]["fitted"]:
        col = row["column"]
        vals = [next(r["fitted"] for r in fit["fitted"] if r["column"] == col)
                for fit in fits]
        mean = sum(vals) / len(vals)
        spread[col] = {"unit": row["unit"], "values": vals,
                       "spread": (max(vals) - min(vals)) / mean}
    doc["name"] = "h100-measured"
    prov = doc.setdefault("provenance", {})
    if "store" in prov.get("measure", {}):
        prov["measure"]["store"] = (os.path.basename(prov["measure"]["store"])
                                    + " in the last run's --out directory")
    prov.update({
        "source": "fitted on an NVIDIA H100 by chip_smoke.py phase 4 "
                  "(Table-2 and the Qwen2-1.5B GEMMs in int8, bf16 and "
                  "f32, fit_from_store on the Hopper tile model)",
        "uncalibrated": False,
        "status": f"measured: the fit of {names[-1]}",
        "chip_runs": [{"name": n, "card": fit.get("power"),
                       "campaign_mape_pct": fit["campaign_mape_pct"],
                       "heldout_mape_pct": fit["heldout_mape_pct"]}
                      for n, fit in zip(names, fits)],
        "commit": commit,
        "spread": spread,
        "note": "rates and per-call costs are the last run's fit; "
                "'spread' gives each column in every run and "
                "(max - min) / mean.  Geometry (capacities, levels) is the "
                "data sheet's, as in h100.json.",
    })
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", nargs="+", required=True)
    ap.add_argument("--names", nargs="+", required=True)
    ap.add_argument("--commit", required=True)
    ap.add_argument("--out", default=os.path.join(ZOO, "h100-measured.json"))
    args = ap.parse_args(argv)
    if len(args.names) != len(args.runs):
        ap.error("one --names entry per --runs directory")
    doc = measured_manifest(args.runs, args.names, args.commit)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    for col, s in doc["provenance"]["spread"].items():
        print(f"{col:<14} " + ", ".join(f"{v:.6g}" for v in s["values"])
              + f" {s['unit']}: spread {100 * s['spread']:.2f}%")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
