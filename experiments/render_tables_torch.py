"""Render the dry-run / roofline tables from the port's JSON records.

The torch twin of ``experiments/render_tables.py``: the same tables, read
from the records the port's dry run and probes write
(``python -m repro_torch.launch.dryrun --all``, into
``experiments/dryrun_torch/``; ``python -m repro_torch.launch.
roofline_probe --all``, into ``experiments/roofline_torch/``; a baseline
probe run given ``--out experiments/roofline_torch_baseline``).  For the
same records it renders what ``render_tables.py`` renders.

    PYTHONPATH=src python experiments/render_tables_torch.py [--which dryrun|roofline|all]
"""
import argparse
import glob
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def _records(subdir: str) -> list[dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(HERE, subdir, "*.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def dryrun_table(subdir: str = "dryrun_torch") -> str:
    rows = _records(subdir)
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    out = ["| arch | shape | mesh | compile(s) | HLO GFLOPs/dev | coll GB/dev "
           "| temp GB/dev | args GB/dev |",
           "|---|---|---|---:|---:|---:|---:|---:|"]
    for r in rows:
        temp = r.get("temp_size_in_bytes", 0) / 1e9
        args = r.get("argument_size_in_bytes", 0) / 1e9
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compile_seconds']:.0f} | {r['flops']/1e9:.1f} "
            f"| {r['collective_bytes']/1e9:.2f} | {temp:.1f} | {args:.2f} |")
    return "\n".join(out)


def roofline_table(subdir: str = "roofline_torch") -> str:
    rows = _records(subdir)
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = ["| arch | shape | t_compute | t_memory | t_collective | dominant "
           "| useful | roofline frac |",
           "|---|---|---:|---:|---:|---|---:|---:|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {r['t_compute_s']*1e3:.2f} ms | {r['t_memory_s']*1e3:.2f} ms "
            f"| {r['t_collective_s']*1e3:.2f} ms | {r['dominant']} "
            f"| {r['useful_flop_ratio']:.3f} | {r['roofline_fraction']:.4f} |")
    return "\n".join(out)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--which", default="all")
    a = ap.parse_args()
    if a.which in ("dryrun", "all"):
        print("## Dry-run\n")
        print(dryrun_table())
    if a.which in ("roofline", "all"):
        print("\n## Roofline (optimized)\n")
        print(roofline_table("roofline_torch"))
        print("\n## Roofline (baseline)\n")
        print(roofline_table("roofline_torch_baseline"))
