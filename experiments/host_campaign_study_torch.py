"""Host measure→fit→validate campaign study (see EXPERIMENTS.md).

Runs the paper's calibration methodology end to end on whatever host
executes this script: measure the Table-2 MobileNetV1 GEMMs (f32, so the
blocked replay hits the host BLAS) plus the smoke grid with the host-numpy
harness, fit the host-cpu template's rates by relative-error least squares,
and validate predicted vs measured — the accuracy claim as an artifact.

Prints the markdown section; EXPERIMENTS.md records the committed output
together with the fitted rates and the MAPE.

The torch twin of ``experiments/host_campaign_study.py``: the same campaigns, sections,
columns and sample counts on the port's ``host-numpy`` harness; its
timings, and so its fitted rates and errors, are this host's.

  PYTHONPATH=src python experiments/host_campaign_study_torch.py [store_dir]
"""
from __future__ import annotations

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import measure


def run(store_dir: str | None = None) -> list[str]:
    store_dir = store_dir or tempfile.mkdtemp(prefix="host-campaign-")
    store = measure.SampleStore(os.path.join(store_dir, "host.jsonl"))

    camps = [
        measure.run_campaign("table2", machine="host-cpu", dtype="f32",
                             harness="host-numpy", store=store,
                             timing={"warmup": 1, "rounds": 2}),
        measure.run_campaign("smoke", machine="host-cpu",
                             harness="host-numpy", store=store),
    ]
    spec, fit = measure.fit_from_store(store, "host-cpu",
                                       name="host-cpu-measured", date=None,
                                       on_nonpositive="free",
                                       manifest_dir=store_dir)
    val = measure.validate_spec(spec, store)
    baseline = measure.validate_spec("host-cpu", store)

    lines = [
        f"- campaigns: "
        + " + ".join(f"`{c.grid}` ({len(c.samples)} samples)"
                     for c in camps)
        + f", host-numpy blocked-loop-nest replay, f32",
        f"- fit: relative-error least squares over "
        f"{fit.samples} samples, residual RMS {fit.residual_rms_s:.3e}s"
        + (f"; columns fitted as free (the host overlaps that traffic "
           f"with compute): {fit.dropped}" if fit.dropped else ""),
        "",
        "| rate column | template (placeholder) | fitted |",
        "|---|---|---|",
    ]
    from repro_torch.machines import get
    template = get("host-cpu")
    for col, x in zip(fit.columns, fit.inverse_rates):
        if col in fit.dropped:
            continue
        if col.startswith("rate:"):
            o, _, d = col[len("rate:"):].partition("->")
            lines.append(f"| `{col}` | {template.transfer_rates[(o, d)]:.3g} "
                         f"B/s | {1.0 / x:.4g} B/s |")
        else:
            dt = col[len("arith:"):]
            lines.append(f"| `{col}` | {template.arith_rate[dt]:.3g} ops/s "
                         f"| {1.0 / x:.4g} ops/s |")
    # same samples, one extra design-matrix column: a fixed cost per
    # micro-kernel dispatch.  insample MAPE is the honest comparison (the
    # overhead term is not a spec rate, so validate_spec cannot see it).
    _, fit_oh = measure.fit_from_store(store, "host-cpu",
                                       name="host-cpu-measured-oh",
                                       date=None, on_nonpositive="free",
                                       overhead_per_block=True)

    w = val.worst
    lines += [
        "",
        f"- fitted-model accuracy: **MAPE {val.mape:.1f}%** over "
        f"{len(val.rows)} cells (median {val.median_ape:.1f}%, worst "
        f"{100 * w.ape:.1f}% on `{w.sample.cell}`)",
        f"- placeholder-template accuracy on the same samples: "
        f"MAPE {baseline.mape:.1f}% — the fit buys "
        f"{baseline.mape / max(val.mape, 1e-9):.1f}x",
        "- per-micro-kernel error profile (shared arithmetic rate):",
    ]
    for mk, g in val.per_micro_kernel().items():
        lines.append(f"  - `{mk}`: {g['cells']} cells, "
                     f"MAPE {g['mape_pct']:.1f}%, bias {g['bias_pct']:+.1f}%")
    oh = fit_oh.overhead_per_block_s
    what = (f"{oh * 1e6:.3g} µs/dispatch" if oh is not None
            else "column fit nonpositive and was dropped — the host-numpy "
                 "replay prices the same loop nest the model does, so "
                 "there is no real dispatch cost to find")
    lines += [
        f"- `overhead_per_block` refit on the same samples: {what}; "
        f"in-sample MAPE {fit.insample_mape_pct:.1f}% -> "
        f"{fit_oh.insample_mape_pct:.1f}% "
        f"({fit.insample_mape_pct - fit_oh.insample_mape_pct:+.1f} pts)",
    ]
    lines += [
        "",
        f"- store + fitted manifest under `{store_dir}` "
        f"(samples keyed by geometry fingerprint "
        f"`{spec.geometry_fingerprint()}`)",
    ]
    return lines


if __name__ == "__main__":
    print("\n".join(run(*sys.argv[1:2])))
