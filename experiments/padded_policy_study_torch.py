"""Batched `padded`-policy Table-2 study (see EXPERIMENTS.md).

The paper's analytic accounting charges partial (edge) tiles their exact
byte ratios; a real blocked implementation pays full-tile cost on edges.
The simulator exposes both as policies ("analytic" vs "padded"), and the
bulk sweep makes the sensitivity cheap to chart across the whole
MobileNetV1 workload: one `repro_torch.gemm.sweep` call crosses all 19 Table-2
layers x 3 variants x both policies (114 planned grid points).

Prints the per-layer sensitivity table as markdown; EXPERIMENTS.md records
the committed output.

The torch twin of ``experiments/padded_policy_study.py``: the same ``run()`` on
``repro_torch``, whose lines equal the JAX study's, the commands
they quote included (``tests/test_torch_studies.py``).

  PYTHONPATH=src python experiments/padded_policy_study_torch.py
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import gemm
from repro_torch.core.mobilenet import TABLE2
from repro_torch.core.variants import Variant


def run() -> list[str]:
    probs = [row.problem for row in TABLE2]
    res = gemm.sweep(probs, backends=["analytic-gap8"],
                     variants=list(Variant),
                     policies=["analytic", "padded"], cache=False)

    lines = [
        "| layer | variant | analytic mk | padded mk | analytic s "
        "| padded s | overhead |",
        "|---|---|---|---|---|---|---|",
    ]
    worst = (0.0, None)
    flips = 0
    tot = {"analytic": 0.0, "padded": 0.0}
    for row in TABLE2:
        for v in Variant:
            a = res.filter(variant=v.value, policy="analytic")
            p = res.filter(variant=v.value, policy="padded")
            ra = next(r for r in a if r.problem.m == row.m
                      and r.problem.n == row.n and r.problem.k == row.k)
            rp = next(r for r in p if r.problem.m == row.m
                      and r.problem.n == row.n and r.problem.k == row.k)
            over = rp.seconds / ra.seconds - 1.0
            tot["analytic"] += ra.seconds
            tot["padded"] += rp.seconds
            mka = str(ra.plan.estimate().micro_kernel)
            mkp = str(rp.plan.estimate().micro_kernel)
            flip = " *" if mka != mkp else ""
            flips += mka != mkp
            if over > worst[0]:
                worst = (over, (row.layer, v.value))
            lines.append(
                f"| {row.layer} | {v.value} | {mka} | {mkp}{flip} "
                f"| {ra.seconds:.4f} | {rp.seconds:.4f} | {over * 100:+.2f}% |")
    lines += [
        "",
        f"- grid: {res.stats['grid_points']} planned points "
        f"({res.stats['problems']} problems x 3 variants x 2 policies), "
        f"one bulk `sweep` call",
        f"- whole-workload overhead of padded accounting: "
        f"{(tot['padded'] / tot['analytic'] - 1) * 100:+.2f}% "
        f"({tot['analytic']:.2f}s -> {tot['padded']:.2f}s summed over the "
        f"grid)",
        f"- worst single cell: {worst[0] * 100:+.2f}% "
        f"(layer {worst[1][0]}, {worst[1][1]})",
        f"- micro-kernel selection flips between policies: {flips}/57 "
        f"(flipped cells marked `*`)",
    ]
    return lines


if __name__ == "__main__":
    print("\n".join(run()))
