"""Arrival-rate x batch x policy serving-simulation study (EXPERIMENTS.md).

Crosses two zoo machines through the discrete-event simulator
(`repro_torch.simulate`) at several Poisson arrival rates: the smoke-size
qwen2-1.5b served on

* ``gap9-fc`` — compute-bound at decode, so the step time *grows* with the
  slot pool and the simulated p99 latency is U-shaped in the batch
  (queueing kills small batches, step-time dilation kills big ones);
* ``cortex-m7`` — memory-bound at these batches, step time ~flat, so a
  bigger batch never hurts the tail and the SLO pick equals the
  throughput pick.

The headline is the gap9-fc acceptance scenario: the peak-throughput
configuration (batch 16) violates a 0.35s p99 SLO that the sim-backed
``evaluate_deployment`` avoids by picking batch 4 — the exact divergence
``ServingEngine.autoconfigure(slo=...)`` acts on.

Prints markdown; EXPERIMENTS.md records the committed output.

The torch twin of ``experiments/sim_slo_study.py``: the same ``run()`` on
``repro_torch``, whose lines equal the JAX study's, the commands
they quote included (``tests/test_torch_studies.py``).

  PYTHONPATH=src python experiments/sim_slo_study_torch.py
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config
from repro_torch.serving.report import plan_deployment
from repro_torch.simulate import (
    SLO,
    PoissonTraffic,
    ServiceModel,
    evaluate_deployment,
    simulate_serving,
)

BATCHES = (1, 2, 4, 8, 16)
RATES = {"gap9-fc": (1.0, 2.0, 5.0), "cortex-m7": (20.0, 40.0, 60.0)}
SLO_P99 = {"gap9-fc": 0.35, "cortex-m7": 0.35}
REQUESTS = 150


def _traffic(rate: float) -> PoissonTraffic:
    return PoissonTraffic(rate=rate, prompt_len=16, decode_len=16, seed=0)


def run() -> list[str]:
    cfg = get_config("qwen2-1.5b", smoke=True)
    lines: list[str] = []
    for machine, rates in RATES.items():
        report = plan_deployment(cfg, machines=(machine,), batches=BATCHES,
                                 dtypes=("bf16",))
        options = {o.batch: o for o in report.options}
        batches = sorted(options)  # memory-infeasible cells already pruned
        services = {
            b: ServiceModel.from_plans(cfg, batch=b, machine=machine,
                                       decode_step_s=o.seconds_per_step)
            for b, o in options.items()}

        lines += [f"### {machine}", "",
                  "simulated p99 latency (s), greedy admission "
                  f"({REQUESTS} Poisson requests, prompt 16, decode 16):",
                  "",
                  "| rate \\ batch | " + " | ".join(map(str, batches))
                  + " |",
                  "|---|" + "---|" * len(batches)]
        for rate in rates:
            cells = []
            for b in batches:
                rep = simulate_serving(services[b], _traffic(rate),
                                       max_batch=b, requests=REQUESTS)
                cells.append(f"{rep.latency['p99']:.3f}"
                             if rep.finite else "unstable")
            lines.append(f"| {rate:g} req/s | " + " | ".join(cells) + " |")
        lines.append("")

        # admission-policy sensitivity at the machine's heaviest rate
        rate = rates[-1]
        b = max(batches)
        pol = {}
        for policy in ("greedy", "drain-first"):
            rep = simulate_serving(services[b], _traffic(rate),
                                   max_batch=b, policy=policy,
                                   requests=REQUESTS)
            pol[policy] = rep
        lines += [
            f"policy sensitivity at batch {b}, {rate:g} req/s: greedy p99 "
            f"{pol['greedy'].latency['p99']:.3f}s vs drain-first "
            f"{pol['drain-first'].latency['p99']:.3f}s "
            f"(batch-synchronous draining "
            f"{pol['drain-first'].latency['p99'] / pol['greedy'].latency['p99']:.2f}x)",
            ""]

        # the SLO-vs-throughput divergence
        base = report.select()
        traffic = _traffic(rates[-1])
        try:
            sel = evaluate_deployment(cfg, report, slo=SLO(
                p99_latency_s=SLO_P99[machine]), traffic=traffic,
                requests=REQUESTS)
            picked = sel.option.batch
            p99 = sel.sim.latency["p99"]
            n_rej = len(sel.rejections)
            lines += [
                f"throughput pick: batch {base.batch} "
                f"({base.tokens_per_second:.0f} peak tok/s); "
                f"SLO(p99<={SLO_P99[machine]}s) pick under {traffic.name}: "
                f"batch **{picked}** (sim p99 {p99:.3f}s, {n_rej} cell(s) "
                f"rejected with machine-readable slo_* reasons)",
                ""]
        except ValueError as e:
            lines += [f"SLO infeasible: {e}", ""]
    return lines


def main() -> None:
    for line in run():
        print(line)


if __name__ == "__main__":
    main()
