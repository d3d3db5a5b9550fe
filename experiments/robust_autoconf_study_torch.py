"""Fair-weather vs perturbation-robust SLO autoconfiguration (EXPERIMENTS.md).

The sim-backed SLO pick (`experiments/sim_slo_study.py`) chooses the cell
with the best *nominal* tail — which on a compute-bound edge machine means
the smallest batch that keeps up, i.e. the cell with the least headroom.
This study injects a duty-cycled thermal throttle
(`repro_torch.simulate.faults.throttle_scenario`) into the same gap9-fc
acceptance scenario and measures what that missing headroom costs:

* per batch, the simulated p99 latency in fair weather and under the
  throttle — the dilation is far from uniform across batches;
* the `evaluate_deployment` pick without faults (fair) and with faults
  (robust), and the p99 each achieves *under* the throttle — the gap
  between them is the price of autoconfiguring for fair weather.

Prints markdown; EXPERIMENTS.md records the committed output.

The torch twin of ``experiments/robust_autoconf_study.py``: the same ``run()`` on
``repro_torch``, whose lines equal the JAX study's, the commands
they quote included (``tests/test_torch_studies.py``).

  PYTHONPATH=src python experiments/robust_autoconf_study_torch.py
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
    throttle_scenario,
)
from repro_torch.simulate.autoconf import FAULT_REJECT_PREFIX

MACHINE = "gap9-fc"
BATCHES = (1, 2, 4, 8, 16)
RATE = 5.0
SLO_P99 = 0.45
REQUESTS = 150
FAULTS = throttle_scenario(factor=1.3, duty=0.2, period_s=10.0)


def _traffic() -> PoissonTraffic:
    return PoissonTraffic(rate=RATE, prompt_len=16, decode_len=16, seed=0)


def run() -> list[str]:
    cfg = get_config("qwen2-1.5b", smoke=True)
    report = plan_deployment(cfg, machines=(MACHINE,), batches=BATCHES,
                             dtypes=("bf16",))
    options = {o.batch: o for o in report.options}
    batches = sorted(options)
    services = {
        b: ServiceModel.from_plans(cfg, batch=b, machine=MACHINE,
                                   decode_step_s=o.seconds_per_step)
        for b, o in options.items()}

    lines = [
        f"simulated p99 latency (s) on {MACHINE}, {RATE:g} req/s Poisson "
        f"(prompt 16, decode 16, {REQUESTS} requests), fair weather vs "
        f"{FAULTS.name} ({FAULTS.throttles[0].factor}x throttle, "
        f"{FAULTS.throttles[0].duration_s:g}s of every "
        f"{FAULTS.period_s:g}s):",
        "",
        "| batch | " + " | ".join(map(str, batches)) + " |",
        "|---|" + "---|" * len(batches)]
    p99 = {}
    for label, faults in (("fair", None), (FAULTS.name, FAULTS)):
        cells = []
        for b in batches:
            rep = simulate_serving(services[b], _traffic(), max_batch=b,
                                   requests=REQUESTS, faults=faults)
            p99[(label, b)] = rep.latency["p99"]
            cells.append(f"{rep.latency['p99']:.3f}"
                         if rep.finite else "unstable")
        lines.append(f"| {label} | " + " | ".join(cells) + " |")
    lines.append("")

    slo = SLO(p99_latency_s=SLO_P99)
    fair = evaluate_deployment(cfg, report, slo=slo, traffic=_traffic(),
                               requests=REQUESTS, attach=False)
    robust = evaluate_deployment(cfg, report, slo=slo, traffic=_traffic(),
                                 requests=REQUESTS, faults=FAULTS,
                                 attach=False)
    fb, rb = fair.option.batch, robust.option.batch
    fair_under = p99[(FAULTS.name, fb)]
    robust_under = p99[(FAULTS.name, rb)]
    coded = sorted({r.reason for r in robust.rejections
                    if r.reason.startswith(FAULT_REJECT_PREFIX)})
    lines += [
        f"fair pick (SLO p99<={SLO_P99}s, no faults): batch **{fb}** "
        f"(nominal p99 {p99[('fair', fb)]:.3f}s) — under {FAULTS.name} it "
        f"degrades to **{fair_under:.3f}s**, violating the SLO",
        "",
        f"robust pick (same SLO, faults={FAULTS.name}): batch **{rb}** "
        f"(p99 {robust_under:.3f}s under the throttle, "
        f"{len(robust.rejections)} cell(s) rejected, reasons {coded})",
        "",
        f"p99 gap under the throttle, fair pick vs robust pick: "
        f"{fair_under:.3f}s vs {robust_under:.3f}s "
        f"({fair_under / robust_under:.2f}x of the robust tail, "
        f"{1000 * (fair_under - robust_under):+.0f}ms)",
        ""]
    return lines


def main() -> None:
    for line in run():
        print(line)


if __name__ == "__main__":
    main()
