"""Online prediction-drift study: a throttle flips the monitor mid-run
(EXPERIMENTS.md).

The offline calibration gate (`repro_torch.measure.fit_from_store`) refuses to
refit when the median measured/predicted ratio drifts beyond 0.2 — but it
only looks when someone re-measures.  `repro_torch.obs.DriftMonitor` watches the
same statistic *online*: every serving/simulation step feeds one
(predicted, measured) pair into a rolling window keyed by machine.  This
study drives the gap9-fc acceptance cell twice through the serving
simulator:

* **control** — no faults; the simulator's analytic costs match the
  model's predictions exactly, so the ratio pins at 1.0 and the verdict
  stays `ok` for the whole run;
* **throttle50** — a 2x thermal throttle with 50% duty (5s of every
  10s).  Probes sampled twice a second show the verdict flipping
  `ok -> stale` inside each throttle window and *recovering* once the
  window passes — the rolling window ages the fault out, which a
  cumulative statistic would not.

The same monitor runs inside the real `ServingEngine` (see
`perf_report()["drift"]`); the simulator variant is used here because its
un-faulted ratio is exactly 1.0, isolating the injected effect.

Prints markdown; EXPERIMENTS.md records the committed output.

The torch twin of ``experiments/drift_study.py``: the same ``run()`` on
``repro_torch``, whose lines equal the JAX study's, the commands
they quote included (``tests/test_torch_studies.py``).

  PYTHONPATH=src python experiments/drift_study_torch.py
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config
from repro_torch.simulate import PoissonTraffic, ServiceModel
from repro_torch.simulate.engine import Simulator
from repro_torch.simulate.faults import SCENARIOS, FaultScenario
from repro_torch.simulate.server import SlotServer

MACHINE = "gap9-fc"
DTYPE = "int8"
BATCH = 4
RATE = 5.0
REQUESTS = 100
DECODE_LEN = 8
PROBE_EVERY_S = 0.5
FAULTS = SCENARIOS["throttle50"]  # 2x throttle, 5s of every 10s


def _run(service: ServiceModel,
         faults: FaultScenario | None) -> tuple[list[dict], dict]:
    """One simulated run with drift probes; returns (probes, report)."""
    traffic = PoissonTraffic(rate=RATE, prompt_len=16, decode_len=DECODE_LEN,
                             seed=0)
    sim = Simulator(seed=0)
    server = SlotServer(sim, service, max_batch=BATCH, faults=faults,
                        drift_key=MACHINE)
    server.drive(traffic.requests(REQUESTS))
    probes: list[dict] = []

    def probe():
        probes.append({
            "t": sim.now,
            "throttled": (faults.service_scale(sim.now) > 1.0
                          if faults else False),
            "status": server.drift.status(MACHINE),
            "median_ratio": server.drift.median_ratio(MACHINE),
        })
        if sim.pending():
            sim.schedule(PROBE_EVERY_S, probe)

    sim.schedule(PROBE_EVERY_S, probe)
    sim.run()
    return probes, server.drift.report(MACHINE)


def _timeline(probes: list[dict]) -> str:
    """One char per probe: . ok, w warn, S stale (upper = throttling)."""
    sym = {"ok": ".", "warn": "w", "stale": "S"}
    return "".join(sym[p["status"]] for p in probes)


def run() -> list[str]:
    cfg = get_config("qwen2-1.5b", smoke=True)
    service = ServiceModel.from_plans(cfg, batch=BATCH, machine=MACHINE,
                                      dtype=DTYPE)
    control_probes, control = _run(service, None)
    fault_probes, faulted = _run(service, FAULTS)

    assert all(p["status"] == "ok" for p in control_probes), \
        "un-faulted control must stay ok at every probe"
    assert control["keys"][MACHINE]["median_ratio"] == 1.0
    stale = [p for p in fault_probes if p["status"] == "stale"]
    assert stale, "the throttle must flip the monitor stale mid-run"
    recovered = any(p["status"] == "ok" and p["t"] > stale[0]["t"]
                    for p in fault_probes)
    assert recovered, "the rolling window must recover between windows"

    w = FAULTS.throttles[0]
    lines = [
        f"`{MACHINE}` dtype={DTYPE} batch={BATCH}, {RATE:g} req/s Poisson "
        f"(prompt 16, decode {DECODE_LEN}, {REQUESTS} requests); "
        f"`DriftMonitor` probed every {PROBE_EVERY_S:g}s.  Fault: "
        f"`{FAULTS.name}` — {w.factor:g}x throttle for {w.duration_s:g}s "
        f"of every {FAULTS.period_s:g}s.",
        "",
        "| run | verdict timeline (1 char / probe: `.` ok, `w` warn, "
        "`S` stale) | final | final median ratio |",
        "|---|---|---|---|",
        f"| control | `{_timeline(control_probes)}` | {control['status']} "
        f"| {control['keys'][MACHINE]['median_ratio']:.3f} |",
        f"| {FAULTS.name} | `{_timeline(fault_probes)}` | "
        f"{faulted['status']} "
        f"| {faulted['keys'][MACHINE]['median_ratio']:.3f} |",
        "",
        f"The control pins at ratio 1.000 (analytic service times equal "
        f"the model's predictions) and never leaves `ok`.  Under "
        f"`{FAULTS.name}` the verdict flips to `stale` "
        f"{sum(1 for p in stale)} of {len(fault_probes)} probes — first at "
        f"t={stale[0]['t']:.1f}s, inside the first throttle window — and "
        f"recovers to `ok` between windows as the {faulted['window']}-"
        f"sample rolling window ages the throttled steps out.",
    ]
    return lines


if __name__ == "__main__":
    print("\n".join(run()))
