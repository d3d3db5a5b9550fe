"""Serving driver: the continuous-batching engine over an initialised model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \\
        --requests 8 --max-new 12
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch granite-moe-3b-a800m --requests 4 --max-new 6
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --autoconfigure --backend cuda --machine h100-measured \\
        --slo-p99 0.35 --rate 5 --trace /tmp/trace.json

The counterpart of ``repro.launch.serve``.  Like it, the CLI serves the
config's smoke reduction of any of the ten archs (``--arch``);
``serve_demo(..., smoke=False)`` serves the full width.  It runs on the
card (``--device cuda``, the default) and exits 2 when there is none;
``--device cpu`` runs the kernels' plain versions on the host.
``--autoconfigure`` picks the engine's operating point from the deployment
report (with ``--slo-p99``, by simulated SLO attainment); ``--backend``
names the planner that prices it, ``analytic-tpu`` by default as in the
JAX package, ``cuda`` for the card.  ``--ckpt-dir`` waits for the
checkpoint manager and is refused with a message.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.interop import require_device
from repro_torch.models.common import HOST_MESH
from repro_torch.models.model import LM
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.resilience import retry_with_backoff

#: flag -> the module it waits for
NOT_PORTED = {
    "--ckpt-dir": "checkpoint/manager.py",
}


def serve_demo(arch: str, *, smoke: bool = True, n_requests: int = 8,
               max_new: int = 12, max_batch: int = 4, max_len: int = 256,
               seed: int = 0, autoconfigure: bool = False,
               machine: str | None = None, memory: bool = True,
               precisions=(), slo=None, traffic=None,
               backend: str = "analytic-tpu",
               deadline_s: float | None = None,
               queue_limit: int | None = None, faults=None,
               on_truncate: str = "raise",
               trace_path: str | None = None, trace_out: str | None = None,
               device="cuda") -> dict:
    """Serve ``n_requests`` random prompts of 3-11 tokens with a model of
    random weights drawn from ``seed``.  With ``autoconfigure`` the engine
    comes from ``ServingEngine.autoconfigure`` (``machine``, ``memory``,
    ``precisions``, ``slo``, ``traffic``, ``faults`` and the planning
    ``backend`` go to it; ``max_batch`` is its pick).  Returns the counts,
    the wall time, the engine's step times, the number of prefills, each
    request's generated tokens and the ``perf_report()``."""
    if trace_out:
        # span tracing costs nothing until enabled; a Chrome-trace export
        # without spans would be instants-only, so asking for one opts in
        obs.enable()
    dev = require_device(device)
    cfg = get_config(arch, smoke=smoke)
    lm = LM(cfg, HOST_MESH, device=dev)
    values = lm.init(torch.Generator(device=dev).manual_seed(seed))
    if autoconfigure:
        # rank the (machine x dtype x batch) deployment grid — memory-
        # infeasible cells pruned against each machine's budget — and let
        # the analytic model pick machine/max_batch/plans.  With an SLO,
        # the surviving cells are additionally run through the discrete-
        # event simulator (repro_torch.simulate) and the pick is by
        # *simulated* SLO attainment rather than peak throughput.
        eng = ServingEngine.autoconfigure(lm, values, machine=machine,
                                          dtypes=("bf16", "int8"),
                                          batches=(1, 2, 4, 8, 16),
                                          max_len=max_len, backend=backend,
                                          memory=memory,
                                          precisions=precisions,
                                          slo=slo, traffic=traffic,
                                          faults=faults,
                                          deadline_s=deadline_s,
                                          queue_limit=queue_limit)
        ac = eng.autoconfig
        print(eng.deployment_report.table(limit=8))
        print(f"autoconfigured: max_batch={ac['max_batch']} "
              f"dtype={ac['dtype']} machine={ac['machine']} "
              f"({ac['predicted_tokens_per_second']:.0f} pred tok/s, "
              f"{ac['memory_headroom_bytes'] / 2**30:.2f} GiB headroom)")
        if "slo" in ac:
            sim = ac["slo"]["sim"]
            mode = "robust SLO" if ac["slo"].get("faults") else "SLO"
            under = ac["slo"]["traffic"] + (
                f" + faults={ac['slo']['faults']}"
                if ac["slo"].get("faults") else "")
            print(f"  {mode} mode ({under}): simulated p99 "
                  f"latency {sim['latency']['p99']:.4g}s, goodput "
                  f"{sim['goodput_tps']:.4g} tok/s, "
                  f"{len(ac['slo']['rejected'])} cell(s) rejected")
    else:
        eng = ServingEngine(lm, values, max_batch=max_batch, max_len=max_len,
                            deadline_s=deadline_s, queue_limit=queue_limit)
    del values
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for i in range(n_requests):
        plen = int(rng.integers(3, 12))
        prompt = rng.integers(0, cfg.vocab_size, size=plen).tolist()
        req = Request(rid=i, prompt=prompt, max_new_tokens=max_new)
        if queue_limit is None:
            eng.submit(req)
        else:
            # bounded queue: on QueueFullError the retry's backpressure is
            # "let the server catch up" — step the engine until a queue
            # slot frees instead of sleeping wall-clock
            def _catch_up(_dt):
                for _ in range(64):
                    eng.step()
                    if len(eng.queue) < queue_limit:
                        return
            retry_with_backoff(lambda: eng.submit(req), sleep=_catch_up)
    done = eng.run_until_drained(on_truncate=on_truncate)
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in done)
    print(f"served {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s) on {dev}")
    perf = eng.perf_report()
    if "measured_requests" in perf:
        m = perf["measured_requests"]
        print(f"  measured: mean latency {m['latency_s']['mean']:.3f}s, "
              f"p95 {m['latency_s']['p95']:.3f}s, mean wait "
              f"{m['wait_s']['mean']:.3f}s")
    res = perf.get("resilience")
    if res:
        deg = res["degraded"]
        print(f"  resilience: shed {res['shed']['count']} "
              f"({res['shed']['causes'] or 'none'}), expired "
              f"{res['expired']}, rejected submits "
              f"{res['rejected_submits']}, rung "
              f"{deg['rung'] or 'nominal'} "
              f"({len(deg['events'])} ladder event(s))")
        if res.get("truncated"):
            print(f"  WARNING: drain truncated with "
                  f"{res['truncated']['active']} active / "
                  f"{res['truncated']['queued']} queued after "
                  f"{res['truncated']['max_steps']} steps")
    for r in sorted(done, key=lambda r: r.rid)[:4]:
        print(f"  req{r.rid}: prompt[:6]={r.prompt[:6]} -> {r.generated}")
    if trace_path:
        with open(trace_path, "w") as f:
            json.dump(eng.trace_json(), f, indent=1, sort_keys=True)
        print(f"wrote event trace to {trace_path} "
              f"(replay: python -m repro_torch.simulate replay --trace "
              f"{trace_path})")
    mach = perf["machine"]
    print(f"  drift: {perf['drift_status']} "
          f"(predicted step {perf['predicted_gemm_seconds_per_step']:.3g}s "
          f"on {mach['name']}"
          f"{', uncalibrated' if mach['uncalibrated'] else ''} vs measured "
          f"— see perf_report()['drift'])")
    if trace_out:
        doc = obs.save_chrome_trace(trace_out)
        print(f"wrote Chrome trace to {trace_out} "
              f"({doc['metadata']['spans']} spans, "
              f"{doc['metadata']['events']} events; open in "
              f"chrome://tracing or ui.perfetto.dev)")
    steps = [e for e in eng.trace_events if e["type"] == "step"]
    return {"requests": len(done), "tokens": toks, "seconds": dt,
            "steps": [{"dt": e["dt"], "admitted": len(e["admitted"]),
                       "active": e["active"]} for e in steps],
            "prefills": sum(1 for e in eng.trace_events
                            if e["type"] == "admit" and e["bucket"]),
            "generated": {r.rid: list(r.generated) for r in done},
            "perf": perf}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="not ported yet: " + "; ".join(
            f"{flag} (waits for {waits})"
            for flag, waits in NOT_PORTED.items()))
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs "
                         "the kernels' plain versions)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--autoconfigure", action="store_true",
                    help="pick machine/max_batch/plans by ranking the "
                         "memory-feasible (machine x dtype x batch) grid "
                         "instead of using --max-batch")
    ap.add_argument("--machine", default=None,
                    help="machine name/glob for --autoconfigure "
                         "(e.g. h100, h100-measured, 'zoo/*')")
    ap.add_argument("--backend", default="analytic-tpu",
                    help="planning backend for --autoconfigure (default "
                         "analytic-tpu, the JAX package's; cuda prices "
                         "the card with the Hopper tile model)")
    ap.add_argument("--precision", nargs="*", default=None,
                    metavar="AxB[->ACC][@kv=KV]",
                    help="mixed-precision what-if cells for "
                         "--autoconfigure's ranking table, e.g. "
                         "int4xint8->int32")
    ap.add_argument("--no-memory", action="store_true",
                    help="autoconfigure on throughput alone, ignoring the "
                         "deployment-memory budget")
    ap.add_argument("--slo-p99", type=float, default=None,
                    help="with --autoconfigure: pick by simulated SLO "
                         "attainment under Poisson traffic instead of "
                         "peak throughput (p99 latency bound, seconds)")
    ap.add_argument("--rate", type=float, default=None,
                    help="arrival rate (req/s) for the --slo-p99 traffic "
                         "scenario; default derives one from the report")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request latency deadline, seconds — arms "
                         "deadline-aware admission/shedding")
    ap.add_argument("--faults", default=None,
                    help="fault scenario name for robust --autoconfigure "
                         "(e.g. throttle20; implies robust SLO mode)")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="bounded submit queue; overflow raises "
                         "QueueFullError and the driver retries with "
                         "backpressure (engine steps)")
    ap.add_argument("--on-truncate", choices=["raise", "report"],
                    default="raise",
                    help="partial-drain policy: raise (default) or record "
                         "the truncation in perf_report and keep going")
    ap.add_argument("--trace", default=None,
                    help="write the engine's event trace JSON here "
                         "(consumed by python -m repro_torch.simulate "
                         "replay)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace/Perfetto JSON of the run "
                         "(spans + events; enables span tracing)")
    a, unknown = ap.parse_known_args(argv)
    if unknown:
        later = [f"{flag} (it waits for {NOT_PORTED[flag]})"
                 for flag in (u.split("=")[0] for u in unknown)
                 if flag in NOT_PORTED]
        ap.error(f"unrecognized arguments: {' '.join(unknown)}"
                 + (f"; not ported to repro_torch yet: {', '.join(later)}"
                    if later else ""))
    slo = traffic = None
    if a.slo_p99 is not None:
        from repro_torch.simulate import SLO, PoissonTraffic
        slo = SLO(p99_latency_s=a.slo_p99)
        if a.rate is not None:
            traffic = PoissonTraffic(rate=a.rate, prompt_len=16,
                                     decode_len=a.max_new)
    elif a.faults is not None:
        ap.error("--faults needs --slo-p99 (robust autoconfiguration is "
                 "SLO attainment under perturbation)")
    try:
        require_device(a.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    serve_demo(a.arch, n_requests=a.requests, max_new=a.max_new,
               max_batch=a.max_batch, max_len=a.max_len,
               autoconfigure=a.autoconfigure, machine=a.machine,
               memory=not a.no_memory, precisions=a.precision or (),
               slo=slo, traffic=traffic, backend=a.backend,
               deadline_s=a.deadline, queue_limit=a.queue_limit,
               faults=a.faults, on_truncate=a.on_truncate,
               trace_path=a.trace, trace_out=a.trace_out, device=a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
