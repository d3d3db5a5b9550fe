"""Serving-simulation command line.

    python -m repro_torch.simulate run --arch qwen2-1.5b \\
        --machine tpu-v5e --batch 8 --traffic poisson --rate 200 \\
        --requests 500
    python -m repro_torch.simulate replay --trace trace.json
    python -m repro_torch.simulate replay --trace trace.json --model \\
        --backend cuda --machine h100-measured
    python -m repro_torch.simulate sweep --arch qwen2-1.5b \\
        --machine gap9-fc --smoke --batches 1 2 4 8 16 --rate 5 \\
        --slo-p99 0.35

``run`` simulates one serving cell — service times priced by the analytic
planner for the given ``(machine, dtype, batch)`` — under an open-loop
traffic scenario and prints the latency/goodput report.  ``replay``
re-enacts a recorded ``ServingEngine`` trace (measured step durations by
default; ``--model`` prices steps analytically instead) and reports the
sim-vs-real verdict.  ``sweep`` crosses a deployment report's feasible
cells with admission policies under one scenario and selects by SLO
attainment.  Everything is config-only — no parameters, no tensors — so
full-size architectures simulate in milliseconds.  The counterpart of
``python -m repro.simulate``: the same flags, defaults and text.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.configs import ARCH_IDS, get_config


def _length(spec: str):
    """``16`` -> fixed, ``8:100`` -> uniform, ``geo:64`` -> geometric."""
    if spec.startswith("geo:"):
        return {"kind": "geometric", "lo": 1, "mean": float(spec[4:])}
    if ":" in spec:
        lo, hi = spec.split(":", 1)
        return (int(lo), int(hi))
    return int(spec)


def _traffic(args):
    from repro_torch.simulate.traffic import make_traffic

    kw = dict(rate=args.rate, prompt_len=_length(args.prompt_len),
              decode_len=_length(args.decode_len), seed=args.seed)
    if args.traffic == "bursty":
        kw["burst"] = args.burst
    return make_traffic(args.traffic, **kw)


def cmd_run(args) -> int:
    from repro_torch import obs
    from repro_torch.simulate.server import ServiceModel, simulate_serving

    if args.trace_out:
        obs.enable()
    cfg = get_config(args.arch, smoke=args.smoke)
    service = ServiceModel.from_plans(
        cfg, batch=args.batch, machine=args.machine, dtype=args.dtype,
        backend=args.backend, max_len=args.max_len)
    traffic = _traffic(args)
    report = simulate_serving(
        service, traffic, max_batch=args.batch, max_len=args.max_len,
        policy=args.policy, requests=args.requests, horizon=args.horizon,
        deadline_s=args.deadline, queue_limit=args.queue_limit,
        faults=args.faults,
        config={"arch": cfg.name, "machine": args.machine,
                "dtype": args.dtype})
    print(f"simulated {cfg.name} on {args.machine or 'native'} "
          f"dtype={args.dtype} batch={args.batch} policy={args.policy} "
          f"under {traffic.name}"
          + (f" faults={args.faults}" if args.faults else ""))
    print(report.table())
    if args.json:
        report.save(args.json)
        print(f"wrote {args.json}")
    if args.trace_out:
        doc = obs.save_chrome_trace(args.trace_out)
        print(f"wrote Chrome trace to {args.trace_out} "
              f"({doc['metadata']['spans']} spans; open in "
              f"chrome://tracing or ui.perfetto.dev)")
    return 0 if report.finite else 1


def cmd_replay(args) -> int:
    from repro_torch.simulate.replay import load_trace, replay
    from repro_torch.simulate.server import ServiceModel

    trace = load_trace(args.trace)
    service = None
    if args.model:
        cfg = get_config(args.arch, smoke=args.smoke)
        service = ServiceModel.from_plans(
            cfg, batch=trace["max_batch"], machine=args.machine,
            dtype=args.dtype, backend=args.backend,
            max_len=trace["max_len"])
    report = replay(trace, service, policy=args.policy)
    print(report.table(limit=args.limit))
    if args.json:
        report.save(args.json)
        print(f"wrote {args.json}")
    return 0 if report.order_match else 1


def cmd_sweep(args) -> int:
    from repro_torch.serving.report import plan_deployment
    from repro_torch.simulate.autoconf import SLO, evaluate_deployment

    cfg = get_config(args.arch, smoke=args.smoke)
    report = plan_deployment(
        cfg, machines=args.machine, dtypes=args.dtypes,
        batches=args.batches, max_len=args.max_len, backend=args.backend)
    if not report.options:
        print("no memory-feasible cells to simulate", file=sys.stderr)
        return 1
    slo = SLO(p99_latency_s=args.slo_p99, p95_ttft_s=args.slo_ttft,
              min_goodput_tps=args.slo_goodput,
              max_shed_fraction=args.slo_shed)
    traffic = _traffic(args) if args.rate is not None else None
    try:
        sel = evaluate_deployment(
            cfg, report, slo=slo, traffic=traffic, policies=args.policies,
            requests=args.requests, seed=args.seed, faults=args.faults,
            deadline_s=args.deadline, queue_limit=args.queue_limit)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    print(f"SLO sweep for {cfg.name} under {sel.traffic_name} "
          + (f"with faults={sel.faults} " if sel.faults else "")
          + f"({len(sel.results)} cells, {len(sel.rejections)} rejected)")
    hdr = (f"{'machine':<18}{'dtype':<7}{'batch':>6}  {'policy':<13}"
           f"{'p99 lat':>10}{'p95 ttft':>10}{'goodput':>10}  slo")
    print(hdr)
    for r in sorted(sel.results,
                    key=lambda r: (r["machine"], r["dtype"], r["batch"])):
        print(f"{r['machine']:<18}{r['dtype']:<7}{r['batch']:>6}  "
              f"{r['policy']:<13}{r['p99_latency_s']:>10.4f}"
              f"{r['p95_ttft_s']:>10.4f}{r['goodput_tps']:>10.1f}  "
              + ("ok" if r["slo_attained"]
                 else ",".join(v["reason"] for v in r["violations"])))
    o = sel.option
    print(f"selected: {o.machine} dtype={o.dtype} max_batch={o.batch} "
          f"policy={sel.policy} (sim p99 "
          f"{sel.sim.latency['p99']:.4f}s, goodput "
          f"{sel.sim.goodput_tps:.1f} tok/s)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(sel.as_dict(), f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.json}")
    return 0


def _traffic_args(p, rate_default):
    p.add_argument("--traffic", choices=["poisson", "uniform", "bursty"],
                   default="poisson")
    p.add_argument("--rate", type=float, default=rate_default,
                   help="arrival rate, requests/second")
    p.add_argument("--burst", type=int, default=8,
                   help="burst size for --traffic bursty")
    p.add_argument("--prompt-len", default="32",
                   help="int | lo:hi | geo:MEAN prompt-length distribution")
    p.add_argument("--decode-len", default="16",
                   help="int | lo:hi | geo:MEAN decode-length distribution")
    p.add_argument("--seed", type=int, default=0)


def _resilience_args(p):
    from repro_torch.simulate.faults import SCENARIOS
    p.add_argument("--faults", default=None,
                   help="named fault scenario to inject: "
                        + "|".join(sorted(SCENARIOS)))
    p.add_argument("--deadline", type=float, default=None, dest="deadline",
                   help="per-request latency deadline, seconds "
                        "(arms deadline-aware shedding)")
    p.add_argument("--queue-limit", type=int, default=None,
                   help="bounded queue depth (overflow is shed)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.simulate")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="simulate one serving cell")
    p.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b")
    p.add_argument("--machine", default="tpu-v5e")
    p.add_argument("--dtype", default="bf16")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--policy", default="greedy")
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--backend", default="analytic-tpu")
    p.add_argument("--requests", type=int, default=200)
    p.add_argument("--horizon", type=float, default=None,
                   help="sim-time cutoff in seconds")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--json", default=None)
    p.add_argument("--trace-out", default=None,
                   help="write a Chrome-trace/Perfetto JSON of the "
                        "simulated timeline (repro_torch.obs spans)")
    _traffic_args(p, rate_default=100.0)
    _resilience_args(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("replay", help="re-enact a recorded engine trace")
    p.add_argument("--trace", required=True, help="trace JSON path "
                   "(ServingEngine.trace_json())")
    p.add_argument("--model", action="store_true",
                   help="price steps with the analytic model instead of "
                        "the measured durations")
    p.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b")
    p.add_argument("--machine", default=None)
    p.add_argument("--dtype", default="bf16")
    p.add_argument("--backend", default="analytic-tpu")
    p.add_argument("--policy", default="greedy")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--limit", type=int, default=12)
    p.add_argument("--json", default=None)
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("sweep", help="SLO sweep over deployment cells")
    p.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b")
    p.add_argument("--machine", nargs="*", default=None)
    p.add_argument("--dtypes", nargs="+", default=["bf16"])
    p.add_argument("--batches", nargs="+", type=int,
                   default=[1, 2, 4, 8, 16])
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--backend", default="analytic-tpu")
    p.add_argument("--policies", nargs="+", default=["greedy"])
    p.add_argument("--requests", type=int, default=200)
    p.add_argument("--slo-p99", type=float, default=None,
                   help="p99 end-to-end latency bound, seconds")
    p.add_argument("--slo-ttft", type=float, default=None,
                   help="p95 time-to-first-token bound, seconds")
    p.add_argument("--slo-goodput", type=float, default=None,
                   help="minimum completed tokens/second")
    p.add_argument("--slo-shed", type=float, default=None,
                   help="maximum tolerated shed fraction (0..1)")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--json", default=None)
    _traffic_args(p, rate_default=None)
    _resilience_args(p)
    p.set_defaults(fn=cmd_sweep)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
