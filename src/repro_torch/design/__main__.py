"""Design-space command line.

    python -m repro_torch.design expand --space smoke
    python -m repro_torch.design sweep --space smoke
    python -m repro_torch.design frontier --space gap9-sweep \\
        --json frontier.json
    python -m repro_torch.design frontier --space gap9-sweep \\
        --arch qwen2-1.5b --smoke --batch 8 --slo-p99 0.35
    python -m repro_torch.design ground --space smoke --index 0 \\
        --store /tmp/design.jsonl --synthetic

``expand`` lists (or writes manifests for) a space's generated specs;
``sweep`` registers a space under the ``gen/`` namespace, runs the GEMM
grid over ``machines="gen/*"`` through ``repro_torch.gemm.sweep``, and
cleans the namespace up; ``frontier`` scores the space and prints the Pareto
frontier (optionally SLO-re-ranked via the serving simulator); ``ground``
runs the expand -> sample -> fit -> validate loop for one design point
(``--synthetic`` prices the campaign against a perturbed ground truth, so
the path is exercisable without hardware).  Everything is config-only —
no parameters, no tensors.  The counterpart of ``python -m repro.design``.
"""
from __future__ import annotations

import argparse
import json
import sys


def _space(args):
    from repro_torch.design.space import get_space

    return get_space(args.space)


def cmd_expand(args) -> int:
    import os

    space = _space(args)
    n = len(space) if args.limit is None else min(args.limit, len(space))
    print(f"{space!r}")
    rows = []
    for pt in space.points():
        if pt.index >= n:
            break
        spec = pt.spec()
        rows.append({"index": pt.index, "name": spec.name,
                     "params": dict(pt.params),
                     "fingerprint": spec.fingerprint()})
        print(f"  [{pt.index:>3}] {spec.name:<26} {pt.label()}")
        if args.out:
            spec.to_manifest(os.path.join(args.out, f"{spec.name}.json"))
    if args.out:
        print(f"wrote {n} manifests under {args.out}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"space": space.name, "points": rows}, f, indent=1)
        print(f"wrote {args.json}")
    return 0


def cmd_sweep(args) -> int:
    from repro_torch import gemm, machines
    from repro_torch.measure.campaign import grid_problems

    space = _space(args)
    names = space.register_all(limit=args.limit)
    try:
        problems = grid_problems(args.grid, dtype=args.dtype)
        result = gemm.sweep(problems, machines="gen/*",
                            backends=[args.backend])
        per_machine: dict[str, float] = {}
        for row in result.rows:
            per_machine[row.machine] = (per_machine.get(row.machine, 0.0)
                                        + row.seconds)
        flops = sum(2.0 * p.m * p.n * p.k for p in problems)
        print(f"{space!r}: {len(names)} designs x {len(problems)} "
              f"{args.grid} problems ({args.backend})")
        for name in sorted(per_machine):
            s = per_machine[name]
            print(f"  {name:<26} {s:.6g} s   {flops / s / 1e9:8.2f} GOPS")
        stats = result.stats
        print(f"[{stats.get('rows', len(result.rows))} rows planned]")
    finally:
        machines.unregister_prefix("gen/")
    return 0


def cmd_frontier(args) -> int:
    from repro_torch.design.explore import pareto, rerank_by_slo, score_designs

    space = _space(args)
    cfg = None
    if args.arch:
        from repro_torch.configs import get_config
        cfg = get_config(args.arch, smoke=args.smoke)
    points = (space.sample(args.sample, method=args.method)
              if args.sample else list(space.points()))
    scores = score_designs(points, cfg=cfg, grid=args.grid,
                           dtype=args.dtype, batch=args.batch,
                           max_len=args.max_len, backend=args.backend)
    workload = f"{args.grid}+{cfg.name}" if cfg is not None else args.grid
    frontier = pareto(scores, workload=workload)
    print(f"{space!r} scored on {workload}")
    print(frontier.table())
    out = frontier.as_dict()
    if args.slo_p99 is not None:
        if cfg is None:
            print("--slo-p99 needs --arch", file=sys.stderr)
            return 2
        traffic = None
        if args.rps is not None:
            from repro_torch.simulate.traffic import PoissonTraffic
            traffic = PoissonTraffic(rate=args.rps, prompt_len=32,
                                     decode_len=16)
        ranked = rerank_by_slo(frontier, points, cfg,
                               slo={"p99_latency_s": args.slo_p99},
                               dtype=args.dtype, batch=args.batch,
                               max_len=args.max_len, backend=args.backend,
                               requests=args.requests, traffic=traffic)
        out["slo_rerank"] = {"p99_latency_s": args.slo_p99,
                             "ranked": ranked}
        print(f"\nSLO re-rank (p99 <= {args.slo_p99:g}s, batch "
              f"{args.batch}):")
        for r in ranked:
            mark = "ok " if r["attained"] else "VIOLATES"
            print(f"  {mark} {r['design']:<26} goodput "
                  f"{r['goodput_tps']:8.4g} tok/s  p99 "
                  f"{r['p99_latency_s']:.4g}s  area {r['area_proxy']:.1f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
        print(f"wrote {args.json}")
    return 0 if frontier.frontier else 1


def cmd_ground(args) -> int:
    from repro_torch.design.ground import ground, sample_design, synthetic_truth
    from repro_torch.measure.store import SampleStore

    space = _space(args)
    pt = space.point(args.index)
    spec = pt.spec()
    store = SampleStore(args.store)
    if args.synthetic:
        truth = synthetic_truth(spec, bw=args.truth_bw,
                                arith=args.truth_arith)
        camp = sample_design(pt, store, grid=args.grid, dtype=args.dtype,
                             truth=truth)
        print(f"sampled {len(camp.samples)} cells for {spec.name} against "
              f"synthetic truth (bw x{args.truth_bw:g}, arith "
              f"x{args.truth_arith:g})")
    result = ground(pt, store, date=args.date,
                    overhead_per_block=args.overhead_per_block,
                    manifest_dir=args.out)
    fit = result.fit
    print(f"grounded {result.spec.name}: residual "
          f"{fit.residual_rms_s:.3g}s over {fit.samples} samples, "
          f"validated MAPE {result.mape:.3g}%")
    assert result.spec.provenance.get("grounded") is True
    if args.out:
        print(f"wrote manifest under {args.out}")
    return 0


def main(argv=None) -> int:
    from repro_torch.design.space import space_names

    ap = argparse.ArgumentParser(prog="python -m repro_torch.design",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, sweep_knobs: bool = True):
        p.add_argument("--space", default="gap9-sweep",
                       choices=space_names(),
                       help="named design space (default: gap9-sweep)")
        if sweep_knobs:
            p.add_argument("--grid", default="table2",
                           help="GEMM grid to score (default: table2)")
            p.add_argument("--dtype", default="int8")
            p.add_argument("--backend", default="analytic-gap8")

    p = sub.add_parser("expand", help="list / write a space's specs")
    common(p, sweep_knobs=False)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--out", default=None, help="write manifests here")
    p.add_argument("--json", default=None)
    p.set_defaults(fn=cmd_expand)

    p = sub.add_parser("sweep", help="register gen/* and sweep the grid")
    common(p)
    p.add_argument("--limit", type=int, default=None)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("frontier", help="score a space, print the Pareto "
                                        "frontier")
    common(p)
    p.add_argument("--arch", default=None,
                   help="model config: score decode tokens/s instead of "
                        "grid GOPS")
    p.add_argument("--smoke", action="store_true",
                   help="smoke-reduce the arch (tiny layers)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--sample", type=int, default=None,
                   help="score a deterministic subset of this size")
    p.add_argument("--method", default="grid", choices=("grid", "halton"))
    p.add_argument("--slo-p99", type=float, default=None,
                   help="re-rank the frontier by simulated p99 attainment")
    p.add_argument("--rps", type=float, default=None,
                   help="fixed Poisson arrival rate for the SLO re-rank "
                        "(default: each design at 0.6x its own peak)")
    p.add_argument("--requests", type=int, default=200)
    p.add_argument("--json", default=None)
    p.set_defaults(fn=cmd_frontier)

    p = sub.add_parser("ground", help="expand -> sample -> fit -> validate "
                                      "one design point")
    common(p)
    p.add_argument("--index", type=int, default=0,
                   help="design-point index within the space")
    p.add_argument("--store", required=True, help="sample store (JSONL)")
    p.add_argument("--synthetic", action="store_true",
                   help="run a simulated campaign against a perturbed "
                        "truth first")
    p.add_argument("--truth-bw", type=float, default=0.8)
    p.add_argument("--truth-arith", type=float, default=0.9)
    p.add_argument("--overhead-per-block", action="store_true",
                   help="fit the per-block dispatch-overhead column too")
    p.add_argument("--date", default=None)
    p.add_argument("--out", default=None, help="manifest output dir")
    p.set_defaults(fn=cmd_ground)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
