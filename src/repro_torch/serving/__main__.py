"""Deployment-planning command line.

    python -m repro_torch.serving plan --arch zamba2-1.2b --machine h100 \\
        --backend cuda
    python -m repro_torch.serving plan --arch qwen2-1.5b --machine 'zoo/*' \\
        --backend analytic-tpu
    python -m repro_torch.serving footprint --arch qwen2-7b --batch 8 \\
        --max-len 2048

``plan`` ranks every feasible ``(machine, dtype, batch)`` serving cell of
the given machines (globs sweep the zoo) by predicted decode throughput,
with memory-infeasible cells pruned against each machine's deployment-level
budget and reported with machine-readable reasons.  Only the model config
is used — no parameters are instantiated, so full-size architectures plan
in seconds, on a host without a card.  ``footprint`` prints the memory
model for one cell.  The counterpart of ``python -m repro.serving``: the
same flags and the same text; the default backend is ``cuda`` (the Hopper
tile model on ``h100``), where the JAX package's is ``analytic-tpu``.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs import ARCH_IDS, get_config


def cmd_plan(args) -> int:
    from repro_torch.serving.report import plan_deployment

    cfg = get_config(args.arch, smoke=args.smoke)
    report = plan_deployment(
        cfg, machines=args.machine, dtypes=args.dtypes,
        batches=args.batches, max_len=args.max_len, backend=args.backend,
        memory=not args.no_memory, precisions=args.precision or ())
    print(f"deployment plan for {cfg.name} (max_len={args.max_len}, "
          f"native dtype {report.native_dtype})")
    print(report.table(limit=args.limit))
    if report.options:
        best = report.select()
        print(f"selected: {best.machine} dtype={best.dtype} "
              f"max_batch={best.batch} "
              f"({best.tokens_per_second:.3g} pred tok/s, "
              f"{best.headroom_fraction:.1%} memory headroom)")
    else:
        print("no feasible deployment — every cell was rejected",
              file=sys.stderr)
    if args.json:
        report.save(args.json)
        print(f"wrote {args.json}")
    return 0 if report.options else 1


def cmd_footprint(args) -> int:
    from repro_torch.serving.footprint import footprint

    cfg = get_config(args.arch, smoke=args.smoke)
    fp = footprint(cfg, batch=args.batch, max_len=args.max_len,
                   dtype=args.dtype)
    gib = 1024.0 ** 3
    print(f"{cfg.name} batch={fp.batch} max_len={fp.max_len} "
          f"dtype={fp.dtype} kv_dtype={fp.kv_dtype}")
    for key in ("weights_bytes", "kv_cache_bytes", "activation_bytes"):
        val = getattr(fp, key)
        print(f"  {key:<18} {val:>16,d}  ({val / gib:.3f} GiB)")
    print(f"  {'total_bytes':<18} {fp.total_bytes:>16,d}  "
          f"({fp.total_bytes / gib:.3f} GiB)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serving")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("plan", help="rank (machine, dtype, batch) cells")
    p.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b")
    p.add_argument("--machine", nargs="*", default=None,
                   help="names/globs; 'zoo/*' ranks the whole registry "
                        "(default: the backend's native machine)")
    p.add_argument("--dtypes", nargs="+", default=["bf16", "int8"])
    p.add_argument("--batches", nargs="+", type=int,
                   default=[1, 2, 4, 8, 16])
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--backend", default="cuda",
                   help="planning backend (default cuda: the Hopper tile "
                        "model; analytic-tpu prices the TPU zoo)")
    p.add_argument("--no-memory", action="store_true",
                   help="skip the memory-budget pruning (throughput only)")
    p.add_argument("--precision", nargs="*", default=None,
                   metavar="AxB[->ACC][@kv=KV]",
                   help="extra mixed-precision what-if cells, e.g. "
                        "int8xint8 int4xint8->int32 bf16xint8->f32@kv=int8")
    p.add_argument("--smoke", action="store_true",
                   help="plan the smoke-size reduction of the arch")
    p.add_argument("--limit", type=int, default=12)
    p.add_argument("--json", default=None, help="also write the report JSON")
    p.set_defaults(fn=cmd_plan)

    p = sub.add_parser("footprint", help="memory model for one cell")
    p.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--dtype", default="bf16")
    p.add_argument("--smoke", action="store_true")
    p.set_defaults(fn=cmd_footprint)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
