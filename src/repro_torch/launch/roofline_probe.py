"""Roofline probes: the dry run at one and two layer periods, extrapolated.

The counterpart of ``repro.launch.roofline_probe``.  XLA's
``cost_analysis()`` counts a scan body once whatever its trip count, so
the JAX package compiles two unrolled probe models (1 and 2 periods of
the layer pattern, the tail attached to both so it cancels, ``attn_chunk
= S`` so the attention KV scan runs once) and extrapolates:

    F_cell = F(1) + (k_full - 1) * (F(2) - F(1))

The port's dry run (``launch/dryrun.py``) runs every layer eagerly and
counts them all, so a full-depth run needs no extrapolation; the probe
keeps it so that ``per_period_flops`` means what the reference's means,
and its tests check that the extrapolation equals a direct run of the
full-depth config.  The terms are priced on the H100
(``core.roofline.RooflineReport``: the ``h100`` manifest's bf16 and HBM
rates, the uncalibrated InfiniBand NDR link rate).
"""
import argparse
import dataclasses
import json
import os

from repro_torch.configs import ARCH_IDS, get_config, shape_cells, skipped_cells
from repro_torch.configs.base import SHAPES
from repro_torch.core.roofline import RooflineReport
from repro_torch.launch.dryrun import run_cell
from repro_torch.models.model import factor_pattern


def probe_config(cfg, n_periods: int, seq_len: int):
    period, k, tail = factor_pattern(cfg.block_pattern)
    pattern = tuple(period) * n_periods + tuple(tail)
    return dataclasses.replace(
        cfg, n_layers=len(pattern), block_pattern=pattern,
        attn_chunk=max(seq_len, cfg.attn_chunk))


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N_active per generated token (decode),
    N = active params."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch      # one token per sequence


def probe_cell(arch: str, shape_name: str, multi_pod: bool = False, *,
               cfg=None, shape=None, mesh_shape=None) -> dict:
    """The cell's record from its 1- and 2-period probes.  ``cfg``,
    ``shape`` and ``mesh_shape`` override the arch's config, the shape and
    the production mesh, as ``run_cell``'s do (tests)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    period, k_full, tail = factor_pattern(cfg.block_pattern)

    f1, f2 = (run_cell(arch, shape_name, multi_pod,
                       cfg=probe_config(cfg, n, shape.seq_len), unroll=True,
                       shape=shape, mesh_shape=mesh_shape)
              for n in (1, 2))

    def extrap(key):
        d = f2[key] - f1[key]
        return f1[key] + (k_full - 1) * d

    # the dry run counts one rank's program: the terms divide by per-card
    # rates (core.roofline.RooflineReport)
    rep = RooflineReport(
        arch=arch, shape_name=shape_name, mesh=f2["mesh"],
        chips=f1["chips"], hlo_flops=extrap("flops"),
        hlo_bytes=extrap("bytes_accessed"),
        coll_bytes=extrap("collective_bytes"),
        model_flops=model_flops(cfg, shape), coll_detail={})
    return {
        "arch": arch, "shape": shape_name,
        "mesh": rep.mesh, "chips": rep.chips,
        "hlo_flops": rep.hlo_flops, "hlo_bytes": rep.hlo_bytes,
        "collective_bytes": rep.coll_bytes,
        "per_period_flops": f2["flops"] - f1["flops"],
        "n_periods": k_full,
        "model_flops": rep.model_flops,
        "useful_flop_ratio": rep.useful_flop_ratio,
        "t_compute_s": rep.t_compute, "t_memory_s": rep.t_memory,
        "t_collective_s": rep.t_collective,
        "dominant": rep.dominant,
        "step_time_bound_s": rep.step_time,
        "roofline_fraction": rep.roofline_fraction,
        "probe_compile_s": f1["compile_seconds"] + f2["compile_seconds"],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true",
                    help="probe the 512-chip mesh (default: single pod)")
    ap.add_argument("--out", default="experiments/roofline_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    if args.all:
        cells = [(a, s.name) for a in ARCH_IDS for s in shape_cells(a)]
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    failures = []
    for arch, shape_name in cells:
        if shape_name in skipped_cells(arch):
            continue
        tag = f"{arch}__{shape_name}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path) and not args.force:
            print(f"CACHED {tag}")
            continue
        print(f"PROBE {tag} ...", flush=True)
        try:
            rec = probe_cell(arch, shape_name, args.multipod)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"  {rec['dominant']:<10} comp={rec['t_compute_s']*1e3:.2f}ms "
                  f"mem={rec['t_memory_s']*1e3:.2f}ms "
                  f"coll={rec['t_collective_s']*1e3:.2f}ms "
                  f"rf={rec['roofline_fraction']:.3f}")
        except Exception as e:  # noqa: BLE001
            failures.append((tag, repr(e)))
            print(f"  FAIL {tag}: {e}")
    if failures:
        for t, e in failures:
            print("FAILED:", t, e)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
