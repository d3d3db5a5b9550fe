"""Mixed-precision decode-GEMM trade-off study (see EXPERIMENTS.md).

Prices the qwen2-1.5b (smoke) decode step under the full precision zoo —
uniform f32/bf16/int8 paths plus the sequel paper's mixed configs
(int4xint8 widening dots, dequantize-on-the-fly fp weights, int8 KV
cache) — on an edge part (`gap9-fc`) and a datacenter part (`tpu-v5e`),
and reports the (tokens/s, accuracy proxy, deployment footprint)
frontier each machine actually offers.

Each machine is swept over the configs *it can plan*: gap9-fc has no
fp MAC path (`arith_rate` covers int8/int4 only), so its fp entries are
the dequantizing `*xint8->int32` configs priced via `rates_mixed`; the
TPU plans every uniform dtype natively and adds the `bf16xint8->f32`
weight-dequant config.  Quantize/dequantize traffic of wider-than-
compute operands is part of every mixed cell's cost (the `quant_*`
terms — docs/COST_MODELS.md, mixed-precision section).

Prints the markdown section; EXPERIMENTS.md records the committed output.

The torch twin of ``experiments/precision_tradeoff_study.py``: the same ``run()`` on
``repro_torch``, whose lines equal the JAX study's, the commands
they quote included (``tests/test_torch_studies.py``).

  PYTHONPATH=src python experiments/precision_tradeoff_study_torch.py
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

BATCH = 8
MAX_LEN = 256

#: per-machine precision menus: every config the machine can price —
#: uniform paths where arith_rate covers the dtype, rates_mixed /
#: compute-dtype fallbacks otherwise.
MENUS = {
    "gap9-fc": ["int8xint8", "int4xint8->int32", "int4xint4->int32",
                "bf16xint8->int32", "f32xint8->int32"],
    "tpu-v5e": ["f32xf32", "bf16xbf16", "int8xint8",
                "bf16xint8->f32", "bf16xbf16->f32@kv=int8"],
}
BACKENDS = {"gap9-fc": "analytic-gap8", "tpu-v5e": "analytic-tpu"}
BASE_DTYPE = {"gap9-fc": "int8", "tpu-v5e": "bf16"}


def _frontier(options):
    """Pareto-efficient options over (tokens/s up, accuracy up, bytes
    down); deterministic order by descending throughput."""
    opts = sorted(options, key=lambda o: (-o.tokens_per_second,
                                          o.dtype))
    keep = []
    for o in opts:
        dominated = any(
            p.tokens_per_second >= o.tokens_per_second
            and p.accuracy_proxy >= o.accuracy_proxy
            and p.footprint.total_bytes <= o.footprint.total_bytes
            and (p.tokens_per_second > o.tokens_per_second
                 or p.accuracy_proxy > o.accuracy_proxy
                 or p.footprint.total_bytes < o.footprint.total_bytes)
            for p in opts if p is not o)
        if not dominated:
            keep.append(o)
    return keep


def run() -> list[str]:
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionConfig
    from repro_torch.serving.report import plan_deployment

    cfg = get_config("qwen2-1.5b", smoke=True)
    lines = [
        f"- workload: `{cfg.name}` (smoke) decode step at batch {BATCH}, "
        f"max_len {MAX_LEN}; every cell is the analytically planned "
        f"per-layer GEMM sum under one `PrecisionConfig`, footprinted "
        f"with weights in the B-operand dtype and the cache in the "
        f"config's KV dtype",
    ]
    for machine in ("gap9-fc", "tpu-v5e"):
        menu = MENUS[machine]
        report = plan_deployment(
            cfg, machines=machine, dtypes=(BASE_DTYPE[machine],),
            batches=(BATCH,), max_len=MAX_LEN,
            backend=BACKENDS[machine],
            precisions=tuple(menu))
        # keep one row per precision config: the dtype-axis base cell
        # duplicates its uniform config (bit-identically), so drop it.
        # A config's key() drops the @kv tag, so re-attach it from the
        # footprint for display (the cache dtype is the only difference).
        opts = [o for o in report.options if o.precision is not None]
        assert len(opts) == len(menu), (machine, [o.dtype for o in opts])

        def show(o):
            pc = PrecisionConfig.parse(o.precision)
            if o.footprint.kv_dtype == "int8" and pc.b_dtype != "int8":
                return f"{o.precision}@kv=int8"
            return o.precision

        front = {id(o) for o in _frontier(opts)}
        base = next(o for o in report.options if o.precision is None)
        uniform_twin = next(
            o for o in opts
            if PrecisionConfig.parse(o.precision).is_uniform
            and PrecisionConfig.parse(o.precision).a_dtype
            == BASE_DTYPE[machine])
        assert uniform_twin.seconds_per_step == base.seconds_per_step, \
            "uniform config must tie the plain dtype path bit-identically"
        lines += [
            "",
            f"### {machine} ({BACKENDS[machine]})",
            "",
            "| precision | tok/s | acc proxy | footprint MiB | frontier |",
            "|---|---|---|---|---|",
        ]
        for o in sorted(opts, key=lambda o: (-o.tokens_per_second,
                                             show(o))):
            lines.append(
                f"| `{show(o)}` | {o.tokens_per_second:.3g} "
                f"| {o.accuracy_proxy:.2f} "
                f"| {o.footprint.total_bytes / 2**20:.2f} "
                f"| {'**yes**' if id(o) in front else 'no'} |")
    lines += [
        "",
        "- reproduce: `PYTHONPATH=src python "
        "experiments/precision_tradeoff_study.py`; CLI equivalent per "
        "cell: `python -m repro.serving plan --arch qwen2-1.5b --smoke "
        "--machine gap9-fc --batches 8 --precision int4xint8->int32 ...`",
    ]
    return lines


if __name__ == "__main__":
    print("\n".join(run()))
