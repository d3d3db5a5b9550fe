"""Batched serving demo on the port: continuous batching over mixed-length
requests, on the card.

    PYTHONPATH=src python examples/serve_batch_torch.py --arch zamba2-1.2b
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu
    PYTHONPATH=src python examples/serve_batch_torch.py --autoconfigure \\
        --machine 'zoo/*'       # memory-aware zoo-wide machine/batch pick
    PYTHONPATH=src python examples/serve_batch_torch.py --autoconfigure \\
        --machine gap9-fc --slo-p99 0.35 --rate 5 \\
        --trace /tmp/trace.json # simulation-backed SLO pick + event trace
    PYTHONPATH=src python examples/serve_batch_torch.py --requests 24 \\
        --deadline 2.0 --queue-limit 8   # overload: shed + backpressure

With ``--autoconfigure`` the engine comes from the ranked deployment grid
(``repro_torch.serving.plan_deployment``): cells whose modelled footprint
(weights + KV cache + workspace) exceeds a machine's deployment-memory
budget are pruned before the GEMM sweep, and the surviving cell with the
best predicted decode throughput is frozen into the engine.  Adding
``--slo-p99`` instead picks the cell by *simulated* SLO attainment under
Poisson traffic (``repro_torch.simulate``) — usually a smaller batch than the
peak-throughput winner; ``--faults throttle20`` on top makes the pick
perturbation-robust (SLO attainment *under* a duty-cycled thermal
throttle).  ``--deadline`` / ``--queue-limit`` arm the overload path —
expired or unmeetable requests are shed at admission, a full queue
pushes back on the submitter, and the shed/expired/degraded counters
land in ``perf_report()`` (see docs/RESILIENCE.md).  ``--trace`` writes
the engine's event trace for ``python -m repro_torch.simulate replay``
sim-vs-real validation; ``--trace-out`` writes a Chrome-trace/Perfetto
JSON of the run's spans + events (``repro_torch.obs``, see
docs/OBSERVABILITY.md).

The torch twin of ``examples/serve_batch.py``, with its flags plus
``--device`` (default cuda; cpu runs the kernels' plain versions): it calls
``repro_torch.launch.serve.serve_demo``, whose model runs its dense
products and logits on the hand-written GEMM kernel and a MoE arch's
experts on the grouped kernel.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import serve_demo


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--autoconfigure", action="store_true")
    ap.add_argument("--machine", default=None)
    ap.add_argument("--no-memory", action="store_true")
    ap.add_argument("--slo-p99", type=float, default=None)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--deadline", type=float, default=None)
    ap.add_argument("--queue-limit", type=int, default=None)
    ap.add_argument("--faults", default=None)
    ap.add_argument("--on-truncate", choices=["raise", "report"],
                    default="raise")
    ap.add_argument("--trace", default=None)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    a = ap.parse_args(argv)
    slo = traffic = None
    if a.slo_p99 is not None:
        from repro_torch.simulate import SLO, PoissonTraffic
        slo = SLO(p99_latency_s=a.slo_p99)
        if a.rate is not None:
            traffic = PoissonTraffic(rate=a.rate, prompt_len=16,
                                     decode_len=a.max_new)
    serve_demo(a.arch, n_requests=a.requests, max_new=a.max_new,
               max_batch=a.max_batch, autoconfigure=a.autoconfigure,
               machine=a.machine, memory=not a.no_memory, slo=slo,
               traffic=traffic, deadline_s=a.deadline,
               queue_limit=a.queue_limit, faults=a.faults,
               on_truncate=a.on_truncate, trace_path=a.trace,
               trace_out=a.trace_out, device=a.device)


if __name__ == "__main__":
    main()
