"""The paper's workflow, end to end, on the port's ``repro_torch.gemm`` API:
explore GEMM algorithm alternatives *before* implementing them, first on
the paper's GAP8 target, then on TPU and on the H100 via the analytic tile
searches, then run the ``cuda`` planner's chosen plan on the card against
its plain version.

    PYTHONPATH=src python examples/autotune_explore_torch.py --m 4096 --n 1536 --k 8960
    PYTHONPATH=src python examples/autotune_explore_torch.py --device cpu

The torch twin of ``examples/autotune_explore.py``.  Its GAP8, machine-zoo
and TPU v5e sections print what the JAX example prints; the Hopper section
ranks the ``cuda`` backend's tile lattice with the Hopper tile model on the
``h100`` manifest; the last section executes the chosen plan at the full
shape in bf16 (the hand-written GEMM kernel on the card, its plain version
on ``--device cpu``) and holds it against the plain PyTorch version at
rtol = atol = 2e-2, exiting non-zero if they disagree.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import gemm, machines
from repro_torch.core import GemmShape, Variant
from repro_torch.core import hopper_model
from repro_torch.core.autotune import candidate_tiles
from repro_torch.core.tpu_model import GridOrder, estimate
from repro_torch.interop import require_device
from repro_torch.kernels import gemm as K

#: the plain version's tolerance for a bf16 result (both sum in f32 and
#: round once; the sum order differs)
BF16_TOL = 2e-2


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--k", type=int, default=1024)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    a = ap.parse_args(argv)
    dev = require_device(a.device)

    print(f"GEMM {a.m} x {a.n} x {a.k}")
    print("\n--- GAP8 (the paper's target): bulk sweep over the variant "
          "axis ---")
    res = gemm.sweep([(a.m, a.n, a.k)], backends=["analytic-gap8"],
                     variants=list(Variant), policies=["analytic", "padded"])
    for r in res.filter(policy="analytic"):
        cb = r.plan.estimate()
        g = cb.grouped()
        print(f"  {r.variant}: mk={cb.micro_kernel} total={cb.total:.3f}s  "
              f"[pack {g['packing']:.2f} | copy {g['copy']:.2f} | "
              f"streams {g['stream_M'] + g['stream_L1'] + g['stream_L2']:.2f} "
              f"| arith {g['arith']:.2f}]")
    win = res.best((a.m, a.n, a.k))
    print(f"  sweep winner across {len(res)} grid points: {win.variant} "
          f"{win.selection} ({win.policy} policy, {win.seconds:.3f}s)")

    print("\n--- machine zoo: the same sweep across every FC-class "
          "manifest ---")
    fc_zoo = [n for n in machines.list_machines("zoo/*")
              if machines.get(n).register_lanes <= 8]
    zres = gemm.sweep([(a.m, a.n, a.k)], backends=["analytic-gap8"],
                      machines=fc_zoo)
    for r in sorted(zres, key=lambda r: r.seconds):
        print(f"  {r.machine:>12}: {r.plan.estimate().micro_kernel} "
              f"{r.seconds:10.3f}s")

    print("\n--- TPU v5e: the analytic search over the Pallas design space ---")
    shape = GemmShape(a.m, a.n, a.k, "bf16")
    ranked = sorted(candidate_tiles(shape),
                    key=lambda t: estimate(shape, t).total())[:5]
    for t in ranked:
        c = estimate(shape, t)
        print(f"  {str(t):>24}: {c.total()*1e6:8.1f}us  "
              f"rf={c.roofline_fraction():.3f}  hbm={c.hbm_bytes/1e6:.1f}MB  "
              f"vmem={c.vmem_peak/1e6:.1f}MB")
    tpu = gemm.plan((a.m, a.n, a.k), backend="analytic-tpu", dtype="bf16")
    print(f"  chosen: {tpu.selection}  ({tpu.provenance['source']})")

    print("\n--- H100: the Hopper tile model over the cuda backend's "
          "lattice ---")
    h100 = machines.get("h100")
    costs = sorted((hopper_model.estimate(shape, t, h100)
                    for t in hopper_model.lattice("bf16")),
                   key=lambda c: c.total)[:5]
    for c in costs:
        print(f"  {str(c.tile):>24}: {c.total*1e6:8.1f}us  "
              f"route={c.route}  blocks={c.blocks}  waves={c.waves}  "
              f"hbm={c.hbm_bytes/1e6:.1f}MB  l2={c.l2_bytes/1e6:.1f}MB")
    best = gemm.plan((a.m, a.n, a.k), backend="cuda", machine="h100",
                     dtype="bf16")
    print(f"  chosen: {best.selection}  ({best.provenance['source']})")

    print(f"\n--- run the chosen plan against its plain version "
          f"({dev}) ---")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(a.m, a.k)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(a.k, a.n)).astype(np.float32)
                         * a.k ** -0.5)        # a weight's init scale
    x, w = x.to(dev, torch.bfloat16), w.to(dev, torch.bfloat16)
    got = best.execute(x, w)
    tile = best.selection
    if tile.order is GridOrder.K_INNER:
        want = K.gemm_k_inner_plain(x, w)
    else:
        want = K.gemm_k_outer_plain(x, w, torch.zeros_like(got), bk=tile.bk)
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), rtol=BF16_TOL,
                             atol=BF16_TOL))
    print(f"  kernel vs plain max|err| = {err:.2e} on {a.m}x{a.n}x{a.k} "
          f"bf16 at {tile} (rtol = atol = {BF16_TOL}: "
          f"{'ok' if ok else 'FAILED'})")
    print(f"  plan cache: {gemm.plan_cache_stats()}")
    if not ok:
        raise SystemExit(f"the {tile} kernel disagrees with its plain "
                         f"version: max|err| {err:.3g}")


if __name__ == "__main__":
    main()
