"""Quickstart on the port: the paper's simulator, its TPU twin, the Hopper
planner and the framework in five minutes.

    PYTHONPATH=src python examples/quickstart_torch.py            # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The torch twin of ``examples/quickstart.py``.  Sections 1-2 print what the
JAX quickstart prints (the port carries the same analytic models); 2b
plans (256, 256, 256) on the ``cuda`` backend (the Hopper tile model) and
executes it on the card in bf16, through the hand-written GEMM kernel;
3-4 train a smoke-scale qwen2 and serve it with the continuous-batching
engine.  ``--device cpu`` runs the kernels' plain versions on the host.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch import gemm
from repro_torch.core import Variant
from repro_torch.interop import require_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--steps", type=int, default=30,
                    help="training steps of section 3")
    a = ap.parse_args(argv)
    dev = require_device(a.device)

    # -----------------------------------------------------------------------
    # 1. The paper: plan blocked-GEMM variants on the GAP8 edge processor
    # -----------------------------------------------------------------------
    print("=== 1. Paper simulator: MobileNetV1 layer #10 GEMM on GAP8 ===")
    print(f"  backends: {gemm.backends()}")
    layer10 = (256, 784, 2304)                   # im2col of conv layer 10
    for v in Variant:
        cb = gemm.plan(layer10, backend="analytic-gap8", variant=v).estimate()
        print(f"  {v.value}: best micro-kernel {cb.micro_kernel}, "
              f"estimated {cb.total:.3f}s "
              f"(arith {cb.arith:.3f}s, transfers {cb.transfer:.3f}s)")

    # -----------------------------------------------------------------------
    # 2. The TPU adaptation: the same plan() call picks Pallas block shapes
    # -----------------------------------------------------------------------
    print("\n=== 2. TileTuner: a transformer MLP GEMM on TPU v5e ===")
    d = gemm.plan((4096, 18944, 3584), backend="analytic-tpu")
    print(f"  tile {d.selection} -> predicted "
          f"{d.predicted_seconds*1e6:.0f}us, "
          f"{d.cost.roofline_fraction():.1%} of roofline "
          f"(paper-mode/no-overlap would be "
          f"{d.cost.total_no_overlap*1e6:.0f}us)")

    # -----------------------------------------------------------------------
    # 2b. Close the loop: execute a plan with the Hopper kernel
    # -----------------------------------------------------------------------
    print("\n=== 2b. plan -> execute on the cuda backend ===")
    p = gemm.plan((256, 256, 256), backend="cuda", dtype="bf16")
    x = torch.ones((256, 256), dtype=torch.bfloat16, device=dev)
    w = torch.full((256, 256), 0.5, dtype=torch.bfloat16, device=dev)
    c = p.execute(x, w)
    print(f"  {p.describe()}")
    print(f"  execute(ones, halves)[0,0] = {float(c[0, 0])} (expect 128.0) "
          f"on {dev}")

    # -----------------------------------------------------------------------
    # 3. The framework: train a small LM for a few steps
    # -----------------------------------------------------------------------
    from repro_torch.launch.train import train

    print(f"\n=== 3. Train a smoke-scale qwen2 for {a.steps} steps ===")
    out = train("qwen2-1.5b", smoke=True, steps=a.steps, batch=8, seq=64,
                lr=3e-3, log_every=10, device=dev)

    # -----------------------------------------------------------------------
    # 4. Serve it with the continuous-batching engine
    # -----------------------------------------------------------------------
    from repro_torch.configs import get_config
    from repro_torch.models.common import HOST_MESH
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import Request, ServingEngine

    print("\n=== 4. Serve a few batched requests ===")
    cfg = get_config("qwen2-1.5b", smoke=True)
    lm = LM(cfg, HOST_MESH, device=dev)
    eng = ServingEngine(lm, out["params"], max_batch=2, max_len=64)
    for i in range(3):
        eng.submit(Request(rid=i, prompt=[1 + i, 2 + i, 3 + i],
                           max_new_tokens=5))
    for r in sorted(eng.run_until_drained(), key=lambda r: r.rid):
        print(f"  request {r.rid}: prompt {r.prompt} -> generated "
              f"{r.generated}")
    print("\nquickstart done.")


if __name__ == "__main__":
    main()
