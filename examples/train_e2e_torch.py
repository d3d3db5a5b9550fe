"""End-to-end training driver on the port, with checkpoint/restart fault
tolerance.

Default: a ~2M-param smoke model for 300 steps on the card.  ``--arch
xlstm-125m --full`` trains the real 106M-parameter xLSTM.

    PYTHONPATH=src python examples/train_e2e_torch.py [--steps 300]
    PYTHONPATH=src python examples/train_e2e_torch.py --device cpu --steps 20

Kill it mid-run (Ctrl+C is fine, SIGTERM triggers the emergency
checkpoint) and re-run the same command: it resumes bit-exactly from the
latest checkpoint.

The torch twin of ``examples/train_e2e.py``, with its flags plus
``--device`` (default cuda; cpu runs the kernels' plain versions): it calls
``repro_torch.launch.train.train``, whose every product runs on the
hand-written GEMM kernel, forward and backward.  Checkpoints go to
``build/train_e2e_torch`` under the checkout unless ``--ckpt-dir`` says
otherwise.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.launch.train import train

CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "build", "train_e2e_torch")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true",
                    help="train the full (non-smoke) config")
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    a = ap.parse_args(argv)

    out = train(a.arch, smoke=not a.full, steps=a.steps, batch=16, seq=128,
                lr=3e-3, ckpt_dir=a.ckpt_dir, ckpt_every=50,
                microbatches=2, device=a.device)
    losses = out["losses"]
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"\nloss first10={first:.3f} -> last10={last:.3f} "
          f"({(1 - last / first):.0%} reduction)")
    print(f"checkpoints in {a.ckpt_dir}: re-run this script to resume.")


if __name__ == "__main__":
    main()
