"""End-to-end training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/run1
    PYTHONPATH=src python -m repro_torch.launch.train --full \\
        --arch qwen2-1.5b --steps 4 --batch 4 --seq 256
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen2-1.5b --steps 30 --batch 8 --seq 64

The counterpart of ``repro.launch.train``, with its flags and log lines.
The loop wires together every fault-tolerance feature: periodic atomic
checkpoints, the SIGTERM handler and its emergency save, the deterministic
resume of the data stream, the straggler watchdog.  It runs on the card
(``--device cuda``, the default) and exits 2 when there is none; ``--device
cpu`` runs the kernels' plain versions on the host.  The parameters are
f32 masters, the compute dtype the config's (bf16 for the published
configs), initialised from ``--seed``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ParallelConfig, ShapeConfig, TrainConfig
from repro_torch.data import DataIterator
from repro_torch.interop import require_device
from repro_torch.models.common import HOST_MESH, tree_copy_
from repro_torch.models.model import LM
from repro_torch.runtime.fault import StepWatchdog
from repro_torch.runtime.train_lib import init_train_state, make_train_step


def train(arch: str, *, smoke: bool = True, steps: int = 100, batch: int = 8,
          seq: int = 128, ckpt_dir: str | None = None, ckpt_every: int = 50,
          lr: float = 3e-3, microbatches: int = 1, log_every: int = 10,
          seed: int = 0, device="cuda") -> dict:
    """Train ``steps`` steps (resuming from ``ckpt_dir``'s latest
    checkpoint if there is one).  Returns the last step, the losses, the
    per-step ``history`` (loss, lr, grad_norm, ce_loss, aux_loss, wall ms,
    tokens/s), whether the run was preempted, the watchdog's summary and
    the parameters."""
    dev = require_device(device)
    cfg = get_config(arch, smoke=smoke)
    shape = ShapeConfig("custom", "train", seq, batch)
    tcfg = TrainConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                       total_steps=steps, checkpoint_every=ckpt_every)
    pcfg = ParallelConfig(microbatches=microbatches)
    lm = LM(cfg, HOST_MESH, device=dev)

    params, _, opt, _ = init_train_state(
        lm, tcfg, torch.Generator(device=dev).manual_seed(seed), pcfg)
    data = DataIterator(cfg, shape, seed=seed)
    step = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=3)
        mgr.install_preemption_handler()
        latest = mgr.latest_step()
        if latest is not None:
            # restored on the host, then copied into the state in place:
            # the card holds one copy of the state
            step, state, extra = mgr.restore_latest(
                {"params": params, "opt": opt}, device="cpu")
            tree_copy_({"params": params, "opt": opt}, state)
            del state
            data.load_state_dict(extra["data"])
            print(f"resumed from step {step}")

    train_step = make_train_step(lm, tcfg, pcfg)
    wd = StepWatchdog()
    losses, history = [], []
    tokens = batch * seq

    saved_step = None

    def save():
        nonlocal saved_step
        mgr.save(step, {"params": params, "opt": opt},
                 extra={"data": data.state_dict(), "watchdog": wd.summary()})
        saved_step = step

    while step < steps:
        batch_data = {k: v.to(dev) for k, v in next(data).items()}
        wd.start()
        t0 = time.perf_counter()
        params, opt, metrics = train_step(params, opt, batch_data)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        wd.stop()
        losses.append(loss)
        step += 1
        history.append({"step": step, "ms": 1e3 * dt,
                        "tokens_per_s": tokens / dt,
                        **{k: float(v) for k, v in metrics.items()}})
        if step % log_every == 0 or step == steps:
            print(f"step {step:5d} loss {loss:.4f} lr "
                  f"{float(metrics['lr']):.2e} gnorm "
                  f"{float(metrics['grad_norm']):.3f}")
        if mgr and (step % ckpt_every == 0 or mgr.preempted):
            save()
            if mgr.preempted:
                print(f"preempted: emergency checkpoint at step {step}")
                return {"step": step, "losses": losses, "history": history,
                        "preempted": True, "watchdog": wd.summary(),
                        "params": params}
    if mgr and saved_step != step:
        # (the JAX package's loop saves a last step that falls on
        # ckpt_every twice, writing the same checkpoint again)
        save()
    print("watchdog:", wd.summary())
    return {"step": step, "losses": losses, "history": history,
            "preempted": False, "watchdog": wd.summary(), "params": params}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu runs "
                         "the kernels' plain versions)")
    a = ap.parse_args(argv)
    try:
        require_device(a.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    out = train(a.arch, smoke=a.smoke, steps=a.steps, batch=a.batch,
                seq=a.seq, ckpt_dir=a.ckpt_dir, ckpt_every=a.ckpt_every,
                lr=a.lr, microbatches=a.microbatches, seed=a.seed,
                device=a.device)
    first, last = np.mean(out["losses"][:5]), np.mean(out["losses"][-5:])
    print(f"loss: first5={first:.4f} last5={last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
