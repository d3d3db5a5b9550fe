"""Faults planted underneath the timed path, to show that the comparison
catches them (the tests, and the calibration's fault readings).

Each fault is a context manager that wraps a function of the program and
breaks what it returns, as a defect in the program would:

* ``unchanged``: a GEMM returns without computing (its output left as
  zeros); a training step returns its state unchanged;
* ``half_batch``: half of the rows are left out (a GEMM's lower half of
  outputs zero; a training step's loss and gradient taken over the first
  half of the batch, the mean over those rows);
* ``altered``: one answer altered where it is produced (one element of
  every GEMM output moved by the output's largest magnitude; a training
  step's gradient of one leaf doubled before the optimizer reads it);
* ``nan``: one NaN written where an answer is produced (one element of
  every GEMM output, or for an integer output the value a NaN converts to,
  the type's least; one element of one gradient leaf of every training
  step, before the optimizer reads it).
"""
from __future__ import annotations

import contextlib

import torch

GEMM_FAULTS = ("unchanged", "half_batch", "altered", "nan")
TRAIN_FAULTS = ("unchanged", "half_batch", "altered", "nan")


def _break(out, fault: str):
    if fault == "unchanged":
        return torch.zeros_like(out)
    out = out.clone()
    if fault == "half_batch":
        rows = out.shape[-2]
        out[..., rows // 2:, :] = 0
        return out
    flat = out.view(-1)
    if fault == "altered":
        flat[flat.numel() // 2] += flat.abs().max()
        return out
    if fault == "nan":
        flat[flat.numel() // 2] = (float("nan") if out.is_floating_point()
                                   else torch.iinfo(out.dtype).min)
        return out
    raise ValueError(f"no fault {fault!r}")


@contextlib.contextmanager
def gemm_fault(fault: str):
    """Every planned and grouped product of the program broken by
    ``fault``."""
    from repro_torch import gemm
    inner = (gemm.matmul, gemm.grouped_matmul)

    def matmul(x, w, **kw):
        return _break(inner[0](x, w, **kw), fault)

    def grouped(x, w):
        return _break(inner[1](x, w), fault)

    gemm.matmul, gemm.grouped_matmul = matmul, grouped
    try:
        yield
    finally:
        gemm.matmul, gemm.grouped_matmul = inner


@contextlib.contextmanager
def train_fault(fault: str):
    """The program's training step broken by ``fault``."""
    from repro_torch.runtime import train_lib
    make, update = train_lib.make_train_step, train_lib.adamw_update

    def make_broken(lm, tcfg, pcfg):
        step = make(lm, tcfg, pcfg)

        def broken(params, opt_state, batch):
            if fault == "unchanged":
                loss = lm.loss_fn(params, batch, remat=pcfg.remat)[0]
                return params, opt_state, {"loss": loss.detach()}
            if fault == "half_batch":
                half = next(iter(batch.values())).shape[0] // 2
                return step(params, opt_state,
                            {k: v[:half] for k, v in batch.items()})
            return step(params, opt_state, batch)

        return broken

    def broken_grads(grads, *args, **kw):
        from repro_torch.models.common import tree_leaves
        leaves = tree_leaves(grads)
        leaf = leaves[len(leaves) // 2]
        if fault == "altered":
            leaf.mul_(2.0)
        else:
            leaf.view(-1)[leaf.numel() // 2] = float("nan")
        return update(grads, *args, **kw)

    if fault not in TRAIN_FAULTS:
        raise ValueError(f"no fault {fault!r}")
    train_lib.make_train_step = make_broken
    if fault in ("altered", "nan"):
        train_lib.adamw_update = broken_grads
    try:
        yield
    finally:
        train_lib.make_train_step, train_lib.adamw_update = make, update
