"""Checkpointing: atomic, keep-N, preemption-safe.

The counterpart of ``repro.checkpoint.manager``, the same layout::

    <dir>/step_00000123/arrays.npz     the flattened tree (path-keyed)
    <dir>/step_00000123/meta.json      step, extra state ("treedef": null)
    <dir>/step_00000123/.complete      commit marker

Path keys join dict keys and list indices with ``/``, as the JAX package
writes them.  Save writes into ``step_N.tmp`` and then ``os.replace``\\ s it,
so a crash mid-save never corrupts the latest checkpoint.  bf16 leaves are
stored as float32 (numpy has no bfloat16) and cast back on restore.

A checkpoint the JAX package's trainer wrote keeps the layer stack as
leaves with a leading period axis (``params/stack/b0_attn/...``); the
port's tree has a list of periods (``params/stack/0/b0_attn/...``).
``restore`` reads a period of such a leaf where the port's key names it
(``interop.checkpoint_source``), for the parameters and every optimizer
tree alike, so a JAX run resumes, or serves, in the port.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.interop import checkpoint_source
from repro_torch.models.common import tree_map, tree_paths


def path_key(path) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(t) -> np.ndarray:
    t = torch.as_tensor(t).detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._preempted = threading.Event()

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: dict | None = None) -> str:
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = {path_key(p): _to_numpy(leaf) for p, leaf in tree_paths(tree)}
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        meta = {"step": step, "extra": extra or {}, "treedef": None}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        open(os.path.join(tmp, ".complete"), "w").close()
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for d in sorted(os.listdir(self.dir)):
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, d, ".complete")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, device=None) -> tuple[Any, dict]:
        """Restore into the structure of ``like`` (a tree of tensors; meta
        tensors do): each leaf a new tensor of its ``like`` leaf's dtype, on
        ``device`` (default: the ``like`` leaf's device, the CPU for a meta
        leaf).  Only the arrays ``like`` names are read.  Raises KeyError on
        a missing key, ValueError on a shape mismatch."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        leaves = []
        with np.load(os.path.join(path, "arrays.npz")) as npz:
            files = set(npz.files)
            stacked = (None, None)          # the JAX stacked leaf last read
            for p, leaf in tree_paths(like):
                key = path_key(p)
                src, period = checkpoint_source(key, files)
                if src is None:
                    raise KeyError(f"checkpoint step {step} has no {key!r}")
                if period is None:
                    arr = npz[src]
                else:
                    if stacked[0] != src:
                        stacked = (src, npz[src])
                    if period >= len(stacked[1]):
                        raise KeyError(f"checkpoint step {step} has no "
                                       f"{key!r}: {src} holds "
                                       f"{len(stacked[1])} periods")
                    arr = stacked[1][period]
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"{key}: checkpoint shape {arr.shape} "
                                     f"vs {tuple(leaf.shape)}")
                dev = device if device is not None else (
                    "cpu" if leaf.device.type == "meta" else leaf.device)
                leaves.append(torch.as_tensor(arr).to(device=dev,
                                                      dtype=leaf.dtype))
        it = iter(leaves)
        return tree_map(lambda _: next(it), like), meta["extra"]

    def restore_latest(self, like: Any, device=None):
        step = self.latest_step()
        if step is None:
            return None, None, None
        tree, extra = self.restore(step, like, device)
        return step, tree, extra

    # -- preemption -------------------------------------------------------------
    def install_preemption_handler(self) -> None:
        """SIGTERM -> set the preempted flag; the train loop checks it each
        step and makes an emergency save and a clean exit."""
        def handler(signum, frame):
            self._preempted.set()
        signal.signal(signal.SIGTERM, handler)

    @property
    def preempted(self) -> bool:
        return self._preempted.is_set()

    def simulate_preemption(self) -> None:   # for tests
        self._preempted.set()
