"""Multi-pod dry run: every (arch x shape x mesh) cell on fake ranks.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell's jitted step on 512 placeholder CPU devices and reads XLA's cost and
memory analyses.  The port has no compiler: one process joins a
``torch.distributed`` "fake" default group at the mesh's world size (256
or 512 ranks; its collectives return at once and move nothing), builds
the production mesh over it, makes this rank's state at its local shard
shapes as ``FakeTensorMode`` tensors (no storage), and runs the port's own
step on them: the train step (forward, remat, backward, the data sync,
AdamW), ``prefill`` or ``decode_step``.  It counts what the step does:

* ``flops``: this rank's floating-point operations
  (``torch.utils.flop_counter.FlopCounterMode``);
* ``bytes_accessed``: the operand and result bytes of every aten
  operation the rank runs eagerly (views excluded): unfused traffic, more
  than XLA's fused count;
* ``collective_*``: ``runtime.sharding.COLLECTIVES``, reset for the cell
  (``collectives`` keeps calls and bytes by op and axis);
* ``argument_size_in_bytes`` / ``output_size_in_bytes``: the exact bytes
  of the step's inputs and outputs on this rank;
* ``compile_seconds``: the seconds the fake run took.

No peak of live bytes is counted, so the record has no
``temp_size_in_bytes`` (the reference's lacks it too where XLA gives no
memory analysis).  No kernel runs: fake tensors are CPU tensors, so every
kernel wrapper takes its plain version (plain k-inner is one
``ref.gemm_ref`` call), as the reference runs no TPU kernel; nothing
queries or touches a CUDA device.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import (
    ARCH_IDS,
    get_config,
    input_specs,
    shape_cells,
    skipped_cells,
)
from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.core.roofline import collective_bytes
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.common import tree_leaves, tree_zip
from repro_torch.models.model import LM
from repro_torch.runtime import sharding as sh
from repro_torch.runtime.serve_lib import (
    abstract_cache,
    make_decode_step,
    serve_plan,
)
from repro_torch.runtime.train_lib import abstract_train_state, make_train_step


class OpBytes(TorchDispatchMode):
    """Adds up the bytes of the tensor operands and results of every aten
    operation dispatched under it, views excluded (they move nothing)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "aten" and not func.is_view:
            self.bytes += tree_bytes((args, kwargs, out))
        return out


@contextlib.contextmanager
def fake_group(world: int):
    """This process as rank 0 of a ``world``-rank "fake" default group for
    the block: its collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run opens its own fake default group; "
                           "this process already has a default group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def local_empty(t: torch.Tensor, spec) -> torch.Tensor:
    """An empty tensor of ``t``'s dtype at this rank's shard shape of
    ``t`` under ``spec`` on the ambient mesh."""
    shape = []
    for d, ax in zip(t.shape, tuple(spec) + (None,) * t.ndim):
        n = sh.axis_size(ax)
        if d % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"over {ax} ({n} ranks)")
        shape.append(d // n)
    return torch.empty(shape, dtype=t.dtype)


def tree_bytes(tree) -> int:
    """The bytes of every tensor in ``tree`` (dicts, lists and tuples)."""
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def config_fields(cfg, pcfg, unroll: bool) -> dict:
    """The record's keys that follow from the configs alone."""
    return {"model_params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "n_layers": cfg.n_layers, "unrolled": unroll, "fsdp": pcfg.fsdp}


def run_cell(arch: str, shape_name: str, multi_pod: bool, cfg=None,
             unroll: bool = False, pcfg=None, *, shape=None,
             mesh_shape=None) -> dict:
    """Run one cell on fake ranks; returns its record.

    ``cfg`` / ``unroll`` / ``pcfg`` override the arch's config and
    parallelism (the roofline probes, ``launch/roofline_probe.py``; the
    port always runs its layers one by one, so ``unroll`` only goes into
    the record).  ``shape`` (a ``ShapeConfig``) and ``mesh_shape`` (a
    ``(data, model)`` mesh in place of the production one) let the tests
    and ``chip_smoke.py`` run a cell at a size they can also run for
    real."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.runtime.sharding import default_parallel

    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    pcfg = pcfg or default_parallel(arch)
    if mesh_shape is not None:
        name, chips = "x".join(map(str, mesh_shape)), math.prod(mesh_shape)
    else:
        name, chips = ("2x16x16", 512) if multi_pod else ("16x16", 256)
    t0 = time.time()
    with fake_group(chips):
        mesh = (make_host_mesh(*mesh_shape, device_type="cpu")
                if mesh_shape is not None else
                make_production_mesh(multi_pod=multi_pod, device_type="cpu"))
        minfo = sh.mesh_info(mesh, fsdp=pcfg.fsdp)
        lm = LM(cfg, minfo, device="cpu")
        tcfg = TrainConfig()
        with sh.use_mesh(mesh):
            # the global shapes as meta tensors ...
            values, pspecs, opt, ospecs = abstract_train_state(lm, tcfg,
                                                               pcfg)
            bspecs = sh.batch_specs(cfg, shape, minfo)
            inputs = input_specs(cfg, shape)
            if shape.kind == "decode":
                plan = serve_plan(cfg, shape, minfo)
                seq_shard = plan["seq_shard"] and pcfg.seq_shard_long_kv
                caches, cspecs = abstract_cache(
                    lm, shape.global_batch, shape.seq_len,
                    seq_shard=seq_shard, batch_shard=plan["batch_shard"])
            # a group over several axes is cut from the mesh's (real) rank
            # tensor on first use: cut each one before the fake mode
            trees = [pspecs] + ([cspecs] if shape.kind == "decode" else [])
            for names in {sh.axis_names(minfo.dp())} | {
                    sh.spec_axes(spec) for tree in trees
                    for spec in tree_leaves(tree)}:
                if len(names) > 1:
                    sh.group(names)
            # ... and this rank's shards as fake ones
            with FakeTensorMode():
                params = tree_zip(local_empty, values, pspecs)
                batch = {k: local_empty(v, bspecs[k])
                         for k, v in inputs.items()}
                if shape.kind == "train":
                    args = (params, tree_zip(local_empty, opt, ospecs),
                            batch)
                    run = make_train_step(lm, tcfg, pcfg)
                elif shape.kind == "prefill":
                    args = (params, batch)
                    run = torch.no_grad()(lm.prefill)
                else:  # decode
                    args = (params, tree_zip(local_empty, caches, cspecs),
                            batch["token"], torch.zeros((), dtype=torch.int32))
                    run = torch.no_grad()(make_decode_step(
                        lm, seq_shard=seq_shard))
                sh.reset_collective_counts()
                with FlopCounterMode(display=False) as flops, \
                        OpBytes() as ops:
                    out = run(*args)
                collectives = sh.collective_counts()
                coll = collective_bytes(sh.COLLECTIVES)
                arg_bytes, out_bytes = tree_bytes(args), tree_bytes(out)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": name,
        "chips": chips,
        "ok": True,
        "compile_seconds": round(time.time() - t0, 1),
        "flops": float(flops.get_total_flops()),
        "bytes_accessed": float(ops.bytes),
        "collective_bytes": coll["_total"],
        "collective_count": coll["_count"],
        "collective_detail": {k: v for k, v in coll.items()
                              if not k.startswith("_") and v},
        "collectives": collectives,
        **config_fields(cfg, pcfg, unroll),
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": out_bytes,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true",
                    help="recompute cached cells")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    if args.all:
        cells = [(a, s.name) for a in ARCH_IDS for s in shape_cells(a)]
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    failures = []
    for arch, shape_name in cells:
        if shape_name in skipped_cells(arch):
            print(f"SKIP {arch} x {shape_name} (full attention; DESIGN.md §8)")
            continue
        for multi_pod in meshes:
            tag = f"{arch}__{shape_name}__{'multipod' if multi_pod else 'pod'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path) and not args.force:
                print(f"CACHED {tag}")
                continue
            print(f"RUN {tag} ...", flush=True)
            try:
                rec = run_cell(arch, shape_name, multi_pod)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"  OK flops={rec['flops']:.3e} "
                      f"coll={rec['collective_bytes']/1e9:.2f}GB "
                      f"({rec['compile_seconds']}s)")
            except Exception as e:  # noqa: BLE001 — record and continue
                failures.append((tag, repr(e)))
                print(f"  FAIL {tag}: {e}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print("\nall requested cells compiled OK")


if __name__ == "__main__":
    main()
