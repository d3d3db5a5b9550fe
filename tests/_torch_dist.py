"""The worker side of the port's multi-rank CPU tests.

``run_group`` spawns a group of gloo ranks on the CPU (``torch.
multiprocessing``, spawn), each joined through a ``file://`` store of its
own under the test's ``tmp_path`` (xdist runs several groups at once), and
fails the test when the group outlives its deadline: a hung collective
then fails its test instead of the suite's clock.  The workers import only
``torch`` and ``repro_torch``: the tests compute the JAX package's
reference in the pytest process and hand it over as numpy.  A worker
checks its own rank's results and raises on a mismatch; ``run_group``
re-raises the first failure.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

#: seconds a group may take before its test fails (four gloo ranks spawn
#: and finish a smoke-size step in ~5-15 s here)
DEADLINE = 150.0
#: gradients, relative L2 a leaf, where the default 1e-5 is not the
#: arch's own bound: zamba2's f32 gradients lie 2.6e-5 (the port) and
#: 3.7e-5 (the JAX package) from a float64 run, so two f32 sum orders
#: differ by about as much; tests/test_torch_autograd.py's GRAD_BOUND
GRAD_REL_L2 = {"zamba2-1.2b": 1e-4}


def run_group(fn, world: int, tmp_path, *args, deadline: float = DEADLINE):
    """Run ``fn(rank, world, *args)`` on ``world`` spawned gloo ranks."""
    os.makedirs(str(tmp_path), exist_ok=True)
    store = os.path.join(str(tmp_path), f"store_{fn.__name__}")
    ctx = torch.multiprocessing.start_processes(
        _entry, args=(fn, world, store, args), nprocs=world, join=False,
        start_method="spawn")
    end = time.monotonic() + deadline
    while not ctx.join(timeout=max(0.1, end - time.monotonic())):
        if time.monotonic() >= end:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(timeout=10)
            raise TimeoutError(f"{fn.__name__} on {world} ranks passed its "
                               f"{deadline:.0f} s deadline")
    assert all(not p.is_alive() for p in ctx.processes)


def run_alone(fn, *args, deadline: float = DEADLINE):
    """``fn(*args)`` in one spawned process of its own (no default group:
    the dry run opens its fake one there), its result returned."""
    import concurrent.futures
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        return pool.submit(fn, *args).result(timeout=deadline)


def _entry(rank, fn, world, store, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=DEADLINE))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _cfg(arch, **overrides):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype="float32",
                               kv_cache_dtype="float32", **overrides)


def _mesh(data, model):
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(data, model, "cpu")


def _rows(x, sh):
    """This rank's batch rows (the batch dim over the data axis)."""
    return x.chunk(sh.axis_size("data"), dim=0)[sh.axis_index("data")]


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _close(got, want, what, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _lm(cfg, minfo, values):
    """An LM on the CPU holding the carried (full) ``values``."""
    from repro_torch import interop
    from repro_torch.models.model import LM

    lm = LM(cfg, minfo, device="cpu")
    interop.load_jax_params(lm, values)
    return lm


def _flat(tree):
    from repro_torch.models.common import tree_paths

    return {"/".join(map(str, p)): v for p, v in tree_paths(tree)}


# ---------------------------------------------------------------------------
# Workers
# ---------------------------------------------------------------------------


def sharded_forward(rank, world, data, model, cases):
    """For each (arch, overrides, JAX values, tokens, reference logits,
    reference loss, reference decode logits, reference gradients or
    None): the sharded prefill's logits (this rank's rows), the
    data-averaged CE loss, one decode step's logits on a sharded cache and
    the CE loss's gradients (averaged over the data axis, gathered) equal
    the single-device port's."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime import train_lib

    mesh = _mesh(data, model)
    for (arch, overrides, values, tokens, want_logits, want_loss,
         want_decoded, want_grads) in cases:
        cfg = _cfg(arch, **overrides)
        with sh.use_mesh(mesh):
            lm = _lm(cfg, sh.mesh_info(mesh), values)
            params = lm.train_mode().shard()
            toks = _rows(torch.from_numpy(tokens), sh)
            with torch.no_grad():
                logits, _ = lm.prefill(params, {"tokens": toks})
                decoded, _ = lm.decode_step(params, lm.init_cache(
                    tokens.shape[0], 8), toks[:, :1], 0)
            _, m = lm.loss_fn(params, {"tokens": toks, "labels": toks})
            loss = sh.all_reduce_(m["ce_loss"].detach().clone(), "data") \
                / data
            _close(logits, _rows(torch.from_numpy(want_logits), sh),
                   f"{arch} logits on ({data}, {model}), rank {rank}")
            _close(decoded, _rows(torch.from_numpy(want_decoded), sh),
                   f"{arch} decode on ({data}, {model}), rank {rank}")
            if want_grads is not None:
                grads = torch.autograd.grad(m["ce_loss"], tree_leaves(params))
                synced, _ = train_lib._data_sync(
                    lm, train_lib._unflatten(params, list(grads)), None)
                bound = GRAD_REL_L2.get(arch, 1e-5)
                for path, g in _flat(sh.gather_tree(synced,
                                                    lm.specs())).items():
                    assert _rel_l2(g, want_grads[path]) <= bound, \
                        (arch, path, _rel_l2(g, want_grads[path]))
        _close(loss, want_loss, f"{arch} CE loss on ({data}, {model})")


def fsdp_train(rank, world, data, model, values, batches, want_grads,
               want_losses, want_params):
    """qwen2-7b smoke, FSDP on (data, model): the first step's gradients
    (data-averaged, gathered) within 1e-5 relative L2 a leaf; under
    int8_ef their sync (:func:`int8_sync`); the losses of three steps
    within 1e-5, the parameters after them within 1e-4 relative L2 a leaf
    (AdamW's first moves are near sign(g) * lr).  Also: ``LM.init``
    cutting leaf by leaf gives :meth:`LM.shard`'s shards, and
    ``init_cache`` the shards' shapes."""
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.optim import init_opt_state
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime import train_lib
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import LM

    mesh = _mesh(data, model)
    cfg = _cfg("qwen2-7b")
    tcfg = TrainConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    pcfg = ParallelConfig(fsdp=True)
    with sh.use_mesh(mesh):
        minfo = sh.mesh_info(mesh, fsdp=True)
        lm = _lm(cfg, minfo, values)
        lm.train_mode()
        params = lm.shard()
        specs = lm.specs()
        assert any("data" in sh.spec_axes(s) for s in tree_leaves(specs))
        # the first step's gradients, as the step syncs them
        b0 = {k: _rows(torch.from_numpy(v), sh) for k, v in batches[0].items()}
        loss, _ = lm.loss_fn(params, b0)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        gtree = train_lib._unflatten(params, list(grads))
        # (the sync all-reduces in place)
        synced, _ = train_lib._data_sync(
            lm, train_lib._unflatten(params, [g.clone() for g in grads]),
            None)
        full = _flat(sh.gather_tree(synced, specs))
        for path, g in full.items():
            assert _rel_l2(g, want_grads[path]) <= 1e-5, \
                (path, _rel_l2(g, want_grads[path]))
        int8_sync(lm, gtree, want_grads)
        opt = init_opt_state(params, train_lib.make_adamw_config(cfg, tcfg))
        step = train_lib.make_train_step(lm, tcfg, pcfg)
        for i, batch in enumerate(batches):
            local = {k: _rows(torch.from_numpy(v), sh)
                     for k, v in batch.items()}
            params, opt, m = step(params, opt, local)
            _close(m["loss"], want_losses[i], f"step {i + 1} loss")
        full = _flat(sh.gather_tree(params, specs))
        # the init cut leaf by leaf, and the cache at its local shapes
        drawn = [LM(cfg, minfo, device="cpu") for _ in range(2)]
        cut = drawn[0].init(torch.Generator().manual_seed(5), shard=True)
        drawn[1].init(torch.Generator().manual_seed(5))
        for a, b in zip(tree_leaves(cut), tree_leaves(drawn[1].shard()),
                        strict=True):
            assert torch.equal(a, b)
        cache = drawn[0].init_cache(4, 8)
        with sh.use_mesh(None):
            whole = drawn[0].init_cache(4, 8)
        for a, b in zip(tree_leaves(cache), tree_leaves(sh.shard_tree(
                whole, drawn[0].cache_specs())), strict=True):
            assert a.shape == b.shape and a.dtype == b.dtype \
                and not a.any(), (a.shape, b.shape)
    for path, p in full.items():
        assert _rel_l2(p.detach(), want_params[path]) <= 1e-4, \
            (path, _rel_l2(p.detach(), want_params[path]))


def int8_sync(lm, grads, want_grads):
    """Under int8_ef, ``train_lib._data_sync`` of this rank's first-step
    gradients ``grads``, twice (the second time with the first's error
    buffer), in the JAX package's stacked layout.  Every leaf, FSDP or
    not, against the JAX package's round trip on the synchronised
    gradient, made here from the single-device gradients ``want_grads``
    (one scale for the whole tensor: the max over its shards): the
    dequantised gradient and the error buffer agree within one quantum (a
    rounding tie apart), and to 1e-3 of a quantum on all but 1 % of the
    leaf's elements."""
    from repro_torch.optim import (dequantize_int8, init_error_buffer,
                                   quantize_int8)
    from repro_torch.models.common import tree_map
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime import train_lib

    def stacked(tree):
        return _flat(train_lib.stack_periods(tree))

    mean = stacked(train_lib._unflatten(
        grads, [torch.from_numpy(want_grads[p]) for p in _flat(grads)]))
    specs = _flat_specs(train_lib.stack_spec_periods(lm.specs()))
    err = init_error_buffer(grads)
    n_fsdp = 0
    for round_ in range(2):
        # (the sync all-reduces the gradients in place)
        synced, new_err = train_lib._data_sync(
            lm, tree_map(torch.clone, grads), err)
        got_g, got_e = stacked(synced), stacked(new_err)
        e_full = stacked(sh.gather_tree(err, lm.specs()))
        for path, spec in specs.items():
            n_fsdp += "data" in sh.spec_axes(spec)
            corrected = mean[path] + e_full[path]
            q, s = quantize_int8(corrected)
            for what, got, want in (
                    ("gradient", got_g, dequantize_int8(q, s)),
                    ("error", got_e, corrected - dequantize_int8(q, s))):
                d = (got[path] - sh.shard_tensor(want, spec)).abs()
                tag = f"{what} {path}, round {round_ + 1}"
                assert float(d.max()) <= 1.001 * float(s), \
                    (tag, float(d.max()), float(s))
                assert int((d > 1e-3 * s).sum()) <= max(2, d.numel() // 100), \
                    (tag, int((d > 1e-3 * s).sum()), d.numel())
        err = new_err
    assert n_fsdp


def masked_dp(rank, world, values, batch, want_loss, want_grads):
    """qwen2-1.5b smoke on a (2, 1) data-parallel mesh, a ``loss_mask``
    that leaves the ranks different numbers of tokens: each rank's CE
    loss is the global masked mean (f32 1e-5) and the gradients averaged
    over the data axis are its gradients (1e-5 relative L2 a leaf), both
    as one device computes them on the whole batch."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime import train_lib

    mesh = _mesh(2, 1)
    with sh.use_mesh(mesh):
        lm = _lm(_cfg("qwen2-1.5b"), sh.mesh_info(mesh), values)
        params = lm.train_mode().shard()
        local = {k: _rows(torch.from_numpy(v), sh) for k, v in batch.items()}
        _, m = lm.loss_fn(params, local, remat="none")
        _close(m["ce_loss"].detach(), want_loss,
               f"masked CE loss, rank {rank}")
        grads = torch.autograd.grad(m["ce_loss"], tree_leaves(params))
        synced, _ = train_lib._data_sync(
            lm, train_lib._unflatten(params, list(grads)), None)
        for path, g in _flat(synced).items():
            assert _rel_l2(g, want_grads[path]) <= 1e-5, \
                (rank, path, _rel_l2(g, want_grads[path]))


def int8_ef_dp(rank, world, values, batches, want_metrics, want_params):
    """qwen2-1.5b smoke on a (2, 1) data-parallel mesh, int8_ef, two
    steps (the error buffer carried into the second): rank 1's tokens
    weigh 1e-3 of rank 0's in the ``loss_mask``, so its gradient of every
    leaf is about 1e-3 of rank 0's.  The losses and gradient norms equal
    the single-device int8_ef steps' on the whole batch within 1e-5, and
    the parameters after them within 1e-4 relative L2 a leaf
    (:func:`fsdp_train`'s bounds)."""
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.optim import init_error_buffer, init_opt_state
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime import train_lib

    mesh = _mesh(2, 1)
    cfg = _cfg("qwen2-1.5b")
    tcfg = TrainConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    with sh.use_mesh(mesh):
        lm = _lm(cfg, sh.mesh_info(mesh), values)
        params = lm.train_mode().shard()
        opt = init_opt_state(params, train_lib.make_adamw_config(cfg, tcfg))
        opt["err"] = init_error_buffer(params)
        step = train_lib.make_train_step(
            lm, tcfg, ParallelConfig(grad_compression="int8_ef"))
        for i, batch in enumerate(batches):
            local = {k: _rows(torch.from_numpy(v), sh)
                     for k, v in batch.items()}
            params, opt, m = step(params, opt, local)
            _close(torch.stack([m["loss"], m["grad_norm"]]).detach(),
                   want_metrics[i], f"step {i + 1} loss and grad_norm, "
                                    f"rank {rank}")
    for path, p in _flat(params).items():
        assert _rel_l2(p.detach(), want_params[path]) <= 1e-4, \
            (rank, path, _rel_l2(p.detach(), want_params[path]))


def seq_sharded_decode(rank, world, values, cache, steps, want_logits,
                       want_cache):
    """zamba2 smoke on a (2, 1) mesh, the KV caches' sequence axis split
    over the data axis (``serve_plan``'s long decode) and every cache
    leaf seeded (``cache``, the whole tree): greedy decode steps at
    ``steps`` (token, position) pairs give the unsharded decode's logits
    (f32 1e-5), finite on a rank whose every key lies past the position;
    only the owner of a position writes it, so each rank's cache ends as
    its shard of the unsharded one (f32 1e-5: the layers after the first
    attention site see its output in another sum order); each attention
    site issues its three
    all-reduces over data a step (max, sum of weights, weighted values)."""
    from repro_torch.runtime import serve_lib
    from repro_torch.runtime import sharding as sh

    mesh = _mesh(2, 1)
    with sh.use_mesh(mesh):
        lm = _lm(_cfg("zamba2-1.2b"), sh.mesh_info(mesh), values)
        params = lm.shard()
        caches = lm.init_cache(1, 16, seq_shard=True, batch_shard=False)
        specs = lm.cache_specs(seq_shard=True, batch_shard=False)
        for path, t in _flat(sh.shard_tree(
                tree_map_np(cache, caches), specs)).items():
            _flat(caches)[path].copy_(t)
        decode = serve_lib.make_decode_step(lm, seq_shard=True)
        sh.reset_collective_counts()
        with torch.no_grad():
            for (tok, pos), want in zip(steps, want_logits):
                _, logits, caches = decode(params, caches,
                                           torch.tensor([[tok]]), pos)
                assert torch.isfinite(logits).all(), (rank, pos)
                _close(logits, want, f"seq-sharded decode at {pos}, rank "
                                     f"{rank}")
        counts = sh.collective_counts()
        sites = lm.cfg.block_pattern.count("shared_attn")
        assert counts["all_reduce over data"]["calls"] \
            == 3 * sites * len(steps), counts
        want = _flat(sh.shard_tree(tree_map_np(want_cache, caches), specs))
        for path, t in _flat(caches).items():
            _close(t, want[path], f"cache {path}, rank {rank}")


def tree_map_np(tree, like):
    """The numpy tree ``tree`` as tensors in ``like``'s structure."""
    from repro_torch.models.common import tree_zip

    return tree_zip(lambda a, t: torch.from_numpy(np.asarray(a)), tree, like)


def dry_cell(kwargs):
    """``launch.dryrun.run_cell(**kwargs)`` (run it through
    :func:`run_alone`)."""
    from repro_torch.launch import dryrun

    return dryrun.run_cell(**kwargs)


def probe_vs_direct(arch, shape_name, cfg, shape, mesh_shape):
    """``roofline_probe.probe_cell`` and a direct dry run of the
    full-depth config at the probe's attention chunk (run it through
    :func:`run_alone`)."""
    from repro_torch.launch import dryrun, roofline_probe

    probe = roofline_probe.probe_cell(arch, shape_name, cfg=cfg, shape=shape,
                                      mesh_shape=mesh_shape)
    full = dataclasses.replace(cfg, attn_chunk=max(shape.seq_len,
                                                   cfg.attn_chunk))
    direct = dryrun.run_cell(arch, shape_name, False, cfg=full, shape=shape,
                             mesh_shape=mesh_shape)
    return probe, direct


def real_cell(rank, world, kwargs, want):
    """The step a dry-run record ``want`` counted (``kwargs`` are its
    ``run_cell`` arguments: cfg, shape, pcfg, mesh_shape), run for real on
    these gloo ranks at the same local shapes, from a seeded state and
    batch: its collectives (calls and bytes by op and axis), its flops
    (``FlopCounterMode``) and the bytes of its inputs and outputs equal
    the record's."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import input_specs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.models.model import LM
    from repro_torch.runtime import serve_lib
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.train_lib import (init_train_state,
                                               make_train_step)

    cfg, shape, pcfg = kwargs["cfg"], kwargs["shape"], kwargs["pcfg"]
    mesh = _mesh(*kwargs["mesh_shape"])
    with sh.use_mesh(mesh):
        minfo = sh.mesh_info(mesh, fsdp=pcfg.fsdp)
        lm = LM(cfg, minfo, device="cpu")
        tcfg = TrainConfig()
        params, _, opt, _ = init_train_state(
            lm, tcfg, torch.Generator().manual_seed(0), pcfg)
        gen = torch.Generator().manual_seed(1)
        bspecs = sh.batch_specs(cfg, shape, minfo)
        batch = {}
        for k, v in input_specs(cfg, shape).items():
            full = (torch.randn(v.shape, generator=gen).to(v.dtype)
                    if v.is_floating_point() else
                    torch.randint(0, cfg.vocab_size, v.shape, generator=gen,
                                  dtype=v.dtype))
            batch[k] = sh.shard_tensor(full, bspecs[k])
        if shape.kind == "train":
            args, run = (params, opt, batch), make_train_step(lm, tcfg, pcfg)
        elif shape.kind == "prefill":
            args, run = (params, batch), torch.no_grad()(lm.prefill)
        else:
            plan = serve_lib.serve_plan(cfg, shape, minfo)
            seq_shard = plan["seq_shard"] and pcfg.seq_shard_long_kv
            caches = lm.init_cache(shape.global_batch, shape.seq_len,
                                   seq_shard=seq_shard,
                                   batch_shard=plan["batch_shard"])
            args = (params, caches, batch["token"],
                    torch.zeros((), dtype=torch.int32))
            run = torch.no_grad()(serve_lib.make_decode_step(
                lm, seq_shard=seq_shard))
        arg_bytes = tree_bytes(args)
        sh.reset_collective_counts()
        with FlopCounterMode(display=False) as flops:
            out = run(*args)
        got = {"collectives": sh.collective_counts(),
               "flops": float(flops.get_total_flops()),
               "argument_size_in_bytes": arg_bytes,
               "output_size_in_bytes": tree_bytes(out)}
    assert got == {k: want[k] for k in got}, (rank, got, want)


def _flat_specs(specs):
    from repro_torch.models.common import tree_paths

    return {"/".join(map(str, p)): v for p, v in tree_paths(specs)}


def moe_ep(rank, world, ep_case, pad_case, psum_case):
    """On a (2, 2) mesh: ``apply_moe_ep`` == ``apply_moe`` (kimi-k2 smoke,
    capacity factor 64), forward and gradients; granite's experts padded
    under the mesh (5 -> 6) give the unpadded block's output on both
    paths; ``psum_compressed`` over all four ranks (the data and model
    axes flattened) == the sum of the ranks' int8 payloads at the mean
    scale, each rank keeping its own error buffer."""
    from repro_torch.models import moe
    from repro_torch.optim import psum_compressed
    from repro_torch.runtime import sharding as sh

    mesh = _mesh(2, 2)
    with sh.use_mesh(mesh):
        minfo = sh.mesh_info(mesh)
        specs = {"router": (None, None), "w_gate": ("model", None, None),
                 "w_up": ("model", None, None),
                 "w_down": ("model", None, None)}
        # -- EP vs the single-device block -------------------------------
        params, x, want_y, want_grads = ep_case
        cfg = _cfg("kimi-k2-1t-a32b", capacity_factor=64.0)
        assert moe.moe_specs(cfg, minfo) == specs
        assert moe.ep_applicable(cfg, minfo, x.shape[1])
        local = {k: sh.shard_tensor(torch.from_numpy(v), specs[k])
                 .requires_grad_(True) for k, v in params.items()}
        xl = _rows(torch.from_numpy(x), sh)
        sh.reset_collective_counts()
        y, aux = moe.apply_moe_ep(local, xl, cfg, minfo)
        _close(y.detach(), _rows(torch.from_numpy(want_y), sh),
               f"EP forward, rank {rank}")
        counts = sh.collective_counts()
        assert counts["all_to_all over model"]["calls"] == 2, counts
        loss = y.float().square().sum()
        grads = torch.autograd.grad(loss, list(local.values()))
        for (name, g) in zip(local, grads):
            g = sh.all_reduce_(g.clone(), "data")        # the batch's sum
            want = sh.shard_tensor(torch.from_numpy(want_grads[name]),
                                   specs[name])
            assert _rel_l2(g, want) <= 1e-5, (name, _rel_l2(g, want))
        # -- expert padding under the mesh -------------------------------
        params, x, want_y = pad_case
        cfg = _cfg("granite-moe-3b-a800m", capacity_factor=64.0)
        assert moe.padded_experts(cfg, minfo) == 6
        local = {k: sh.shard_tensor(torch.from_numpy(v), specs[k])
                 for k, v in params.items()}
        xl = _rows(torch.from_numpy(x), sh)
        with torch.no_grad():
            for path in (moe.apply_moe, moe.apply_moe_ep):
                y, _ = path(local, xl, cfg, minfo)
                _close(y, _rows(torch.from_numpy(want_y), sh),
                       f"{path.__name__} padded, rank {rank}")
        # -- psum_compressed over the four ranks --------------------------
        grads, errs, want_sum, want_err = psum_case
        got, err = psum_compressed(
            {k: torch.from_numpy(v[rank]) for k, v in grads.items()},
            {k: torch.from_numpy(v[rank]) for k, v in errs.items()},
            ("data", "model"))
        for k in grads:         # gloo may sum the four scales in any order
            np.testing.assert_allclose(got[k].numpy(), want_sum[k],
                                       rtol=1e-6, atol=0, err_msg=k)
            np.testing.assert_array_equal(err[k].numpy(), want_err[k][rank],
                                          err_msg=k)


def one_rank_bitwise(rank, world, archs):
    """A (1, 1) mesh, for each of ``archs``: two FSDP + int8_ef train
    steps, a prefill and a decode step equal the unsharded path from the
    same seed bit for bit (every collective over one rank is the
    identity); the steps issue their FSDP gathers and scatters and the
    int8 all-reduce."""
    for arch in archs:
        _one_rank_bitwise(arch)


def _one_rank_bitwise(arch):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (ParallelConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.data import make_batch
    from repro_torch.models.common import HOST_MESH, tree_leaves
    from repro_torch.models.model import LM
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.train_lib import (init_train_state,
                                               make_train_step)

    cfg = get_config(arch, smoke=True)
    tcfg = TrainConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    pcfg = ParallelConfig(fsdp=True, grad_compression="int8_ef")
    batches = [make_batch(cfg, ShapeConfig("t", "train", 16, 4), i, seed=3)
               for i in range(2)]
    out = {}
    mesh = _mesh(1, 1)
    for name in ("plain", "mesh"):
        with sh.use_mesh(mesh if name == "mesh" else None):
            minfo = sh.mesh_info(mesh, fsdp=True) if name == "mesh" \
                else HOST_MESH
            lm = LM(cfg, minfo, device="cpu")
            params, _, opt, _ = init_train_state(
                lm, tcfg, torch.Generator().manual_seed(11), pcfg)
            step = make_train_step(lm, tcfg, pcfg)
            sh.reset_collective_counts()
            metrics = []
            for b in batches:
                params, opt, m = step(params, opt, b)
                metrics.append(torch.stack([m["loss"], m["grad_norm"]]))
            counts = sh.collective_counts()
            with torch.no_grad():
                logits, caches = lm.prefill(params, {
                    "tokens": batches[0]["tokens"][:, :8]})
                full = lm.init_cache(4, 12)
                tok = batches[0]["tokens"][:, :1]
                dec, _ = lm.decode_step(params, full, tok, 0)
            out[name] = (tree_leaves([params, opt]), metrics, logits, dec,
                         counts)
    (p0, m0, l0, d0, c0), (p1, m1, l1, d1, c1) = out["plain"], out["mesh"]
    assert c0 == {}, c0
    for op in ("all_gather over data", "reduce_scatter over data",
               "all_reduce over model", "all_reduce over data"):
        assert c1.get(op, {}).get("calls", 0) > 0, (op, c1)
    for a, b in zip(p0 + m0 + [l0, d0], p1 + m1 + [l1, d1], strict=True):
        assert torch.equal(a, b), (a, b)


def tp_step_collectives(rank, world, values, batch, want_loss, want_grads):
    """qwen2-1.5b smoke on a (1, 2) mesh, remat off: one train step's
    loss and gradients equal the single-device port's, and its collectives
    are the expected ones: per layer the two row-parallel all-reduces in
    the forward and the two column-parallel inputs' in the backward, the
    vocab lookup's, the cross-entropy's three and the logits input's, one
    for the clipping norm's model-sharded squares; the data-axis
    all-reduces of the gradients and metrics; no all-to-all, no
    all-gather.  The gradients with block remat, backpropagated on a
    thread of their own or after the ``use_mesh`` block has closed, are
    the same."""
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import init_opt_state
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime import train_lib

    mesh = _mesh(1, 2)
    cfg = _cfg("qwen2-1.5b")
    tcfg = TrainConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    pcfg = ParallelConfig(remat="none")
    with sh.use_mesh(mesh):
        lm = _lm(cfg, sh.mesh_info(mesh), values)
        lm.train_mode()
        params = lm.shard()
        specs = lm.specs()
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        sh.reset_collective_counts()
        loss, _ = lm.loss_fn(params, b, remat="none")
        fwd = sh.collective_counts()
        grads = torch.autograd.grad(loss, tree_leaves(params))
        _close(loss.detach(), want_loss, "loss")
        # block remat, its backward on another thread (as autograd runs it
        # on the card): the recompute must issue the forward's collectives
        # again there
        remat_loss, _ = lm.loss_fn(params, b, remat="block")
        remat_grads = []
        worker = threading.Thread(target=lambda: remat_grads.extend(
            torch.autograd.grad(remat_loss, tree_leaves(params))))
        worker.start()
        worker.join(timeout=120)
        assert not worker.is_alive() and remat_grads
        late_loss, _ = lm.loss_fn(params, b, remat="block")
    # ... and its backward called after the use_mesh block has closed
    late_grads = torch.autograd.grad(late_loss, tree_leaves(params))
    with sh.use_mesh(mesh):
        for got in (grads, remat_grads, late_grads):
            full = _flat(sh.gather_tree(
                train_lib._unflatten(params, list(got)), specs))
            for path, g in full.items():
                assert _rel_l2(g, want_grads[path]) <= 1e-5, \
                    (path, _rel_l2(g, want_grads[path]))
        opt = init_opt_state(params, train_lib.make_adamw_config(cfg, tcfg))
        sh.reset_collective_counts()
        train_lib.make_train_step(lm, tcfg, pcfg)(params, opt, b)
        step = sh.collective_counts()
    n_layers, n_leaves = cfg.n_layers, len(tree_leaves(params))
    assert fwd == {"all_reduce over model": {
        "calls": 2 * n_layers + 1 + 3,
        "bytes": fwd["all_reduce over model"]["bytes"]}}, fwd
    model_calls = (2 * n_layers + 1 + 3) + (2 * n_layers + 1) + 1
    assert set(step) == {"all_reduce over model", "all_reduce over data"}, \
        step
    assert step["all_reduce over model"]["calls"] == model_calls, step
    assert step["all_reduce over data"]["calls"] == n_leaves + 3, step


def pipeline(rank, world, params, x, want_y, want_grads):
    """``pipeline_apply`` over ``world`` stages == the sequential stack,
    forward and the gradients of sum(y^2) with respect to every stage's
    parameters."""
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.pipeline_parallel import (pipeline_apply,
                                                       split_stages)
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))

    def block(p, h):
        for w, b in zip(p["w"], p["b"]):
            h = torch.tanh(h @ w + b)
        return h

    full = {k: torch.from_numpy(v) for k, v in params.items()}
    staged = split_stages(full, world)
    with sh.use_mesh(mesh):
        local = {k: sh.shard_tensor(v, ("pod",) + (None,) * (v.ndim - 1))
                 .requires_grad_(True) for k, v in staged.items()}
    y = pipeline_apply(block, local, torch.from_numpy(x), mesh=mesh,
                       axis="pod")
    _close(y.detach(), want_y, f"pipeline forward, rank {rank}", atol=1e-6)
    grads = torch.autograd.grad(y.square().sum(), list(local.values()))
    n = params["w"].shape[0] // world
    for (name, g) in zip(local, grads):
        want = want_grads[name][rank * n:(rank + 1) * n]
        assert _rel_l2(g[0], want) <= 1e-5, (name, rank, _rel_l2(g[0], want))


def _copy_prefix(caches, pref):
    """A prefill's caches copied into the front of decode caches."""
    if isinstance(caches, dict):
        for key in caches:
            _copy_prefix(caches[key], pref[key])
    elif isinstance(caches, list):
        for c, p in zip(caches, pref, strict=True):
            _copy_prefix(c, p)
    else:
        caches[tuple(slice(0, n) for n in pref.shape)] = \
            pref.to(caches.dtype)


def mamba_prefill_decode(lm, params, tokens, fed):
    """``lm``'s prefill of ``tokens`` and three decode steps after it, the
    tokens ``fed`` fed in: (the prefill's logits, each step's logits, the
    caches after the steps)."""
    with torch.no_grad():
        logits, pref = lm.prefill(params, {"tokens": tokens})
        caches = lm.init_cache(tokens.shape[0], tokens.shape[1] + len(fed))
        _copy_prefix(caches, pref)
        steps = [lm.decode_step(params, caches, tok, tokens.shape[1] + i)[0]
                 for i, tok in enumerate(fed)]
    return logits, steps, caches


def mamba_mesh(rank, world, overrides, values, tokens, want):
    """zamba2 smoke with ``overrides`` on a (1, ``world``) mesh whose model
    axis divides d_inner but not the Mamba2 heads: the prefill's logits,
    three decode steps after it (logits, greedy tokens and the caches,
    gathered) within 1e-5 relative L2 of the single-device port's
    ``want``, and the CE loss's gradients (gathered) within 1e-4 a leaf;
    every Mamba2 block gathers its channels over the model axis."""
    from repro_torch.models import ssm
    from repro_torch.models.common import tree_leaves
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime import train_lib

    mesh = _mesh(1, world)
    cfg = _cfg("zamba2-1.2b", **overrides)
    toks = torch.from_numpy(tokens)
    fed = [torch.from_numpy(t) for t in want["fed"]]
    with sh.use_mesh(mesh):
        minfo = sh.mesh_info(mesh)
        assert ssm._tp_axes(cfg, minfo) == ("model", "model")
        lm = _lm(cfg, minfo, values)
        params = lm.train_mode().shard()
        sh.reset_collective_counts()
        logits, steps, caches = mamba_prefill_decode(lm, params, toks, fed)
        gathers = sh.collective_counts()["all_gather over model"]["calls"]
        assert gathers >= 4 * cfg.block_pattern.count("mamba2"), gathers
        assert _rel_l2(logits, want["logits"]) <= 1e-5, \
            (rank, _rel_l2(logits, want["logits"]))
        for i, got in enumerate(steps):
            assert _rel_l2(got, want["steps"][i]) <= 1e-5, \
                (rank, i, _rel_l2(got, want["steps"][i]))
            assert torch.equal(got.argmax(-1),
                               torch.from_numpy(want["steps"][i]).argmax(-1))
        whole = _flat(sh.gather_tree(caches, lm.cache_specs()))
        for path, c in whole.items():
            assert _rel_l2(c, want["cache"][path]) <= 1e-5, \
                (rank, path, _rel_l2(c, want["cache"][path]))
        _, m = lm.loss_fn(params, {"tokens": toks, "labels": toks})
        grads = torch.autograd.grad(m["ce_loss"], tree_leaves(params))
        synced, _ = train_lib._data_sync(
            lm, train_lib._unflatten(params, list(grads)), None)
        for path, g in _flat(sh.gather_tree(synced, lm.specs())).items():
            assert _rel_l2(g, want["grads"][path]) <= 1e-4, \
                (rank, path, _rel_l2(g, want["grads"][path]))


def init_shard_cases(rank, world, cases):
    """For each (arch, overrides, (data, model), fsdp): ``LM.init(shard=
    True)`` equals :meth:`LM.shard` of the whole ``LM.init()`` from the
    same seed, bit for bit, leaf for leaf (the ranks' meshes are cut from
    one group of ``world`` ranks)."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import LM
    from repro_torch.runtime import sharding as sh

    for arch, overrides, (data, model), fsdp in cases:
        cfg = dataclasses.replace(get_config(arch, smoke=True), **overrides)
        mesh = _mesh(data, model)
        with sh.use_mesh(mesh):
            minfo = sh.mesh_info(mesh, fsdp=fsdp)
            cut = LM(cfg, minfo, device="cpu").init(
                torch.Generator().manual_seed(rank + 3), shard=True)
            whole = LM(cfg, minfo, device="cpu")
            whole.init(torch.Generator().manual_seed(rank + 3))
            shards = whole.shard()
            assert any(sh.spec_axes(s) for s in tree_leaves(whole.specs()))
            for a, b in zip(tree_leaves(cut), tree_leaves(shards),
                            strict=True):
                assert a.shape == b.shape and a.dtype == b.dtype \
                    and torch.equal(a, b), (arch, rank, a.shape, b.shape)


def largest_tensor_mode():
    """A ``TorchDispatchMode`` that keeps the bytes of the largest tensor
    any operation run under it made (``.largest``) and that operation
    (``.op``)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Largest(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.largest, self.op = 0, None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    n = t.numel() * t.element_size()
                    if n > self.largest:
                        self.largest, self.op = n, str(func)
            return out

    return Largest()


def kimi_init_peak(layers):
    """kimi-k2-1t-a32b at full width cut to ``layers`` blocks, initialised
    with ``shard=True`` under ``FakeTensorMode`` as rank 0 of the 16x16
    production mesh (FSDP, as ``default_parallel`` has it) on the dry
    run's fake group (run it through :func:`run_alone`).  Returns the
    largest tensor made during the init and its operation, the two leaves
    that bound it (one expert's in f32, the largest non-expert leaf's in
    f32), the bytes of the rank's shards and the bytes its spec tree
    gives them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.common import tree_leaves, tree_paths, tree_zip
    from repro_torch.models.model import LM
    from repro_torch.runtime import sharding as sh

    full = get_config("kimi-k2-1t-a32b")
    cfg = dataclasses.replace(full, n_layers=layers,
                              block_pattern=full.block_pattern[:layers])
    pcfg = sh.default_parallel(full.name)
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        minfo = sh.mesh_info(mesh, fsdp=pcfg.fsdp)
        lm = LM(cfg, minfo, device="cpu")
        with torch.device("meta"):        # the global shapes
            values = LM(cfg, minfo, device="meta").init(torch.Generator())
        specs = lm.specs()
        with sh.use_mesh(mesh):
            expert = max(4 * math.prod(v.shape[1:])
                         for p, v in tree_paths(values) if "moe" in p
                         and p[-1] != "router")
            other = max(4 * v.numel() for p, v in tree_paths(values)
                        if not ("moe" in p and p[-1] != "router"))
            with FakeTensorMode():
                spec_bytes = sum(
                    t.numel() * t.element_size() for t in tree_leaves(
                        tree_zip(dryrun.local_empty, values, specs)))
                mode = largest_tensor_mode()
                with mode:
                    shards = lm.init(torch.Generator().manual_seed(0),
                                     shard=True)
                shard_bytes = sum(t.numel() * t.element_size()
                                  for t in tree_leaves(shards))
    return {"largest": mode.largest, "op": mode.op, "expert": expert,
            "other": other, "shard_bytes": shard_bytes,
            "spec_bytes": spec_bytes}
