"""The training step: ``(params, opt_state, batch) -> updated``.

The counterpart of ``repro.runtime.train_lib`` on one device, eagerly:

* microbatch gradient accumulation (``ParallelConfig.microbatches``) is a
  Python loop that sums f32 gradients, where the JAX package runs a
  ``lax.scan``;
* remat per layer period (``ParallelConfig.remat``: ``block``, ``dots``,
  ``none``) through ``torch.utils.checkpoint`` (``LM.loss_fn``);
* ``grad_compression == "int8_ef"`` round-trips the gradient through int8
  with error feedback, the buffer kept in ``opt_state["err"]``.

The step updates the parameters and the optimizer's moments in place (the
JAX trainer donates them to its jitted step) and returns them with the
metrics ``loss``, ``lr``, ``grad_norm``, ``ce_loss`` and ``aux_loss``, all
0-d tensors on the parameters' device: a step reads nothing back to the
host.  The parameter leaves must be leaf tensors; the step makes them
trainable (``requires_grad``) if they are not.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, TrainConfig
from repro_torch.models.common import tree_leaves, tree_map, tree_zip
from repro_torch.models.model import LM
from repro_torch.optim import (
    AdamWConfig,
    adamw_update,
    init_opt_state,
    lr_schedule,
)
from repro_torch.optim.compression import (
    compress_tree,
    decompress_tree,
    init_error_buffer,
)


def make_adamw_config(cfg: ModelConfig, tcfg: TrainConfig) -> AdamWConfig:
    return AdamWConfig(b1=tcfg.b1, b2=tcfg.b2,
                       weight_decay=tcfg.weight_decay,
                       grad_clip=tcfg.grad_clip,
                       moment_dtype=cfg.opt_state_dtype)


def decay_ranks(params: dict) -> dict:
    """The rank AdamW's "decay matrices only" rule reads for each leaf: the
    JAX package stacks the layer periods' leaves, so it sees every leaf
    under ``stack`` one rank higher and decays the stacked norm scales and
    biases too.  The port keeps that (the tail and zamba2's shared block
    are not stacked in either package)."""
    return {k: tree_map(lambda p: p.ndim + (k == "stack"), v)
            for k, v in params.items()}


def stack_periods(tree: dict) -> dict:
    """``tree`` in the JAX package's layout: the list of layer periods
    under ``stack`` becomes one tensor a leaf with a leading period axis."""
    periods = tree.get("stack")
    if not periods:
        return tree
    return {**tree, "stack": tree_zip(lambda *xs: torch.stack(xs),
                                      periods[0], *periods[1:])}


def unstack_periods(tree: dict) -> dict:
    """The inverse of :func:`stack_periods`."""
    stacked = tree.get("stack")
    if not isinstance(stacked, dict) or not tree_leaves(stacked):
        return tree
    n = tree_leaves(stacked)[0].shape[0]
    return {**tree, "stack": [tree_map(lambda x: x[i], stacked)
                              for i in range(n)]}


def _split_microbatches(batch: dict, k: int) -> list[dict]:
    for x in batch.values():
        assert x.shape[0] % k == 0, (x.shape[0], k)
    return [{key: x.chunk(k, dim=0)[i] for key, x in batch.items()}
            for i in range(k)]


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def make_train_step(lm: LM, tcfg: TrainConfig, pcfg: ParallelConfig
                    ) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``.  With ``pcfg.grad_compression == "int8_ef"`` the
    opt state must carry an error buffer (see :func:`init_train_state`)."""
    ocfg = make_adamw_config(lm.cfg, tcfg)
    remat = pcfg.remat

    def grads_of(params, leaves, mb):
        loss, metrics = lm.loss_fn(params, mb, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: torch.as_tensor(v).detach()
                               for k, v in metrics.items()}, grads

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        with torch.enable_grad():
            if pcfg.microbatches > 1:
                k = pcfg.microbatches
                acc = [torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for p in leaves]
                loss = 0.0
                metrics = {}
                for mb in _split_microbatches(batch, k):
                    l_, m_, g_ = grads_of(params, leaves, mb)
                    for a, g in zip(acc, g_):
                        a += g
                    loss = loss + l_
                    for key, v in m_.items():
                        metrics[key] = metrics.get(key, 0.0) + v / k
                grads = [a / float(k) for a in acc]
                loss = loss / float(k)
            else:
                loss, metrics, grads = grads_of(params, leaves, batch)
        grads = _unflatten(params, grads)
        if pcfg.grad_compression == "int8_ef":
            # int8 + error feedback on the gradient the optimizer sees (on
            # a fleet the quantisation rides the cross-pod all-reduce).  One
            # scale a tensor of the JAX package's layout: the periods of a
            # stacked leaf share it.
            stacked = stack_periods(grads)
            qtree, ebuf = compress_tree(stacked,
                                        stack_periods(opt_state["err"]))
            grads = unstack_periods(decompress_tree(qtree, stacked))
            ebuf = unstack_periods(ebuf)
        lr = lr_schedule(opt_state["step"], base_lr=tcfg.lr,
                         warmup=tcfg.warmup_steps, total=tcfg.total_steps)
        params, new_opt, om = adamw_update(grads, opt_state, params, lr,
                                           ocfg, decay_ranks(params))
        if pcfg.grad_compression == "int8_ef":
            new_opt["err"] = ebuf
        return params, new_opt, {"loss": loss, "lr": lr, **om, **metrics}

    return train_step


def init_train_state(lm: LM, tcfg: TrainConfig, generator: torch.Generator,
                     pcfg: ParallelConfig | None = None):
    """(param values, opt state): ``lm`` initialised from ``generator`` and
    made trainable, its values the tree the step trains.  The JAX
    package's spec trees have no counterpart on one device."""
    values = lm.init(generator)
    lm.train_mode()
    opt = init_opt_state(values, make_adamw_config(lm.cfg, tcfg))
    if pcfg is not None and pcfg.grad_compression == "int8_ef":
        opt["err"] = init_error_buffer(values)
    return values, opt


def abstract_train_state(lm: LM, tcfg: TrainConfig,
                         pcfg: ParallelConfig | None = None):
    """The state's shapes and dtypes as ``meta`` tensors (no storage), for
    the dry-run path and for ``CheckpointManager.restore``'s ``like``."""
    meta = LM(lm.cfg, lm.mesh, device="meta")
    with torch.device("meta"):
        values = meta.init(torch.Generator())
    ocfg = make_adamw_config(lm.cfg, tcfg)
    opt = init_opt_state(values, ocfg)
    if pcfg is not None and pcfg.grad_compression == "int8_ef":
        opt["err"] = init_error_buffer(values)
    return values, opt
