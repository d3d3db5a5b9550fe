"""The training step: ``(params, opt_state, batch) -> updated``.

The counterpart of ``repro.runtime.train_lib``, eagerly:

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

Under an ambient mesh (``runtime.sharding.use_mesh``) the parameters, the
moments and the batch are this rank's shards (``init_train_state`` cuts
them; ``sharding.batch_specs`` says how the batch splits), and the
forward and backward issue the tensor-parallel and FSDP collectives
themselves.  The step then averages the gradients over the data axes:
an FSDP-sharded leaf's were already summed over them by the backward's
reduce-scatter; every other leaf's are all-reduced in full precision.
Under int8_ef every leaf then takes the JAX package's round trip on the
synchronised gradient: one scale a tensor of the JAX package's layout
(the max over the leaf's shards, all-reduced over the axes that shard
it) and one error buffer, equal on every data rank (each rank keeps its
shard of it).  ``optim.psum_compressed``, which quantises each rank's
own gradient, is not the step's: at the mean of the ranks' scales it
inflates the payloads of a rank whose gradient is far below another's.
With a ``loss_mask`` the loss is the global masked mean
(``layers.cross_entropy``).  The clipping
norm sums each leaf's squares over the axes that shard it, and the
metrics are averaged over the data axes.  On a one-rank mesh every
collective is the identity and the step is the unsharded one, bit for
bit.
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
    opt_state_specs,
)
from repro_torch.optim.compression import (
    compress_tree,
    decompress_tree,
    dequantize_int8,
    init_error_buffer,
    quantize_int8,
)
from repro_torch.runtime import sharding as sh


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


def stack_spec_periods(specs: dict) -> dict:
    """A spec tree in the JAX package's layout: the periods' specs (equal
    from period to period) become one spec a leaf with a leading ``None``
    for the period axis."""
    periods = specs.get("stack")
    if not periods:
        return specs
    return {**specs, "stack": tree_map(lambda s: (None,) + s, periods[0],
                                       is_leaf=sh.is_spec)}


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


def _data_sync(lm: LM, grads: dict, err):
    """The gradients averaged over the data axes of the ambient mesh (see
    the module's docstring), and the new error buffer (``err`` is None
    without int8_ef)."""
    dp, data_axes = lm.mesh.dp(), set(lm.mesh.data_axes)
    n = sh.axis_size(dp)

    def fsdp(spec):
        return bool(data_axes & set(sh.spec_axes(spec)))

    if err is None:
        return tree_zip(lambda g, s: (g if fsdp(s) else sh.all_reduce_(g, dp))
                        / n, grads, lm.specs()), None

    def one(g, e, spec):
        # the JAX package's round trip on the synchronised gradient: sum
        # it in full precision (an FSDP leaf's reduce-scatter already did),
        # then one scale for the whole tensor (its max over the shards) and
        # one error buffer, equal on every data rank
        if not fsdp(spec):
            g = sh.all_reduce_(g, dp)
        corrected = (g / n).float() + e
        amax = sh.all_reduce_(corrected.abs().max(), sh.spec_axes(spec),
                              "max")
        q, s = quantize_int8(corrected, amax)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), corrected - deq

    # one scale a tensor of the JAX package's layout (as on one rank)
    pairs = tree_zip(one, stack_periods(grads), stack_periods(err),
                     stack_spec_periods(lm.specs()))
    return (unstack_periods(tree_map(lambda t: t[0], pairs,
                                     is_leaf=_is_pair)),
            unstack_periods(tree_map(lambda t: t[1], pairs,
                                     is_leaf=_is_pair)))


def _is_pair(x) -> bool:
    return isinstance(x, tuple)


def sharded_global_norm(grads: dict, specs: dict) -> torch.Tensor:
    """The global norm of a tree of shards: each leaf's sum of squares
    summed over the axes that shard it (one all-reduce per set of axes),
    the total in leaf order as ``optim.global_norm`` takes it."""
    sq = [g.float().square().sum() for g in tree_leaves(grads)]
    by_axes: dict = {}
    for i, spec in enumerate(tree_leaves(specs)):
        if sh.communicates(sh.spec_axes(spec)):
            by_axes.setdefault(frozenset(sh.spec_axes(spec)), []).append(i)
    for axes, idx in by_axes.items():
        summed = sh.all_reduce_(torch.stack([sq[i] for i in idx]),
                                tuple(sorted(axes)))
        for j, i in enumerate(idx):
            sq[i] = summed[j]
    return torch.stack(sq).sum().sqrt()


def make_train_step(lm: LM, tcfg: TrainConfig, pcfg: ParallelConfig
                    ) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``.  With ``pcfg.grad_compression == "int8_ef"`` the
    opt state must carry an error buffer (see :func:`init_train_state`).
    The step runs under the mesh that is ambient when it is called."""
    ocfg = make_adamw_config(lm.cfg, tcfg)
    remat = pcfg.remat
    int8_ef = pcfg.grad_compression == "int8_ef"

    def grads_of(params, leaves, mb):
        loss, metrics = lm.loss_fn(params, mb, remat=remat)
        # a leaf the loss does not read (the audio frontend's token table)
        # gets a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), {
            k: torch.as_tensor(v, device=loss.device).detach()
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
        gnorm = None
        ebuf = opt_state.get("err") if int8_ef else None
        if sh.ambient_mesh() is not None:
            grads, ebuf = _data_sync(lm, grads, ebuf)
            gnorm = sharded_global_norm(grads, lm.specs())
            dp = lm.mesh.dp()
            loss, metrics = (
                sh.all_reduce_(loss.clone(), dp) / sh.axis_size(dp),
                {k_: sh.all_reduce_(v.clone(), dp) / sh.axis_size(dp)
                 for k_, v in metrics.items()})
        elif int8_ef:
            # int8 + error feedback on the gradient the optimizer sees (on
            # a fleet the quantisation rides the data all-reduce).  One
            # scale a tensor of the JAX package's layout: the periods of a
            # stacked leaf share it.
            stacked = stack_periods(grads)
            qtree, ebuf = compress_tree(stacked, stack_periods(ebuf))
            grads = unstack_periods(decompress_tree(qtree, stacked))
            ebuf = unstack_periods(ebuf)
        lr = lr_schedule(opt_state["step"], base_lr=tcfg.lr,
                         warmup=tcfg.warmup_steps, total=tcfg.total_steps)
        params, new_opt, om = adamw_update(grads, opt_state, params, lr,
                                           ocfg, decay_ranks(params), gnorm)
        if int8_ef:
            new_opt["err"] = ebuf
        return params, new_opt, {"loss": loss, "lr": lr, **om, **metrics}

    return train_step


def _state(lm: LM, values: dict, tcfg: TrainConfig,
           pcfg: ParallelConfig | None):
    specs = lm.specs()
    opt = init_opt_state(values, make_adamw_config(lm.cfg, tcfg))
    ospecs = opt_state_specs(specs)
    if pcfg is not None and pcfg.grad_compression == "int8_ef":
        opt["err"] = init_error_buffer(values)
        ospecs = {**ospecs, "err": specs}
    return values, specs, opt, ospecs


def init_train_state(lm: LM, tcfg: TrainConfig, generator: torch.Generator,
                     pcfg: ParallelConfig | None = None):
    """(param values, param specs, opt state, opt specs): ``lm``
    initialised from ``generator`` and made trainable, its values the tree
    the step trains.  Under an ambient mesh every rank draws the
    parameters from the same generator, leaf by leaf, and keeps its
    shard of each as it is drawn (``LM.init(shard=True)``); the opt state
    is built on the shards.  The specs are in the port's layout
    (``stack_spec_periods`` gives the JAX one)."""
    values = lm.init(generator, shard=sh.ambient_mesh() is not None)
    lm.train_mode()
    return _state(lm, values, tcfg, pcfg)


def abstract_train_state(lm: LM, tcfg: TrainConfig,
                         pcfg: ParallelConfig | None = None):
    """The state's global shapes and dtypes as ``meta`` tensors (no
    storage) with its spec trees, for the dry-run path and for
    ``CheckpointManager.restore``'s ``like``."""
    meta = LM(lm.cfg, lm.mesh, device="meta")
    with torch.device("meta"):
        values = meta.init(torch.Generator())
    return _state(meta, values, tcfg, pcfg)
