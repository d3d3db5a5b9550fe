"""GPipe-style pipeline parallelism over a mesh axis.

The counterpart of ``repro.runtime.pipeline_parallel``.  The layer stack
is split into ``S`` equal stages along a mesh axis (the ``pod`` axis at
production scale); microbatches stream through the fill-drain schedule
over ``n_micro + S - 1`` ticks: at tick ``t`` stage ``s`` runs microbatch
``t - s`` and hands its output to stage ``s + 1`` with
``dist.batch_isend_irecv``.  The last stage's outputs reach every rank as
the JAX package does it: masked to zero elsewhere, then all-reduced.

It is differentiable.  The JAX package transposes ``collective_permute``;
here :class:`_Pipeline` is one autograd Function whose backward runs the
schedule in reverse: at each tick (last to first) a stage takes the
gradient of its output (from the loss on the last stage, from stage
``s + 1``'s input gradient elsewhere), backpropagates it through its own
block, keeps the parameters' gradients and sends the input's gradient to
stage ``s - 1``.  Every exchange is one both sides post at the same tick,
so no rank waits on a backward autograd may skip.  Bubble ticks (no
microbatch on the stage) compute nothing; the JAX package computes them
and discards the result.

The module is model-agnostic: it pipelines any per-stage
``block_fn(stage_params, x) -> x``.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.runtime import sharding as sh


def _exchange(send, send_to, recv, recv_from, c) -> None:
    """Post this tick's send and receive (either may be None) over the
    resolved axis ``c`` and wait."""
    ops = []
    if send is not None:
        sh.count_collective("send", c.names, send)
        ops.append(dist.P2POp(dist.isend, send.contiguous(),
                              dist.get_global_rank(c.group, send_to),
                              c.group))
    if recv is not None:
        sh.count_collective("recv", c.names, recv)
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(c.group, recv_from),
                              c.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _Pipeline(torch.autograd.Function):
    """(x_micro, *stage parameter leaves) -> the last stage's outputs on
    the last stage, zeros elsewhere."""

    @staticmethod
    def forward(ctx, x_micro, block_fn, unflatten, c, *leaves):
        s_idx, n_st = c.index, c.size
        n_micro = x_micro.shape[0]
        first, last = s_idx == 0, s_idx == n_st - 1
        params = [p.detach().requires_grad_(p.requires_grad)
                  for p in leaves]
        outs = torch.zeros_like(x_micro)
        buf = torch.empty_like(x_micro[0])
        ticks = {}                      # tick -> (input leaf, output)
        for t in range(n_micro + n_st - 1):
            m = t - s_idx                # this stage's microbatch
            y = None
            if 0 <= m < n_micro:
                x_in = (x_micro[m] if first else buf).detach() \
                    .requires_grad_(True)
                with torch.enable_grad():
                    y = block_fn(unflatten(params), x_in)
                ticks[t] = (x_in, y)
                if last:
                    outs[m] = y.detach()
            # stage s+1 runs microbatch m at tick t+1: it receives now
            recv = None
            if not first and 0 <= t - (s_idx - 1) < n_micro:
                buf = torch.empty_like(x_micro[0])
                recv = buf
            _exchange(None if last else y, s_idx + 1, recv, s_idx - 1, c)
        ctx.state = (ticks, params, c, n_micro)
        return outs

    @staticmethod
    def backward(ctx, g_outs):
        ticks, params, c, n_micro = ctx.state
        s_idx, n_st = c.index, c.size
        first, last = s_idx == 0, s_idx == n_st - 1
        g_params = [None if not p.requires_grad else torch.zeros_like(p)
                    for p in params]
        g_x = torch.zeros_like(g_outs)
        g_next = None                   # grad of the output sent last tick
        for t in reversed(range(n_micro + n_st - 1)):
            m = t - s_idx
            # stage s+1's input grad for microbatch m (its tick t+1)
            g_y = None
            if not last and 0 <= m < n_micro:
                g_y = torch.empty_like(g_outs[0])
            _exchange(g_next, s_idx - 1, g_y, s_idx + 1, c)
            g_next = None
            if not 0 <= m < n_micro:
                continue
            x_in, y = ticks[t]
            if last:
                g_y = g_outs[m]
            wanted = [x_in] + [p for p in params if p.requires_grad]
            got = torch.autograd.grad(y, wanted, g_y, allow_unused=True)
            it = iter(got[1:])
            for i, p in enumerate(params):
                if p.requires_grad:
                    g = next(it)
                    if g is not None:
                        g_params[i] += g
            g_in = got[0] if got[0] is not None else torch.zeros_like(x_in)
            if first:
                g_x[m] = g_in
            else:
                g_next = g_in           # goes to stage s-1 next tick
        return (g_x, None, None, None, *g_params)


def pipeline_apply(block_fn: Callable, stage_params, x_micro, *, mesh,
                   axis: str = "pod"):
    """Run microbatches through pipeline stages.

    block_fn: (params_for_one_stage, x) -> x
    stage_params: this rank's stage, a tree whose leaves have leading dim 1
        (the shard of ``split_stages``' leaves over ``axis``)
    x_micro: (n_micro, mb, ...) microbatched activations (replicated)
    mesh: the ``DeviceMesh`` holding ``axis`` (installed as the ambient
        mesh for the call)

    Returns (n_micro, mb, ...) outputs (replicated over ``axis``).
    """
    with sh.use_mesh(mesh):
        leaves = tree_leaves(stage_params)

        def unflatten(flat):
            it = iter(flat)
            return tree_map(lambda _: next(it)[0], stage_params)

        outs = _Pipeline.apply(x_micro, block_fn, unflatten, sh.comm(axis),
                               *leaves)
        # valid only on the last stage (zeros elsewhere): the sum
        # replicates it, and its backward hands every rank the gradient
        return sh.all_reduce(outs, axis)


def split_stages(stacked_params, n_stages: int):
    """(L, ...) stacked layer params -> (S, L/S, ...) stage-major."""
    def f(v):
        n_layers = v.shape[0]
        if n_layers % n_stages:
            raise ValueError(f"{n_layers} layers do not split into "
                             f"{n_stages} stages")
        return v.reshape(n_stages, n_layers // n_stages, *v.shape[1:])
    return tree_map(f, stacked_params)
