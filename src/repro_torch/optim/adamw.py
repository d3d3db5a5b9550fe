"""AdamW with global-norm clipping and dtype-configurable moments.

The counterpart of ``repro.optim.adamw``, with its arithmetic order: the
clip scale multiplies the gradient before the moments, the bias
corrections use ``step + 1``, weight decay applies to matrices only, and
the update is computed in f32 before the cast to the parameter's dtype.
``lr_schedule(0)`` is 0, so a run's first step moves nothing.

Trees are nested dicts (lists allowed) of tensors.  ``adamw_update``
writes the new parameters and moments into the tensors it is given (the
JAX trainer donates them to its jitted step) and returns the same trees;
every intermediate stays on the parameters' device, so a step reads no
value back to the host.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.common import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    dt = getattr(torch, cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def opt_state_specs(param_specs) -> dict:
    """Moments shard exactly like their parameters."""
    return {"m": param_specs, "v": param_specs, "step": ()}


def global_norm(tree) -> torch.Tensor:
    sq = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.stack(sq).sum().sqrt()


def adamw_update(grads, opt_state, params, lr, cfg: AdamWConfig,
                 ranks=None, gnorm=None):
    """One AdamW step.  Returns (params, opt_state, metrics); ``params``
    and the moments are updated in place, ``opt_state["step"]`` is a new
    tensor.  ``lr`` is a float or a 0-d tensor.  Weight decay applies to
    leaves of rank 2 or more; ``ranks`` (a tree like ``params``) gives the
    rank the rule reads where it is not the leaf's own (the trainer's
    stacked layers, see ``train_lib.decay_ranks``).  ``gnorm``: the global
    gradient norm where ``grads`` holds only this rank's shards (default:
    :func:`global_norm` of ``grads``)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    stepf = step.float()
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)

    leaves = tree_leaves(params)
    ranks = [p.ndim for p in leaves] if ranks is None else tree_leaves(ranks)
    with torch.no_grad():
        for p, g, m, v, rank in zip(leaves, tree_leaves(grads),
                                    tree_leaves(opt_state["m"]),
                                    tree_leaves(opt_state["v"]), ranks,
                                    strict=True):
            g = g.float() * scale
            m_new = cfg.b1 * m.float() + (1 - cfg.b1) * g
            v_new = cfg.b2 * v.float() + (1 - cfg.b2) * g.square()
            mhat = m_new / b1c
            vhat = v_new / b2c
            delta = mhat / (vhat.sqrt() + cfg.eps)
            if cfg.weight_decay and rank >= 2:     # decay matrices only
                delta = delta + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(m_new)
            v.copy_(v_new)
    return params, {**opt_state, "step": step}, {"grad_norm": gnorm}


def lr_schedule(step, *, base_lr: float, warmup: int, total: int,
                min_ratio: float = 0.1):
    """Linear warmup -> cosine decay to ``min_ratio * base_lr``; ``step``
    an int or an integer tensor, the result an f32 tensor."""
    step = torch.as_tensor(step).float()
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)
