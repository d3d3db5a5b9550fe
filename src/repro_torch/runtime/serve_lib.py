"""Serving-step builders: prefill and decode, with greedy sampling.

The counterparts of ``repro.runtime.serve_lib``: the prefill and decode
steps (under an ambient mesh they run on this rank's shards and return the
full logits), ``abstract_cache`` (the cache's global shapes and its spec
tree) and ``serve_plan`` (how a decode cell shards its cache).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import LM
from repro_torch.runtime.sharding import use_mesh


def make_prefill_step(lm: LM) -> Callable:
    def prefill_step(params, batch):
        logits, caches = lm.prefill(params, batch)
        return logits, caches
    return prefill_step


def make_decode_step(lm: LM, *, seq_shard: bool = False) -> Callable:
    """decode_step(params, caches, token, pos) -> (next_token (B, 1),
    logits (B, Vp) f32, caches), greedy.  Sampling masks the padded vocab
    tail.  ``seq_shard``: the caches' sequence axis is split over the
    data axes (``serve_plan``'s long decode; ``LM.init_cache(...,
    seq_shard=True, batch_shard=False)``)."""
    vocab = lm.cfg.vocab_size

    def decode_step(params, caches, token, pos):
        logits, caches = lm.decode_step(params, caches, token, pos,
                                        seq_shard=seq_shard)
        logits = logits.float()
        if logits.shape[-1] > vocab:
            logits[..., vocab:] = -1e9
        next_token = torch.argmax(logits, dim=-1)[:, None]
        return next_token, logits, caches

    return decode_step


def abstract_cache(lm: LM, batch: int, max_len: int, *, seq_shard=False,
                   batch_shard=True):
    """The cache's global shapes and dtypes as ``meta`` tensors, and its
    spec tree (the dry-run path)."""
    meta = LM(lm.cfg, lm.mesh, device="meta")
    with torch.device("meta"), use_mesh(None):    # global shapes
        values = meta.init_cache(batch, max_len, seq_shard=seq_shard,
                                 batch_shard=batch_shard)
    return values, meta.cache_specs(seq_shard=seq_shard,
                                    batch_shard=batch_shard)


def serve_plan(cfg: ModelConfig, shape: ShapeConfig, minfo):
    """Decide decode-cell sharding: DP over batch when divisible; otherwise
    (long_500k, batch=1) SP over the KV sequence axis."""
    batch_shard = shape.global_batch % minfo.data == 0
    seq_shard = (not batch_shard)
    return {"batch_shard": batch_shard, "seq_shard": seq_shard}
