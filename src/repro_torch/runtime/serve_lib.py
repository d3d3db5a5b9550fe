"""Serving-step builders: prefill and decode, with greedy sampling.

The counterparts of ``repro.runtime.serve_lib.make_prefill_step`` /
``make_decode_step``; ``abstract_cache`` and ``serve_plan`` are sharding
decisions and come with the multi-device queue.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.model import LM


def make_prefill_step(lm: LM) -> Callable:
    def prefill_step(params, batch):
        logits, caches = lm.prefill(params, batch)
        return logits, caches
    return prefill_step


def make_decode_step(lm: LM) -> Callable:
    """decode_step(params, caches, token, pos) -> (next_token (B, 1),
    logits (B, Vp) f32, caches), greedy.  Sampling masks the padded vocab
    tail."""
    vocab = lm.cfg.vocab_size

    def decode_step(params, caches, token, pos):
        logits, caches = lm.decode_step(params, caches, token, pos)
        logits = logits.float()
        if logits.shape[-1] > vocab:
            logits[..., vocab:] = -1e9
        next_token = torch.argmax(logits, dim=-1)[:, None]
        return next_token, logits, caches

    return decode_step
