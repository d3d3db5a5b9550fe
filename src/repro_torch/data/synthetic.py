"""Deterministic synthetic LM data pipeline.

The counterpart of ``repro.data.synthetic``, the same contract: the stream
is a pure function of ``(seed, step, host_id)``, so resuming from a
checkpoint at step N reproduces exactly the batches an uninterrupted run
would have seen.  Tokens follow a Zipf(1.1) marginal (inverse CDF of a
uniform draw) with short-range structure (each token copies the previous
one with p = 0.5), so the LM loss actually decreases.

The draws come from a ``torch.Generator`` on the CPU seeded from
``(seed, step, host_id)``; the numbers differ from ``jax.random``'s, as the
port's initialisers do, and parity with the JAX package is held on carried
batches.  Batches are CPU tensors; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

#: the frontends' own streams, as the JAX package folds 99 and 98 into
#: the batch key
_FRAMES, _PATCHES = 99, 98


def _generator(*words: int) -> torch.Generator:
    """A CPU generator seeded by a hash of ``words`` (a pure function)."""
    seed = np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed) & ((1 << 63) - 1))


def _zipf_tokens(gen, shape, vocab: int):
    """Zipf(1.1)-ish sampling via the inverse CDF of a uniform draw."""
    u = 1e-6 + (1.0 - 1e-6) * torch.rand(shape, generator=gen)
    alpha = 1.1
    rank = torch.floor(u ** (-1.0 / alpha)) - 1.0
    return torch.clamp(rank, 0, vocab - 1).long()


def make_batch(cfg: ModelConfig, shape: ShapeConfig, step: int, seed: int = 0,
               host_id: int = 0, num_hosts: int = 1) -> dict:
    """One training batch (this host's slice) as CPU tensors: ``tokens``
    and ``labels`` (int64, labels the tokens shifted by one); the audio
    frontend's ``frames`` replace the tokens, the vision frontend's
    ``patches`` come before them."""
    b = shape.global_batch // num_hosts
    s = shape.seq_len
    gen = _generator(seed, step, host_id)
    base = _zipf_tokens(gen, (b, s + 1), cfg.vocab_size)
    # structure: with p = 0.5 copy the previous token (a learnable bigram)
    copy_mask = torch.rand((b, s), generator=gen) < 0.5
    # token j >= 1 is base[src_j]: src_j = j unless it copies, then
    # src_{j-1}, so src is a running max of the positions that do not copy
    pos = torch.arange(1, s + 1).expand(b, s)
    src = torch.where(copy_mask, 0, pos).cummax(dim=1).values
    src = torch.cat([torch.zeros((b, 1), dtype=src.dtype), src], dim=1)
    tokens = base.gather(1, src)                               # (b, s+1)

    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    dtype = getattr(torch, cfg.compute_dtype)
    if cfg.frontend == "audio_stub":
        g = _generator(seed, step, host_id, _FRAMES)
        frames = torch.randn((b, s, cfg.d_model), generator=g) * 0.02
        batch = {"frames": frames.to(dtype), "labels": tokens[:, 1:]}
    elif cfg.frontend == "vision_stub":
        g = _generator(seed, step, host_id, _PATCHES)
        npx = cfg.num_prefix_tokens
        st = s - npx
        patches = torch.randn((b, npx, cfg.d_model), generator=g) * 0.02
        batch = {"patches": patches.to(dtype), "tokens": tokens[:, :st],
                 "labels": tokens[:, 1:st + 1]}
    return batch


@dataclasses.dataclass
class DataIterator:
    """Stateful wrapper with a checkpointable position."""
    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    step: int = 0

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = make_batch(self.cfg, self.shape, self.step, self.seed,
                           self.host_id, self.num_hosts)
        self.step += 1
        return batch

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, d: dict) -> None:
        self.step = int(d["step"])
        self.seed = int(d["seed"])
