"""Architecture registry: ``--arch <id>`` ids map to one config module each;
``input_specs`` builds shape-and-dtype stand-ins for every model input of
one cell as tensors on the ``meta`` device (no storage is allocated).
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1p5b",
    "qwen2.5-32b": "repro_torch.configs.qwen2p5_32b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b",
}

ARCH_IDS = tuple(_MODULES)

# archs with sub-quadratic token mixing run the long_500k cell; pure
# full-attention archs skip it.
SUBQUADRATIC = ("zamba2-1.2b", "xlstm-125m")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(_MODULES[arch])
    return mod.smoke_config() if smoke else mod.get_config()


def shape_cells(arch: str) -> list[ShapeConfig]:
    """The assigned (arch x shape) cells, with the long_500k rule applied."""
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if arch in SUBQUADRATIC:
        cells.append(SHAPES["long_500k"])
    return cells


def skipped_cells(arch: str) -> list[str]:
    return [] if arch in SUBQUADRATIC else ["long_500k"]


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``meta``-device stand-ins for every model input of one cell.

    train:    token/label batches (frontends: embeddings + labels)
    prefill:  the request batch (tokens / frame embeddings / patches+text)
    decode:   one new token per sequence (+ ``pos``); the caches are built
              separately by ``LM.init_cache``.

    Token ids and positions are int32, as in the JAX package; the models
    index with them as they are.
    """
    def S(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    emb = getattr(torch, cfg.compute_dtype)
    d = cfg.d_model

    if shape.kind == "train":
        if cfg.frontend == "audio_stub":
            return {"frames": S((b, s, d), emb), "labels": S((b, s), i32)}
        if cfg.frontend == "vision_stub":
            st = s - cfg.num_prefix_tokens
            return {"patches": S((b, cfg.num_prefix_tokens, d), emb),
                    "tokens": S((b, st), i32), "labels": S((b, st), i32)}
        return {"tokens": S((b, s), i32), "labels": S((b, s), i32)}

    if shape.kind == "prefill":
        if cfg.frontend == "audio_stub":
            return {"frames": S((b, s, d), emb)}
        if cfg.frontend == "vision_stub":
            st = s - cfg.num_prefix_tokens
            return {"patches": S((b, cfg.num_prefix_tokens, d), emb),
                    "tokens": S((b, st), i32)}
        return {"tokens": S((b, s), i32)}

    # decode: one token (audio: one frame embedding)
    if cfg.frontend == "audio_stub":
        return {"token": S((b, 1, d), emb), "pos": S((), i32)}
    return {"token": S((b, 1), i32), "pos": S((), i32)}
