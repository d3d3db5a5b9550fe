"""paligemma-3b — SigLIP vision tower (STUB) + Gemma decoder backbone.

[arXiv:2407.07726]  18L, d_model=2048, 8H (kv=1, MQA), d_ff=16384,
vocab=257216.  ``input_specs`` provides 256 precomputed patch embeddings as a
bidirectional prefix (prefix-LM mask); GeGLU MLP, tied embeddings, MQA's
single KV head replicates across TP (DESIGN.md §5).  Full attention ->
``long_500k`` skipped.
"""
from repro_torch.configs.base import ModelConfig

NUM_PATCHES = 256


def get_config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b",
        family="vlm",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        d_ff=16384,
        vocab_size=257216,
        head_dim=256,
        act="geglu",
        tie_embeddings=True,
        frontend="vision_stub",
        num_prefix_tokens=NUM_PATCHES,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-smoke",
        family="vlm",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        act="geglu",
        tie_embeddings=True,
        frontend="vision_stub",
        num_prefix_tokens=8,
    )
