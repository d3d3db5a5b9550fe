"""musicgen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284]  48L, d_model=1536, 24H (kv=24), d_ff=6144, vocab=2048.
The EnCodec frontend is a STUB per the assignment: ``input_specs`` provides
precomputed frame embeddings; the backbone is a standard LayerNorm+GeLU
decoder.  Full attention -> ``long_500k`` skipped.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        head_dim=64,
        norm_type="layernorm",
        act="gelu",
        frontend="audio_stub",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke",
        family="audio",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=128,
        head_dim=16,
        norm_type="layernorm",
        act="gelu",
        frontend="audio_stub",
    )
