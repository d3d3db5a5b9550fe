"""qwen2-1.5b — dense GQA with QKV bias.  [arXiv:2407.10671]

28L, d_model=1536, 12H (kv=2), d_ff=8960, vocab=151936, tied embeddings.
Full attention -> ``long_500k`` skipped.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        head_dim=128,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b-smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        qkv_bias=True,
        tie_embeddings=True,
    )
