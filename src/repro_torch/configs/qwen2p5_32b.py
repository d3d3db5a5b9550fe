"""qwen2.5-32b — dense GQA with QKV bias.  [Qwen2.5 family]

64L, d_model=5120, 40H (kv=8), d_ff=27648, vocab=152064.  FSDP (parameter +
optimizer-state sharding over the data axis) is required at this size.
Full attention -> ``long_500k`` skipped.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=27648,
        vocab_size=152064,
        head_dim=128,
        qkv_bias=True,
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b-smoke",
        family="dense",
        n_layers=4,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=192,
        vocab_size=512,
        head_dim=16,
        qkv_bias=True,
    )
