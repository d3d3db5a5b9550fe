"""zamba2-1.2b — hybrid Mamba2 backbone + shared (tied) attention blocks.

[arXiv:2411.15242]  38L, d_model=2048, 32H (kv=32), d_ff=8192, vocab=32000,
ssm_state=64.  Shared transformer block applied every 6th slot with tied
weights (Zamba-style); remaining slots are Mamba2 SSD blocks.
Runs ``long_500k`` (sub-quadratic backbone).
"""
from repro_torch.configs.base import ModelConfig

# 38 slots: shared-attention sites at 5, 11, 17, 23, 29, 35; tail of 2 mamba.
_PERIOD = ("mamba2",) * 5 + ("shared_attn",)
_PATTERN = _PERIOD * 6 + ("mamba2", "mamba2")


def get_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32000,
        head_dim=64,
        ssm_state=64,
        ssm_head_dim=64,
        block_pattern=_PATTERN,
        shared_block=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        n_layers=7,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_chunk=16,
        block_pattern=("mamba2", "mamba2", "shared_attn") * 2 + ("mamba2",),
        shared_block=True,
    )
