"""granite-moe-3b-a800m — IBM Granite MoE (40 experts, top-8).

[hf:ibm-granite]  32L, d_model=1536, 24H (kv=8), expert d_ff=512,
vocab=49155.  40 experts don't divide a 16-way model axis, so expert FFN
dims shard instead (TP-inside-expert); the 49155 vocab is padded to a
256-multiple for the vocab-sharded embedding (DESIGN.md §5).
Full attention -> ``long_500k`` skipped.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=0,
        vocab_size=49155,
        head_dim=64,
        n_experts=40,
        experts_per_token=8,
        moe_d_ff=512,
        block_pattern=("moe",) * 32,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=0,
        vocab_size=300,   # deliberately not 256-divisible (padding path)
        head_dim=16,
        n_experts=5,
        experts_per_token=2,
        moe_d_ff=32,
        block_pattern=("moe",) * 3,
        tie_embeddings=True,
    )
