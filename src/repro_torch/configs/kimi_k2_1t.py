"""kimi-k2-1t-a32b — trillion-parameter MoE (384 experts, top-8).

[Kimi K2 paper table]  61L, d_model=7168, 64H (kv=8), expert d_ff=2048,
vocab=163840.  Per the assignment the attention is GQA (not MLA).  Optimizer
moments are kept in bf16 — f32 moments for 1T params (8 TB) would not fit
512 x 16 GB HBM (DESIGN.md §4).  Full attention -> ``long_500k`` skipped.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=0,
        vocab_size=163840,
        head_dim=128,
        n_experts=384,
        experts_per_token=8,
        moe_d_ff=2048,
        block_pattern=("moe",) * 61,
        param_dtype="bfloat16",
        opt_state_dtype="bfloat16",
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=0,
        vocab_size=512,
        head_dim=16,
        n_experts=8,
        experts_per_token=2,
        moe_d_ff=32,
        block_pattern=("moe",) * 3,
    )
