"""qwen2-7b — dense GQA with QKV bias.  [arXiv:2407.10671]

28L, d_model=3584, 28H (kv=4), d_ff=18944, vocab=152064.  28 heads don't
divide a 16-way model axis: the runtime pads query heads to 32 (exact
results, zero wo rows; DESIGN.md §5).  Full attention -> ``long_500k``
skipped.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b",
        family="dense",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        head_dim=128,
        qkv_bias=True,
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b-smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=6,   # deliberately not a power of two (head padding path)
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        qkv_bias=True,
    )
