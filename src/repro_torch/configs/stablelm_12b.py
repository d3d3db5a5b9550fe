"""stablelm-12b — dense GQA decoder.  [hf:stabilityai/stablelm-2-12b]

40L, d_model=5120, 32H (kv=8), d_ff=13824, vocab=100352.  LayerNorm +
SwiGLU.  Full attention -> ``long_500k`` skipped.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=13824,
        vocab_size=100352,
        head_dim=160,
        norm_type="layernorm",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        norm_type="layernorm",
    )
