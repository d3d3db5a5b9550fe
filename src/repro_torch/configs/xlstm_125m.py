"""xlstm-125m — alternating sLSTM + mLSTM blocks.  [arXiv:2405.04517]

12L, d_model=768, 4 heads, d_ff=0 (blocks carry their own up/down
projections), vocab=50304.  Runs ``long_500k`` (recurrent decode).
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        head_dim=192,
        lstm_heads=4,
        block_pattern=("mlstm", "slstm") * 6,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke",
        family="ssm",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=512,
        head_dim=16,
        lstm_heads=4,
        xlstm_chunk=16,
        block_pattern=("mlstm", "slstm") * 2,
        tie_embeddings=True,
    )
