"""moonlight-16b-a3b — DeepSeek-V3's block at a width one card trains.

[hf:moonshotai/Moonlight-16B-A3B, ``model_type`` deepseek_v3]  27L,
d_model=2048, latent attention (MLA) with 16 heads: no query low rank, a
joint key-value latent of 512 with its RMSNorm, q.k over 128 + 64 (RoPE)
dims, values of 128, rope_theta 50,000 unscaled.  The first layer is
dense (d_ff=11264); the other 26 route each token over 64 experts of
width 1408 (top 6, sigmoid scores, a correction bias that chooses,
normalised weights scaled by 2.446) beside 2 shared experts.
vocab=163840, untied.

``get_config`` is one card's share of a deployment in which 8 cards
share each layer: the 64 routed experts 8 to a card (this card holds
experts 0-7; the router keeps all 64 outputs), the embedding and the
head in eighths (a vocabulary of 20,480 ids), attention, the router and
the shared experts whole on every card.  No width is cut and all 27
layers are kept.  The balance loss's coefficient, the bias's update rate
and its first draw are not in the published config: the DeepSeek-V3
report's 1e-4 and 1e-3, and N(0, 1e-2) so that choosing and weighting
differ from the first step.

Serving and decoding through a latent cache and a mesh with a model axis
are not supported (``LM`` raises).
"""
from repro_torch.configs.base import DeepSeekV3Config

#: the published sizes this card's share is cut from
PUBLISHED_EXPERTS = 64
PUBLISHED_VOCAB = 163840
#: cards that share each layer in the deployment
CHIPS_PER_LAYER = 8


def get_config() -> DeepSeekV3Config:
    held = PUBLISHED_EXPERTS // CHIPS_PER_LAYER
    return DeepSeekV3Config(
        name="moonlight-16b-a3b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=11264,
        vocab_size=PUBLISHED_VOCAB // CHIPS_PER_LAYER,
        attn_type="mla",
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        head_dim=128,
        rope_theta=50000.0,
        norm_eps=1e-5,
        n_experts=PUBLISHED_EXPERTS,
        experts_per_token=6,
        moe_d_ff=1408,
        router="sigmoid",
        n_shared_experts=2,
        routed_scale=2.446,
        router_aux_coef=1e-4,
        bias_rate=1e-3,
        bias_init_std=1e-2,
        experts_held=tuple(range(held)),
        first_k_dense=1,
    )


def smoke_config() -> DeepSeekV3Config:
    """The same form at a CPU test's size: 8 experts routed over, 2 held."""
    return DeepSeekV3Config(
        name="moonlight-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab_size=300,
        attn_type="mla",
        kv_lora_rank=16,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
        head_dim=16,
        rope_theta=50000.0,
        norm_eps=1e-5,
        n_experts=8,
        experts_per_token=2,
        moe_d_ff=32,
        router="sigmoid",
        n_shared_experts=1,
        routed_scale=2.446,
        router_aux_coef=1e-4,
        bias_rate=1e-3,
        bias_init_std=1e-2,
        experts_held=(0, 1),
        first_k_dense=1,
        attn_chunk=8,
    )
