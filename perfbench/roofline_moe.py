"""The frozen counts of a DeepSeek-V3-style decoder's training step
(``drivers/train_moe.py``): the model's operations a step, and the
grouped products a step sends to the grouped kernel, from the
configuration file's sizes alone.

Both count the experts this card holds at their mean load: every token
chooses ``num_experts_per_tok`` of the ``deployment.n_routed_experts``
routed over, so a held expert takes ``tokens * k / E`` rows on average
(768 at 8,192 tokens), whatever the step's routing and padding.  Nothing
here imports the program.
"""
from __future__ import annotations

from perfbench import roofline


def _sizes(config: dict) -> dict:
    dep = config["deployment"]
    return {"d": config["hidden_size"], "f": config["intermediate_size"],
            "h": config["num_attention_heads"],
            "layers": config["num_hidden_layers"],
            "dense": config["first_k_dense_replace"],
            "vocab": config["vocab_size"],
            "r": config["kv_lora_rank"], "nope": config["qk_nope_head_dim"],
            "rope": config["qk_rope_head_dim"], "dv": config["v_head_dim"],
            "fe": config["moe_intermediate_size"],
            "e": dep["n_routed_experts"], "held": len(dep["experts_held"]),
            "k": config["num_experts_per_tok"],
            "shared": config["n_shared_experts"]}


def mean_rows(config: dict, tokens: int) -> float:
    """A held expert's mean load a step: (token, choice) pairs over the
    experts routed over."""
    s = _sizes(config)
    return tokens * s["k"] / s["e"]


def grouped_products(config: dict, tokens: int) -> list[dict]:
    """The grouped products of one training step, as the MoE layers send
    them: each layer's gate, up and down over the held experts at the
    mean load, four times a step (forward, the block's recompute, dx and
    dw; the backward products permute m, n and k, so each has the
    forward's operations and bound)."""
    s = _sizes(config)
    m, n_moe = mean_rows(config, tokens), s["layers"] - s["dense"]
    return [
        {"name": "gate", "m": m, "n": s["fe"], "k": s["d"],
         "groups": s["held"], "count": 4 * n_moe},
        {"name": "up", "m": m, "n": s["fe"], "k": s["d"],
         "groups": s["held"], "count": 4 * n_moe},
        {"name": "down", "m": m, "n": s["d"], "k": s["fe"],
         "groups": s["held"], "count": 4 * n_moe},
    ]


def matmul_params_per_token(config: dict) -> float:
    """Weights a token is multiplied by in the forward: latent attention's
    four projections in every layer, the dense MLPs, each MoE layer's
    router, shared experts and its mean share of the held experts (``k``
    of ``E`` experts chosen, ``held`` of them here), and the head (at the
    logical vocabulary)."""
    s = _sizes(config)
    d, h, r = s["d"], s["h"], s["r"]
    mla = (d * h * (s["nope"] + s["rope"]) + d * (r + s["rope"])
           + r * h * (s["nope"] + s["dv"]) + h * s["dv"] * d)
    moe = (d * s["e"] + 3 * d * s["shared"] * s["fe"]
           + s["k"] * s["held"] / s["e"] * 3 * d * s["fe"])
    n_moe = s["layers"] - s["dense"]
    return (s["layers"] * mla + s["dense"] * 3 * d * s["f"] + n_moe * moe
            + d * s["vocab"])


def train_model_flops(config: dict, batch: int, seq: int) -> float:
    """Model operations of one training step (three times the forward's;
    the recompute is not counted): two a multiply-add over every weight a
    token meets (:func:`matmul_params_per_token`), plus causal attention's
    scores over nope + rope dims and weighted values over the values'
    width for each visible (query, key) pair."""
    s = _sizes(config)
    fwd = 2.0 * matmul_params_per_token(config) * batch * seq
    pairs = batch * seq * (seq + 1) / 2
    fwd += s["layers"] * 2.0 * s["h"] * (s["nope"] + s["rope"] + s["dv"]) \
        * pairs
    return 3.0 * fwd
