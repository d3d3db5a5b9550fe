"""Core layers: norms, rotary embeddings, MLPs, embedding / logits heads.

The counterparts of ``repro.models.layers``, same functions on tensors.
Every matmul-shaped operation routes through the unified plan/execute API
(``repro_torch.gemm.matmul``): the planned CUDA kernels for CUDA tensors,
their plain versions for CPU tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import gemm as gemm_api
from repro_torch.models.common import (
    MeshInfo,
    dense_init,
    embed_init,
    ones_init,
    zeros_init,
)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg, mesh: MeshInfo, dtype, device):
    p = {"scale": ones_init((cfg.d_model,), dtype, device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = zeros_init((cfg.d_model,), dtype, device)
    return p


def apply_norm(params, x, cfg):
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * params["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_tables(positions, head_dim: int, theta: float):
    """positions: (...,) int -> (sin, cos) of shape (..., head_dim//2)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs              # (..., half)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: (..., seq, heads, head_dim); sin/cos: (..., seq, head_dim//2).
    Rotation in f32, result cast back to x.dtype."""
    half = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    s = sin[..., None, :]  # broadcast over heads axis
    c = cos[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU)
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg, mesh: MeshInfo, dtype, device, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {
        "w_up": dense_init(gen, d, (d, f), dtype, device),
        "w_down": dense_init(gen, f, (f, d), dtype, device),
    }
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, d, (d, f), dtype, device)
    return p


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def apply_mlp(params, x, cfg):
    up = gemm_api.matmul(x, params["w_up"])
    if cfg.act == "swiglu":
        h = F.silu(gemm_api.matmul(x, params["w_gate"])) * up
    elif cfg.act == "geglu":
        h = _gelu(gemm_api.matmul(x, params["w_gate"])) * up
    else:
        h = _gelu(up)
    return gemm_api.matmul(h, params["w_down"])


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def init_embedding(gen, cfg, mesh: MeshInfo, dtype, device):
    v = cfg.padded_vocab
    p = {"table": embed_init(gen, v, cfg.d_model, dtype, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, cfg.d_model, (cfg.d_model, v), dtype,
                                  device)
    return p


def embed_tokens(params, token_ids, cfg):
    return params["table"][token_ids]


def head_matrix(params, cfg):
    """The (D, Vp) logits matrix, row-major.  With tied embeddings it is
    the transposed table; the CUDA kernels take row-major operands only, so
    it is made contiguous here, once per compute copy (``LM.compute_params``
    keeps it under ``"head"``), not once per decode step."""
    if "head" in params:
        return params["head"]
    if cfg.tie_embeddings:
        return params["table"].t().contiguous()
    return params["unembed"]


def logits_head(params, x, cfg):
    """x: (..., d) -> (..., padded_vocab); soft-capped if configured."""
    logits = gemm_api.matmul(x, head_matrix(params, cfg))
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
