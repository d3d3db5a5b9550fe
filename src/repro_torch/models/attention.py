"""GQA attention with RoPE, prefix-LM masks and KV caches.

The counterparts of ``repro.models.attention`` on one device: no head
padding (``head_layout`` is the identity on a one-device mesh), KV heads
repeated to the query heads for the full-sequence path, the blockwise
online-softmax attention of the prefill, and the one-token decode against a
bf16, f32 or int8 KV cache with per-slot positions.  The projections are
``torch.einsum``, as the JAX package leaves them to XLA.

Unlike the JAX package, ``decode_attention`` writes the new key and value
into the caller's cache tensors in place (and returns the same dict):
the JAX version returns an updated copy of every cache, which on the card
would rewrite each layer's whole cache per decoded token.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import MeshInfo, dense_init, zeros_init
from repro_torch.models.layers import apply_rope, rope_tables

NEG_INF = -1e30


def head_layout(cfg, mesh: MeshInfo) -> tuple[int, int]:
    """(hq, hkv): on one device the logical head counts, unpadded."""
    return cfg.n_heads, cfg.n_kv_heads


def init_attention(gen, cfg, mesh: MeshInfo, dtype, device):
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = head_layout(cfg, mesh)
    p = {
        "wq": dense_init(gen, d, (d, hq, hd), dtype, device),
        "wk": dense_init(gen, d, (d, hkv, hd), dtype, device),
        "wv": dense_init(gen, d, (d, hkv, hd), dtype, device),
        "wo": dense_init(gen, hq * hd, (hq, hd, d), dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros_init((hq, hd), dtype, device)
        p["bk"] = zeros_init((hkv, hd), dtype, device)
        p["bv"] = zeros_init((hkv, hd), dtype, device)
    return p


def _project_qkv(params, x, cfg, positions):
    """x: (B, S, D) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd), with RoPE applied."""
    q = torch.einsum("bsd,dhe->bshe", x, params["wq"])
    k = torch.einsum("bsd,dhe->bshe", x, params["wk"])
    v = torch.einsum("bsd,dhe->bshe", x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    sin, cos = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    return q, k, v


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def blockwise_attention(q, k, v, *, chunk: int, causal: bool,
                        prefix_len: int = 0):
    """Online-softmax attention over KV chunks; O(S*chunk) memory.

    q: (B, Sq, H, hd); k, v: (B, Skv, H, hd) (KV already repeated to H).
    ``causal`` masks by position; ``prefix_len`` positions attend
    bidirectionally (prefix-LM).
    """
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    scale = hd ** -0.5
    qf = (q * scale).float()
    chunk = min(chunk, skv)
    n_chunks = math.ceil(skv / chunk)
    dev = q.device
    q_pos = torch.arange(sq, device=dev)

    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=dev)
    for idx in range(n_chunks):
        kb = k[:, idx * chunk:(idx + 1) * chunk].float()
        vb = v[:, idx * chunk:(idx + 1) * chunk].float()
        kv_pos = idx * chunk + torch.arange(kb.shape[1], device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        if causal:
            vis = kv_pos[None, :] <= q_pos[:, None]
            if prefix_len:
                vis = vis | (kv_pos[None, :] < prefix_len)
            s = torch.where(vis[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                 # (B, Sq, H, hd)


# ---------------------------------------------------------------------------
# Decode path (KV cache)
# ---------------------------------------------------------------------------


def init_kv_cache(cfg, mesh: MeshInfo, batch: int, max_len: int, dtype,
                  device):
    """Cache tensors for one attention layer.  With
    ``cfg.kv_cache_dtype == "int8"`` the cache stores int8 entries plus one
    f32 scale per (position, head)."""
    _, hkv = head_layout(cfg, mesh)
    shape = (batch, max_len, hkv, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                   device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quant_kv(x):
    """x: (..., hd) -> (int8 values, f32 scale over the last dim)."""
    xf = x.float()
    scale = xf.abs().amax(-1).clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def decode_attention(params, cache, x, cfg, mesh: MeshInfo, *, pos):
    """One-token decode.  x: (B, 1, D); pos: a scalar (every row at the same
    position) or a (B,) vector of per-slot positions (continuous batching).

    Writes the new key/value at ``pos`` into ``cache`` in place and returns
    (out (B, 1, D), cache).
    """
    b = x.shape[0]
    dev = x.device
    pos = torch.as_tensor(pos, device=dev).long()
    per_slot = pos.ndim == 1
    positions = pos[:, None] if per_slot else pos.expand(b, 1)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions)
    quant = "k_scale" in cache
    if quant:
        k_new, k_s = _quant_kv(k_new)          # (B,1,H,hd) int8, (B,1,H) f32
        v_new, v_s = _quant_kv(v_new)
    rows = torch.arange(b, device=dev)
    cols = positions[:, 0]
    cache["k"][rows, cols] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, cols] = v_new[:, 0].to(cache["v"].dtype)
    if quant:
        cache["k_scale"][rows, cols] = k_s[:, 0]
        cache["v_scale"][rows, cols] = v_s[:, 0]

    hq = q.shape[2]
    hkv = cache["k"].shape[2]
    n_rep = hq // hkv
    skv = cache["k"].shape[1]
    scale = cfg.head_dim ** -0.5
    qg = (q * scale).reshape(b, 1, hkv, n_rep, cfg.head_dim).float()
    if quant:
        kf = cache["k"].float() * cache["k_scale"][..., None]
        vf = cache["v"].float() * cache["v_scale"][..., None]
    else:
        kf = cache["k"].float()
        vf = cache["v"].float()
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg, kf)          # (B,Hkv,rep,1,Skv)
    valid = torch.arange(skv, device=dev)[None, :] <= positions  # (B, Skv)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", p, vf)
    out = out.reshape(b, 1, hq, cfg.head_dim).to(x.dtype)
    out = torch.einsum("bshe,hed->bsd", out, params["wo"])
    return out, cache
