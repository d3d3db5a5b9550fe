"""GQA attention with RoPE, prefix-LM masks and KV caches.

The counterparts of ``repro.models.attention``: head padding for tensor
parallelism (``head_layout``: query heads padded up to a multiple of the
model axis, per KV group for GQA, zero-initialised so results are exact),
KV heads repeated to the query heads for the full-sequence path, the
blockwise online-softmax attention of the prefill, and the one-token
decode against a bf16, f32 or int8 KV cache with per-slot positions.  The
projections are ``torch.einsum``, as the JAX package leaves them to XLA.

Under a mesh each rank holds its query heads (and its KV heads when they
divide the model axis; else all of them, replicated): the query path
starts at ``copy_to`` and the output projection ends at ``all_reduce``
(row-parallel), where XLA's partitioner would put them.  Replicated KV
heads are computed whole on every rank and pass ``copy_to`` before each
rank picks the ones its query heads read, so their gradient sums the
ranks' partial uses.

Unlike the JAX package, ``decode_attention`` writes the new key and value
into the caller's cache tensors in place (and returns the same dict):
the JAX version returns an updated copy of every cache, which on the card
would rewrite each layer's whole cache per decoded token.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import (WHOLE, Cut, MeshInfo, dense_init,
                                       zeros_init)
from repro_torch.models.layers import apply_rope, rope_tables
from repro_torch.runtime import sharding as sh

NEG_INF = -1e30


def head_layout(cfg, mesh: MeshInfo) -> tuple[int, int]:
    """(hq_padded, hkv_padded) for TP.

    * both divisible by the model axis -> no padding;
    * MHA (kv == q heads) -> pad both to the axis multiple;
    * GQA -> replicate KV, pad query heads *per KV group* so the grouping
      ``q_head -> q_head // n_rep`` survives padding (n_rep stays integral).
    Padded positions are zero-initialised in wq/bq/wo (and wk/wv for padded
    KV), so forward results are exactly the unpadded model's.
    """
    tp = mesh.model
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if hq % tp == 0 and (hkv % tp == 0 or hkv == hq):
        return hq, hkv
    if hkv == hq:                                   # MHA: pad both
        h = tp * math.ceil(hq / tp)
        return h, h
    g = math.gcd(hkv, tp)
    step = tp // g
    r = hq // hkv                                   # reps per KV group
    rp = step * math.ceil(r / step)
    return hkv * rp, hkv


def pad_q(w, cfg, mesh: MeshInfo, head_axis: int):
    """``w`` with the logical query heads on ``head_axis``, zero heads
    inserted at the end of each KV group (and zero groups appended if the
    KV heads are padded too): logical head (g, i) lands at g * rp + i."""
    hq0, hkv0 = cfg.n_heads, cfg.n_kv_heads
    hq, hkv = head_layout(cfg, mesh)
    if hq == hq0:
        return w
    r0, rp = hq0 // hkv0, hq // hkv
    heads = torch.arange(hq0, device=w.device)
    idx = (heads // r0) * rp + heads % r0
    shape = list(w.shape)
    shape[head_axis] = hq
    out = torch.zeros(shape, dtype=w.dtype, device=w.device)
    return out.index_copy(head_axis, idx, w)


def pad_kv(w, cfg, mesh: MeshInfo, head_axis: int):
    """``w`` with the logical KV heads on ``head_axis``, zero heads
    appended up to the padded count."""
    _, hkv = head_layout(cfg, mesh)
    if hkv == cfg.n_kv_heads:
        return w
    pad = [0, 0] * (w.ndim - 1 - head_axis) + [0, hkv - cfg.n_kv_heads]
    return F.pad(w, pad)


def attention_specs(cfg, mesh: MeshInfo) -> dict:
    """The specs of :func:`init_attention`'s leaves."""
    hq, hkv = head_layout(cfg, mesh)
    h_ax = mesh.shard_if(hq)                  # always shardable after padding
    kv_ax = mesh.shard_if(hkv)                # may be None (replicated KV)
    fsdp = mesh.fsdp_if(cfg.d_model)
    specs = {"wq": (fsdp, h_ax, None), "wk": (fsdp, kv_ax, None),
             "wv": (fsdp, kv_ax, None), "wo": (h_ax, None, fsdp)}
    if cfg.qkv_bias:
        specs.update(bq=(h_ax, None), bk=(kv_ax, None), bv=(kv_ax, None))
    return specs


def init_attention(gen, cfg, mesh: MeshInfo, dtype, device,
                   cut: Cut = WHOLE):
    """Logical-shape weights drawn as on one device, then padded (and then
    cut): the logical parameters are the same whatever the mesh."""
    d, hd = cfg.d_model, cfg.head_dim
    hq0, hkv0 = cfg.n_heads, cfg.n_kv_heads
    hq, hkv = head_layout(cfg, mesh)

    def padded(key, pad, axis):
        return cut.of(key, lambda w: pad(w, cfg, mesh, axis))

    p = {
        "wq": dense_init(gen, d, (d, hq0, hd), dtype, device,
                         padded("wq", pad_q, 1)),
        "wk": dense_init(gen, d, (d, hkv0, hd), dtype, device,
                         padded("wk", pad_kv, 1)),
        "wv": dense_init(gen, d, (d, hkv0, hd), dtype, device,
                         padded("wv", pad_kv, 1)),
        "wo": dense_init(gen, hq0 * hd, (hq0, hd, d), dtype, device,
                         padded("wo", pad_q, 0)),
    }
    if cfg.qkv_bias:
        p["bq"] = cut("bq", zeros_init((hq, hd), dtype, device))
        p["bk"] = cut("bk", zeros_init((hkv, hd), dtype, device))
        p["bv"] = cut("bv", zeros_init((hkv, hd), dtype, device))
    return p


def _project_qkv(params, x, cfg, positions, x_kv=None):
    """x: (B, S, D) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd), with RoPE applied;
    k and v read ``x_kv`` where given (the replicated-KV path)."""
    x_kv = x if x_kv is None else x_kv
    q = torch.einsum("bsd,dhe->bshe", x, params["wq"])
    k = torch.einsum("bsd,dhe->bshe", x_kv, params["wk"])
    v = torch.einsum("bsd,dhe->bshe", x_kv, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    sin, cos = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    return q, k, v


def _tp_layout(cfg, mesh: MeshInfo):
    """(h_ax, kv replicated under sharded query heads?, the kv head each
    local query head reads or None): how this rank's heads line up."""
    hq, hkv = head_layout(cfg, mesh)
    h_ax = mesh.shard_if(hq)
    tp = sh.axis_size(h_ax)
    if tp == 1 or sh.axis_size(mesh.shard_if(hkv)) == tp:
        return h_ax, False, None
    hq_l = hq // tp
    q0 = sh.axis_index(h_ax) * hq_l
    return h_ax, True, (q0 + torch.arange(hq_l)) // (hq // hkv)


def project_local(params, x, cfg, mesh: MeshInfo, positions):
    """This rank's q, k and v for ``x`` (B, S, D) replicated over the model
    axis: q of the local query heads; k and v of the local KV heads, or of
    all of them where they are replicated."""
    h_ax, replicated, _ = _tp_layout(cfg, mesh)
    xq = sh.copy_to(x, h_ax)
    return _project_qkv(params, xq, cfg, positions,
                        x_kv=x if replicated else xq)


def kv_for_local_heads(k, cfg, mesh: MeshInfo):
    """``k`` (B, S, Hkv_local, hd) repeated to one KV head per local query
    head (q_head -> q_head // n_rep)."""
    h_ax, replicated, idx = _tp_layout(cfg, mesh)
    if not replicated:
        hq, hkv = head_layout(cfg, mesh)
        return _repeat_kv(k, hq // hkv)
    return sh.copy_to(k, h_ax).index_select(2, idx.to(k.device))


def output_projection(out, params, cfg, mesh: MeshInfo):
    """(B, S, Hq_local, hd) @ wo -> (B, S, D), summed over the model axis
    (row-parallel)."""
    hq, _ = head_layout(cfg, mesh)
    y = torch.einsum("bshe,hed->bsd", out, params["wo"])
    return sh.all_reduce(y, mesh.shard_if(hq))


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


def apply_attention(params, x, cfg, mesh: MeshInfo, *, positions=None,
                    prefix_len: int = 0):
    """Full-sequence (training / prefill) attention.  x: (B, S, D)
    replicated over the model axis -> (B, S, D), the heads' parts summed
    over it.  The model's block (``model._apply_block``) composes the same
    functions and also keeps k and v for the cache."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = project_local(params, x, cfg, mesh, positions)
    out = blockwise_attention(q, kv_for_local_heads(k, cfg, mesh),
                              kv_for_local_heads(v, cfg, mesh),
                              chunk=cfg.attn_chunk, causal=True,
                              prefix_len=prefix_len)
    return output_projection(out, params, cfg, mesh)


# ---------------------------------------------------------------------------
# Decode path (KV cache)
# ---------------------------------------------------------------------------


def kv_cache_specs(cfg, mesh: MeshInfo, seq_shard: bool = False,
                   batch_shard: bool = True) -> dict:
    """The specs of :func:`init_kv_cache`'s leaves.  ``seq_shard`` turns on
    SP for long decode (KV sequence axis over the data axis; batch is then
    unsharded)."""
    _, hkv = head_layout(cfg, mesh)
    kv_ax = mesh.shard_if(hkv)
    if seq_shard:
        spec, sspec = (None, mesh.dp(), kv_ax, None), (None, mesh.dp(), kv_ax)
    else:
        bspec = mesh.dp() if batch_shard else None
        spec, sspec = (bspec, None, kv_ax, None), (bspec, None, kv_ax)
    if cfg.kv_cache_dtype == "int8":
        return {"k": spec, "v": spec, "k_scale": sspec, "v_scale": sspec}
    return {"k": spec, "v": spec}


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


def decode_attention(params, cache, x, cfg, mesh: MeshInfo, *, pos,
                     seq_shard: bool = False):
    """One-token decode.  x: (B, 1, D); pos: a scalar (every row at the same
    position) or a (B,) vector of per-slot positions (continuous batching).

    Writes the new key/value at ``pos`` into ``cache`` (this rank's KV
    heads) in place and returns (out (B, 1, D), cache).

    ``seq_shard`` (under an ambient mesh): the cache's sequence axis is
    split over the data axes (``kv_cache_specs(seq_shard=True)``), rank
    ``r`` of ``n`` holding positions ``[r S/n, (r+1) S/n)``.  Only the
    owner of ``pos`` writes the new key and value; each rank scores its
    keys at their global positions and the ranks combine their softmax
    statistics (:func:`_combine_shards`).
    """
    b = x.shape[0]
    dev = x.device
    pos = torch.as_tensor(pos, device=dev).long()
    per_slot = pos.ndim == 1
    positions = pos[:, None] if per_slot else pos.expand(b, 1)
    q, k_new, v_new = project_local(params, x, cfg, mesh, positions)
    quant = "k_scale" in cache
    if quant:
        k_new, k_s = _quant_kv(k_new)          # (B,1,H,hd) int8, (B,1,H) f32
        v_new, v_s = _quant_kv(v_new)
    seq_ax = mesh.dp() if seq_shard and sh.communicates(mesh.dp()) else None
    skv = cache["k"].shape[1]
    first = sh.axis_index(seq_ax) * skv
    rows = torch.arange(b, device=dev)
    cols = positions[:, 0] - first
    new = {"k": k_new[:, 0], "v": v_new[:, 0]}
    if quant:
        new.update(k_scale=k_s[:, 0], v_scale=v_s[:, 0])
    if seq_ax is None:
        for name, t in new.items():
            cache[name][rows, cols] = t.to(cache[name].dtype)
    else:
        # only the owner of pos writes: the others write back what they
        # hold (no data-dependent shapes, so a dry run traces it too)
        mine = (cols >= 0) & (cols < skv)
        cols = cols.clamp(0, skv - 1)
        for name, t in new.items():
            keep = mine.reshape((b,) + (1,) * (t.ndim - 1))
            cache[name][rows, cols] = torch.where(
                keep, t.to(cache[name].dtype), cache[name][rows, cols])

    hq = q.shape[2]
    scale = cfg.head_dim ** -0.5
    if quant:
        kf = cache["k"].float() * cache["k_scale"][..., None]
        vf = cache["v"].float() * cache["v_scale"][..., None]
    else:
        kf = cache["k"].float()
        vf = cache["v"].float()
    _, replicated, idx = _tp_layout(cfg, mesh)
    if replicated:               # one KV head per local query head
        kf = kf.index_select(2, idx.to(dev))
        vf = vf.index_select(2, idx.to(dev))
    hkv = kf.shape[2]
    n_rep = hq // hkv
    qg = (q * scale).reshape(b, 1, hkv, n_rep, cfg.head_dim).float()
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg, kf)          # (B,Hkv,rep,1,Skv)
    kv_pos = first + torch.arange(skv, device=dev)
    valid = kv_pos[None, :] <= positions                   # (B, Skv)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    if seq_ax is None:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhrqk,bkhd->bqhrd", p, vf)
    else:
        out = _combine_shards(s, vf, seq_ax)
    out = out.reshape(b, 1, hq, cfg.head_dim).to(x.dtype)
    return output_projection(out, params, cfg, mesh), cache


def _combine_shards(s, vf, ax):
    """softmax(s) @ v over keys split across the ranks of ``ax``: s
    (B, Hkv, rep, 1, Skv_local) masked with the finite ``NEG_INF``, vf
    (B, Skv_local, Hkv, hd).  Each rank keeps its max ``m``, its sum of
    exponentials ``l`` and its weighted values ``acc`` in f32; the ranks
    all-reduce the max, rescale by ``exp(m_r - m)`` and all-reduce ``l``
    and ``acc``.  A rank whose every key lies past ``pos`` has uniform
    local weights, which the rescale zeroes (with ``-inf`` masks its
    ``exp`` would be NaN).  Returns (B, 1, Hkv, rep, hd)."""
    m_r = s.amax(-1, keepdim=True)
    p = torch.exp(s - m_r)
    m = sh.all_reduce_(m_r.clone(), ax, "max")
    corr = torch.exp(m_r - m)
    l = sh.all_reduce_(p.sum(-1, keepdim=True) * corr, ax)
    acc = sh.all_reduce_(torch.einsum("bhrqk,bkhd->bqhrd", p, vf)
                         * corr[..., 0].permute(0, 3, 1, 2)[..., None], ax)
    return acc / l[..., 0].permute(0, 3, 1, 2)[..., None]
