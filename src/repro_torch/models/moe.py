"""Mixture-of-Experts block: top-k router + capacity-based dispatch.

The counterpart of ``repro.models.moe``'s single-device path: GShard/Switch
dispatch with a fixed per-expert capacity, enforced per sequence (overflow
tokens fall back to the residual path), the expert FFNs (SwiGLU) as three
grouped GEMMs over the expert dimension through ``gemm.grouped_matmul`` —
the hand-written grouped CUDA kernel — and a gate-weighted combine.  The
expert-parallel path (``apply_moe_ep``) belongs to the multi-device queue.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import gemm as gemm_api
from repro_torch.models.common import MeshInfo, dense_init


def padded_experts(cfg, mesh: MeshInfo) -> int:
    """Physical expert count: on one device the logical count, unpadded."""
    return cfg.n_experts


def init_moe(gen, cfg, mesh: MeshInfo, dtype, device):
    d, f, e = cfg.d_model, cfg.moe_d_ff, padded_experts(cfg, mesh)
    return {
        "router": dense_init(gen, d, (d, e), torch.float32, device),
        "w_gate": dense_init(gen, d, (e, d, f), dtype, device),
        "w_up": dense_init(gen, d, (e, d, f), dtype, device),
        "w_down": dense_init(gen, f, (e, f, d), dtype, device),
    }


def _masked_router_logits(params, x, cfg):
    """Router logits in f32 over physical experts; a padded tail (none on
    one device) is masked."""
    # the compute copy holds the router in the compute dtype; JAX's einsum
    # promotes it to f32, torch's does not
    logits = torch.einsum("bsd,de->bse", x.float(),
                          params["router"].float())
    e_phys = logits.shape[-1]
    if e_phys > cfg.n_experts:
        mask = torch.arange(e_phys, device=x.device) >= cfg.n_experts
        logits = torch.where(mask, -1e9, logits)
    return logits


def _capacity(tokens: int, cfg) -> int:
    c = int(cfg.capacity_factor * tokens * cfg.experts_per_token / cfg.n_experts)
    return max(8, (c + 7) // 8 * 8)


def apply_moe(params, x, cfg, mesh: MeshInfo | None = None):
    """x: (B, S, D) -> (y, aux_loss).  Router in f32 for stability.

    ``S`` is the length the caller runs, pad tokens included: the capacity
    is computed from it and pad tokens are routed like any other (they come
    after the real tokens in the cumulative order, so they can only drop
    themselves), exactly as in the JAX package.
    """
    b, s, d = x.shape
    e, k = params["router"].shape[-1], cfg.experts_per_token
    cap = _capacity(s, cfg)
    dev = x.device

    logits = _masked_router_logits(params, x, cfg)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1, sorted=True)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balancing auxiliary loss (per sequence, then mean)
    me = probs.mean(1)                                        # (B,E)
    ce = F.one_hot(expert_idx[:, :, 0], e).float().mean(1)    # (B,E)
    aux = cfg.router_aux_coef * e * (me * ce).sum(-1).mean()

    # --- per-sequence dispatch ---------------------------------------------
    flat_e = expert_idx.reshape(b, s * k)                     # (B, S*k)
    pos_all = F.one_hot(flat_e, e).cumsum(1) - 1
    pos = pos_all.gather(2, flat_e[..., None])[..., 0]        # (B, S*k)
    keep = pos < cap
    safe_pos = torch.where(keep, pos, 0)
    tok_idx = torch.arange(s, device=dev).repeat_interleave(k)  # (S*k,)
    src = torch.where(keep[..., None], x[:, tok_idx], 0).to(x.dtype)
    rows = torch.arange(b, device=dev)[:, None].expand(b, s * k)
    # a scatter-ADD, as in the JAX package: a dropped token lands on its
    # expert's slot 0 with a zeroed source, which an assignment would turn
    # into an overwrite of that slot's real token.
    buf = torch.zeros((b, e, cap, d), dtype=x.dtype, device=dev)
    buf.index_put_((rows, flat_e, safe_pos), src, accumulate=True)

    # --- expert FFN (SwiGLU), batched over experts ---------------------------
    g = gemm_api.grouped_matmul(buf, params["w_gate"])
    u = gemm_api.grouped_matmul(buf, params["w_up"])
    h = F.silu(g) * u
    out_buf = gemm_api.grouped_matmul(h, params["w_down"])

    # --- combine (gather + gate weighting), in the compute dtype -------------
    eo = out_buf[rows, flat_e, safe_pos]                      # (B, S*k, D)
    gvb = gate_vals.reshape(b, s * k).to(out_buf.dtype)
    contrib = torch.where(keep[..., None], eo, 0) * gvb[..., None]
    # The JAX package's scatter-add over tok_idx: token t owns the k
    # consecutive entries t*k .. t*k+k-1 (tok_idx is arange(s) repeated k
    # times), added in order in the compute dtype.  Written as k adds of
    # strided views it is deterministic on the card, where index_add_ would
    # add with atomics in no fixed order.
    parts = contrib.reshape(b, s, k, d)
    y = parts[:, :, 0]
    for j in range(1, k):
        y = y + parts[:, :, j]
    return y.to(x.dtype), aux
