"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

The mLSTM recurrence C_t = f_t C_{t-1} + i_t v_t k_t^T with read-out
q_t^T C_t / max(|q_t^T n_t|, 1) is the same computation as the SSD scan
(``models/ssm.py``) with (q, k, v) as (C, B, x), sigmoid gates as
(exp(a), dt), and the normalizer n tracked by extending v with a ones
column, so both blocks share ``ssd_chunked`` / ``ssd_decode_step`` — one
scan core, two papers' blocks (the sigmoid-input-gate mLSTM variant, as in
the JAX package).

sLSTM has genuine recurrent mixing (R h_{t-1}) and cannot be parallelised
over time: the JAX package's ``lax.scan`` over steps is a Python loop over
the S positions here, with block-diagonal per-head recurrent matrices.

The counterpart of ``repro.models.xlstm``; every product is a plain
``torch.matmul`` / ``torch.einsum``, as the JAX package computes them.
The decode functions write the new state into the caller's cache tensors
in place.

Under a mesh the specs shard the mLSTM's inner width and the sLSTM's
feed-forward width over the model axis; the recurrences stay whole on
every rank.  mLSTM: the up and gate projections are column-parallel, the
convolution runs on this rank's channels, q, k, v and the gates are
row-parallel products whose sums one all-reduce each completes, the
normalised read-out is cut back to this rank's channels for the gate and
the row-parallel down projection.  sLSTM: its feed-forward is an MLP
sharded as ``layers.apply_mlp`` is.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import (HOST_MESH, MeshInfo, dense_init,
                                       ones_init, zeros_init)
from repro_torch.models.layers import _gelu
from repro_torch.runtime import sharding as sh
from repro_torch.models.ssm import (
    _conv_tail,
    causal_conv,
    causal_conv_step,
    silu,
    ssd_chunked,
    ssd_decode_step,
)


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def mlstm_specs(cfg, mesh: MeshInfo) -> dict:
    in_ax = mesh.shard_if(cfg.mlstm_inner)
    fsdp = mesh.fsdp_if(cfg.d_model)
    return {"w_up": (fsdp, in_ax), "w_z": (fsdp, in_ax),
            "w_q": (in_ax, None), "w_k": (in_ax, None), "w_v": (in_ax, None),
            "w_i": (in_ax, None), "w_f": (in_ax, None), "f_bias": (None,),
            "conv_w": (None, in_ax), "conv_b": (in_ax,),
            "norm_scale": (in_ax,), "w_down": (in_ax, fsdp)}


def init_mlstm(gen, cfg, mesh: MeshInfo, dtype, device):
    d, di, hh = cfg.d_model, cfg.mlstm_inner, cfg.lstm_heads
    p = {
        "w_up": dense_init(gen, d, (d, di), dtype, device),
        "w_z": dense_init(gen, d, (d, di), dtype, device),
        "w_q": dense_init(gen, di, (di, di), dtype, device),
        "w_k": dense_init(gen, di, (di, di), dtype, device),
        "w_v": dense_init(gen, di, (di, di), dtype, device),
        "w_i": dense_init(gen, di, (di, hh), dtype, device),
        "w_f": dense_init(gen, di, (di, hh), dtype, device),
        "f_bias": torch.full((hh,), 3.0, dtype=torch.float32, device=device),
    }
    conv_w = torch.randn((cfg.ssm_conv, di), generator=gen,
                         dtype=torch.float32, device=device)
    p["conv_w"] = (conv_w / math.sqrt(cfg.ssm_conv)).to(dtype)
    p["conv_b"] = zeros_init((di,), dtype, device)
    p["norm_scale"] = ones_init((di,), dtype, device)
    p["w_down"] = dense_init(gen, di, (di, d), dtype, device)
    return p


def _mlstm_qkvif(params, xc, cfg, b, s, ax=None):
    hh = cfg.lstm_heads
    p = cfg.mlstm_inner // hh

    def proj(name):          # row-parallel under a mesh: sum the ranks'
        return sh.all_reduce(torch.matmul(xc, params[name]), ax)

    q = proj("w_q").reshape(b, s, hh, p)
    # the scale is a bf16 constant in JAX's bf16 product (a weak-typed
    # Python float); a Python float here would multiply in f32
    scale = torch.full((), p ** -0.5, dtype=xc.dtype, device=xc.device)
    k = proj("w_k").reshape(b, s, hh, p) * scale
    v = proj("w_v").reshape(b, s, hh, p)
    i_gate = torch.sigmoid(proj("w_i").float())
    logf = -F.softplus(-(proj("w_f").float() + params["f_bias"]))
    return q, k, v, i_gate, logf


def _mlstm_out(params, y_ext, z, cfg, b, s, ax=None):
    p = cfg.mlstm_inner // cfg.lstm_heads
    y = y_ext[..., :p]
    norm = y_ext[..., p:p + 1]
    y = y / torch.clamp(norm.abs(), min=1.0)
    y = y.reshape(b, s, cfg.mlstm_inner)
    yf = y.float()
    ms = yf.square().mean(-1, keepdim=True)
    scale = params["norm_scale"].float()
    y = sh.scatter_to(yf * torch.rsqrt(ms + cfg.norm_eps), ax, -1)
    y = (y * scale).to(z.dtype)
    y = y * silu(z)
    return sh.all_reduce(torch.matmul(y, params["w_down"]), ax)


def _with_ones(v):
    """v extended by the normalizer column of ones."""
    return torch.cat([v, torch.ones(v.shape[:-1] + (1,), dtype=v.dtype,
                                    device=v.device)], dim=-1)


def apply_mlstm(params, x, cfg, mesh: MeshInfo = HOST_MESH):
    """x: (B, S, D) -> (y, state, conv_tail)."""
    b, s, _ = x.shape
    ax = mesh.shard_if(cfg.mlstm_inner)
    xl = sh.copy_to(x, ax)
    xin = torch.matmul(xl, params["w_up"])
    z = torch.matmul(xl, params["w_z"])
    xc = silu(causal_conv(xin, params["conv_w"], params["conv_b"]))
    q, k, v, i_gate, logf = _mlstm_qkvif(params, xc, cfg, b, s, ax)
    y_ext, h_last = ssd_chunked(_with_ones(v), logf, i_gate, k, q,
                                cfg.xlstm_chunk)
    out = _mlstm_out(params, y_ext.float(), z, cfg, b, s, ax)
    return out, h_last, _conv_tail(xin, cfg.ssm_conv - 1)


def mlstm_cache_specs(cfg, mesh: MeshInfo, batch_shard: bool = True) -> dict:
    dp = mesh.dp() if batch_shard else None
    return {"h": (dp, None, None, None),
            "conv": (dp, None, mesh.shard_if(cfg.mlstm_inner))}


def init_mlstm_cache(cfg, mesh: MeshInfo, batch: int, dtype, device):
    di, hh = cfg.mlstm_inner, cfg.lstm_heads
    p = di // hh
    return {
        "h": torch.zeros((batch, hh, p + 1, p), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype,
                            device=device),
    }


def decode_mlstm(params, cache, x, cfg, mesh: MeshInfo = HOST_MESH):
    b = x.shape[0]
    ax = mesh.shard_if(cfg.mlstm_inner)
    xl = sh.copy_to(x, ax)
    xin = torch.matmul(xl, params["w_up"])
    z = torch.matmul(xl, params["w_z"])
    xc, conv_new = causal_conv_step(cache["conv"], xin,
                                    params["conv_w"], params["conv_b"])
    xc = silu(xc)
    q, k, v, i_gate, logf = _mlstm_qkvif(params, xc, cfg, b, 1, ax)
    v_ext = _with_ones(v)[:, 0]                              # (B,H,P+1)
    y_ext, h_new = ssd_decode_step(cache["h"], v_ext, logf[:, 0],
                                   i_gate[:, 0], k[:, 0], q[:, 0])
    out = _mlstm_out(params, y_ext[:, None].float(), z, cfg, b, 1, ax)
    cache["h"].copy_(h_new)
    cache["conv"].copy_(conv_new)
    return out, cache


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------


def slstm_specs(cfg, mesh: MeshInfo) -> dict:
    fsdp = mesh.fsdp_if(cfg.d_model)
    ff_ax = mesh.shard_if(2 * cfg.d_model)
    return {"w_in": (fsdp, None, None), "r": (None, None, None, None),
            "bias": (None, None), "f_bias": (None,), "w_ff1": (fsdp, ff_ax),
            "w_ff2": (ff_ax, fsdp)}


def init_slstm(gen, cfg, mesh: MeshInfo, dtype, device):
    d, hh = cfg.d_model, cfg.lstm_heads
    q = d // hh
    ff = 2 * d
    w_in = dense_init(gen, d, (d, 4, d), dtype, device)
    r = torch.randn((hh, 4, q, q), generator=gen, dtype=torch.float32,
                    device=device)
    return {
        "w_in": w_in,
        "r": (r / math.sqrt(q)).to(dtype),
        "bias": zeros_init((4, d), torch.float32, device),
        "f_bias": torch.full((d,), 3.0, dtype=torch.float32, device=device),
        "w_ff1": dense_init(gen, d, (d, ff), dtype, device),
        "w_ff2": dense_init(gen, ff, (ff, d), dtype, device),
    }


def _slstm_cell(params, cfg, wx_t, state, r):
    """wx_t: (B, 4, D) pre-computed input part; state: (h, c, n) each
    (B, D); r: the recurrent matrices in f32."""
    hh = cfg.lstm_heads
    d = cfg.d_model
    q = d // hh
    h, c, n = state
    hb = h.reshape(-1, hh, q)
    rec = torch.einsum("bhq,hgqr->bghr", hb.float(), r).reshape(-1, 4, d)
    pre = wx_t.float() + rec + params["bias"]
    z = torch.tanh(pre[:, 0])
    i = torch.sigmoid(pre[:, 1])
    f = torch.sigmoid(pre[:, 2] + params["f_bias"])
    o = torch.sigmoid(pre[:, 3])
    c_new = f * c + i * z
    n_new = f * n + i
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return h_new, c_new, n_new


def _slstm_ffn(params, y, cfg, mesh: MeshInfo):
    # post-MLP (GeLU, tanh form as jax.nn.gelu), as in the xLSTM sLSTM block
    ff_ax = mesh.shard_if(2 * cfg.d_model)
    y = sh.copy_to(y, ff_ax)
    return sh.all_reduce(torch.matmul(
        _gelu(torch.matmul(y, params["w_ff1"])), params["w_ff2"]), ff_ax)


def apply_slstm(params, x, cfg, mesh: MeshInfo = HOST_MESH):
    """x: (B, S, D) -> (y, final_state).  Sequential over time."""
    b, s, d = x.shape
    wx = torch.einsum("bsd,dge->bsge", x, params["w_in"])   # (B,S,4,D)
    r = params["r"].float()
    state = tuple(torch.zeros((b, d), dtype=torch.float32, device=x.device)
                  for _ in range(3))
    hs = []
    for t in range(s):
        state = _slstm_cell(params, cfg, wx[:, t], state, r)
        hs.append(state[0])
    y = torch.stack(hs, dim=1).to(x.dtype)                  # (B,S,D)
    return _slstm_ffn(params, y, cfg, mesh), state


def slstm_cache_specs(cfg, mesh: MeshInfo, batch_shard: bool = True) -> dict:
    dp = mesh.dp() if batch_shard else None
    return {"h": (dp, None), "c": (dp, None), "n": (dp, None)}


def init_slstm_cache(cfg, mesh: MeshInfo, batch: int, dtype, device):
    d = cfg.d_model
    return {key: torch.zeros((batch, d), dtype=torch.float32, device=device)
            for key in ("h", "c", "n")}


def decode_slstm(params, cache, x, cfg, mesh: MeshInfo = HOST_MESH):
    wx = torch.einsum("bsd,dge->bsge", x, params["w_in"])[:, 0]
    state = (cache["h"], cache["c"], cache["n"])
    h, c, n = _slstm_cell(params, cfg, wx, state, params["r"].float())
    y = _slstm_ffn(params, h[:, None, :].to(x.dtype), cfg, mesh)
    for key, val in zip(("h", "c", "n"), (h, c, n)):
        cache[key].copy_(val)
    return y, cache
