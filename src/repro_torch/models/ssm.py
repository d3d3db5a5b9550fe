"""Mamba2 (SSD) block: chunked-scan prefill path + recurrent decode path.

The SSD (state-space duality) recurrence per head (state ``h``: P x N):

    h_t = exp(a_t) * h_{t-1} + dt_t * (x_t  (x)  B_t)         a_t = dt_t * A
    y_t = (h_t @ C_t) + D * x_t

The prefill uses the chunked algorithm: an intra-chunk quadratic term plus
an inter-chunk state carried from chunk to chunk (sub-quadratic in the
sequence length).  ``ssd_chunked`` is shared with the mLSTM block
(``models/xlstm.py``), whose matrix-memory recurrence is the same
computation with (q, k, v) playing (C, B, x) and sigmoid gates playing
(exp(a), dt).

The counterpart of ``repro.models.ssm``.  The JAX package's ``lax.scan``
over chunks is a Python loop over the ``nc`` chunks here; every product is
a plain ``torch.matmul`` / ``torch.einsum``, as the JAX package computes
them outside any Pallas kernel.  ``decode_mamba2`` writes the new state
into the caller's cache tensors in place (see ``attention.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import (HOST_MESH, MeshInfo, dense_init,
                                       ones_init, zeros_init)
from repro_torch.runtime import sharding as sh


def silu(x):
    """x * sigmoid(x) as ``jax.nn.silu`` writes it, x * (1 / (1 + exp(-x))),
    each operation rounded to x's dtype.  In f32 it equals ``F.silu``; in
    bf16 it rounds as the JAX package does (``F.silu`` rounds once), which
    the mLSTM's normalised read-out would otherwise amplify past 2e-2."""
    return x * torch.reciprocal(1 + torch.exp(-x))


# ---------------------------------------------------------------------------
# Shared chunked-SSD core
# ---------------------------------------------------------------------------


def ssd_chunked(xh, a, dt, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD scan.

    xh: (B, S, H, P)   per-head inputs ("v" in attention terms)
    a:  (B, S, H)      log-decay per step (<= 0)
    dt: (B, S, H)      input gate
    Bm: (B, S, H, N)   input mixing ("k"; broadcast over H for mamba2 groups=1)
    Cm: (B, S, H, N)   output mixing ("q")
    h0: optional initial state (B, H, P, N)

    Returns (y (B,S,H,P) in xh's dtype, h_final (B,H,P,N) f32).
    """
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    nc = math.ceil(s / chunk)
    pad = nc * chunk - s
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    L = chunk
    xc = xh.reshape(b, nc, L, h, p).float()
    ac = a.reshape(b, nc, L, h).float()
    dtc = dt.reshape(b, nc, L, h).float()
    Bc = Bm.reshape(b, nc, L, h, n).float()
    Cc = Cm.reshape(b, nc, L, h, n).float()

    cum = torch.cumsum(ac, dim=2)                            # (B,C,L,H)
    # intra-chunk "attention": att[i,j] = exp(cum_i - cum_j) dt_j (C_i.B_j),
    # j <= i.  Above the diagonal seg is positive and exp may overflow, so
    # it is clamped and then masked by selection (inf * 0 would be nan).
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,C,L,L,H)
    causal = torch.ones((L, L), dtype=torch.bool,
                        device=xh.device).tril()[None, None, :, :, None]
    dec = torch.where(causal, torch.exp(torch.clamp(seg, max=0.0)), 0.0)
    cb = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc)          # (B,C,L,L,H)
    att = dec * cb * dtc[:, :, None, :, :]                   # (B,C,L,L,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, xc)

    # per-chunk aggregated state:
    #   S_c = sum_j exp(cum_L - cum_j) dt_j x_j (x) B_j
    tail = torch.exp(cum[:, :, -1:, :] - cum) * dtc          # (B,C,L,H)
    s_chunk = torch.einsum("bclh,bclhp,bclhn->bchpn", tail, xc, Bc)
    a_chunk = torch.exp(cum[:, :, -1, :])                    # (B,C,H)

    hprev = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
             if h0 is None else h0.float())
    befores = []
    for c in range(nc):
        befores.append(hprev)
        hprev = hprev * a_chunk[:, c, :, None, None] + s_chunk[:, c]
    h_befores = torch.stack(befores, dim=1)                  # (B,C,H,P,N)

    # inter-chunk contribution: y_i += C_i . (exp(cum_i) * h_before)
    y_inter = torch.einsum("bcihn,bchpn,bcih->bcihp",
                           Cc, h_befores, torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, nc * L, h, p)
    return y[:, :s].to(xh.dtype), hprev


def ssd_decode_step(h, x_t, a_t, dt_t, B_t, C_t):
    """One recurrent step.  h: (B,H,P,N); x_t: (B,H,P); a/dt: (B,H);
    B_t/C_t: (B,H,N).  Returns (y_t (B,H,P), h_new f32)."""
    hf = h.float()
    contrib = (dt_t[:, :, None, None] * x_t[:, :, :, None].float()
               * B_t[:, :, None, :].float())
    h_new = hf * torch.exp(a_t.float())[:, :, None, None] + contrib
    y = torch.einsum("bhpn,bhn->bhp", h_new, C_t.float())
    return y.to(x_t.dtype), h_new


# ---------------------------------------------------------------------------
# Causal depthwise conv (width cfg.ssm_conv) with decode cache
# ---------------------------------------------------------------------------


def causal_conv(x, w, b):
    """x: (B, S, C); w: (K, C); b: (C,) — depthwise causal conv."""
    k = w.shape[0]
    w = w.to(x.dtype)
    xp = F.pad(x, (0, 0, k - 1, 0))
    s = x.shape[1]
    out = xp[:, 0:s, :] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s, :] * w[i]
    return out + b.to(x.dtype)


def causal_conv_step(cache, x_t, w, b):
    """cache: (B, K-1, C); x_t: (B, 1, C) -> (y_t, new_cache)."""
    window = torch.cat([cache.to(x_t.dtype), x_t], dim=1)   # (B,K,C)
    y = torch.einsum("bkc,kc->bc", window, w.to(x_t.dtype))[:, None, :] \
        + b.to(x_t.dtype)
    return y, window[:, 1:, :]


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


def mamba2_specs(cfg, mesh: MeshInfo) -> dict:
    in_ax = mesh.shard_if(cfg.d_inner)
    h_ax = mesh.shard_if(cfg.ssm_heads)
    fsdp = mesh.fsdp_if(cfg.d_model)
    return {"w_z": (fsdp, in_ax), "w_x": (fsdp, in_ax),
            "w_B": (fsdp, None), "w_C": (fsdp, None), "w_dt": (fsdp, h_ax),
            "dt_bias": (h_ax,), "A_log": (h_ax,), "Dskip": (h_ax,),
            "conv_w": (None, in_ax), "conv_b": (in_ax,),
            "w_out": (in_ax, fsdp), "norm_scale": (in_ax,)}


def init_mamba2(gen, cfg, mesh: MeshInfo, dtype, device):
    d, di, n, hh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di  # conv over the x stream only (B/C kept conv-free)
    conv_w = torch.randn((cfg.ssm_conv, conv_ch), generator=gen,
                         dtype=torch.float32, device=device).to(dtype)
    return {
        "w_z": dense_init(gen, d, (d, di), dtype, device),
        "w_x": dense_init(gen, d, (d, di), dtype, device),
        "w_B": dense_init(gen, d, (d, n), dtype, device),
        "w_C": dense_init(gen, d, (d, n), dtype, device),
        "w_dt": dense_init(gen, d, (d, hh), dtype, device),
        "dt_bias": zeros_init((hh,), torch.float32, device),
        "A_log": torch.log(torch.arange(1, hh + 1, dtype=torch.float32,
                                        device=device)),
        "Dskip": ones_init((hh,), torch.float32, device),
        "conv_w": conv_w * (1.0 / math.sqrt(cfg.ssm_conv)),
        "conv_b": zeros_init((conv_ch,), dtype, device),
        "w_out": dense_init(gen, di, (di, d), dtype, device),
        "norm_scale": ones_init((di,), dtype, device),
    }


def _tp_axis(cfg, mesh: MeshInfo):
    """The model axis this block's inner width and heads shard over, or
    None; refuses a mesh that shards only one of them (no local layout
    keeps whole heads then)."""
    in_ax, h_ax = mesh.shard_if(cfg.d_inner), mesh.shard_if(cfg.ssm_heads)
    if in_ax != h_ax and sh.axis_size(mesh.model_axis) > 1:
        raise NotImplementedError(
            f"mamba2 on a model axis of {mesh.model}: it divides only one "
            f"of d_inner {cfg.d_inner} and the {cfg.ssm_heads} heads")
    return in_ax


def _mamba2_inner(params, x, cfg, ax=None):
    # under a mesh B and C come whole from replicated weights; each rank
    # reads them for its own heads, so their weights' gradients are summed
    xl = sh.copy_to(x, ax)
    z = torch.matmul(xl, params["w_z"])
    xs = torch.matmul(xl, params["w_x"])
    Bm = torch.matmul(xl, sh.copy_to(params["w_B"], ax))
    Cm = torch.matmul(xl, sh.copy_to(params["w_C"], ax))
    dt_raw = torch.matmul(xl, params["w_dt"])
    return z, xs, Bm, Cm, dt_raw


def mean_square(yf, width: int, ax=None):
    """The mean of ``yf``'s squares over its last dim, ``width`` wide in
    all, of which this rank holds a slice when ``ax`` shards it (the sum
    over the ranks' slices, its gradient summed back to every slice)."""
    if not sh.communicates(ax):
        return yf.square().mean(-1, keepdim=True)
    total = sh.all_reduce(yf.square().sum(-1, keepdim=True), ax)
    return sh.copy_to(total, ax) / width


def _gated_out(params, y, z, cfg, b, s, ax=None):
    y = y.reshape(b, s, -1)
    # grouped RMSNorm then gate (mamba2's norm-before-gate)
    yf = y.float()
    ms = mean_square(yf, cfg.d_inner, ax)
    scale = params["norm_scale"].float()
    y = (yf * torch.rsqrt(ms + cfg.norm_eps) * scale).to(z.dtype)
    y = y * silu(z)
    return sh.all_reduce(torch.matmul(y, params["w_out"]), ax)


def _conv_tail(xs, k):
    """The last ``k`` positions of ``xs`` (B, S, C), zero-padded on the
    left when the sequence is shorter: the decode conv cache."""
    s = xs.shape[1]
    return xs[:, s - k:, :] if s >= k else F.pad(xs, (0, 0, k - s, 0))


def apply_mamba2(params, x, cfg, mesh: MeshInfo = HOST_MESH):
    """Prefill path.  x: (B, S, D) -> (y, h_final, conv_tail)."""
    b, s, _ = x.shape
    p = cfg.ssm_head_dim
    ax = _tp_axis(cfg, mesh)
    z, xs, Bm, Cm, dt_raw = _mamba2_inner(params, x, cfg, ax)
    hh = xs.shape[-1] // p                                   # local heads
    xs_conv = silu(causal_conv(xs, params["conv_w"], params["conv_b"]))
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    a = -torch.exp(params["A_log"])[None, None, :] * dt      # (B,S,H)
    xh = xs_conv.reshape(b, s, hh, p)
    n = cfg.ssm_state
    Bh = Bm[:, :, None, :].expand(b, s, hh, n)               # groups=1
    Ch = Cm[:, :, None, :].expand(b, s, hh, n)
    y, h_last = ssd_chunked(xh, a, dt, Bh, Ch, cfg.ssm_chunk)
    y = y + params["Dskip"][None, None, :, None] * xh.float()
    out = _gated_out(params, y.to(x.dtype), z, cfg, b, s, ax)
    return out, h_last, _conv_tail(xs, cfg.ssm_conv - 1)


def mamba2_cache_specs(cfg, mesh: MeshInfo, batch_shard: bool = True) -> dict:
    dp = mesh.dp() if batch_shard else None
    return {"h": (dp, mesh.shard_if(cfg.ssm_heads), None, None),
            "conv": (dp, None, mesh.shard_if(cfg.d_inner))}


def init_mamba2_cache(cfg, mesh: MeshInfo, batch: int, dtype, device):
    di, hh, p, n = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "h": torch.zeros((batch, hh, p, n), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype,
                            device=device),
    }


def decode_mamba2(params, cache, x, cfg, mesh: MeshInfo = HOST_MESH):
    """One-token decode.  x: (B, 1, D) -> (y (B,1,D), cache), the cache
    updated in place."""
    b = x.shape[0]
    p = cfg.ssm_head_dim
    ax = _tp_axis(cfg, mesh)
    z, xs, Bm, Cm, dt_raw = _mamba2_inner(params, x, cfg, ax)
    hh = xs.shape[-1] // p
    xc, conv_new = causal_conv_step(cache["conv"], xs,
                                    params["conv_w"], params["conv_b"])
    xc = silu(xc)
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])
    a = -torch.exp(params["A_log"])[None, :] * dt            # (B,H)
    xh = xc.reshape(b, hh, p)
    n = cfg.ssm_state
    Bh = Bm[:, 0, None, :].expand(b, hh, n)
    Ch = Cm[:, 0, None, :].expand(b, hh, n)
    y, h_new = ssd_decode_step(cache["h"], xh, a, dt, Bh, Ch)
    y = y + params["Dskip"][None, :, None] * xh.float()
    out = _gated_out(params, y[:, None].to(x.dtype), z, cfg, b, 1, ax)
    cache["h"].copy_(h_new)
    cache["conv"].copy_(conv_new)
    return out, cache
