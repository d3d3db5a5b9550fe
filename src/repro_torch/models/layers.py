"""Core layers: norms, rotary embeddings, MLPs, embedding / logits heads.

The counterparts of ``repro.models.layers``, same functions on tensors.
Every matmul-shaped operation routes through the unified plan/execute API
(``repro_torch.gemm.matmul``): the planned CUDA kernels for CUDA tensors,
their plain versions for CPU tensors.

Under a mesh (``runtime.sharding``) the MLP is column- then row-parallel
over ``d_ff`` (one all-reduce), the embedding table and the logits head
are sharded over the vocabulary (a masked lookup plus an all-reduce; the
logits stay vocab-sharded: :func:`cross_entropy` reduces over the shards
for training, :func:`gather_logits` gathers them for serving).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import gemm as gemm_api
from repro_torch.models.common import (
    HOST_MESH,
    WHOLE,
    Cut,
    MeshInfo,
    dense_init,
    embed_init,
    ones_init,
    zeros_init,
)
from repro_torch.runtime import sharding as sh


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_specs(cfg, mesh: MeshInfo) -> dict:
    specs = {"scale": (None,)}
    if cfg.norm_type == "layernorm":
        specs["bias"] = (None,)
    return specs


def init_norm(cfg, mesh: MeshInfo, dtype, device, cut: Cut = WHOLE):
    p = {"scale": cut("scale", ones_init((cfg.d_model,), dtype, device))}
    if cfg.norm_type == "layernorm":
        p["bias"] = cut("bias", zeros_init((cfg.d_model,), dtype, device))
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


def apply_rope_pairs(x, sin, cos):
    """RoPE on adjacent pairs: dims (2i, 2i+1) rotate at frequency i, the
    layout DeepSeek-V3's published modelling code gives its rope dims (it
    de-interleaves them and rotates halves: the scores are the same).
    Shapes as :func:`apply_rope`; f32 inside, cast back."""
    xf = x.float().unflatten(-1, (-1, 2))
    x1, x2 = xf[..., 0], xf[..., 1]
    s = sin[..., None, :]
    c = cos[..., None, :]
    out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.flatten(-2).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU)
# ---------------------------------------------------------------------------


def mlp_specs(cfg, mesh: MeshInfo, d_ff: int | None = None) -> dict:
    f = d_ff or cfg.d_ff
    ff_ax = mesh.shard_if(f)
    fsdp = mesh.fsdp_if(cfg.d_model)
    specs = {"w_up": (fsdp, ff_ax), "w_down": (ff_ax, fsdp)}
    if cfg.act in ("swiglu", "geglu"):
        specs["w_gate"] = (fsdp, ff_ax)
    return specs


def init_mlp(gen, cfg, mesh: MeshInfo, dtype, device, d_ff: int | None = None,
             cut: Cut = WHOLE):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {
        "w_up": dense_init(gen, d, (d, f), dtype, device, cut.of("w_up")),
        "w_down": dense_init(gen, f, (f, d), dtype, device,
                             cut.of("w_down")),
    }
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, d, (d, f), dtype, device,
                                 cut.of("w_gate"))
    return p


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def apply_mlp(params, x, cfg, mesh: MeshInfo = HOST_MESH):
    """Under a mesh the weights hold this rank's share of ``d_ff`` (when
    the model axis divides it): the products' sum comes out of one
    all-reduce."""
    ff_ax = mesh.shard_if(cfg.d_ff)
    x = sh.copy_to(x, ff_ax)
    up = gemm_api.matmul(x, params["w_up"])
    if cfg.act == "swiglu":
        h = F.silu(gemm_api.matmul(x, params["w_gate"])) * up
    elif cfg.act == "geglu":
        h = _gelu(gemm_api.matmul(x, params["w_gate"])) * up
    else:
        h = _gelu(up)
    return sh.all_reduce(gemm_api.matmul(h, params["w_down"]), ff_ax)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def embedding_specs(cfg, mesh: MeshInfo) -> dict:
    vax = mesh.shard_if(cfg.padded_vocab)
    fsdp = mesh.fsdp_if(cfg.d_model)
    specs = {"table": (vax, fsdp)}
    if not cfg.tie_embeddings:
        specs["unembed"] = (fsdp, vax)
    return specs


def init_embedding(gen, cfg, mesh: MeshInfo, dtype, device,
                   cut: Cut = WHOLE):
    v = cfg.padded_vocab
    p = {"table": embed_init(gen, v, cfg.d_model, dtype, device,
                             cut.of("table"))}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, cfg.d_model, (cfg.d_model, v), dtype,
                                  device, cut.of("unembed"))
    return p


def vocab_axis(cfg, mesh: MeshInfo):
    return mesh.shard_if(cfg.padded_vocab)


def embed_tokens(params, token_ids, cfg, mesh: MeshInfo = HOST_MESH):
    """Under a mesh each rank looks up the ids its vocabulary shard holds,
    zeros the rest, and the all-reduce sums the shards' rows."""
    table = params["table"]
    vax = vocab_axis(cfg, mesh)
    if not sh.communicates(vax):
        return table[token_ids]
    rows = table.shape[0]
    local = token_ids - sh.axis_index(vax) * rows
    mine = (local >= 0) & (local < rows)
    emb = table[local.clamp(0, rows - 1)]
    return sh.all_reduce(torch.where(mine[..., None], emb, 0), vax)


def head_matrix(params, cfg):
    """The (D, Vp) logits matrix.  With tied embeddings it is the table's
    ``.t()``, a view: the bf16 GEMM reads it in place (K-major B), so
    neither a training step nor a compute copy copies the table
    (``LM.compute_params`` keeps the view under ``"head"``); the f32 route
    copies it row-major inside each call.  Under autograd the view is an
    ordinary differentiable op, and the table's gradient flows through
    it."""
    if "head" in params:
        return params["head"]
    if cfg.tie_embeddings:
        return params["table"].t()
    return params["unembed"]


def logits_head(params, x, cfg, mesh: MeshInfo = HOST_MESH):
    """x: (..., d) -> (..., padded_vocab); soft-capped if configured.  With
    tied embeddings the backward product ``dX = dlogits · table`` reads the
    table row-major and ``dTable`` comes out in the table's layout
    (``gemm/autograd.py``).  Under a mesh the logits are this rank's
    vocabulary shard (:func:`gather_logits` joins them)."""
    x = sh.copy_to(x, vocab_axis(cfg, mesh))
    logits = gemm_api.matmul(x, head_matrix(params, cfg))
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def gather_logits(logits, cfg, mesh: MeshInfo = HOST_MESH):
    """The vocabulary shards of :func:`logits_head` joined on every rank
    (serving)."""
    return sh.gather_from(logits, vocab_axis(cfg, mesh), -1)


class _VocabLogSumExp(torch.autograd.Function):
    """logsumexp over the last dim of logits sharded over ``names``: the
    max and the sum of exponentials reduce over the shards.  On one shard
    it computes what ``torch.logsumexp`` does, operation for operation,
    and its backward is ``torch.logsumexp``'s."""

    @staticmethod
    def forward(ctx, x, names):
        m = sh.all_reduce_(x.amax(-1, keepdim=True), names, op="max")
        s = sh.all_reduce_((x - m).exp().sum(-1), names)
        lse = s.log().add(m[..., 0])
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * (x - lse[..., None]).exp(), None


class _MaskedMean(torch.autograd.Function):
    """The global masked mean over the data ranks: the ranks' masked sums
    ``num`` all-reduced over ``names``, over ``den`` (their all-reduced
    mask count).  Its backward scales this rank's gradient by ``n / den``
    (``n`` ranks), so that the train step's average of the ranks'
    gradients is the gradient of the global mean."""

    @staticmethod
    def forward(ctx, num, den, names):
        ctx.den, ctx.n = den, sh.axis_size(names)
        return sh.all_reduce_(num.clone(), names) / den

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n / ctx.den, None, None


def cross_entropy(logits, labels, vocab_size: int, z_coef: float = 1e-4,
                  mask=None, vocab_ax=None, data_ax=None):
    """Next-token CE over the *logical* vocab (the padded tail masked out).

    logits: (B, S, Vp); labels: (B, S) int.  Returns the scalar mean loss
    (plus a small z-loss against logit drift) over unmasked positions, in
    f32.  The tail is set to -1e9 out of place, so autograd follows it.
    With ``vocab_ax`` under a mesh the logits are this rank's vocabulary
    shard (vocab-parallel cross-entropy: the logsumexp and the gold logit
    reduce over the shards).  Without a mask the mean is over this rank's
    tokens (the data ranks hold equal shares; the train step averages
    them).  With a mask and ``data_ax`` under a mesh it is the global
    masked mean over the data ranks, as on one device (the JAX package's):
    every rank returns it, and its gradient is scaled for the step's
    average (:class:`_MaskedMean`).
    """
    logits = logits.float()
    if not sh.communicates(vocab_ax):
        vp = logits.shape[-1]
        if vp > vocab_size:
            tail = torch.arange(vp, device=logits.device) >= vocab_size
            logits = logits.masked_fill(tail, -1e9)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    else:
        vl = logits.shape[-1]
        first = sh.axis_index(vocab_ax) * vl
        if vl * sh.axis_size(vocab_ax) > vocab_size:
            cols = first + torch.arange(vl, device=logits.device)
            logits = logits.masked_fill(cols >= vocab_size, -1e9)
        lse = _VocabLogSumExp.apply(logits, sh.axis_names(vocab_ax))
        local = labels.long() - first
        mine = (local >= 0) & (local < vl)
        gold = logits.gather(-1, local.clamp(0, vl - 1)[..., None])[..., 0]
        gold = sh.all_reduce(torch.where(mine, gold, 0.0), vocab_ax)
    per_tok = (lse - gold) + z_coef * lse.square()
    if mask is None:
        return per_tok.mean()
    mask = mask.float()
    if not sh.communicates(data_ax):
        return (per_tok * mask).sum() / mask.sum().clamp_min(1.0)
    den = sh.all_reduce_(mask.sum(), data_ax).clamp_min(1.0)
    return _MaskedMean.apply((per_tok * mask).sum(), den,
                             sh.axis_names(data_ax))
