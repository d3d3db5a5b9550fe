"""The plain reference of a dense decoder's training step.

Plain PyTorch in float32 (TF32 off), importing nothing of the program: the
published architecture of a Qwen2-style decoder (RMSNorm before attention
and before the MLP, rotary positions over the two halves of each head,
grouped-query causal attention with biases on q, k and v, a SwiGLU MLP, a
final RMSNorm and a head tied to the embedding table) and the training
recipe the traffic file states (next-token cross-entropy over the
vocabulary, the rows of the table past it masked, plus a z-loss; AdamW with
global-norm clipping, bias corrections, decoupled weight decay and a
linear warmup).  The embedding table has ``padded_vocab`` rows, as the
model stores it.

The parameters are made here from the seed (:func:`make_params`), so the
benchmark hands the same tensors to the program and the reference works
them out again.  A step runs row by row: each row's share of the mean loss
is backpropagated on its own and the gradients summed, so that one
sequence's activations are alive at a time.

``fp8=True`` is the control: every product with a weight (the
projections, the MLP and the head) forward and backward takes its operands
rounded to float8 e4m3 at one scale a tensor, the rest as above.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.gemm import FP8_MAX, exact_f32


def padded_vocab(vocab: int) -> int:
    return 256 * -(-vocab // 256)


def arch_of(config: dict) -> dict:
    """The sizes the reference reads from a configuration file."""
    h = config["num_attention_heads"]
    return {"d": config["hidden_size"], "f": config["intermediate_size"],
            "h": h, "kv": config["num_key_value_heads"],
            "hd": config.get("derived", {}).get("head_dim")
            or config["hidden_size"] // h,
            "layers": config["num_hidden_layers"],
            "vocab": config["vocab_size"],
            "vp": padded_vocab(config["vocab_size"]),
            "eps": config["rms_norm_eps"], "theta": config["rope_theta"],
            "init_std": config["initializer_range"]}


def leaf_specs(a: dict) -> list[tuple[str, tuple, str]]:
    """``(name, shape, init)`` of every parameter, in a fixed order;
    ``init`` is ``normal`` (std ``initializer_range``), ``ones`` or
    ``zeros``."""
    d, f, h, kv, hd = a["d"], a["f"], a["h"], a["kv"], a["hd"]
    out = [("embed", (a["vp"], d), "normal")]
    for i in range(a["layers"]):
        p = f"layers.{i}."
        out += [(p + "norm1", (d,), "ones"),
                (p + "wq", (d, h, hd), "normal"),
                (p + "wk", (d, kv, hd), "normal"),
                (p + "wv", (d, kv, hd), "normal"),
                (p + "wo", (h, hd, d), "normal"),
                (p + "bq", (h, hd), "zeros"),
                (p + "bk", (kv, hd), "zeros"),
                (p + "bv", (kv, hd), "zeros"),
                (p + "norm2", (d,), "ones"),
                (p + "w_gate", (d, f), "normal"),
                (p + "w_up", (d, f), "normal"),
                (p + "w_down", (f, d), "normal")]
    out.append(("final_norm", (d,), "ones"))
    return out


def make_params(a: dict, seed: int, device) -> tuple[torch.Tensor, dict]:
    """``(flat, {name: view})``: every parameter in float32, each a view
    of one buffer that holds the normal ones first, drawn in one call from
    a generator on ``device`` seeded with ``seed``."""
    specs = sorted(leaf_specs(a), key=lambda s: s[2] != "normal")
    sizes = [math.prod(s) for _, s, _ in specs]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    views, off, normal = {}, 0, 0
    for (name, shape, init), n in zip(specs, sizes):
        views[name] = flat[off:off + n].view(shape)
        if init == "ones":
            views[name].fill_(1.0)
        elif init == "zeros":
            views[name].zero_()
        else:
            normal = off + n
        off += n
    flat[:normal].normal_(0.0, a["init_std"],
                          generator=torch.Generator(device).manual_seed(seed))
    return flat, {name: views[name] for name, _, _ in leaf_specs(a)}


def decays(name: str) -> bool:
    """Whether AdamW's weight decay applies to a parameter: every layer's
    parameter and the embedding table, not the final norm's scale (the
    program decays a layer's vectors too: it stacks the layers)."""
    return name != "final_norm"


# ---------------------------------------------------------------------------
# The forward pass
# ---------------------------------------------------------------------------


def _q8(t):
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _Fp8Product(torch.autograd.Function):
    """x @ w with both operands, and both backward products' operands,
    rounded to float8 e4m3 (the control)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _q8(x) @ _q8(w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gq = _q8(g)
        return gq @ _q8(w).t(), _q8(x).t() @ gq


def _mm(x, w, fp8: bool):
    """(..., k) @ (k, n)."""
    if not fp8:
        return x @ w
    lead = x.shape[:-1]
    return _Fp8Product.apply(x.reshape(-1, x.shape[-1]), w).reshape(
        *lead, w.shape[-1])


def _norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta: float):
    """x: (S, heads, hd), positions 0..S-1, the two halves rotated."""
    s, _, hd = x.shape
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(x, p, pre: str, a: dict, fp8: bool):
    s, d = x.shape
    h, kv, hd = a["h"], a["kv"], a["hd"]
    q = _mm(x, p[pre + "wq"].reshape(d, h * hd), fp8).view(s, h, hd) \
        + p[pre + "bq"]
    k = _mm(x, p[pre + "wk"].reshape(d, kv * hd), fp8).view(s, kv, hd) \
        + p[pre + "bk"]
    v = _mm(x, p[pre + "wv"].reshape(d, kv * hd), fp8).view(s, kv, hd) \
        + p[pre + "bv"]
    q, k = _rope(q, a["theta"]), _rope(k, a["theta"])
    rep = h // kv
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q * hd ** -0.5, k)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("hqk,khd->qhd", scores.softmax(-1), v)
    return _mm(out.reshape(s, h * hd), p[pre + "wo"].reshape(h * hd, d),
               fp8)


def _mlp(x, p, pre: str, fp8: bool):
    gate = _mm(x, p[pre + "w_gate"], fp8)
    up = _mm(x, p[pre + "w_up"], fp8)
    return _mm(F.silu(gate) * up, p[pre + "w_down"], fp8)


def row_loss_sum(p: dict, a: dict, tokens, labels, z_loss: float,
                 fp8: bool = False):
    """The sum over one row's positions of the next-token cross-entropy
    plus ``z_loss`` times the squared log-normaliser."""
    x = p["embed"][tokens]
    for i in range(a["layers"]):
        pre = f"layers.{i}."
        x = x + _attention(_norm(x, p[pre + "norm1"], a["eps"]), p, pre, a,
                           fp8)
        x = x + _mlp(_norm(x, p[pre + "norm2"], a["eps"]), p, pre, fp8)
    x = _norm(x, p["final_norm"], a["eps"])
    logits = _mm(x, p["embed"].t(), fp8)
    if a["vp"] > a["vocab"]:
        logits = logits.masked_fill(
            torch.arange(a["vp"], device=x.device) >= a["vocab"], -1e9)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[:, None])[:, 0]
    return ((lse - gold) + z_loss * lse.square()).sum()


# ---------------------------------------------------------------------------
# The training step
# ---------------------------------------------------------------------------


def lr_at(step: int, opt: dict) -> float:
    """The learning rate of the step that has ``step`` steps before it:
    a linear warmup over ``warmup_steps`` (0 at the first step)."""
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / max(opt["warmup_steps"], 1)
    prog = min(1.0, (step - opt["warmup_steps"])
               / max(opt["total_steps"] - opt["warmup_steps"], 1))
    return opt["lr"] * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"])
                        * 0.5 * (1 + math.cos(math.pi * prog)))


def initial_state(a: dict, seed: int, device) -> dict:
    """The state a run starts from: the parameters the seed makes, zero
    moments, step 0 (the form :func:`train_steps` takes)."""
    _, p = make_params(a, seed, device)
    return {"p": p, "m": {n: torch.zeros_like(t) for n, t in p.items()},
            "v": {n: torch.zeros_like(t) for n, t in p.items()}, "step": 0}


def copy_state(state: dict) -> dict:
    return {k: ({n: t.clone() for n, t in v.items()}
                if isinstance(v, dict) else v) for k, v in state.items()}


def train_steps(a: dict, seed: int, batches: list, recipe: dict, device,
                fp8: bool = False, state: dict | None = None) -> dict:
    """The reference's ``len(batches)`` steps: ``{"loss": [...],
    "grad_norm": {name: norm of the first of these steps' clipped
    gradient}, "change_norm": {name: norm of the parameters' change over
    the steps}}``.  ``batches``: ``(tokens, labels)`` pairs of (B, S)
    integer tensors.  The steps start from ``state`` where it is given
    (``{"p", "m", "v": {name: float32 tensor}, "step": steps done}``, a copy
    of a run's state, updated in place), else from the parameters the seed
    makes, zero moments and step 0."""
    opt = recipe["optimizer"]
    if state is None:
        state = initial_state(a, seed, device)
    p, m, v = state["p"], state["m"], state["v"]
    p0 = {n: t.clone() for n, t in p.items()}
    names = list(p)
    losses, grad_norm = [], None
    with exact_f32():
        for i, (tokens, labels) in enumerate(batches):
            step = state["step"] + i
            for t in p.values():
                t.requires_grad_(True)
            grads = {n: torch.zeros_like(t) for n, t in p.items()}
            total = 0.0
            count = tokens.numel()
            for r in range(tokens.shape[0]):
                loss = row_loss_sum(p, a, tokens[r], labels[r],
                                    recipe["z_loss"], fp8) / count
                g = torch.autograd.grad(loss, [p[n] for n in names])
                for n, gi in zip(names, g):
                    grads[n] += gi
                total += float(loss.detach())
                del loss, g
            losses.append(total)
            with torch.no_grad():
                for t in p.values():
                    t.requires_grad_(False)
                gnorm = torch.stack([g.square().sum()
                                     for g in grads.values()]).sum().sqrt()
                scale = min(1.0, opt["grad_clip"] / (float(gnorm) + 1e-9))
                k = step + 1
                b1c, b2c = 1 - opt["b1"] ** k, 1 - opt["b2"] ** k
                lr = lr_at(step, opt)
                if i == 0:
                    grad_norm = {n: float(grads[n].norm()) * scale
                                 for n in names}
                for n in names:
                    g = grads[n] * scale
                    m[n].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                    v[n].mul_(opt["b2"]).add_(g.square(),
                                              alpha=1 - opt["b2"])
                    delta = (m[n] / b1c) / ((v[n] / b2c).sqrt() + opt["eps"])
                    if opt["weight_decay"] and decays(n):
                        delta = delta + opt["weight_decay"] * p[n]
                    p[n].sub_(lr * delta)
            del grads
        state["step"] += len(batches)
        change = {n: float((p[n] - p0[n]).norm()) for n in names}
    return {"loss": losses, "grad_norm": grad_norm, "change_norm": change}
