"""The plain reference of a DeepSeek-V3-style decoder's training step, as
one device holds it (Moonlight-16B-A3B's architecture).

Plain PyTorch in float32 (TF32 off: ``exact_f32``), importing nothing of
the program, written from the published description (the DeepSeek-V3
report, arXiv:2412.19437, and the model's ``config.json``):

* latent attention (MLA) without a query low rank: ``q = x Wq`` per head
  ``[q_nope, q_rope]``; ``[c, k_rope] = x Wkv_a``; ``[k_nope, v] =
  RMSNorm(c) Wkv_b`` per head; RoPE on ``q_rope`` and on the one
  ``k_rope`` every head shares; causal softmax attention over ``[nope,
  rope]`` dims, scaled by that width to the -1/2, of values of their own
  width; ``o = out Wo``;
* the first ``first_k_dense_replace`` layers with a SwiGLU MLP, the others
  with an MoE layer: sigmoid scores over every routed expert, the top
  ``num_experts_per_tok`` of scores plus the correction bias chosen, their
  unbiased scores normalised and scaled by ``routed_scaling_factor``, no
  token dropped, the held experts' SwiGLUs, and ``n_shared_experts``
  shared experts (one SwiGLU of their widths side by side) on every token;
* RMSNorm before attention and before the MLP or MoE layer, a final
  RMSNorm and an untied head;
* the loss: next-token cross-entropy over the vocabulary (rows of the
  table past it masked) plus the z-loss, plus the sequence-wise balance
  loss (the report's eqs. 17-20) of every MoE layer;
* AdamW as ``dense_lm`` has it (its schedule and decay rule; the bias is
  not trained), then the bias update ``b_i += gamma * sign(mean load -
  load_i)`` on the step's loads.

Departures, each deliberate:

* **RoPE pairing.**  The rope dims rotate in adjacent pairs ``(2i,
  2i+1)`` at frequency ``i`` (``theta ** (-2i / rope_dims)``), in place.
  DeepSeek-V3's published modelling code de-interleaves them first and
  rotates halves; q and k are permuted alike, so the scores are the same.
* **The held share.**  The router scores every routed expert
  (``deployment.n_routed_experts``), but only the experts in
  ``deployment.experts_held`` exist: they compute their part of the result
  for the pairs routed to them, and what the others would add is left out
  (one card's share of an expert-parallel layer; the vocabulary is that
  card's slice, a smaller vocabulary).  The balance loss and the loads are
  over every routed expert, as every card computes them alike.
* **alpha, gamma and the bias's first draw** are not in the published
  config: ``assumed`` gives the report's alpha = 1e-4 and gamma = 1e-3,
  and the bias drawn at N(0, ``bias_init_std``) from the seed.
* The balance loss's ``f_i`` counts the experts chosen (on scores plus
  the bias), as DeepSeek-V3's published modelling code counts them.
* The weights are drawn from the seed, every matrix N(0,
  ``initializer_range``), the norms' scales ones.

A step runs row by row (each row's share of the mean loss backpropagated
alone, the gradients summed in the leaves) and checkpoints each layer, so
that one layer's attention scores are alive at a time: the mathematics is
unchanged.

``fp8=True`` is the control: every product with a weight but the router's
(the projections, the MLP, the experts, the head) forward and backward
takes its operands rounded to float8 e4m3 at one scale a tensor; the
router's logits stay float32, as the program computes them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.dense_lm import (_mm, _norm, copy_state, decays,
                                          lr_at, padded_vocab)
from perfbench.reference.gemm import exact_f32

BIAS = "router_bias"


def arch_of(config: dict) -> dict:
    """The sizes the reference reads from a configuration file."""
    dep, assumed = config["deployment"], config["assumed"]
    return {"d": config["hidden_size"], "f": config["intermediate_size"],
            "h": config["num_attention_heads"],
            "layers": config["num_hidden_layers"],
            "dense": config["first_k_dense_replace"],
            "vocab": config["vocab_size"],
            "vp": padded_vocab(config["vocab_size"]),
            "eps": config["rms_norm_eps"], "theta": config["rope_theta"],
            "r": config["kv_lora_rank"], "nope": config["qk_nope_head_dim"],
            "rope": config["qk_rope_head_dim"], "dv": config["v_head_dim"],
            "fe": config["moe_intermediate_size"],
            "e": dep["n_routed_experts"], "held": list(dep["experts_held"]),
            "k": config["num_experts_per_tok"],
            "shared": config["n_shared_experts"],
            "scale": config["routed_scaling_factor"],
            "alpha": assumed["alpha"]["value"],
            "gamma": assumed["gamma"]["value"],
            "bias_std": assumed["bias_init_std"]["value"],
            "init_std": assumed["initializer_range"]["value"]}


def leaf_specs(a: dict) -> list[tuple[str, tuple, str]]:
    """``(name, shape, init)`` of every leaf, in a fixed order; ``init``
    is ``normal`` (std ``initializer_range``), ``bias`` (std
    ``bias_init_std``) or ``ones``."""
    d, h, r, rope = a["d"], a["h"], a["r"], a["rope"]
    nope, dv, fe, hn = a["nope"], a["dv"], a["fe"], len(a["held"])
    fs = a["shared"] * fe
    out = [("embed", (a["vp"], d), "normal"),
           ("unembed", (d, a["vp"]), "normal")]
    for i in range(a["layers"]):
        p = f"layers.{i}."
        out += [(p + "norm1", (d,), "ones"),
                (p + "wq", (d, h * (nope + rope)), "normal"),
                (p + "wkv_a", (d, r + rope), "normal"),
                (p + "kv_norm", (r,), "ones"),
                (p + "wkv_b", (r, h * (nope + dv)), "normal"),
                (p + "wo", (h * dv, d), "normal"),
                (p + "norm2", (d,), "ones")]
        if i < a["dense"]:
            out += [(p + "w_gate", (d, a["f"]), "normal"),
                    (p + "w_up", (d, a["f"]), "normal"),
                    (p + "w_down", (a["f"], d), "normal")]
        else:
            out += [(p + "router", (d, a["e"]), "normal"),
                    (p + BIAS, (a["e"],), "bias"),
                    (p + "experts.w_gate", (hn, d, fe), "normal"),
                    (p + "experts.w_up", (hn, d, fe), "normal"),
                    (p + "experts.w_down", (hn, fe, d), "normal"),
                    (p + "shared.w_gate", (d, fs), "normal"),
                    (p + "shared.w_up", (d, fs), "normal"),
                    (p + "shared.w_down", (fs, d), "normal")]
    out.append(("final_norm", (a["d"],), "ones"))
    return out


def is_bias(name: str) -> bool:
    return name.endswith(BIAS)


def make_params(a: dict, seed: int, device) -> tuple[torch.Tensor, dict]:
    """``(flat, {name: view})``: every leaf in float32, each a view of one
    buffer that holds the drawn ones first, drawn in one call from a
    generator on ``device`` seeded with ``seed`` and scaled leaf by leaf."""
    specs = sorted(leaf_specs(a), key=lambda s: s[2] == "ones")
    sizes = [math.prod(s) for _, s, _ in specs]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    views, off, drawn = {}, 0, 0
    for (name, shape, init), n in zip(specs, sizes):
        views[name] = flat[off:off + n].view(shape)
        if init != "ones":
            drawn = off + n
        off += n
    flat[:drawn].normal_(0.0, 1.0,
                         generator=torch.Generator(device).manual_seed(seed))
    std = {"normal": a["init_std"], "bias": a["bias_std"]}
    for name, _, init in specs:
        if init == "ones":
            views[name].fill_(1.0)
        else:
            views[name].mul_(std[init])
    return flat, {name: views[name] for name, _, _ in leaf_specs(a)}


# ---------------------------------------------------------------------------
# The forward pass
# ---------------------------------------------------------------------------


def _rope_pairs(x, theta: float):
    """x: (S, heads, rope), positions 0..S-1, adjacent pairs rotated."""
    s, _, n = x.shape
    half = n // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).flatten(-2)


def _mla(x, p, pre: str, a: dict, fp8: bool):
    s = x.shape[0]
    h, r, nope, rope, dv = a["h"], a["r"], a["nope"], a["rope"], a["dv"]
    q = _mm(x, p[pre + "wq"], fp8).view(s, h, nope + rope)
    q = torch.cat([q[..., :nope], _rope_pairs(q[..., nope:], a["theta"])],
                  dim=-1)
    kv_a = _mm(x, p[pre + "wkv_a"], fp8)
    latent = _norm(kv_a[:, :r], p[pre + "kv_norm"], a["eps"])
    k_rope = _rope_pairs(kv_a[:, None, r:], a["theta"])
    kv = _mm(latent, p[pre + "wkv_b"], fp8).view(s, h, nope + dv)
    k = torch.cat([kv[..., :nope], k_rope.expand(s, h, rope)], dim=-1)
    scores = torch.einsum("qhd,khd->hqk", q * (nope + rope) ** -0.5, k)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("hqk,khd->qhd", scores.softmax(-1), kv[..., nope:])
    return _mm(out.reshape(s, h * dv), p[pre + "wo"], fp8)


def _swiglu(x, gate, up, down, fp8: bool):
    return _mm(F.silu(_mm(x, gate, fp8)) * _mm(x, up, fp8), down, fp8)


def _moe(x, p, pre: str, a: dict, fp8: bool):
    """(the routed experts' part plus the shared experts', the balance
    loss of this sequence, the (E,) load)."""
    s = x.shape[0]
    e, k = a["e"], a["k"]
    scores = torch.sigmoid(x @ p[pre + "router"])
    chosen = torch.topk(scores + p[pre + BIAS], k, dim=-1).indices
    w = scores.gather(1, chosen)
    w = w / w.sum(-1, keepdim=True) * a["scale"]
    y = torch.zeros_like(x)
    for j, ex in enumerate(a["held"]):
        hit = chosen == ex
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel():
            got = _swiglu(x[rows], p[pre + "experts.w_gate"][j],
                          p[pre + "experts.w_up"][j],
                          p[pre + "experts.w_down"][j], fp8)
            y = y.index_add(0, rows, (w * hit).sum(-1)[rows, None] * got)
    y = y + _swiglu(x, p[pre + "shared.w_gate"], p[pre + "shared.w_up"],
                    p[pre + "shared.w_down"], fp8)
    load = F.one_hot(chosen, e).sum((0, 1)).float()
    share = (scores / scores.sum(-1, keepdim=True)).mean(0)
    aux = a["alpha"] * (load * (e / (k * s)) * share).sum()
    return y, aux, load


def _layer(i: int, a: dict, p: dict, fp8: bool):
    """Layer ``i`` as a function of its input: (x, aux, load)."""
    pre = f"layers.{i}."

    def run(x):
        x = x + _mla(_norm(x, p[pre + "norm1"], a["eps"]), p, pre, a, fp8)
        h = _norm(x, p[pre + "norm2"], a["eps"])
        if i < a["dense"]:
            return (x + _swiglu(h, p[pre + "w_gate"], p[pre + "w_up"],
                                p[pre + "w_down"], fp8),
                    x.new_zeros(()), x.new_zeros(a["e"]))
        y, aux, load = _moe(h, p, pre, a, fp8)
        return x + y, aux, load
    return run


def row_logits(p: dict, a: dict, tokens, fp8: bool = False,
               remat: bool = True):
    """(one row's logits (S, padded vocabulary), the rows of the table past
    the vocabulary masked, the sum over layers of the row's balance loss,
    {layer index: its (E,) load}); with ``remat`` each layer is
    checkpointed."""
    x = p["embed"][tokens]
    aux, loads = 0.0, {}
    for i in range(a["layers"]):
        fn = _layer(i, a, p, fp8)
        x, ax, load = (checkpoint(fn, x, use_reentrant=False) if remat
                       else fn(x))
        aux = aux + ax
        if i >= a["dense"]:
            loads[i] = load.detach()
    x = _norm(x, p["final_norm"], a["eps"])
    logits = _mm(x, p["unembed"], fp8)
    if a["vp"] > a["vocab"]:
        logits = logits.masked_fill(
            torch.arange(a["vp"], device=x.device) >= a["vocab"], -1e9)
    return logits, aux, loads


def row_loss(p: dict, a: dict, tokens, labels, z_loss: float,
             fp8: bool = False, remat: bool = True):
    """(the sum over one row's positions of the next-token cross-entropy
    plus ``z_loss`` times the squared log-normaliser, the sum over layers
    of the row's balance loss, {layer index: its (E,) load})."""
    logits, aux, loads = row_logits(p, a, tokens, fp8, remat)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[:, None])[:, 0]
    return ((lse - gold) + z_loss * lse.square()).sum(), aux, loads


# ---------------------------------------------------------------------------
# The training step
# ---------------------------------------------------------------------------


def initial_state(a: dict, seed: int, device) -> dict:
    """The state a run starts from: the leaves the seed makes, zero
    moments of the trained ones, step 0 (the form :func:`train_steps`
    takes)."""
    _, p = make_params(a, seed, device)
    return {"p": p,
            "m": {n: torch.zeros_like(t) for n, t in p.items()
                  if not is_bias(n)},
            "v": {n: torch.zeros_like(t) for n, t in p.items()
                  if not is_bias(n)}, "step": 0}


def train_steps(a: dict, seed: int, batches: list, recipe: dict, device,
                fp8: bool = False, state: dict | None = None) -> dict:
    """The reference's ``len(batches)`` steps: ``{"loss": [...],
    "grad_norm": {name: norm of the first of these steps' clipped
    gradient}, "change_norm": {name: norm of the leaf's change over the
    steps}, "bias": {name: the bias after the steps, on the host}}``, the
    trained leaves named in the first two.  ``batches``: ``(tokens,
    labels)`` pairs of (B, S) integer tensors.  The steps start from
    ``state`` where it is given (``{"p", "m", "v": {name: float32
    tensor}, "step": steps done}``, a copy of a run's state, updated in
    place), else from the leaves the seed makes, zero moments and step
    0."""
    opt = recipe["optimizer"]
    if state is None:
        state = initial_state(a, seed, device)
    p, m, v = state["p"], state["m"], state["v"]
    names = list(m)
    # the start, kept on the host: the device holds the state and one
    # row's activations
    p0 = {n: p[n].detach().to("cpu", copy=True) for n in names}
    losses, grad_norm = [], None
    with exact_f32():
        for i, (tokens, labels) in enumerate(batches):
            step = state["step"] + i
            for n in names:
                p[n].requires_grad_(True)
                p[n].grad = None
            total, count = 0.0, tokens.numel()
            loads: dict = {}
            for r in range(tokens.shape[0]):
                ce, aux, row_loads = row_loss(p, a, tokens[r], labels[r],
                                              recipe["z_loss"], fp8)
                loss = ce / count + aux / tokens.shape[0]
                loss.backward()
                total += float(loss.detach())
                for j, load in row_loads.items():
                    loads[j] = loads.get(j, 0) + load
                del ce, aux, loss
            losses.append(total)
            with torch.no_grad():
                # a held expert no row reached has no gradient: zero
                grads = {n: p[n].grad if p[n].grad is not None
                         else torch.zeros_like(p[n]) for n in names}
                for n in names:
                    p[n].requires_grad_(False)
                    p[n].grad = None
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
                    g = grads[n].mul_(scale)
                    m[n].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                    v[n].mul_(opt["b2"]).add_(g.square(),
                                              alpha=1 - opt["b2"])
                    delta = (m[n] / b1c) / ((v[n] / b2c).sqrt() + opt["eps"])
                    if opt["weight_decay"] and decays(n):
                        delta = delta + opt["weight_decay"] * p[n]
                    p[n].sub_(lr * delta)
                del grads
                for j, load in loads.items():
                    p[f"layers.{j}.{BIAS}"].add_(
                        torch.sign(load.mean() - load), alpha=a["gamma"])
        state["step"] += len(batches)
        change = {n: float((p[n] - p0[n].to(device)).norm()) for n in names}
    return {"loss": losses, "grad_norm": grad_norm, "change_norm": change,
            "bias": {n: t.detach().to("cpu", copy=True)
                     for n, t in p.items() if is_bias(n)}}


__all__ = ["arch_of", "copy_state", "initial_state", "is_bias",
           "leaf_specs", "make_params", "row_logits", "row_loss",
           "train_steps"]
