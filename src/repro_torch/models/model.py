"""Full language-model assembly: blocks -> layers -> prefill / decode.

The counterpart of ``repro.models.model`` for the serving path of the
block kinds ``attn`` and ``moe``.  Parameters keep the JAX package's tree
(``embed``, ``final_norm``, ``frontend``, ``stack``, ``tail``) except that
the period stack is a list of ``n_periods`` period dicts instead of leaves
with a leading period axis: the port runs the layers in a Python loop, and
``interop.load_jax_params`` maps the stacked axis onto the list.  Caches
follow the same layout, so every cache leaf has its batch axis first.

Two JAX habits change on the card:

* ``cast_for_compute`` ran inside every JAX call, fused by XLA.  Eagerly it
  would rewrite every weight per call, so :meth:`LM.compute_params` makes
  the compute copy once (plus the tied logits head as a row-major
  ``(D, Vp)`` matrix); ``prefill`` and ``decode_step`` accept either tree
  and cast a tree already in the compute dtype at no cost.
* ``decode_step`` updates the caches in place (see ``attention.py``).
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.interop import require_device
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe
from repro_torch.models.common import (HOST_MESH, MeshInfo, ParamTree,
                                       cast_for_compute)

_LATER = {
    "mamba2": "the ssm family (ROADMAP queue 1 item 1)",
    "mlstm": "the xlstm family (ROADMAP queue 1 item 1)",
    "slstm": "the xlstm family (ROADMAP queue 1 item 1)",
    "shared_attn": "the hybrid (zamba2) family (ROADMAP queue 1 item 1)",
}


def _not_ported(what: str, when: str):
    return NotImplementedError(
        f"{what} is not ported yet; it comes with {when}")


def _check_kind(kind: str) -> None:
    if kind in _LATER:
        raise _not_ported(f"block kind {kind!r}", _LATER[kind])
    if kind not in ("attn", "moe"):
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# Pattern factoring
# ---------------------------------------------------------------------------


def factor_pattern(pattern: tuple) -> tuple[tuple, int, tuple]:
    """pattern -> (period, n_periods, tail). Chooses the smallest period that
    covers a maximal prefix of the pattern."""
    n = len(pattern)
    for plen in range(1, n + 1):
        period = pattern[:plen]
        k = n // plen
        if k >= 1 and tuple(period * k) == pattern[:plen * k]:
            tail = pattern[plen * k:]
            # accept only if tail shorter than one period
            if len(tail) < plen:
                return tuple(period), k, tuple(tail)
    return tuple(pattern), 1, ()


# ---------------------------------------------------------------------------
# Single blocks (norm + mixer (+ mlp)), init / apply / decode
# ---------------------------------------------------------------------------


def _init_block(gen, kind: str, cfg, mesh, dtype, device):
    _check_kind(kind)
    p = {"norm1": layers.init_norm(cfg, mesh, dtype, device),
         "attn": attn.init_attention(gen, cfg, mesh, dtype, device)}
    if kind == "moe":
        p["norm2"] = layers.init_norm(cfg, mesh, dtype, device)
        p["moe"] = moe.init_moe(gen, cfg, mesh, dtype, device)
    elif cfg.d_ff:
        p["norm2"] = layers.init_norm(cfg, mesh, dtype, device)
        p["mlp"] = layers.init_mlp(gen, cfg, mesh, dtype, device)
    return p


def _ffn(params, kind: str, x, cfg, mesh):
    """The block's second half: returns (x, aux)."""
    if kind == "moe":
        h2 = layers.apply_norm(params["norm2"], x, cfg)
        y, aux = moe.apply_moe(params["moe"], h2, cfg, mesh)
        return x + y, aux
    if cfg.d_ff:
        h2 = layers.apply_norm(params["norm2"], x, cfg)
        return x + layers.apply_mlp(params["mlp"], h2, cfg), 0.0
    return x, 0.0


def _apply_block(params, kind: str, x, cfg, mesh):
    """Prefill forward; returns (x, aux_loss, cache_out)."""
    _check_kind(kind)
    h = layers.apply_norm(params["norm1"], x, cfg)
    b, s, _ = h.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = attn._project_qkv(params["attn"], h, cfg, positions)
    n_rep = q.shape[2] // k.shape[2]
    out = attn.blockwise_attention(
        q, attn._repeat_kv(k, n_rep), attn._repeat_kv(v, n_rep),
        chunk=cfg.attn_chunk, causal=True)
    x = x + torch.einsum("bshe,hed->bsd", out, params["attn"]["wo"])
    x, aux = _ffn(params, kind, x, cfg, mesh)
    return x, aux, {"k": k, "v": v}


def _decode_block(params, kind: str, cache, x, cfg, mesh, *, pos):
    _check_kind(kind)
    h = layers.apply_norm(params["norm1"], x, cfg)
    out, cache = attn.decode_attention(params["attn"], cache, h, cfg, mesh,
                                       pos=pos)
    x, _ = _ffn(params, kind, x + out, cfg, mesh)
    return x, cache


# ---------------------------------------------------------------------------
# The LM
# ---------------------------------------------------------------------------


class LM(nn.Module):
    """The language model of one config on one device.

    ``init(generator)`` draws the parameters (``cfg.param_dtype``) on
    ``device`` and registers them; ``values()`` returns them as the nested
    tree every other method takes.  ``device`` defaults to the card and is
    checked on construction: the CPU runs only when asked for.
    """

    def __init__(self, cfg: ModelConfig, mesh: MeshInfo = HOST_MESH, *,
                 device="cuda"):
        super().__init__()
        if cfg.frontend != "none":
            raise _not_ported(f"the {cfg.frontend} frontend",
                              "the frontends (ROADMAP queue 1 item 1)")
        if cfg.shared_block:
            raise _not_ported("the shared attention block",
                              _LATER["shared_attn"])
        for kind in cfg.block_pattern:
            _check_kind(kind)
        self.cfg = cfg
        self.mesh = mesh
        self.device = require_device(device)
        self.params: ParamTree | None = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator) -> dict:
        cfg, mesh, dev = self.cfg, self.mesh, self.device
        dtype = getattr(torch, cfg.param_dtype)
        period, k, tail = factor_pattern(cfg.block_pattern)
        p: dict[str, Any] = {
            "embed": layers.init_embedding(generator, cfg, mesh, dtype, dev),
            "final_norm": layers.init_norm(cfg, mesh, dtype, dev),
            "frontend": {},
            "stack": [{f"b{j}_{kind}": _init_block(generator, kind, cfg,
                                                   mesh, dtype, dev)
                       for j, kind in enumerate(period)}
                      for _ in range(k)],
            "tail": {f"t{j}_{kind}": _init_block(generator, kind, cfg, mesh,
                                                 dtype, dev)
                     for j, kind in enumerate(tail)},
        }
        self.params = ParamTree(p)
        return self.values()

    def values(self) -> dict:
        if self.params is None:
            raise RuntimeError("LM has no parameters: call init() or "
                               "interop.load_jax_params() first")
        return self.params.tree()

    def compute_params(self, params=None) -> dict:
        """The compute copy of ``params`` (default: this model's): matrices
        in the compute dtype, vectors kept, plus the logits matrix as a
        row-major ``(D, Vp)`` under ``embed.head``.  Make it once and pass
        it to every call; a tree that is already a compute copy comes back
        unchanged, without copies."""
        params = self.values() if params is None else params
        out = cast_for_compute(params, self.compute_dtype)
        if "head" not in out["embed"]:
            out["embed"] = dict(out["embed"],
                                head=layers.head_matrix(out["embed"],
                                                        self.cfg))
        return out

    # -- shared helpers -------------------------------------------------------
    def _layout(self):
        """(kind, key path) of every layer, in order; the path indexes the
        parameter tree and the cache tree alike."""
        period, k, tail = factor_pattern(self.cfg.block_pattern)
        for i in range(k):
            for j, kind in enumerate(period):
                yield kind, ("stack", i, f"b{j}_{kind}")
        for j, kind in enumerate(tail):
            yield kind, ("tail", f"t{j}_{kind}")

    def _embed_inputs(self, params, batch) -> torch.Tensor:
        x = layers.embed_tokens(params["embed"], batch["tokens"], self.cfg)
        return x.to(self.compute_dtype)

    # -- serving: prefill -------------------------------------------------------
    def prefill(self, params, batch):
        """Full-sequence forward; returns (last_logits, caches)."""
        cfg, mesh = self.cfg, self.mesh
        params = self.compute_params(params)
        x = self._embed_inputs(params, batch)
        caches = self._empty_tree()
        for kind, path in self._layout():
            x, _, cache = _apply_block(_get(params, path), kind, x, cfg, mesh)
            _put(caches, path, cache)
        x = layers.apply_norm(params["final_norm"], x, cfg)
        logits = layers.logits_head(params["embed"], x[:, -1:], cfg)
        return logits[:, 0], caches

    # -- serving: decode ---------------------------------------------------------
    def _empty_tree(self) -> dict:
        period, k, _ = factor_pattern(self.cfg.block_pattern)
        return {"stack": [{} for _ in range(k)], "tail": {}}

    def init_cache(self, batch: int, max_len: int) -> dict:
        caches = self._empty_tree()
        for _, path in self._layout():
            _put(caches, path, attn.init_kv_cache(
                self.cfg, self.mesh, batch, max_len, self.compute_dtype,
                self.device))
        return caches

    def decode_step(self, params, caches, token, pos):
        """token: (B, 1) int; pos: a scalar or a (B,) per-slot vector.
        Returns (logits (B, Vp), caches), the caches updated in place."""
        cfg, mesh = self.cfg, self.mesh
        params = self.compute_params(params)
        x = self._embed_inputs(params, {"tokens": token})
        for kind, path in self._layout():
            x, _ = _decode_block(_get(params, path), kind, _get(caches, path),
                                 x, cfg, mesh, pos=pos)
        x = layers.apply_norm(params["final_norm"], x, cfg)
        logits = layers.logits_head(params["embed"], x, cfg)
        return logits[:, 0], caches


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _put(tree, path, value) -> None:
    _get(tree, path[:-1])[path[-1]] = value
