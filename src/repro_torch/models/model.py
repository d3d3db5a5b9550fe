"""Full language-model assembly: blocks -> layers -> prefill / decode.

The counterpart of ``repro.models.model`` for the serving path, every
block kind (``attn``, ``moe``, ``mamba2``, ``mlstm``, ``slstm``,
``shared_attn``) and both frontend stubs.  Parameters keep the JAX
package's tree (``embed``, ``final_norm``, ``frontend``, ``shared``,
``stack``, ``tail``) except that the period stack is a list of
``n_periods`` period dicts instead of leaves with a leading period axis:
the port runs the layers in a Python loop, and ``interop.load_jax_params``
maps the stacked axis onto the list.  Caches follow the same layout, so
every cache leaf has its batch axis first.  zamba2's shared attention
block lives once, in ``shared``, outside the stack: every
``shared_attn`` site reads that one set of tensors (its KV cache is the
site's own).

Two JAX habits change on the card:

* ``cast_for_compute`` ran inside every JAX call, fused by XLA.  Eagerly it
  would rewrite every weight per call, so :meth:`LM.compute_params` makes
  the compute copy once (plus the tied logits head as a row-major
  ``(D, Vp)`` matrix); ``prefill`` and ``decode_step`` accept either tree
  and cast a tree already in the compute dtype at no cost.
* ``decode_step`` updates the caches in place (see ``attention.py``,
  ``ssm.py`` and ``xlstm.py``).

Under a mesh (``runtime.sharding.use_mesh``) every rank holds the shards
its specs give it (:meth:`LM.specs`, :meth:`LM.shard`): the attention,
MLP, MoE and vocabulary layers issue their collectives themselves
(``models/attention.py``, ``layers.py``, ``moe.py``), the MoE block takes
the expert-parallel branch where the JAX package does, and a block's
FSDP-sharded weights are all-gathered over the data axes as the block
starts (inside its remat unit, so the backward gathers them again and
reduce-scatters their gradients).  The recurrent blocks shard as their
specs say (``models/ssm.py``, ``xlstm.py``).
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.gemm import autograd as gemm_autograd
from repro_torch.interop import require_device
from repro_torch.models import attention as attn
from repro_torch.models import frontends, layers, moe, ssm, xlstm
from repro_torch.models.common import (HOST_MESH, MeshInfo, ParamTree,
                                       cast_for_compute, tree_map)
from repro_torch.runtime import sharding as sh

#: the block kinds ``LM`` builds
KINDS = ("attn", "moe", "mamba2", "mlstm", "slstm", "shared_attn")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}; the models build "
                         f"{KINDS}")


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
    p = {"norm1": layers.init_norm(cfg, mesh, dtype, device)}
    if kind == "mamba2":
        p["mamba"] = ssm.init_mamba2(gen, cfg, mesh, dtype, device)
        return p
    if kind == "mlstm":
        p["mlstm"] = xlstm.init_mlstm(gen, cfg, mesh, dtype, device)
        return p
    if kind == "slstm":
        p["slstm"] = xlstm.init_slstm(gen, cfg, mesh, dtype, device)
        return p
    p["attn"] = attn.init_attention(gen, cfg, mesh, dtype, device)
    if kind == "moe":
        p["norm2"] = layers.init_norm(cfg, mesh, dtype, device)
        p["moe"] = moe.init_moe(gen, cfg, mesh, dtype, device)
    elif cfg.d_ff:
        p["norm2"] = layers.init_norm(cfg, mesh, dtype, device)
        p["mlp"] = layers.init_mlp(gen, cfg, mesh, dtype, device)
    return p


def _block_specs(kind: str, cfg, mesh):
    """The specs of :func:`_init_block`'s leaves."""
    _check_kind(kind)
    p = {"norm1": layers.norm_specs(cfg, mesh)}
    if kind == "mamba2":
        p["mamba"] = ssm.mamba2_specs(cfg, mesh)
        return p
    if kind == "mlstm":
        p["mlstm"] = xlstm.mlstm_specs(cfg, mesh)
        return p
    if kind == "slstm":
        p["slstm"] = xlstm.slstm_specs(cfg, mesh)
        return p
    p["attn"] = attn.attention_specs(cfg, mesh)
    if kind == "moe":
        p["norm2"] = layers.norm_specs(cfg, mesh)
        p["moe"] = moe.moe_specs(cfg, mesh)
    elif cfg.d_ff:
        p["norm2"] = layers.norm_specs(cfg, mesh)
        p["mlp"] = layers.mlp_specs(cfg, mesh)
    return p


def _ffn(params, kind: str, x, cfg, mesh, *, ep: bool = False):
    """The block's second half: returns (x, aux).  ``ep``: the MoE block
    may take the expert-parallel branch (the full-sequence forward)."""
    if kind == "moe":
        h2 = layers.apply_norm(params["norm2"], x, cfg)
        if ep and moe.ep_applicable(cfg, mesh, h2.shape[1]):
            y, aux = moe.apply_moe_ep(params["moe"], h2, cfg, mesh)
        else:
            y, aux = moe.apply_moe(params["moe"], h2, cfg, mesh)
        return x + y, aux
    if cfg.d_ff:
        h2 = layers.apply_norm(params["norm2"], x, cfg)
        return x + layers.apply_mlp(params["mlp"], h2, cfg, mesh), 0.0
    return x, 0.0


def _apply_block(params, kind: str, x, cfg, mesh, *, prefix_len: int = 0):
    """Prefill forward; returns (x, aux_loss, cache_out)."""
    _check_kind(kind)
    h = layers.apply_norm(params["norm1"], x, cfg)
    if kind == "mamba2":
        y, h_last, conv_tail = ssm.apply_mamba2(params["mamba"], h, cfg,
                                                mesh)
        return x + y, 0.0, {"h": h_last, "conv": conv_tail}
    if kind == "mlstm":
        y, h_last, conv_tail = xlstm.apply_mlstm(params["mlstm"], h, cfg,
                                                 mesh)
        return x + y, 0.0, {"h": h_last, "conv": conv_tail}
    if kind == "slstm":
        y, (hs, cs, ns) = xlstm.apply_slstm(params["slstm"], h, cfg, mesh)
        return x + y, 0.0, {"h": hs, "c": cs, "n": ns}
    b, s, _ = h.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = attn.project_local(params["attn"], h, cfg, mesh, positions)
    out = attn.blockwise_attention(
        q, attn.kv_for_local_heads(k, cfg, mesh),
        attn.kv_for_local_heads(v, cfg, mesh),
        chunk=cfg.attn_chunk, causal=True, prefix_len=prefix_len)
    x = x + attn.output_projection(out, params["attn"], cfg, mesh)
    x, aux = _ffn(params, kind, x, cfg, mesh, ep=True)
    return x, aux, {"k": k, "v": v}


def _decode_block(params, kind: str, cache, x, cfg, mesh, *, pos,
                  seq_shard: bool = False):
    _check_kind(kind)
    h = layers.apply_norm(params["norm1"], x, cfg)
    if kind == "mamba2":
        y, cache = ssm.decode_mamba2(params["mamba"], cache, h, cfg, mesh)
        return x + y, cache
    if kind == "mlstm":
        y, cache = xlstm.decode_mlstm(params["mlstm"], cache, h, cfg, mesh)
        return x + y, cache
    if kind == "slstm":
        y, cache = xlstm.decode_slstm(params["slstm"], cache, h, cfg, mesh)
        return x + y, cache
    out, cache = attn.decode_attention(params["attn"], cache, h, cfg, mesh,
                                       pos=pos, seq_shard=seq_shard)
    x, _ = _ffn(params, kind, x + out, cfg, mesh)
    return x, cache


def _block_cache_specs(kind: str, cfg, mesh, seq_shard: bool,
                       batch_shard: bool):
    if kind == "mamba2":
        return ssm.mamba2_cache_specs(cfg, mesh, batch_shard)
    if kind == "mlstm":
        return xlstm.mlstm_cache_specs(cfg, mesh, batch_shard)
    if kind == "slstm":
        return xlstm.slstm_cache_specs(cfg, mesh, batch_shard)
    return attn.kv_cache_specs(cfg, mesh, seq_shard, batch_shard)


def _init_block_cache(kind: str, cfg, mesh, batch: int, max_len: int, dtype,
                      device):
    if kind == "mamba2":
        return ssm.init_mamba2_cache(cfg, mesh, batch, dtype, device)
    if kind == "mlstm":
        return xlstm.init_mlstm_cache(cfg, mesh, batch, dtype, device)
    if kind == "slstm":
        return xlstm.init_slstm_cache(cfg, mesh, batch, dtype, device)
    return attn.init_kv_cache(cfg, mesh, batch, max_len, dtype, device)


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
        if cfg.frontend not in ("none", "audio_stub", "vision_stub"):
            raise ValueError(f"unknown frontend {cfg.frontend!r}")
        for kind in cfg.block_pattern:
            _check_kind(kind)
        self.cfg = cfg
        self.mesh = mesh
        self.device = require_device(device)
        self.params: ParamTree | None = None
        self._specs: dict | None = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def _tied(self, kind: str) -> bool:
        return kind == "shared_attn" and self.cfg.shared_block

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator, *, shard: bool = False
             ) -> dict:
        """Draw the parameters from ``generator``.  With ``shard`` (under
        an ambient mesh) each part (the embedding, the frontend, each
        block) is cut to this rank's shards as soon as it is drawn, so a
        rank holds its shards and at most one full block at a time; the
        shards equal those :meth:`shard` cuts from the full init."""
        cfg, mesh, dev = self.cfg, self.mesh, self.device
        dtype = getattr(torch, cfg.param_dtype)
        period, k, tail = factor_pattern(cfg.block_pattern)
        specs = self.specs()

        def cut(tree, spec):
            return sh.shard_tree(tree, spec) if shard else tree

        def block(kind, spec):
            return cut(_init_block(generator, kind, cfg, mesh, dtype, dev),
                       spec)

        p: dict[str, Any] = {
            "embed": cut(layers.init_embedding(generator, cfg, mesh, dtype,
                                               dev), specs["embed"]),
            "final_norm": cut(layers.init_norm(cfg, mesh, dtype, dev),
                              specs["final_norm"]),
            "frontend": cut(frontends.init_frontend(generator, cfg, mesh,
                                                    dtype, dev),
                            specs["frontend"]),
        }
        if cfg.shared_block:
            # one set of tied weights for every shared_attn site
            p["shared"] = block("attn", specs["shared"])
        p["stack"] = [{f"b{j}_{kind}": block(kind, specs["stack"][i][
                           f"b{j}_{kind}"])
                       for j, kind in enumerate(period)
                       if not self._tied(kind)}
                      for i in range(k)]
        p["tail"] = {f"t{j}_{kind}": block(kind,
                                           specs["tail"][f"t{j}_{kind}"])
                     for j, kind in enumerate(tail)}
        self.params = ParamTree(p)
        return self.values()

    def specs(self) -> dict:
        """The spec of every parameter, a tree of :meth:`values`'
        structure (the JAX package's ``Param`` specs, with the period stack
        a list: ``train_lib.stack_spec_periods`` gives the JAX layout).
        Built once; do not modify it."""
        if self._specs is None:
            self._specs = self._build_specs()
        return self._specs

    def _build_specs(self) -> dict:
        cfg, mesh = self.cfg, self.mesh
        period, k, tail = factor_pattern(cfg.block_pattern)
        p: dict[str, Any] = {
            "embed": layers.embedding_specs(cfg, mesh),
            "final_norm": layers.norm_specs(cfg, mesh),
            "frontend": frontends.frontend_specs(cfg, mesh),
        }
        if cfg.shared_block:
            p["shared"] = _block_specs("attn", cfg, mesh)
        p["stack"] = [{f"b{j}_{kind}": _block_specs(kind, cfg, mesh)
                       for j, kind in enumerate(period)
                       if not self._tied(kind)}
                      for _ in range(k)]
        p["tail"] = {f"t{j}_{kind}": _block_specs(kind, cfg, mesh)
                     for j, kind in enumerate(tail)}
        return p

    def shard(self) -> dict:
        """Replace the (full) parameters by this rank's shards under the
        ambient mesh, as :meth:`specs` cuts them; returns the new values."""
        self.params = ParamTree(sh.shard_tree(self.values(), self.specs()),
                                requires_grad=any(
                                    p.requires_grad
                                    for p in self.params.parameters()))
        return self.values()

    def _check_mesh(self) -> None:
        """Under an ambient mesh, its axes must be the ones ``self.mesh``
        describes."""
        if sh.ambient_mesh() is None:
            return
        got = (sh.axis_size(self.mesh.data_axes),
               sh.axis_size(self.mesh.model_axis))
        if got != (self.mesh.data, self.mesh.model):
            raise ValueError(f"the ambient mesh has (data, model) = {got}; "
                             f"the model was built for {self.mesh}")

    def _gathered(self, params, path):
        """The parameters at ``path`` with their FSDP shards all-gathered
        over the data axes (differentiable; a no-op without a mesh or
        FSDP)."""
        tree, specs = _get(params, path), _get(self.specs(), path)
        if "head" in tree:      # the compute copy's view: not FSDP-sharded
            specs = {**specs, "head": (None, None)}
        return sh.gather_fsdp(tree, specs, self.mesh.data_axes)

    def train_mode(self, on: bool = True) -> "LM":
        """Make the parameters trainable (``requires_grad``), or frozen
        again with ``on=False``; serving keeps them frozen."""
        for p in self.params.parameters():
            p.requires_grad_(on)
        return self

    def values(self) -> dict:
        if self.params is None:
            raise RuntimeError("LM has no parameters: call init() or "
                               "interop.load_jax_params() first")
        return self.params.tree()

    def compute_params(self, params=None) -> dict:
        """The compute copy of ``params`` (default: this model's): matrices
        in the compute dtype, vectors kept, plus the ``(D, Vp)`` logits
        matrix under ``embed.head`` (tied: a view of the table,
        ``layers.head_matrix``).  Make it once and pass
        it to every call; a tree that is already a compute copy comes back
        unchanged, without copies."""
        params = self.values() if params is None else params
        out = cast_for_compute(params, self.compute_dtype)
        if "head" not in out["embed"] and not self._fsdp_embed():
            out["embed"] = dict(out["embed"],
                                head=layers.head_matrix(out["embed"],
                                                        self.cfg))
        return out

    def _fsdp_embed(self) -> bool:
        """Whether the embedding is FSDP-sharded under the ambient mesh:
        the logits matrix then comes from the gathered table, per call."""
        return any(sh.communicates(ax) and set(sh.axis_names(ax))
                   <= set(self.mesh.data_axes)
                   for spec in layers.embedding_specs(self.cfg,
                                                      self.mesh).values()
                   for ax in spec)

    # -- shared helpers -------------------------------------------------------
    def _layout(self):
        """(kind, parameter path, cache path) of every layer, in order.  A
        tied ``shared_attn`` site reads the ``shared`` block; its cache is
        the site's own."""
        period, k, tail = factor_pattern(self.cfg.block_pattern)
        for i in range(k):
            for j, kind in enumerate(period):
                path = ("stack", i, f"b{j}_{kind}")
                yield kind, (("shared",) if self._tied(kind) else path), path
        for j, kind in enumerate(tail):
            path = ("tail", f"t{j}_{kind}")
            yield kind, path, path

    def _embed_inputs(self, params, batch, embed) -> tuple[torch.Tensor, int]:
        """Returns (x (B, S, D) in the compute dtype, prefix_len): vision
        patches form a bidirectional prefix before the tokens, audio frames
        replace them.  ``embed``: the (gathered) embedding parameters."""
        cfg = self.cfg
        parts = []
        prefix_len = 0
        if cfg.frontend == "vision_stub":
            patches = frontends.apply_frontend(params["frontend"],
                                               batch["patches"], cfg)
            parts.append(patches)
            prefix_len = patches.shape[1]
        if cfg.frontend == "audio_stub":
            parts.append(frontends.apply_frontend(params["frontend"],
                                                  batch["frames"], cfg))
        if "tokens" in batch:
            parts.append(layers.embed_tokens(embed, batch["tokens"], cfg,
                                             self.mesh))
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        return x.to(self.compute_dtype), prefix_len

    # -- training ---------------------------------------------------------------
    def _run_stack(self, params, x, *, prefix_len: int, remat):
        """Forward through every layer for a loss: returns (x, aux).  Each
        period of the stack is one remat unit, as in the JAX package:
        ``"block"`` (or True) recomputes all of it in the backward pass,
        ``"dots"`` keeps the GEMM and grouped-GEMM outputs and recomputes
        the rest, ``"none"`` (or False / None) keeps everything; the tail
        layers keep everything."""
        cfg, mesh = self.cfg, self.mesh
        if remat not in (None, False, True, "none", "block", "dots"):
            raise ValueError(f"remat {remat!r}: one of 'block', 'dots', "
                             f"'none'")
        units: dict = {}        # (part, period) -> the unit's layers
        for kind, ppath, cpath in self._layout():
            units.setdefault(cpath[:2] if cpath[0] == "stack" else cpath,
                             []).append((kind, ppath, cpath))

        # a remat unit's recompute runs in the backward pass, on autograd's
        # thread or after the caller's use_mesh block has closed: it
        # installs the forward's mesh again to issue the same collectives
        ambient = sh.ambient_mesh()

        def body(x, layers_):
            aux = 0.0
            with sh.use_mesh(ambient):
                for kind, ppath, _ in layers_:
                    x, a, _ = _apply_block(self._gathered(params, ppath),
                                           kind, x, cfg, mesh,
                                           prefix_len=prefix_len)
                    aux = aux + a
            return x, aux

        aux_total = 0.0
        for key, unit in units.items():
            if key[0] == "tail" or remat in (None, False, "none"):
                x, aux = body(x, unit)
            elif remat in ("block", True):
                x, aux = checkpoint(body, x, unit, use_reentrant=False,
                                    preserve_rng_state=False)
            elif remat == "dots":
                x, aux = checkpoint(body, x, unit, use_reentrant=False,
                                    preserve_rng_state=False,
                                    context_fn=gemm_autograd.dots_context)
            aux_total = aux_total + aux
        return x, aux_total

    def loss_fn(self, params, batch, *, remat="block"):
        """Mean next-token CE (+ z-loss) plus the MoE auxiliary loss.
        Returns (loss, {"ce_loss", "aux_loss"}), differentiable in
        ``params`` (the master tree: the compute copy, the tied head
        included, is made inside, under autograd).  ``batch`` holds
        ``labels`` (B, S) and the inputs ``prefill`` takes, optionally a
        ``loss_mask``."""
        cfg, mesh = self.cfg, self.mesh
        self._check_mesh()
        params = self.compute_params(params)
        embed = self._gathered(params, ("embed",))
        x, prefix_len = self._embed_inputs(params, batch, embed)
        x, aux = self._run_stack(params, x, prefix_len=prefix_len,
                                 remat=remat)
        x = layers.apply_norm(params["final_norm"], x, cfg)
        if prefix_len:
            x = x[:, prefix_len:]
        logits = layers.logits_head(embed, x, cfg, mesh)
        loss = layers.cross_entropy(logits, batch["labels"], cfg.vocab_size,
                                    mask=batch.get("loss_mask"),
                                    vocab_ax=layers.vocab_axis(cfg, mesh),
                                    data_ax=mesh.dp())
        return loss + aux, {"ce_loss": loss, "aux_loss": aux}

    # -- serving: prefill -------------------------------------------------------
    def prefill(self, params, batch):
        """Full-sequence forward; returns (last_logits, caches).  ``batch``
        holds ``tokens`` (B, S), and for the frontends ``patches``
        (B, P, D) before them or ``frames`` (B, S, D) instead of them."""
        cfg, mesh = self.cfg, self.mesh
        self._check_mesh()
        params = self.compute_params(params)
        embed = self._gathered(params, ("embed",))
        x, prefix_len = self._embed_inputs(params, batch, embed)
        caches = self._empty_tree()
        for kind, ppath, cpath in self._layout():
            x, _, cache = _apply_block(self._gathered(params, ppath), kind,
                                       x, cfg, mesh, prefix_len=prefix_len)
            _put(caches, cpath, cache)
        x = layers.apply_norm(params["final_norm"], x, cfg)
        logits = layers.logits_head(embed, x[:, -1:], cfg, mesh)
        return layers.gather_logits(logits, cfg, mesh)[:, 0], caches

    # -- serving: decode ---------------------------------------------------------
    def _empty_tree(self) -> dict:
        period, k, _ = factor_pattern(self.cfg.block_pattern)
        return {"stack": [{} for _ in range(k)], "tail": {}}

    def init_cache(self, batch: int, max_len: int, *,
                   seq_shard: bool = False, batch_shard: bool = True) -> dict:
        """Decode state of ``batch`` slots: a KV cache of ``max_len``
        positions per attention layer (each ``shared_attn`` site its own),
        the f32 recurrent state and conv tail per recurrent layer.  Under
        an ambient mesh, this rank's shards of it (:meth:`cache_specs`
        with the same flags: ``batch`` is the global batch), allocated at
        their local shapes; with ``seq_shard`` the KV caches' sequence
        axis is split over the data axes (decode them with
        ``decode_step(..., seq_shard=True)``)."""
        caches = self._empty_tree()
        for kind, _, path in self._layout():
            _put(caches, path, _init_block_cache(
                kind, self.cfg, self.mesh, batch, max_len,
                self.compute_dtype, torch.device("meta")))
        # every cache starts at zero: the meta tree's shards give the shapes
        return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                              device=self.device),
                        sh.shard_tree(caches, self.cache_specs(
                            seq_shard=seq_shard, batch_shard=batch_shard)))

    def cache_specs(self, *, seq_shard: bool = False,
                    batch_shard: bool = True) -> dict:
        """The spec of every cache leaf, a tree of :meth:`init_cache`'s
        structure."""
        specs = self._empty_tree()
        for kind, _, path in self._layout():
            _put(specs, path, _block_cache_specs(kind, self.cfg, self.mesh,
                                                 seq_shard, batch_shard))
        return specs

    def decode_step(self, params, caches, token, pos, *,
                    seq_shard: bool = False):
        """token: (B, 1) int, or (B, 1, D) frame embeddings for the audio
        frontend; pos: a scalar or a (B,) per-slot vector.  Returns
        (logits (B, Vp), caches), the caches updated in place.
        ``seq_shard``: the caches come from ``init_cache(...,
        seq_shard=True)`` (``attention.decode_attention``)."""
        cfg, mesh = self.cfg, self.mesh
        self._check_mesh()
        params = self.compute_params(params)
        embed = self._gathered(params, ("embed",))
        if token.ndim == 3:  # audio frames pass through the frontend
            x = frontends.apply_frontend(params["frontend"], token, cfg)
        else:
            x = layers.embed_tokens(embed, token, cfg, mesh)
        x = x.to(self.compute_dtype)
        for kind, ppath, cpath in self._layout():
            x, _ = _decode_block(self._gathered(params, ppath), kind,
                                 _get(caches, cpath), x, cfg, mesh, pos=pos,
                                 seq_shard=seq_shard)
        x = layers.apply_norm(params["final_norm"], x, cfg)
        logits = layers.logits_head(embed, x, cfg, mesh)
        return layers.gather_logits(logits, cfg, mesh)[:, 0], caches


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _put(tree, path, value) -> None:
    _get(tree, path[:-1])[path[-1]] = value
