"""Mixture-of-Experts block: top-k router + capacity-based dispatch.

The counterpart of ``repro.models.moe``: GShard/Switch dispatch with a
fixed per-expert capacity, enforced per sequence (overflow tokens fall back
to the residual path), the expert FFNs (SwiGLU) as three grouped GEMMs over
the expert dimension through ``gemm.grouped_matmul`` — the hand-written
grouped CUDA kernel — and a gate-weighted combine.

Under a mesh the experts are padded to a multiple of the model axis
(``padded_experts``; dead experts get -inf router logits, so routing is
the logical model's) and shard over it.  Two paths:

* :func:`apply_moe`: every rank routes every token (the router is
  replicated), runs its own experts on the tokens routed to them, and the
  combine's partial sums meet in one all-reduce;
* :func:`apply_moe_ep` (expert parallelism, taken by ``LM`` wherever
  :func:`ep_applicable`): each rank routes its S/model slice of the
  sequence, ships each expert's inputs to the expert's rank and back with
  two all-to-all exchanges, and the slices are gathered again.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import gemm as gemm_api
from repro_torch.models.common import MeshInfo, dense_init
from repro_torch.runtime import sharding as sh


def padded_experts(cfg, mesh: MeshInfo) -> int:
    """Physical expert count: padded up to a model-axis multiple so the
    expert dim shards and the EP all-to-all path applies (granite's 40 -> 48
    on a 16-way axis).  Dead experts get -inf router logits, so routing is
    exactly the logical model's."""
    e, m = cfg.n_experts, mesh.model
    if m > 1 and e % m:
        return m * ((e + m - 1) // m)
    return e


def moe_specs(cfg, mesh: MeshInfo) -> dict:
    e = padded_experts(cfg, mesh)
    e_ax = mesh.shard_if(e)
    f_ax = mesh.shard_if(cfg.moe_d_ff) if e_ax is None else None  # TP
    fsdp = mesh.fsdp_if(cfg.d_model)
    return {"router": (fsdp, None), "w_gate": (e_ax, fsdp, f_ax),
            "w_up": (e_ax, fsdp, f_ax), "w_down": (e_ax, f_ax, fsdp)}


def pad_e(w, cfg, mesh: MeshInfo, axis: int):
    """Logical-shape weights with the expert dim zero-padded: identical
    logical parameters regardless of mesh (dead experts stay zero: they
    receive no tokens, hence no gradient)."""
    e = padded_experts(cfg, mesh)
    if e == cfg.n_experts:
        return w
    pad = [0, 0] * (w.ndim - 1 - axis) + [0, e - cfg.n_experts]
    return F.pad(w, pad)


def init_moe(gen, cfg, mesh: MeshInfo, dtype, device):
    d, f, e0 = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    return {
        "router": pad_e(dense_init(gen, d, (d, e0), torch.float32, device),
                        cfg, mesh, 1),
        "w_gate": pad_e(dense_init(gen, d, (e0, d, f), dtype, device), cfg,
                        mesh, 0),
        "w_up": pad_e(dense_init(gen, d, (e0, d, f), dtype, device), cfg,
                      mesh, 0),
        "w_down": pad_e(dense_init(gen, f, (e0, f, d), dtype, device), cfg,
                        mesh, 0),
    }


def _masked_router_logits(params, x, cfg):
    """Router logits in f32 over physical experts; padded tail masked to
    -1e9."""
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


def _route(params, x, cfg, cap: int):
    """Top-k routing with per-sequence capacity.  Returns (gate values
    (B, S, k), expert of each (token, choice) (B, S*k), its slot
    (B, S*k), kept? (B, S*k), aux loss)."""
    b, s, _ = x.shape
    e, k = params["router"].shape[-1], cfg.experts_per_token
    logits = _masked_router_logits(params, x, cfg)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1, sorted=True)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balancing auxiliary loss (per sequence, then mean)
    me = probs.mean(1)                                        # (B,E)
    ce = F.one_hot(expert_idx[:, :, 0], e).float().mean(1)    # (B,E)
    aux = cfg.router_aux_coef * e * (me * ce).sum(-1).mean()

    flat_e = expert_idx.reshape(b, s * k)                     # (B, S*k)
    pos_all = F.one_hot(flat_e, e).cumsum(1) - 1
    pos = pos_all.gather(2, flat_e[..., None])[..., 0]        # (B, S*k)
    keep = pos < cap
    safe_pos = torch.where(keep, pos, 0)
    return gate_vals, flat_e, safe_pos, keep, aux


def _dispatch(x, flat_e, safe_pos, keep, e: int, cap: int, k: int):
    """(B, E, cap, D) expert inputs.  A scatter-ADD, as in the JAX package:
    a dropped token lands on its expert's slot 0 with a zeroed source,
    which an assignment would turn into an overwrite of that slot's real
    token."""
    b, s, d = x.shape
    dev = x.device
    tok_idx = torch.arange(s, device=dev).repeat_interleave(k)  # (S*k,)
    src = torch.where(keep[..., None], x[:, tok_idx], 0).to(x.dtype)
    rows = torch.arange(b, device=dev)[:, None].expand(b, s * k)
    buf = torch.zeros((b, e, cap, d), dtype=x.dtype, device=dev)
    return buf.index_put((rows, flat_e, safe_pos), src, accumulate=True)


def _experts(buf, params):
    """SwiGLU over the experts' buffers (..., E, C, D) on the grouped
    kernel; leading dims fold into C."""
    g = gemm_api.grouped_matmul(buf, params["w_gate"])
    u = gemm_api.grouped_matmul(buf, params["w_up"])
    return gemm_api.grouped_matmul(F.silu(g) * u, params["w_down"])


def _combine(out_buf, flat_e, safe_pos, keep, gate_vals, s: int, k: int):
    """Gather each (token, choice)'s expert output and weight it by its
    gate, in the compute dtype.  The JAX package's scatter-add over
    tok_idx: token t owns the k consecutive entries t*k .. t*k+k-1, added
    in order.  Written as k adds of strided views it is deterministic on
    the card, where index_add_ would add with atomics in no fixed order."""
    b, d = out_buf.shape[0], out_buf.shape[-1]
    rows = torch.arange(b, device=out_buf.device)[:, None].expand(b, s * k)
    eo = out_buf[rows, flat_e, safe_pos]                      # (B, S*k, D)
    gvb = gate_vals.reshape(b, s * k).to(out_buf.dtype)
    contrib = torch.where(keep[..., None], eo, 0) * gvb[..., None]
    parts = contrib.reshape(b, s, k, d)
    y = parts[:, :, 0]
    for j in range(1, k):
        y = y + parts[:, :, j]
    return y


def apply_moe(params, x, cfg, mesh: MeshInfo | None = None):
    """x: (B, S, D) -> (y, aux_loss).  Router in f32 for stability.

    ``S`` is the length the caller runs, pad tokens included: the capacity
    is computed from it and pad tokens are routed like any other (they come
    after the real tokens in the cumulative order, so they can only drop
    themselves), exactly as in the JAX package.

    Under a mesh whose model axis shards the experts, this rank runs the
    experts it holds; the tokens' inputs pass ``copy_to`` and their gates
    too (each rank's gradient covers its experts' share), and the combined
    outputs' partial sums meet in one all-reduce.
    """
    s, k = x.shape[1], cfg.experts_per_token
    e_ax = None if mesh is None else mesh.shard_if(
        padded_experts(cfg, mesh))
    cap = _capacity(s, cfg)
    gate_vals, flat_e, safe_pos, keep, aux = _route(params, x, cfg, cap)
    e_loc = params["w_gate"].shape[0]
    if sh.communicates(e_ax):
        first = sh.axis_index(e_ax) * e_loc
        mine = (flat_e >= first) & (flat_e < first + e_loc)
        keep = keep & mine
        flat_e = torch.where(mine, flat_e - first, 0)
        x = sh.copy_to(x, e_ax)
        gate_vals = sh.copy_to(gate_vals, e_ax)
    buf = _dispatch(x, flat_e, safe_pos, keep, e_loc, cap, k)
    out_buf = _experts(buf, params)
    y = _combine(out_buf, flat_e, safe_pos, keep, gate_vals, s, k)
    return sh.all_reduce(y, e_ax).to(x.dtype), aux


# ---------------------------------------------------------------------------
# Expert parallelism (sequence split + two all-to-all exchanges)
# ---------------------------------------------------------------------------


def ep_applicable(cfg, mesh: MeshInfo | None, seq_len: int) -> bool:
    if mesh is None or mesh.model <= 1 or seq_len % mesh.model:
        return False
    return padded_experts(cfg, mesh) % mesh.model == 0


def apply_moe_ep(params, x, cfg, mesh: MeshInfo):
    """Expert-parallel MoE: sequence-split routing + two all-to-all
    exchanges (dispatch / return).

    Each (data, model) rank routes its own S/model token slice, ships
    expert inputs directly to their owner shard and back — payload =
    tokens x top_k x D in the compute dtype, no reduction op.  Capacity is
    enforced per sequence chunk (S/M tokens).  ``x`` (B_local, S, D) is
    replicated over the model axis and so is the result: the slices are
    gathered again.  ``params`` holds this rank's experts and the whole
    (replicated) router, whose gradient sums the ranks' slices.
    ``aux`` is averaged over the model axis, then over the data axes.
    """
    if sh.ambient_mesh() is None:
        raise RuntimeError(
            "apply_moe_ep needs an ambient mesh; wrap the call in "
            "`with repro_torch.runtime.sharding.use_mesh(mesh):`")
    b, s, d = x.shape
    e, k = padded_experts(cfg, mesh), cfg.experts_per_token
    m_ax, mm = mesh.model_axis, mesh.model
    e_loc = e // mm
    cap = _capacity(s // mm, cfg)

    xs = sh.scatter_to(x, m_ax, 1)                # (B, S/M, D), this slice
    router = {"router": sh.copy_to(params["router"], m_ax)}
    gate_vals, flat_e, safe_pos, keep, aux = _route(router, xs, cfg, cap)
    aux = sh.data_mean(sh.all_reduce(aux / mm, m_ax), mesh.dp())

    buf = _dispatch(xs, flat_e, safe_pos, keep, e, cap, k)  # (B,E,cap,D)
    # dispatch: the experts' owner rank leads; sources stack on dim 0
    buf = buf.reshape(b, mm, e_loc, cap, d).transpose(0, 1)
    buf = sh.all_to_all(buf, m_ax)               # (M_src, B, E_loc, cap, D)
    out = sh.all_to_all(_experts(buf, params), m_ax)      # return trip
    out = out.transpose(0, 1).reshape(b, e, cap, d)
    y = _combine(out, flat_e, safe_pos, keep, gate_vals, s // mm, k)
    return sh.gather_from(y.to(x.dtype), m_ax, 1), aux
