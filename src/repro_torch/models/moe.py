"""Mixture-of-Experts blocks: top-k routers and their dispatch.

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

A second design, DeepSeek-V3's (``cfg.router == "sigmoid"``,
:func:`apply_moe_sigmoid`), routes with sigmoid scores and a correction
bias, drops no token, adds shared experts and holds a chosen subset of the
experts routed over (one device's share of an expert-parallel layer).  It
runs on one device, or replicated over the data axes.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch import gemm as gemm_api
from repro_torch import obs
from repro_torch.models import layers
from repro_torch.models.common import WHOLE, Cut, MeshInfo, dense_init
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


def _skip(v):
    """Keeps nothing of a draw: the draw only moves the generator on."""
    return v[:0]


def _expert_stack(gen, cfg, mesh: MeshInfo, d_in: int, shape: tuple, dtype,
                  device, cut: Cut, key: str):
    """Leaf ``key``: the (E_phys, *shape) stack of the logical experts,
    each drawn alone as :func:`dense_init` draws it, then the zero
    padding experts.  Every expert is drawn, in order (the generator moves
    as for the whole stack), but only the experts ``cut`` keeps are kept,
    each cut as it is drawn: a rank holds its shard and one expert's f32
    draw.  On ``meta`` (no values) the stack is one draw: the loop would
    make kimi-k2's 61 blocks 70k meta draws, and building its abstract
    state (the dry run's) took 37.5 s so against 1.5 s (one core of an
    Intel Xeon).  ``test_the_whole_init_on_meta_keeps_its_shapes`` holds
    the two to the same shapes."""
    e0, e = cfg.n_experts, padded_experts(cfg, mesh)
    if torch.device(device).type == "meta":
        return cut(key, pad_e(dense_init(gen, d_in, (e0,) + shape, dtype,
                                         device), cfg, mesh, 0))
    rows, one = cut.rows(key, e)
    kept_shape = shape if one is None else tuple(
        one(torch.empty(shape, device="meta")).shape)
    out = torch.zeros((len(rows),) + kept_shape, dtype=dtype, device=device)
    for i in range(e0):
        kept = i in rows
        w = dense_init(gen, d_in, shape, dtype, device,
                       one if kept else _skip)
        if kept:
            out[i - rows.start] = w
    return out


def init_moe(gen, cfg, mesh: MeshInfo, dtype, device, cut: Cut = WHOLE):
    """The router drawn whole (it is replicated), then each expert stack
    one expert at a time (:func:`_expert_stack`)."""
    d, f, e0 = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    return {
        "router": dense_init(gen, d, (d, e0), torch.float32, device,
                             cut.of("router",
                                    lambda w: pad_e(w, cfg, mesh, 1))),
        "w_gate": _expert_stack(gen, cfg, mesh, d, (d, f), dtype, device,
                                cut, "w_gate"),
        "w_up": _expert_stack(gen, cfg, mesh, d, (d, f), dtype, device, cut,
                              "w_up"),
        "w_down": _expert_stack(gen, cfg, mesh, f, (f, d), dtype, device,
                                cut, "w_down"),
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


# ---------------------------------------------------------------------------
# DeepSeek-V3's design: sigmoid router with a correction bias, dropless
# dispatch over the experts held, shared experts
# ---------------------------------------------------------------------------

#: the leaf of the router's correction bias: state that the training step
#: moves between steps (:func:`update_bias`), not a trained parameter
BIAS = "router_bias"
#: each held expert's rows are padded to a multiple of this
ROW_MULTIPLE = 64


def sigmoid_specs(cfg, mesh: MeshInfo) -> dict:
    """The specs of :func:`init_moe_sigmoid`'s leaves: whole on every rank
    (the held experts are this device's share already)."""
    return {"router": (None, None), BIAS: (None,),
            "w_gate": (None, None, None), "w_up": (None, None, None),
            "w_down": (None, None, None),
            "shared": layers.mlp_specs(cfg, mesh, shared_width(cfg))}


def shared_width(cfg) -> int:
    """The shared experts as one SwiGLU: their widths side by side."""
    return cfg.n_shared_experts * cfg.moe_d_ff


def init_moe_sigmoid(gen, cfg, mesh: MeshInfo, dtype, device,
                     cut: Cut = WHOLE):
    """The router over all ``n_experts`` (f32) and its correction bias,
    drawn at N(0, ``bias_init_std``) (f32); the held experts' stacks
    (``n_experts_held``, ...); the shared experts as one MLP."""
    d, f, e, h = cfg.d_model, cfg.moe_d_ff, cfg.n_experts, cfg.n_experts_held
    bias = torch.randn((e,), generator=gen, dtype=torch.float32,
                       device=device)
    return {
        "router": dense_init(gen, d, (d, e), torch.float32, device,
                             cut.of("router")),
        BIAS: cut(BIAS, bias * cfg.bias_init_std),
        "w_gate": dense_init(gen, d, (h, d, f), dtype, device,
                             cut.of("w_gate")),
        "w_up": dense_init(gen, d, (h, d, f), dtype, device, cut.of("w_up")),
        "w_down": dense_init(gen, f, (h, f, d), dtype, device,
                             cut.of("w_down")),
        "shared": layers.init_mlp(gen, cfg, mesh, dtype, device,
                                  d_ff=shared_width(cfg),
                                  cut=cut.at("shared")),
    }


class _Unit:
    """One remat unit's record of the largest loads its MoE layers read:
    the forward appends, the recompute hands them back in order."""

    def __init__(self, kept: list, replay: bool):
        self.kept, self.replay = kept, replay

    def __enter__(self):
        _UNITS.append(self)
        return self

    def __exit__(self, *exc):
        _UNITS.remove(self)
        return False


#: the active remat units, innermost last
_UNITS: list[_Unit] = []
#: the active collectors of (bias, load) pairs (:func:`collect_loads`)
_LOADS: list[list] = []
#: the held experts' lookup tables by (held, routed over, device)
_LUTS: dict = {}


def remat_context():
    """``context_fn`` of ``torch.utils.checkpoint`` for a unit with
    :func:`apply_moe_sigmoid` layers: (the forward's recording context, the
    recompute's replaying one), so that the recompute pads to the rows
    the forward read and reads nothing from the device."""
    kept: list = []
    return _Unit(kept, replay=False), _Unit(kept, replay=True)


@contextlib.contextmanager
def collect_loads():
    """Collect, while open, each :func:`apply_moe_sigmoid` forward's
    ``(bias, load)``: its router's bias leaf and the (n_experts,) count of
    (token, choice) pairs routed to each expert (not the recompute's)."""
    got: list = []
    _LOADS.append(got)
    try:
        yield got
    finally:
        _LOADS.remove(got)


def update_bias(loads: list, rate: float) -> None:
    """DeepSeek-V3's update between steps, in place: each bias moves by
    ``rate`` toward balance, ``b_i += rate * sign(mean load - load_i)``,
    on the loads its layer's forwards routed (summed over microbatches)."""
    by: dict = {}
    for bias, load in loads:
        got = by.get(id(bias))
        by[id(bias)] = (bias, load if got is None else got[1] + load)
    with torch.no_grad():
        for bias, load in by.values():
            bias.add_(torch.sign(load.mean() - load), alpha=rate)


def _held_lut(cfg, device):
    """(n_experts,) long: each routed expert's row in the held stacks, or
    -1 where this device does not hold it."""
    key = (cfg.experts_held, cfg.n_experts, str(device))
    lut = _LUTS.get(key)
    if lut is None:
        held = list(cfg.experts_held) or list(range(cfg.n_experts))
        lut = torch.full((cfg.n_experts,), -1, dtype=torch.long)
        lut[held] = torch.arange(len(held))
        lut = _LUTS.setdefault(key, lut.to(device))
    return lut


def _route_sigmoid(params, x, cfg):
    """(experts chosen (B, S, K), their weights (B, S, K) f32, the balance
    loss, the (E,) load): logits in f32 over every expert routed over,
    sigmoid scores, the top K of scores plus the bias chosen, weighted by
    their unbiased scores normalised and scaled.  The balance loss is the
    DeepSeek-V3 report's sequence-wise one (arXiv:2412.19437, eqs. 17-20):
    per sequence, alpha * sum_i f_i P_i with f_i = E/(K S) times the
    positions that chose expert i and P_i the mean over positions of
    expert i's score over the sum of the position's scores; the mean over
    sequences."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    # the compute copy holds the router in the compute dtype: f32 logits
    scores = torch.sigmoid(x.float() @ params["router"].float())
    chosen = torch.topk(scores + params[BIAS], k, dim=-1).indices
    w = scores.gather(-1, chosen)
    w = w / w.sum(-1, keepdim=True) * cfg.routed_scale
    counts = torch.zeros(b, e, dtype=torch.float32, device=x.device)
    counts.scatter_add_(1, chosen.view(b, s * k),
                        torch.ones(b, s * k, device=x.device))
    share = (scores / scores.sum(-1, keepdim=True)).mean(1)
    aux = cfg.router_aux_coef * (counts * (e / (k * s)) * share).sum(
        -1).mean()
    return chosen, w, aux, counts.sum(0)


def _unit():
    """The innermost active remat unit, or None."""
    return _UNITS[-1] if _UNITS else None


def _rows(per_expert) -> tuple[int, int]:
    """A MoE layer's one read from the device: (rows an expert: the held
    experts' largest load rounded up to :data:`ROW_MULTIPLE`, rows routed),
    kept for the enclosing remat unit's recompute, which reads nothing and
    takes the forward's; the counters while ``obs`` records."""
    unit = _unit()
    if unit is not None and unit.replay:
        return unit.kept.pop(0)
    top, rows = torch.stack([per_expert.max(), per_expert.sum()]).tolist()
    cap = ROW_MULTIPLE * max(1, -(-top // ROW_MULTIPLE))
    if obs.recorder.enabled:
        obs.metrics.counter("moe.load_reads")
        obs.metrics.counter("moe.rows_routed", rows)
        obs.metrics.counter("moe.rows_padded",
                            cap * per_expert.numel() - rows)
    if unit is not None:
        unit.kept.append((cap, rows))
    return cap, rows


def _slots(key, per, held: int, cap: int, k: int):
    """For the (token, choice) pairs ``key`` (T*K,: the held expert's row
    in the stacks, ``held`` where none is held): ``slot`` (T*K,), the row
    of the (held * cap) expert rows each pair fills, the pairs of one
    expert in token order, ``held * cap`` where it fills none; and ``src``
    (held * cap,), the token each row holds, T where it is padding."""
    n = key.numel()
    sorted_key, order = torch.sort(key, stable=True)
    first = torch.cumsum(per, 0) - per
    pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=key.device) - first[sorted_key])
    slot = torch.where(key < held, key * cap + pos, held * cap)
    src = torch.full((held * cap + 1,), n // k, dtype=torch.long,
                     device=key.device)
    # unique rows, but for the pairs held nowhere, which all land on the
    # row past the end that is dropped
    src.index_put_((slot,), torch.arange(n, device=key.device) // k)
    return slot, src[:-1]


def _with_zero_row(t):
    return torch.cat([t, t.new_zeros(1, t.shape[1])])


class _Dispatch(torch.autograd.Function):
    """``buf[r] = x[src[r]]``, a zero row where ``src[r]`` is T: the held
    experts' rows.  The backward sums each token's rows over its K choices
    in choice order, in f32 (``dx[t] = sum_j dbuf[slot[t, j]]``), so the
    sum does not depend on the order of atomic adds, as a scatter-add's
    would."""

    @staticmethod
    def forward(ctx, x, slot, src, k):
        ctx.save_for_backward(slot)
        ctx.k = k
        return _with_zero_row(x)[src]

    @staticmethod
    def backward(ctx, g):
        slot, = ctx.saved_tensors
        parts = _with_zero_row(g)[slot].view(-1, ctx.k, g.shape[1])
        dx = parts[:, 0].float()
        for j in range(1, ctx.k):
            dx = dx + parts[:, j]
        return dx.to(g.dtype), None, None, None


class _Combine(torch.autograd.Function):
    """``y[t] = sum_j w[t, j] out[slot[t, j]]`` (a zero row for a choice
    no held expert took), summed in f32 in choice order and cast to
    ``out``'s dtype.  Backward: each row has one source token, so
    ``dout[r]`` is its choice's weight times ``dy[src[r]]``, a gather; and
    ``dw[t, j] = dy[t] . out[slot[t, j]]``."""

    @staticmethod
    def forward(ctx, out, slot, src, w):
        ctx.save_for_backward(out, slot, src, w)
        t, k = w.shape
        eo = _with_zero_row(out)[slot].view(t, k, out.shape[1])
        y = w[:, :1] * eo[:, 0]
        for j in range(1, k):
            y = y + w[:, j:j + 1] * eo[:, j]
        return y.to(out.dtype)

    @staticmethod
    def backward(ctx, gy):
        out, slot, src, w = ctx.saved_tensors
        t, k = w.shape
        gy = gy.float()
        w_row = torch.zeros(out.shape[0] + 1, dtype=w.dtype,
                            device=w.device)
        w_row.index_put_((slot,), w.reshape(-1))
        dout = (_with_zero_row(gy)[src] * w_row[:-1, None]).to(out.dtype)
        eo = _with_zero_row(out)[slot].view(t, k, out.shape[1])
        dw = torch.stack([(gy * eo[:, j]).sum(-1) for j in range(k)], -1)
        return dout, None, None, dw


def apply_moe_sigmoid(params, x, cfg):
    """x: (B, S, D) -> (y, balance loss).  DeepSeek-V3's MoE layer as one
    device holds it: every token is routed over all ``n_experts``
    (:func:`_route_sigmoid`); the held experts compute their part of the
    result for the (token, choice) pairs routed to them, none dropped, each
    expert's rows padded to the held experts' largest load rounded up to
    :data:`ROW_MULTIPLE` (one read from the device a forward, which a
    block's recompute reuses: :func:`remat_context`), through the grouped
    kernel; the shared experts run on every token.  What the experts held
    elsewhere would add is left out, and no exchange stands in for it.

    While ``obs`` records: spans ``moe.route``, ``moe.shared``,
    ``moe.dispatch`` (``cap``: an expert's rows; ``rows``: the pairs routed
    to the held experts), ``moe.experts``, ``moe.combine``; counters
    ``moe.load_reads``, ``moe.rows_routed``, ``moe.rows_padded`` at each
    read (the recompute reads nothing)."""
    b, s, d = x.shape
    k, held = cfg.experts_per_token, params["w_gate"].shape[0]
    with obs.span("moe.route"):
        chosen, w, aux, load = _route_sigmoid(params, x, cfg)
        unit = _unit()
        if _LOADS and not (unit is not None and unit.replay):
            _LOADS[-1].append((params[BIAS], load))
        key = _held_lut(cfg, x.device)[chosen].view(-1)
        key = torch.where(key >= 0, key, held)
        per = torch.bincount(key, minlength=held + 1)
    with obs.span("moe.shared"):
        shared = layers.apply_mlp(params["shared"], x, cfg)
    with obs.span("moe.dispatch") as span:
        cap, rows = _rows(per[:held])
        span.set(cap=cap, rows=rows)
        slot, src = _slots(key, per, held, cap, k)
        buf = _Dispatch.apply(x.reshape(b * s, d), slot, src, k)
    with obs.span("moe.experts"):
        out = _experts(buf.view(held, cap, d), params)
    with obs.span("moe.combine"):
        y = _Combine.apply(out.view(held * cap, d), slot, src,
                           w.view(b * s, k))
        return y.view(b, s, d) + shared, aux
