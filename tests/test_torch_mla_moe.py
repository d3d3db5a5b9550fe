"""Moonlight-16B-A3B's block in the port, on the CPU at the smoke config's
size (d 64, 4 heads, latent 16, nope 16, rope 8, v 16, 8 experts routed
over with top 2, 2 held, 1 shared, 3 layers with the first dense):
latent attention and the sigmoid router's MoE layer against the
benchmark's plain reference (``perfbench/reference/mla_moe_lm.py``) in
f32, the expert share, dropless dispatch under a forced imbalance,
``blockwise_attention`` with values narrower than q.k, and the softmax
router's path and equal-width attention unchanged bit for bit.

    PYTHONPATH=src python -m pytest tests/test_torch_mla_moe.py -q

Tolerances: f32 against the f32 reference, rtol 1e-5 / atol 1e-6 (the
same sums in another order).
"""
import dataclasses
import hashlib
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench.reference import mla_moe_lm as ref  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs.moonlight_16b_a3b import smoke_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import HOST_MESH, MeshInfo  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.runtime import train_lib  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


def _cfg(**kw):
    return dataclasses.replace(smoke_config(), compute_dtype="float32", **kw)


def arch(cfg, init_std=0.1) -> dict:
    """The reference's sizes of a port config."""
    return {"d": cfg.d_model, "f": cfg.d_ff, "h": cfg.n_heads,
            "layers": cfg.n_layers, "dense": cfg.first_k_dense,
            "vocab": cfg.vocab_size, "vp": cfg.padded_vocab,
            "eps": cfg.norm_eps, "theta": cfg.rope_theta,
            "r": cfg.kv_lora_rank, "nope": cfg.qk_nope_head_dim,
            "rope": cfg.qk_rope_head_dim, "dv": cfg.v_head_dim,
            "fe": cfg.moe_d_ff, "e": cfg.n_experts,
            "held": list(cfg.experts_held) or list(range(cfg.n_experts)),
            "k": cfg.experts_per_token, "shared": cfg.n_shared_experts,
            "scale": cfg.routed_scale, "alpha": cfg.router_aux_coef,
            "gamma": cfg.bias_rate, "bias_std": cfg.bias_init_std,
            "init_std": init_std}


def moe_params(views, i, held=None):
    """Layer ``i``'s MoE leaves in the port's layout (``held``: the rows of
    the reference's expert stacks to keep)."""
    pre = f"layers.{i}."
    sl = slice(None) if held is None else held
    return {"router": views[pre + "router"], moe.BIAS: views[pre + ref.BIAS],
            **{k: views[pre + "experts." + k][sl]
               for k in ("w_gate", "w_up", "w_down")},
            "shared": {k: views[pre + "shared." + k]
                       for k in ("w_gate", "w_up", "w_down")}}


def ref_rows(fn, x):
    """``fn`` over each row of (B, S, D), stacked."""
    outs = [fn(x[b]) for b in range(x.shape[0])]
    return [torch.stack(o) for o in zip(*outs)]


def test_latent_attention_matches_the_reference():
    cfg = _cfg()
    a = arch(cfg)
    _, views = ref.make_params(a, 3, "cpu")
    p = {k: views["layers.1." + k]
         for k in ("wq", "wkv_a", "kv_norm", "wkv_b", "wo")}
    with torch.no_grad():
        p["kv_norm"].add_(0.1 * torch.randn(p["kv_norm"].shape))
    x = torch.randn(2, 19, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    got = attn.apply_mla(p, x, cfg)
    want, = ref_rows(lambda r: (ref._mla(r, views, "layers.1.", a, False),),
                     x)
    torch.testing.assert_close(got, want, **TOL)


def test_the_router_and_dropless_experts_match_the_reference():
    cfg = _cfg()
    a = arch(cfg)
    _, views = ref.make_params(a, 5, "cpu")
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator()
                    .manual_seed(6))
    y, aux = moe.apply_moe_sigmoid(moe_params(views, 2), x, cfg)
    want, waux, _ = ref_rows(
        lambda r: ref._moe(r, views, "layers.2.", a, False), x)
    torch.testing.assert_close(y, want, **TOL)
    torch.testing.assert_close(aux, waux.mean(), **TOL)


def test_the_shares_add_up_to_the_uncut_layer():
    """Four shares of 2 experts each, the shared experts counted once, give
    what the reference's layer with all 8 experts gives."""
    cfg = _cfg()
    whole = arch(cfg)
    whole["held"] = list(range(cfg.n_experts))
    _, views = ref.make_params(whole, 7, "cpu")
    x = torch.randn(2, 33, cfg.d_model, generator=torch.Generator()
                    .manual_seed(8))
    parts, auxes = [], []
    for r in range(4):
        held = (2 * r, 2 * r + 1)
        y, aux = moe.apply_moe_sigmoid(
            moe_params(views, 1, slice(2 * r, 2 * r + 2)), x,
            dataclasses.replace(cfg, experts_held=held))
        parts.append(y)
        auxes.append(aux)
    shared = moe.layers.apply_mlp(moe_params(views, 1)["shared"], x, cfg)
    want, waux, _ = ref_rows(
        lambda r: ref._moe(r, views, "layers.1.", whole, False), x)
    torch.testing.assert_close(sum(parts) - 3 * shared, want, **TOL)
    for aux in auxes:
        torch.testing.assert_close(aux, waux.mean(), **TOL)


def test_a_forced_imbalance_drops_nothing():
    """A bias that sends every token to held expert 0: its rows are all
    the tokens, padded to a multiple of 64, and the result is the
    reference's."""
    cfg = _cfg()
    a = arch(cfg)
    _, views = ref.make_params(a, 9, "cpu")
    with torch.no_grad():
        views["layers.1." + ref.BIAS][0] = 10.0
    x = torch.randn(2, 50, cfg.d_model, generator=torch.Generator()
                    .manual_seed(10))
    obs.clear()
    obs.enable()
    try:
        y, _ = moe.apply_moe_sigmoid(moe_params(views, 1), x, cfg)
        span, = [s for s in obs.recorder.spans if s.name == "moe.dispatch"]
        routed = obs.metrics.get("moe.rows_routed")
    finally:
        obs.disable()
        obs.clear()
    assert span.attrs["cap"] == 128 and span.attrs["rows"] == routed
    assert routed >= 100
    want, _, _ = ref_rows(
        lambda r: ref._moe(r, views, "layers.1.", a, False), x)
    torch.testing.assert_close(y, want, **TOL)


def test_values_narrower_than_qk_are_plain_softmax_attention():
    g = torch.Generator().manual_seed(11)
    q, k = (torch.randn(2, 21, 3, 24, generator=g) for _ in range(2))
    v = torch.randn(2, 21, 3, 16, generator=g)
    got = attn.blockwise_attention(q, k, v, chunk=8, causal=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 24 ** -0.5
    s = s.masked_fill(~torch.ones(21, 21, dtype=torch.bool).tril(),
                      float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
    assert got.shape == (2, 21, 3, 16)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_equal_widths_attention_is_unchanged_bit_for_bit():
    """The digest of ``blockwise_attention``'s outputs before values could
    be narrower (f32 and bf16; causal, prefix-LM and full)."""
    g = torch.Generator().manual_seed(31)
    q, k, v = (torch.randn(2, 24, 3, 16, generator=g) for _ in range(3))
    h = hashlib.sha256()
    for dt in (torch.float32, torch.bfloat16):
        for causal, prefix in ((True, 0), (True, 5), (False, 0)):
            out = attn.blockwise_attention(q.to(dt), k.to(dt), v.to(dt),
                                           chunk=7, causal=causal,
                                           prefix_len=prefix)
            h.update(out.float().contiguous().numpy().tobytes())
    assert h.hexdigest() == ("1a70dc30b3e8073cb02ab8035db0f27c0a9c401cb946"
                             "3aca7247510f1d180c53")


def test_the_softmax_router_is_unchanged_bit_for_bit():
    """granite's softmax top-k with a per-sequence capacity on a seeded
    input: the digests of its output (f32, bf16) and of its gradients
    (f32) before the sigmoid router was added."""
    cfg = get_config("granite-moe-3b-a800m", smoke=True)
    p = moe.init_moe(torch.Generator().manual_seed(1234), cfg, HOST_MESH,
                     torch.float32, "cpu")
    x = torch.randn(2, 24, cfg.d_model,
                    generator=torch.Generator().manual_seed(99))
    want = {torch.float32: "767ff3e9f5bd6e80d8510ac9952e2486b5617d071f9313"
                           "9e4ffa1eeef885dcf7",
            torch.bfloat16: "cba4c09dbb415a8eb739a182ef16f90fca5012af34e0"
                            "42a4bb7ee35aa2bf3d7f"}
    for dt, digest in want.items():
        pp = {k: v.to(dt) if v.ndim >= 2 else v for k, v in p.items()}
        y, _ = moe.apply_moe(pp, x.to(dt), cfg)
        assert hashlib.sha256(y.float().contiguous().numpy().tobytes()
                              ).hexdigest() == digest
    pp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xx = x.clone().requires_grad_(True)
    y, aux = moe.apply_moe(pp, xx, cfg)
    (y.square().sum() + aux).backward()
    h = hashlib.sha256()
    for t in [y, xx.grad] + [pp[k].grad for k in sorted(pp)]:
        h.update(t.detach().float().contiguous().numpy().tobytes())
    assert h.hexdigest() == ("b5900cc91468570c237e1634b1a84ced7d5c741e4c80"
                             "3179b9d47e88fdb37e5d")


def test_the_recompute_reuses_the_forwards_read_and_gives_its_gradients():
    """With block remat a step reads each MoE layer's largest load once
    (the forward's), and its gradients are those without remat."""
    cfg = _cfg()
    lm = LM(cfg, device="cpu")
    params = lm.init(torch.Generator().manual_seed(2))
    toks = torch.randint(0, cfg.vocab_size, (2, 33),
                         generator=torch.Generator().manual_seed(3))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    leaves = [p for p in train_lib.trained(params)["stack"][0]
              ["b0_moe"]["moe"].values() if torch.is_tensor(p)]
    grads = {}
    for remat in ("block", "none"):
        for p in leaves:
            p.requires_grad_(True)
        obs.clear()
        obs.enable()
        try:
            loss, _ = lm.loss_fn(params, batch, remat=remat)
            grads[remat] = torch.autograd.grad(loss, leaves)
            reads = obs.metrics.get("moe.load_reads")
        finally:
            obs.disable()
            obs.clear()
        assert reads == 2
    for g, h in zip(*grads.values()):
        torch.testing.assert_close(g, h, rtol=0, atol=0)


def test_the_bias_is_not_trained_and_moves_by_the_rate():
    """The step leaves the bias out of the gradients and AdamW's state,
    and moves it by exactly the rate a step, toward balance."""
    cfg = _cfg()
    lm = LM(cfg, device="cpu")
    tcfg = TrainConfig(warmup_steps=1)
    values, _, opt, _ = train_lib.init_train_state(
        lm, tcfg, torch.Generator().manual_seed(0))
    assert "router_bias" not in opt["m"]["stack"][0]["b0_moe"]["moe"]
    step = train_lib.make_train_step(lm, tcfg, ParallelConfig())
    toks = torch.randint(0, cfg.vocab_size, (2, 17),
                         generator=torch.Generator().manual_seed(1))
    bias = values["stack"][0]["b0_moe"]["moe"]["router_bias"]
    b0 = bias.detach().clone()
    with moe.collect_loads() as loads:
        lm.loss_fn(values, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    load = [n for b, n in loads if b is bias][0]
    step(values, opt, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    torch.testing.assert_close(
        bias.detach() - b0, cfg.bias_rate * torch.sign(load.mean() - load),
        rtol=0, atol=1e-9)


def test_the_lead_layer_is_its_own_part_and_other_trees_keep_theirs():
    meta = LM(smoke_config(), device="meta")
    with torch.device("meta"):
        tree = meta.init(torch.Generator())
    assert list(tree["lead"]) == ["l0_attn"] and len(tree["stack"]) == 2
    assert set(tree["lead"]["l0_attn"]["attn"]) == {
        "wq", "wkv_a", "kv_norm", "wkv_b", "wo"}
    assert tree["lead"]["l0_attn"]["mlp"]["w_up"].shape == (64, 96)
    assert tree["stack"][0]["b0_moe"]["moe"]["w_gate"].shape == (2, 64, 32)
    for arch_id in ("granite-moe-3b-a800m", "qwen2-1.5b"):
        m = LM(get_config(arch_id, smoke=True), device="meta")
        with torch.device("meta"):
            assert "lead" not in m.init(torch.Generator())


def test_what_one_device_does_not_do_raises():
    cfg = smoke_config()
    with pytest.raises(NotImplementedError, match="model axis"):
        LM(cfg, MeshInfo(data=1, model=2), device="cpu")
    lm = LM(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="latent"):
        lm.init_cache(1, 8)
