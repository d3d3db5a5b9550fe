"""The Moonlight-16B-A3B cell's parts: the program against the plain
reference (``reference/mla_moe_lm.py``) in float32 at the smoke sizes
(d 64, 4 heads, latent 16, nope 16, rope 8, v 16, 8 experts routed over
with top 2, 2 held, 1 shared, 3 layers with the first dense) for logits,
loss, every leaf's gradient and two AdamW steps with the bias updates;
the configuration file against the published config; the frozen counts;
the new metrics' readers and the bias check."""
import copy
import dataclasses
import json
import math
import os

import pytest
import torch

from perfbench import harness, roofline, roofline_moe
from perfbench.drivers import train, train_moe
from perfbench.reference import mla_moe_lm as ref

CELL = "moonlight-16b-a3b.train-2x4k"
TOL = dict(rtol=1e-5, atol=1e-6)


def config():
    return harness.load_json(os.path.join(harness.HERE, "configs",
                                          "moonlight-16b-a3b.json"))


def smoke():
    """The configuration file at the smoke sizes, in the file's keys."""
    cfg = copy.deepcopy(config())
    cfg.update(hidden_size=64, intermediate_size=96, num_attention_heads=4,
               num_key_value_heads=4, num_hidden_layers=3, vocab_size=300,
               kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
               v_head_dim=16, moe_intermediate_size=32, n_routed_experts=2,
               num_experts_per_tok=2, n_shared_experts=1)
    cfg["deployment"].update(n_routed_experts=8, experts_held=[0, 1])
    cfg["assumed"]["initializer_range"]["value"] = 0.1
    return cfg


def program(cfg, seed):
    """(reference sizes, the reference's leaves, the f32 model, its tree:
    the same tensors)."""
    from repro_torch.models.model import LM
    a = ref.arch_of(cfg)
    _, views = ref.make_params(a, seed, torch.device("cpu"))
    lm = LM(dataclasses.replace(train_moe.model_config(cfg),
                                compute_dtype="float32"), device="cpu")
    return a, views, lm, train.program_tree(lm, views,
                                            train_moe.program_paths(a))


def batch_of(a, seed, b=2, s=21):
    ids = torch.randint(0, a["vocab"], (b, s + 1),
                        generator=torch.Generator().manual_seed(seed))
    return ids[:, :-1], ids[:, 1:]


def program_logits(lm, params, tokens):
    from repro_torch.models import layers
    cp = lm.compute_params(params)
    x, _ = lm._embed_inputs(cp, {"tokens": tokens}, cp["embed"])
    x, _ = lm._run_stack(cp, x, prefix_len=0, remat="none")
    x = layers.apply_norm(cp["final_norm"], x, lm.cfg)
    return layers.logits_head(cp["embed"], x, lm.cfg)


def test_logits_loss_and_every_gradient_match_the_reference():
    a, views, lm, params = program(smoke(), 3)
    tokens, labels = batch_of(a, 4)
    with torch.no_grad():
        want = torch.stack([ref.row_logits(views, a, tokens[r],
                                           remat=False)[0]
                            for r in range(2)])
        # logits of order 1 after three layers' sums in another order
        torch.testing.assert_close(program_logits(lm, params, tokens)[
            ..., :a["vocab"]], want[..., :a["vocab"]], rtol=1e-5,
            atol=1e-5)
    names = [n for n in views if not ref.is_bias(n)]
    leaves = [views[n] for n in names]
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = lm.loss_fn(params, {"tokens": tokens, "labels": labels},
                         remat="block")
    got = torch.autograd.grad(loss, leaves)
    total = 0.0
    for r in range(2):
        ce, aux, _ = ref.row_loss(views, a, tokens[r], labels[r], 1e-4)
        total = total + ce / tokens.numel() + aux / 2
    want = torch.autograd.grad(total, leaves)
    torch.testing.assert_close(loss, total, **TOL)
    for n, g, w in zip(names, got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-7, msg=n)


def test_two_adamw_steps_and_bias_updates_match_the_reference():
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.optim import init_opt_state
    from repro_torch.runtime import train_lib
    cfg = smoke()
    traffic = harness.load_json(os.path.join(harness.HERE, "traffic",
                                             "train-2x4k.json"))
    traffic["optimizer"]["warmup_steps"] = 1
    a, views, lm, params = program(cfg, 5)
    opt = traffic["optimizer"]
    tcfg = TrainConfig(lr=opt["lr"], warmup_steps=1,
                       total_steps=opt["total_steps"],
                       weight_decay=opt["weight_decay"],
                       grad_clip=opt["grad_clip"], b1=opt["b1"], b2=opt["b2"])
    state = init_opt_state(train_lib.trained(params),
                           train_lib.make_adamw_config(lm.cfg, tcfg))
    step = train_lib.make_train_step(lm, tcfg, ParallelConfig())
    batches = [batch_of(a, 6 + i) for i in range(2)]
    for tokens, labels in batches:
        params, state, _ = step(params, state, {"tokens": tokens,
                                                "labels": labels})
    want = ref.train_steps(a, 5, batches, traffic, torch.device("cpu"))
    _, start = ref.make_params(a, 5, torch.device("cpu"))
    for n, t in views.items():
        if ref.is_bias(n):
            torch.testing.assert_close(t, want["bias"][n], rtol=0, atol=0)
            assert float((t - start[n]).abs().max()) > 0
        else:
            change = float((t.detach() - start[n]).norm())
            assert change == pytest.approx(want["change_norm"][n],
                                           rel=1e-3, abs=1e-7), n


def test_the_file_keeps_the_published_config_but_the_share():
    cfg = config()
    published = {"hidden_size": 2048, "intermediate_size": 11264,
                 "kv_lora_rank": 512, "q_lora_rank": None,
                 "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
                 "v_head_dim": 128, "moe_intermediate_size": 1408,
                 "num_attention_heads": 16, "num_key_value_heads": 16,
                 "num_experts_per_tok": 6, "n_shared_experts": 2,
                 "num_hidden_layers": 27, "first_k_dense_replace": 1,
                 "routed_scaling_factor": 2.446, "rope_theta": 50000,
                 "scoring_func": "sigmoid", "topk_method": "noaux_tc",
                 "norm_topk_prob": True, "tie_word_embeddings": False}
    assert {k: cfg[k] for k in published} == published
    assert cfg["reduced"] == ["n_routed_experts", "vocab_size"]
    dep = cfg["deployment"]
    assert (dep["n_routed_experts"], dep["vocab_size"]) == (64, 163840)
    assert dep["experts_held"] == list(range(cfg["n_routed_experts"])) \
        == list(range(8))
    assert cfg["vocab_size"] * dep["chips_sharing_each_layer"] == 163840
    assert {k: v["value"] for k, v in cfg["assumed"].items()} == {
        "alpha": 1e-4, "gamma": 1e-3, "bias_init_std": 1e-2,
        "initializer_range": 0.02}


def test_the_ports_configuration_is_the_files():
    from repro_torch.configs.moonlight_16b_a3b import get_config
    assert train_moe.model_config(config()) == get_config()


def test_the_program_holds_2p78_billion_parameters():
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import LM
    mcfg = train_moe.model_config(config())
    meta = LM(mcfg, device="meta")
    with torch.device("meta"):
        n = sum(t.numel() for t in tree_leaves(meta.init(torch.Generator())))
    assert n == sum(math.prod(s) for _, s, _ in ref.leaf_specs(
        ref.arch_of(config()))) == 2_777_412_736
    assert mcfg.param_count() == pytest.approx(n, rel=1e-4)


def test_frozen_counts():
    cfg = config()
    assert round(2 * roofline_moe.matmul_params_per_token(cfg) / 1e9,
                 2) == 2.21
    assert round(roofline_moe.train_model_flops(cfg, 2, 4096) / 1e12,
                 1) == 68.2
    prods = roofline_moe.grouped_products(cfg, 8192)
    assert roofline_moe.mean_rows(cfg, 8192) == 768
    assert [(p["m"], p["n"], p["k"], p["groups"], p["count"])
            for p in prods] == [(768, 1408, 2048, 8, 104),
                                (768, 1408, 2048, 8, 104),
                                (768, 2048, 1408, 8, 104)]


def test_the_new_readers():
    def reader(name):
        return harness.metric_reader(name)
    rec = {"kind": "train", "steps": 8, "wall_s": 20.0, "traced_steps": 3,
           "trace": {"busy_s": 6.0, "kernels": {
               "void wide::grouped_wgmma<256>(x)": [0.05, 10],
               "void grouped_wgmma<64>(y)": [0.05, 10]}},
           "grouped_products": roofline_moe.grouped_products(config(), 8192),
           "counters": {"moe.rows_routed": 1000.0, "moe.rows_padded": 250.0},
           "layer_spans": {"attn.mla": 2.4, "moe.route": 0.1,
                           "moe.dispatch": 0.05, "moe.combine": 0.15,
                           "moe.experts": 1.0, "(none)": 2.0}}
    assert reader("moe.pad_pct.train")(rec) == 25.0
    assert reader("moe.glue_pct.train")(rec) == pytest.approx(5.0)
    assert reader("mla.attn_pct.train")(rec) == pytest.approx(40.0)
    bound = 3 * roofline.pass_bound_s(rec["grouped_products"], "bf16")
    assert reader("grouped_wgmma_roofline.train")(rec) == pytest.approx(
        100 * bound / 0.1)
    for name in ("moe.pad_pct.train", "moe.glue_pct.train",
                 "mla.attn_pct.train", "grouped_wgmma_roofline.train"):
        assert reader(name)({"kind": "train", "steps": 8}) is None


def test_the_bias_check():
    b0 = {"b": torch.zeros(4)}
    want = {"b": torch.tensor([1.0, -1.0, 1.0, -1.0])}
    assert train_moe.bias_gap(want, want, b0) == 0.0
    assert train_moe.bias_gap(b0, want, b0) == 1.0
    assert train_moe.bias_gap({"b": -want["b"]}, want, b0) == 2.0
    assert train_moe.bias_gap({"b": torch.tensor([float("nan")] * 4)},
                              want, b0) == math.inf


def test_the_cell_claims_the_train_metrics_and_its_own():
    bench = harness.manifest()
    cell = harness.load_cell(CELL, bench)
    assert cell.chips == 1 and cell.traffic["driver"] == "train_moe"
    assert {m["name"] for m in cell.end_to_end} == {"train_tokens_per_s",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "train_mfu_pct", "device.idle_pct.train",
        "grouped_wgmma_roofline.train", "moe.pad_pct.train",
        "moe.glue_pct.train", "mla.attn_pct.train"}
    assert set(cell.limits["checks"]) == {"loss", "grad_norm",
                                          "change_norm", "router_bias"}
    json.dumps(cell.limits)
