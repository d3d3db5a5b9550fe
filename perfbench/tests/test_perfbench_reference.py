"""The plain reference against hand-computed results at a tiny size, and
against the program's own model computed in float32 on the CPU."""
import os

import torch

from perfbench import harness
from perfbench.reference import dense_lm
from perfbench.reference import gemm as ref


def test_bf16_product_is_the_float32_sum():
    g = torch.Generator().manual_seed(0)
    a = torch.randn(5, 7, generator=g).bfloat16()
    b = torch.randn(7, 3, generator=g).bfloat16()
    want = [[sum(float(a[i, t]) * float(b[t, j]) for t in range(7))
             for j in range(3)] for i in range(5)]
    got = ref.product(a, b, "bf16", 0, 3)
    assert got.dtype == torch.float32
    assert torch.allclose(got, torch.tensor(want), rtol=1e-6, atol=1e-6)
    assert torch.equal(ref.product(a, b, "bf16", 1, 3), got[:, 1:3])


def test_int8_product_is_exact():
    g = torch.Generator().manual_seed(1)
    a = torch.randint(-127, 128, (4, 300), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (300, 6), generator=g, dtype=torch.int8)
    want = a.long() @ b.long()
    assert torch.equal(ref.product(a, b, "int8", 0, 6).long(), want)
    assert ref.compare(want.int(), a, b, "int8") == {"mismatches": 0.0}
    assert ref.compare(want.int() + 1, a, b, "int8")["mismatches"] == 24.0


def test_grouped_product_and_the_numbers():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 4, 8, generator=g).bfloat16()
    w = torch.randn(3, 8, 5, generator=g).bfloat16()
    want = torch.stack([x[e].float() @ w[e].float() for e in range(3)])
    assert torch.allclose(ref.product(x, w, "bf16", 0, 5), want)
    out = want.clone()
    got = ref.compare(out, x, w, "bf16")
    assert got == {"rel_l2": 0.0, "max_err": 0.0}
    out[1, 2, 3] += 1.0
    rms = float(want.square().mean().sqrt())
    assert abs(ref.compare(out, x, w, "bf16")["max_err"] - 1.0 / rms) < 1e-5


def test_control_rounds_to_the_lower_precision():
    g = torch.Generator().manual_seed(3)
    a = torch.randn(64, 256, generator=g).bfloat16()
    b = (torch.randn(256, 64, generator=g) / 16).bfloat16()
    got = ref.compare(ref.control_output(a, b, "bf16"), a, b, "bf16")
    assert 0.01 < got["rel_l2"] < 0.1
    ai = torch.randint(-127, 128, (8, 64), generator=g, dtype=torch.int8)
    bi = torch.randint(-127, 128, (64, 8), generator=g, dtype=torch.int8)
    assert ref.compare(ref.control_output(ai, bi, "int8"), ai, bi,
                       "int8")["mismatches"] > 0


def tiny_arch():
    cfg = harness.load_json(os.path.join(harness.HERE, "configs",
                                         "qwen2-1.5b.json"))
    cfg.update(hidden_size=32, intermediate_size=48, num_attention_heads=4,
               num_key_value_heads=2, num_hidden_layers=2, vocab_size=300)
    cfg["derived"] = dict(cfg["derived"], head_dim=8)
    return cfg, dense_lm.arch_of(cfg)


def test_reference_loss_is_the_programs_model_in_float32():
    """The reference's loss equals the program's LM.loss_fn with float32
    parameters and compute, on the same parameters and tokens."""
    import dataclasses
    from perfbench.drivers import train
    from repro_torch.models.model import LM

    cfg, a = tiny_arch()
    dev = torch.device("cpu")
    _, views = dense_lm.make_params(a, 5, dev)
    with torch.no_grad():     # biases the init leaves at zero
        for n, t in views.items():
            if n.split(".")[-1] in ("bq", "bk", "bv", "norm1", "norm2"):
                t.add_(0.1 * torch.randn(t.shape))
    mcfg = dataclasses.replace(train.model_config(cfg),
                               compute_dtype="float32")
    lm = LM(mcfg, device=dev)
    params = train.program_tree(lm, views, train.program_paths(a))
    tokens = torch.randint(0, a["vocab"], (2, 9), generator=torch.Generator()
                           .manual_seed(6))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    with torch.no_grad():
        want = float(lm.loss_fn(params, batch, remat="none")[0])
        got = sum(float(dense_lm.row_loss_sum(views, a, batch["tokens"][r],
                                              batch["labels"][r], 1e-4))
                  for r in range(2)) / batch["tokens"].numel()
    assert abs(got - want) < 1e-5 * abs(want)
