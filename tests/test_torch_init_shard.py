"""``LM.init(shard=True)`` cuts each leaf as soon as it is drawn.

On gloo processes on the CPU, kimi-k2 smoke (FSDP on a (2, 2) mesh, its
experts over the model axis), granite smoke (5 experts padded to 8 on a
(1, 4) mesh), qwen2-7b smoke (6 heads padded to 8) and zamba2 smoke with
one Mamba2 head on a (1, 2) mesh: the leaf-by-leaf init equals
``shard()`` of the whole init from the same generator, bit for bit.  And
kimi-k2-1t-a32b at full width (two of its 61 blocks) as rank 0 of the
16x16 production mesh under ``FakeTensorMode``: no tensor made during the
init is larger than the larger of one expert's leaf in f32 (7168 x 2048
x 4 B) and the largest non-expert leaf in f32 (the 163,840 x 7,168
embedding), and the rank's shards hold the bytes its spec tree gives.
The expert stacks are drawn one expert at a time, whole init or not, so
the generator's draws are the same either way.
"""
import pytest
import torch

import _torch_dist as W
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.common import HOST_MESH
from repro_torch.models.model import LM


#: (mesh, its cases: (arch, config overrides, FSDP)); a group of ranks
#: builds one mesh
GROUPS = {(2, 2): [("kimi-k2-1t-a32b", {}, True)],
          (1, 4): [("granite-moe-3b-a800m", {}, False),
                   ("qwen2-7b", {}, True)],
          (1, 2): [("zamba2-1.2b", {"ssm_head_dim": 128}, False)]}


@pytest.mark.parametrize("mesh", list(GROUPS))
def test_the_leaf_by_leaf_init_equals_the_cut_whole_init(tmp_path, mesh):
    W.run_group(W.init_shard_cases, mesh[0] * mesh[1], tmp_path,
                [(arch, kw, mesh, fsdp) for arch, kw, fsdp in GROUPS[mesh]])


def test_the_expert_stack_is_drawn_one_expert_at_a_time():
    cfg = get_config("kimi-k2-1t-a32b", smoke=True)
    gen = torch.Generator().manual_seed(7)
    p = moe.init_moe(gen, cfg, HOST_MESH, torch.float32, "cpu")
    again = torch.Generator().manual_seed(7)
    d, f = cfg.d_model, cfg.moe_d_ff
    torch.randn((d, cfg.n_experts), generator=again)         # the router
    for e in range(cfg.n_experts):
        want = torch.randn((d, f), generator=again) * d ** -0.5
        assert torch.equal(p["w_gate"][e], want)


def test_the_whole_init_on_meta_keeps_its_shapes():
    cfg = get_config("granite-moe-3b-a800m", smoke=True)
    with torch.device("meta"):
        meta = LM(cfg, device="meta").init(torch.Generator())
    real = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    for (a, b) in zip(W._flat(meta).values(), W._flat(real).values(),
                      strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_kimi_k2_init_under_a_fake_16x16_rank_stays_within_one_leaf():
    got = W.run_alone(W.kimi_init_peak, 2, deadline=300.0)
    expert = 7168 * 2048 * 4
    embedding = 163840 * 7168 * 4
    assert (got["expert"], got["other"]) == (expert, embedding)
    bound = max(expert, embedding)
    assert got["largest"] <= bound, got
    assert got["shard_bytes"] == got["spec_bytes"], got
