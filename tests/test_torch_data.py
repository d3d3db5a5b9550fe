"""The port's synthetic data stream, on the CPU: twins of
``tests/test_runtime.py``'s data tests (determinism and resume, disjoint
host shards, learnable structure) and the frontend batches' keys, shapes
and dtypes beside the JAX package's ``make_batch``.

The port draws from a ``torch.Generator`` seeded from ``(seed, step,
host_id)``, so its numbers differ from ``jax.random``'s; the contract
(a pure function of those three, the Zipf(1.1) marginal, the copy
process at p = 0.5, the batch layout) is what is held here.  Parity of
what the batches feed is held on carried batches (``test_torch_train.py``).
"""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import make_batch as jmake_batch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataIterator, make_batch


def test_data_deterministic_and_resumable():
    cfg = get_config("qwen2-1.5b", smoke=True)
    shape = ShapeConfig("t", "train", 32, 4)
    it1 = DataIterator(cfg, shape, seed=7)
    batches = [next(it1) for _ in range(5)]
    # resume from state at step 3
    it2 = DataIterator(cfg, shape, seed=0)
    it2.load_state_dict({"step": 3, "seed": 7})
    b3 = next(it2)
    assert torch.equal(b3["tokens"], batches[3]["tokens"])
    assert it2.state_dict() == {"step": 4, "seed": 7}
    assert torch.equal(make_batch(cfg, shape, 3, seed=7)["labels"],
                       batches[3]["labels"])
    assert not torch.equal(batches[3]["tokens"], batches[4]["tokens"])


def test_data_host_sharding_disjoint():
    cfg = get_config("qwen2-1.5b", smoke=True)
    shape = ShapeConfig("t", "train", 16, 8)
    b0 = make_batch(cfg, shape, step=0, seed=1, host_id=0, num_hosts=2)
    b1 = make_batch(cfg, shape, step=0, seed=1, host_id=1, num_hosts=2)
    assert b0["tokens"].shape == (4, 16)
    assert not torch.equal(b0["tokens"], b1["tokens"])


def test_data_has_learnable_structure():
    cfg = get_config("qwen2-1.5b", smoke=True)
    shape = ShapeConfig("t", "train", 256, 8)
    toks = make_batch(cfg, shape, step=0, seed=0)["tokens"].numpy()
    copies = (toks[:, 1:] == toks[:, :-1]).mean()
    assert 0.3 < copies < 0.7        # the copy-process signal


def test_labels_are_the_tokens_shifted_and_the_marginal_is_zipf():
    cfg = get_config("qwen2-1.5b")
    b = make_batch(cfg, ShapeConfig("t", "train", 512, 16), step=2, seed=3)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    toks = b["tokens"].numpy()
    assert toks.min() >= 0 and toks.max() < cfg.vocab_size
    # rank ~ u^(-1/1.1) - 1: P(rank 0) = 1 - 2^(-1.1) = 0.53 on a fresh
    # draw; copies keep the marginal
    assert 0.45 < (toks == 0).mean() < 0.61
    jt = np.asarray(jmake_batch(jget_config("qwen2-1.5b"),
                                JShapeConfig("t", "train", 512, 16),
                                step=2, seed=3)["tokens"])
    assert abs((toks == 0).mean() - (jt == 0).mean()) < 0.04
    assert abs((toks < 10).mean() - (jt < 10).mean()) < 0.04


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "musicgen-medium",
                                  "paligemma-3b"])
def test_frontend_batches_have_the_reference_keys_and_shapes(arch):
    cfg, jcfg = get_config(arch, smoke=True), jget_config(arch, smoke=True)
    shape = ShapeConfig("t", "train", 24, 2)
    got = make_batch(cfg, shape, step=1, seed=4)
    want = jmake_batch(jcfg, JShapeConfig("t", "train", 24, 2), step=1,
                       seed=4)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        floating = np.issubdtype(np.asarray(v).dtype, np.floating) or \
            str(v.dtype) == "bfloat16"
        assert got[k].is_floating_point() == floating, k
    for k in ("frames", "patches"):
        if k in got:
            assert got[k].dtype == getattr(torch, cfg.compute_dtype)
            assert 0.015 < got[k].float().std().item() < 0.025
            assert torch.equal(got[k], make_batch(cfg, shape, 1, 4)[k])
