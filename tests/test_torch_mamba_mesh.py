"""Mamba2 on a model axis that divides d_inner but not the heads, on gloo
processes on the CPU.

The JAX package shards ``d_inner`` and the heads each by its own
``shard_if`` (``repro.models.ssm.init_mamba2``), so such an axis shards
the channels and leaves the heads, the head-wise weights and the state
``h`` whole.  zamba2 smoke (d_inner 128) with ``ssm_head_dim`` 128 (one
head) on a model axis of 2, and with 64 (two heads) on an axis of 4: the
spec trees and cache specs equal the JAX package's; on gloo ranks
(``_torch_dist.mamba_mesh``) the prefill, three decode steps after it and
the CE loss's gradients equal the single-device port's on the same
carried weights (f32: 1e-5 relative L2 for logits and caches, 1e-4 a leaf
for gradients), which is held to the JAX package's prefill here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dist as W
from repro.configs import get_config as jget_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models.common import MeshInfo as JMeshInfo
from repro.models.common import split_params
from repro.models.model import LM as JLM
from repro.runtime import serve_lib as jserve_lib
from repro.runtime import train_lib as jtrain_lib
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.models import ssm
from repro_torch.models.common import MeshInfo, tree_leaves, tree_paths
from repro_torch.models.model import LM
from repro_torch.runtime import serve_lib
from repro_torch.runtime.train_lib import (abstract_train_state,
                                           stack_periods, stack_spec_periods)

#: (ssm_head_dim, model axis): d_inner 128 divides the axis, the heads
#: (128 / head_dim) do not
CASES = [(128, 2), (64, 4)]


def _cfgs(head_dim):
    kw = dict(ssm_head_dim=head_dim, compute_dtype="float32",
              kv_cache_dtype="float32")
    return (dataclasses.replace(get_config("zamba2-1.2b", smoke=True), **kw),
            dataclasses.replace(jget_config("zamba2-1.2b", smoke=True), **kw))


def _jspecs(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


def _by_path(tree):
    """{``keystr`` path: shape} of a port tree (lists index by position)."""
    return {"".join(f"[{k!r}]" for k in path): tuple(v.shape)
            for path, v in tree_paths(tree)}


def _jby_path(tree):
    return {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _flat(tree):
    return {"/".join(map(str, p)): v.detach().numpy().copy()
            for p, v in tree_paths(tree)}


@pytest.mark.parametrize("head_dim,model", CASES)
def test_the_axis_shards_the_channels_and_keeps_the_heads(head_dim, model):
    cfg, _ = _cfgs(head_dim)
    minfo = MeshInfo(model=model)
    assert cfg.d_inner % model == 0 and cfg.ssm_heads % model
    assert ssm._tp_axes(cfg, minfo) == ("model", "model")
    specs = ssm.mamba2_specs(cfg, minfo)
    assert specs["w_x"] == (None, "model") and specs["w_dt"] == (None, None)
    assert ssm.mamba2_cache_specs(cfg, minfo) == {
        "h": ("data", None, None, None), "conv": ("data", None, "model")}
    # the heads dividing the axis: both shard, no channel gather
    assert ssm._tp_axes(cfg, MeshInfo(model=1)) == ("model", None)


@pytest.mark.parametrize("head_dim,model", CASES)
def test_spec_trees_equal_the_jax_package(head_dim, model):
    cfg, jcfg = _cfgs(head_dim)
    minfo, jminfo = MeshInfo(data=1, model=model), JMeshInfo(data=1,
                                                              model=model)
    jlm = JLM(jcfg, jminfo)
    _, jspecs, _, jospecs = jtrain_lib.abstract_train_state(
        jlm, JTrainConfig(), jax.random.key(0))
    lm = LM(cfg, minfo, device="cpu")
    values, specs, _, ospecs = abstract_train_state(
        lm, TrainConfig(), ParallelConfig())
    assert stack_spec_periods(specs) == _jspecs(jspecs)
    assert {k: stack_spec_periods(v) if k != "step" else v
            for k, v in ospecs.items()} == _jspecs(jospecs)
    jvals, jcspecs = jserve_lib.abstract_cache(jlm, 4, 64)
    vals, cspecs = serve_lib.abstract_cache(lm, 4, 64)
    assert stack_spec_periods(cspecs) == _jspecs(jcspecs)
    assert _by_path(stack_periods(vals)) == _jby_path(jvals)


def _reference(head_dim, model, seed):
    """Carried weights (the JAX package's init for the mesh, heads padded
    for it), tokens, and the single-device port's prefill, decode steps,
    caches and CE-loss gradients on them; the port's prefill held to the
    JAX package's on the way."""
    cfg, jcfg = _cfgs(head_dim)
    values = jax.tree.map(lambda x: np.asarray(x, np.float32), split_params(
        JLM(jcfg, JMeshInfo(model=model)).init(jax.random.key(seed)))[0])
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 24))
    lm = LM(cfg, MeshInfo(model=model), device="cpu")
    interop.load_jax_params(lm, values)
    params = lm.train_mode().values()
    toks = torch.from_numpy(tokens)
    with torch.no_grad():
        first, _ = lm.prefill(params, {"tokens": toks})
    fed = [first.argmax(-1, keepdim=True)]
    logits, steps, caches = W.mamba_prefill_decode(lm, params, toks, fed)
    for _ in range(2):                     # the greedy tokens, one by one
        fed.append(steps[-1].argmax(-1, keepdim=True))
        logits, steps, caches = W.mamba_prefill_decode(lm, params, toks, fed)
    jlogits, _ = JLM(jcfg, JMeshInfo(model=model)).prefill(
        values, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    _, m = lm.loss_fn(params, {"tokens": toks, "labels": toks})
    grads = torch.autograd.grad(m["ce_loss"], tree_leaves(params))
    want = {"logits": logits.numpy(), "steps": [s.numpy() for s in steps],
            "fed": [t.numpy() for t in fed], "cache": _flat(caches),
            "grads": dict(zip(_flat(params), (g.numpy() for g in grads)))}
    return values, tokens, want


@pytest.mark.parametrize("head_dim,model", CASES)
def test_prefill_decode_and_gradients_equal_one_device(tmp_path, head_dim,
                                                       model):
    values, tokens, want = _reference(head_dim, model, seed=11)
    W.run_group(W.mamba_mesh, model, tmp_path,
                {"ssm_head_dim": head_dim}, values, tokens, want)
