"""The port's spec trees and sharding rules against the JAX package's, on
the CPU, in one process (no process group).

For every config at the 16x16 and 2x16x16 production sizes (``fsdp`` from
``default_parallel``) the parameter, opt-state, error-buffer and cache spec
trees (and the padded global shapes) equal the JAX package's
``abstract_train_state`` / ``abstract_cache`` ones, taken with
``jax.eval_shape`` (no devices); ``batch_specs``, ``default_parallel``,
``serve_plan``, ``quantized_specs``, ``head_layout`` and
``padded_experts`` equal the JAX package's; the padding itself equals the
JAX package's padded init, carried across; the padded forward equals the
unpadded one on one process (qwen2-7b smoke: 6 heads padded to 8; granite
smoke: 5 experts padded to 8).  The import rules of the mesh modules are
held in a fresh interpreter.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models.common import MeshInfo as JMeshInfo
from repro.models.common import split_params
from repro.models.model import LM as JLM
from repro.runtime import quantized as jquantized
from repro.runtime import serve_lib as jserve_lib
from repro.runtime import sharding as jsharding
from repro.runtime import train_lib as jtrain_lib
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES, ParallelConfig, TrainConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.common import (HOST_MESH, MeshInfo, tree_leaves,
                                       tree_paths)
from repro_torch.models.model import LM
from repro_torch.runtime import quantized, serve_lib, sharding
from repro_torch.runtime.train_lib import (abstract_train_state,
                                           stack_periods, stack_spec_periods)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MESHES = {"16x16": dict(data=16, model=16),
          "2x16x16": dict(data=32, model=16, data_axes=("pod", "data"))}


def _jspecs(tree):
    """A JAX spec tree with every PartitionSpec as a tuple."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


def _meshes(arch, mesh):
    fsdp = sharding.default_parallel(arch).fsdp
    return (MeshInfo(**MESHES[mesh], fsdp=fsdp),
            JMeshInfo(**MESHES[mesh], fsdp=fsdp))


def _shapes(values):
    return [tuple(x.shape) for x in tree_leaves(values)]


def _by_path(tree):
    """{``keystr`` path: shape} of a port tree (lists index by position)."""
    return {"".join(f"[{k!r}]" for k in path): tuple(v.shape)
            for path, v in tree_paths(tree)}


def _jby_path(tree):
    return {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_state_specs_equal_the_jax_package(arch, mesh):
    minfo, jminfo = _meshes(arch, mesh)
    jlm = JLM(jget_config(arch), jminfo)
    jv, jspecs, _, jospecs = jtrain_lib.abstract_train_state(
        jlm, JTrainConfig(), jax.random.key(0))
    lm = LM(get_config(arch), minfo, device="cpu")
    values, specs, opt, ospecs = abstract_train_state(
        lm, TrainConfig(), ParallelConfig(grad_compression="int8_ef"))
    assert stack_spec_periods(specs) == _jspecs(jspecs)
    assert {k: stack_spec_periods(v) if k != "step" else v
            for k, v in ospecs.items()} == {**_jspecs(jospecs),
                                            "err": _jspecs(jspecs)}
    # the padded global shapes, leaf for leaf in the JAX package's order
    stacked = stack_periods(values)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, _jspecs(jspecs),
                                           is_leaf=lambda x: isinstance(
                                               x, tuple))) \
        == jax.tree.structure(jax.tree.map(lambda _: 0, jv))
    assert _by_path(stacked) == _jby_path(jv)
    assert _shapes(opt["err"]) == _shapes(values)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_jax_package(arch, mesh):
    minfo, jminfo = _meshes(arch, mesh)
    jlm = JLM(jget_config(arch), jminfo)
    lm = LM(get_config(arch), minfo, device="cpu")
    for name in ("decode_32k", "long_500k"):
        shape = SHAPES[name]
        plan = serve_lib.serve_plan(lm.cfg, shape, minfo)
        assert plan == jserve_lib.serve_plan(jlm.cfg, JSHAPES[name], jminfo)
        jvals, jspecs = jserve_lib.abstract_cache(
            jlm, shape.global_batch, 64, **plan)
        vals, specs = serve_lib.abstract_cache(lm, shape.global_batch, 64,
                                               **plan)
        assert stack_spec_periods(specs) == _jspecs(jspecs)
        assert _by_path(stack_periods(vals)) == _jby_path(jvals)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_specs_and_defaults_equal_the_jax_package(mesh):
    for arch in ARCH_IDS:
        minfo, jminfo = _meshes(arch, mesh)
        assert dataclasses.asdict(sharding.default_parallel(arch)) == \
            dataclasses.asdict(jsharding.default_parallel(arch))
        for name, shape in SHAPES.items():
            got = sharding.batch_specs(get_config(arch), shape, minfo)
            want = jsharding.batch_specs(jget_config(arch), JSHAPES[name],
                                         jminfo)
            assert got == _jspecs(want), (arch, name)
    minfo = MeshInfo(data=16, model=16)
    assert sharding.batch_specs(get_config("zamba2-1.2b"),
                                SHAPES["long_500k"], minfo)["token"] == \
        (None, None)                   # batch 1: replicated (SP instead)


def test_quantized_specs_equal_the_jax_package():
    cfg, jcfg = get_config("qwen2-7b"), jget_config("qwen2-7b")
    minfo, jminfo = MeshInfo(16, 16), JMeshInfo(16, 16)
    jv, jspecs, _, _ = jtrain_lib.abstract_train_state(
        JLM(jcfg, jminfo), JTrainConfig(), jax.random.key(0))
    values, specs, _, _ = abstract_train_state(LM(cfg, minfo, device="cpu"),
                                               TrainConfig())
    got = quantized.quantized_specs(stack_periods(values),
                                    stack_spec_periods(specs))
    want = jquantized.quantized_specs(jv, jspecs)
    flat = {"".join(f"[{k!r}]" for k in path): v
            for path, v in tree_paths(got)}
    jflat = dict((jax.tree_util.keystr(p), v) for p, v in
                 jax.tree_util.tree_leaves_with_path(
                     want, is_leaf=lambda x: isinstance(
                         x, (jquantized.QuantizedTensor, P))))
    assert flat.keys() == jflat.keys()
    for key, v in flat.items():
        j = jflat[key]
        if isinstance(v, quantized.QuantizedTensor):
            assert (v.q, v.scale) == (tuple(j.q), tuple(j.scale)), key
        else:
            assert v == tuple(j), key


@pytest.mark.parametrize("model", [1, 2, 4, 6, 8, 16])
def test_head_and_expert_layouts_equal_the_jax_package(model):
    for arch in ARCH_IDS:
        for smoke in (False, True):
            cfg, jcfg = get_config(arch, smoke), jget_config(arch, smoke)
            minfo, jminfo = MeshInfo(model=model), JMeshInfo(model=model)
            assert attn.head_layout(cfg, minfo) == \
                jattn.head_layout(jcfg, jminfo)
            if cfg.n_experts:
                assert moe.padded_experts(cfg, minfo) == \
                    jmoe.padded_experts(jcfg, jminfo)


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, dtype=np.float32), tree)


def test_padding_equals_the_jax_packages_padded_init():
    """pad_q / pad_kv / pad_e applied to the JAX package's logical weights
    give its padded init exactly (its draws do not depend on the mesh)."""
    mesh, jmesh = MeshInfo(data=2, model=4), JMeshInfo(data=2, model=4)
    cfg, jcfg = get_config("qwen2-7b", True), jget_config("qwen2-7b", True)
    jcfg = dataclasses.replace(jcfg, qkv_bias=True)
    cfg = dataclasses.replace(cfg, qkv_bias=True)
    key = jax.random.key(3)
    host = _np(split_params(jattn.init_attention(key, jcfg,
                                                 JMeshInfo(), jnp.float32))[0])
    padded = _np(split_params(jattn.init_attention(key, jcfg, jmesh,
                                                   jnp.float32))[0])
    assert padded["wq"].shape[1] == 8 and host["wq"].shape[1] == 6
    for name, pad, ax in (("wq", attn.pad_q, 1), ("wk", attn.pad_kv, 1),
                          ("wv", attn.pad_kv, 1), ("wo", attn.pad_q, 0)):
        got = pad(torch.from_numpy(host[name]), cfg, mesh, ax).numpy()
        np.testing.assert_array_equal(got, padded[name], err_msg=name)
    cfg, jcfg = (get_config("granite-moe-3b-a800m", True),
                 jget_config("granite-moe-3b-a800m", True))
    host = _np(split_params(jmoe.init_moe(key, jcfg, JMeshInfo(),
                                          jnp.float32))[0])
    padded = _np(split_params(jmoe.init_moe(key, jcfg, jmesh,
                                            jnp.float32))[0])
    assert padded["w_up"].shape[0] == 8 and host["w_up"].shape[0] == 5
    for name, ax in (("router", 1), ("w_gate", 0), ("w_up", 0),
                     ("w_down", 0)):
        got = moe.pad_e(torch.from_numpy(host[name]), cfg, mesh, ax).numpy()
        np.testing.assert_array_equal(got, padded[name], err_msg=name)


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32",
                               kv_cache_dtype="float32")


def test_padded_heads_forward_equals_the_unpadded_one():
    """qwen2-7b smoke on a 4-way model axis: 6 query heads padded to 8
    (per KV group), the JAX package's padded init carried across; the
    forward on one process (no mesh) equals the unpadded model's, and the
    padded heads' weights are zero."""
    cfg = _f32(get_config("qwen2-7b", smoke=True))
    jcfg = _f32(jget_config("qwen2-7b", smoke=True))
    mesh, jmesh = MeshInfo(data=1, model=4), JMeshInfo(data=1, model=4)
    key = jax.random.key(5)
    padded = LM(cfg, mesh, device="cpu")
    interop.load_jax_params(padded, _np(split_params(JLM(jcfg, jmesh).init(
        key))[0]))
    host = LM(cfg, HOST_MESH, device="cpu")
    interop.load_jax_params(host, _np(split_params(JLM(jcfg, JMeshInfo())
                                                   .init(key))[0]))
    wq = padded.values()["stack"][0]["b0_attn"]["attn"]["wq"]
    assert wq.shape[1] == 8
    assert not wq[:, [3, 7]].any()               # one zero head per group
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)))
    batch = {"tokens": tokens, "labels": tokens}
    with torch.no_grad():
        lp, _ = padded.prefill(padded.values(), {"tokens": tokens})
        lh, _ = host.prefill(host.values(), {"tokens": tokens})
        torch.testing.assert_close(lp, lh, rtol=1e-5, atol=1e-5)
        loss_p, _ = padded.loss_fn(padded.values(), batch)
        loss_h, _ = host.loss_fn(host.values(), batch)
    torch.testing.assert_close(loss_p, loss_h, rtol=1e-5, atol=1e-5)


def test_padded_experts_forward_equals_the_unpadded_one():
    """granite smoke on a 4-way model axis: 5 experts padded to 8 (dead
    experts masked in the router), capacity_factor 64 so that no token
    drops; ``apply_moe`` on one process equals the unpadded block."""
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m", True),
                              capacity_factor=64.0)
    jcfg = dataclasses.replace(jget_config("granite-moe-3b-a800m", True),
                               capacity_factor=64.0)
    mesh, jmesh = MeshInfo(data=2, model=4), JMeshInfo(data=2, model=4)
    key = jax.random.key(7)

    def params(jm):
        v = _np(split_params(jmoe.init_moe(key, jcfg, jm, jnp.float32))[0])
        return {k: torch.from_numpy(a) for k, a in v.items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    y_pad, aux_pad = moe.apply_moe(params(jmesh), x, cfg, mesh)
    y_host, aux_host = moe.apply_moe(params(JMeshInfo()), x, cfg, None)
    torch.testing.assert_close(y_pad, y_host, rtol=1e-5, atol=1e-5)
    # the JAX package's aux counts the padded expert count in its scale
    jy, _ = jmoe.apply_moe(_np(split_params(jmoe.init_moe(
        key, jcfg, JMeshInfo(), jnp.float32))[0]), jnp.asarray(x.numpy()),
        jcfg, None)
    np.testing.assert_allclose(y_host.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert torch.isfinite(aux_pad) and torch.isfinite(aux_host)


def test_apply_moe_ep_refuses_without_an_ambient_mesh():
    cfg = get_config("kimi-k2-1t-a32b", smoke=True)
    mesh = MeshInfo(data=1, model=2)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, mesh,
                     torch.float32, "cpu")
    with pytest.raises(RuntimeError, match="needs an ambient mesh"):
        moe.apply_moe_ep(p, torch.zeros(1, 4, cfg.d_model), cfg, mesh)


def test_importing_the_mesh_modules_creates_no_group_and_touches_no_card():
    code = (
        "import torch, torch.distributed as dist\n"
        "import repro_torch.launch.mesh, repro_torch.runtime.sharding\n"
        "import repro_torch.runtime.pipeline_parallel\n"
        "assert not dist.is_initialized()\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_shardings_for_gives_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard

    class _Mesh:                        # the attribute shardings_for reads
        mesh_dim_names = ("pod", "data", "model")
    got = sharding.shardings_for(_Mesh(), {"w": (("pod", "data"), "model"),
                                           "b": (None,)})
    assert got == {"w": (Shard(0), Shard(0), Shard(1)),
                   "b": (Replicate(), Replicate(), Replicate())}


def test_the_ambient_mesh_is_per_thread_and_nests():
    """Two threads inside ``use_mesh`` blocks at once each see their own
    mesh, and a closed block restores the one around it."""
    import threading

    outer, seen = object(), {}
    barrier = threading.Barrier(2, timeout=30)

    def run(name):
        mesh = object()
        with sharding.use_mesh(mesh):
            barrier.wait()          # both blocks are open now
            seen[name] = sharding.ambient_mesh() is mesh
            barrier.wait()
        seen[name + " after"] = sharding.ambient_mesh() is None

    with sharding.use_mesh(outer):
        with sharding.use_mesh(None):
            assert sharding.ambient_mesh() is None
        assert sharding.ambient_mesh() is outer
        threads = [threading.Thread(target=run, args=(n,))
                   for n in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert sharding.ambient_mesh() is outer
    assert sharding.ambient_mesh() is None
    assert seen == {"a": True, "b": True, "a after": True, "b after": True}
