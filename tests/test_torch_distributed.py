"""The port's multi-device layer on gloo processes on the CPU.

Each test spawns one group of ranks (``_torch_dist.run_group``: spawn, a
``file://`` store under ``tmp_path``, a deadline of its own) whose workers
import only ``torch`` and ``repro_torch``.  The references are computed
here: the single-device port on the same carried weights (the JAX
package's init, as numpy), and that port in turn against the JAX package.
The JAX package's own sharded tests fail under jax 0.9.0 (ROADMAP queue
3), so they are no oracle: the sharded port is held to the single-device
baselines they compare to.  Tolerances are the JAX package's: f32 rtol =
atol = 1e-5, gradients 1e-5 relative L2 a leaf.

* the sharded forward (prefill logits, the data-averaged CE loss, one
  decode step's logits on a sharded cache) and the CE loss's gradients on
  ``(2, 2)`` and ``(1, 4)`` meshes, qwen2-7b smoke (6 heads: padded to 8
  with replicated KV on the 4-way axis), granite smoke (5 experts: padded
  to 6 and 8, the expert-parallel branch; its gradients are the EP test's),
  and on ``(2, 2)`` zamba2 smoke (Mamba2 heads and the shared block
  sharded) and xlstm smoke (mLSTM and sLSTM);
* an FSDP train step on ``(2, 2)``: the first step's synced gradients,
  three steps' losses and the parameters after them;
* ``apply_moe_ep`` == ``apply_moe`` (kimi-k2 smoke, capacity factor 64),
  forward and gradients; expert padding under the mesh; ``psum_compressed``
  on four ranks;
* a one-rank mesh: the FSDP + int8_ef step, prefill and decode equal the
  unsharded path bit for bit (the card's phase 16 (a) in miniature);
* a tensor-parallel step on ``(1, 2)`` and its collectives;
* on ``(2, 1)``, data parallel: a ``loss_mask`` leaving the ranks 3 and
  61 of their 64 tokens gives the global masked mean and its gradients,
  and two int8_ef steps in which one rank's gradients are about 1e-3 of
  the other's equal the single-device int8_ef steps;
* the sequence-sharded long decode on ``(2, 1)`` (zamba2 smoke, every
  cache leaf seeded): the unsharded decode's logits and cache.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_dist as W
from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.models.common import HOST_MESH as JHOST_MESH
from repro.models.common import MeshInfo as JMeshInfo
from repro.models.common import split_params
from repro.models.model import LM as JLM
from repro.optim import compression as jcompression
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.models import moe
from repro_torch.models.common import (HOST_MESH, MeshInfo, tree_leaves,
                                       tree_map, tree_paths)
from repro_torch.models.model import LM
from repro_torch.optim import dequantize_int8, init_opt_state, quantize_int8
from repro_torch.runtime import train_lib

RTOL = ATOL = 1e-5


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, compute_dtype="float32",
                               kv_cache_dtype="float32", **kw)


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, dtype=np.float32), tree)


def _jvalues(jcfg, jmesh, seed):
    return _np(split_params(JLM(jcfg, jmesh).init(jax.random.key(seed)))[0])


def _flat(tree):
    return {"/".join(map(str, p)): v.detach().numpy().copy()
            for p, v in tree_paths(tree)}


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


@functools.lru_cache(maxsize=None)
def _host_reference(arch, capacity_factor, seed):
    """Tokens, and the single-device port's prefill logits, CE loss and
    decode logits on the unpadded weights, the port held to the JAX
    package on the way (one call per arch: both meshes' tests read it)."""
    overrides = {"capacity_factor": capacity_factor} if capacity_factor \
        else {}
    cfg = _f32(get_config(arch, smoke=True), **overrides)
    jcfg = _f32(jget_config(arch, smoke=True), **overrides)
    tokens = _tokens(cfg, (4, 16), seed)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(tokens)}
    host = LM(cfg, HOST_MESH, device="cpu")
    interop.load_jax_params(host, _jvalues(jcfg, JHOST_MESH, seed))
    with torch.no_grad():
        logits, _ = host.prefill(host.values(), {"tokens": batch["tokens"]})
        _, m = host.loss_fn(host.values(), batch)
        decoded, _ = host.decode_step(host.values(), host.init_cache(4, 8),
                                      batch["tokens"][:, :1], 0)
    jlm = JLM(jcfg, JHOST_MESH)
    jlogits, _ = jlm.prefill(_jvalues(jcfg, JHOST_MESH, seed),
                             {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    return tokens, logits.numpy(), m["ce_loss"].numpy(), decoded.numpy()


def _forward_case(arch, overrides, mesh, seed):
    """(arch, overrides, carried values for ``mesh``, then
    :func:`_host_reference`'s tokens and results, and the CE loss's
    gradients of the single-device port on the carried weights (None for
    a MoE arch: without a mesh its padded model would take the
    expert-parallel branch, which needs one))."""
    cfg = _f32(get_config(arch, smoke=True), **overrides)
    jcfg = _f32(jget_config(arch, smoke=True), **overrides)
    tokens, logits, loss, decoded = _host_reference(
        arch, overrides.get("capacity_factor"), seed)
    values = _jvalues(jcfg, JMeshInfo(*mesh), seed)
    grads = None
    if not cfg.n_experts:
        padded = LM(cfg, MeshInfo(*mesh), device="cpu")
        interop.load_jax_params(padded, values)
        params = padded.train_mode().values()
        _, m_pad = padded.loss_fn(params, {"tokens": torch.from_numpy(tokens),
                                           "labels": torch.from_numpy(tokens)})
        grads = dict(zip(_flat(params), (g.numpy() for g in torch.autograd
                                         .grad(m_pad["ce_loss"],
                                               tree_leaves(params)))))
    return (arch, overrides, values, tokens, logits, loss, decoded, grads)


#: the padding cases (qwen2-7b's heads, granite's experts) on both meshes;
#: the recurrent archs on the 2x2 one
FORWARD_ARCHS = {(2, 2): ("qwen2-7b", "granite-moe-3b-a800m", "zamba2-1.2b",
                          "xlstm-125m"),
                 (1, 4): ("qwen2-7b", "granite-moe-3b-a800m")}


def _forward_cases(mesh):
    seeds = {"qwen2-7b": 1, "granite-moe-3b-a800m": 2, "zamba2-1.2b": 3,
             "xlstm-125m": 4}
    return [_forward_case(arch, {"capacity_factor": 64.0}
                          if arch.startswith("granite") else {}, mesh,
                          seeds[arch])
            for arch in FORWARD_ARCHS[mesh]]


def test_sharded_forward_on_a_2x2_mesh(tmp_path):
    W.run_group(W.sharded_forward, 4, tmp_path, 2, 2, _forward_cases((2, 2)))


def test_sharded_forward_on_a_1x4_mesh_pads_heads_and_experts(tmp_path):
    W.run_group(W.sharded_forward, 4, tmp_path, 1, 4, _forward_cases((1, 4)))


def test_fsdp_train_step_on_a_2x2_mesh_equals_one_device(tmp_path):
    from repro.configs.base import ParallelConfig as JParallelConfig
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.data import make_batch as jmake_batch
    from repro.runtime import train_lib as jtrain_lib

    cfg = _f32(get_config("qwen2-7b", smoke=True))
    jcfg = _f32(jget_config("qwen2-7b", smoke=True))
    values = _jvalues(jcfg, JMeshInfo(2, 2, fsdp=True), 4)
    batches = [{k: np.asarray(v).astype(np.int64) for k, v in jmake_batch(
        jcfg, JShapeConfig("t", "train", 16, 4), i, seed=4).items()}
        for i in range(3)]
    tkw = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    lm = LM(cfg, HOST_MESH, device="cpu")
    interop.load_jax_params(lm, values)
    params = lm.train_mode().values()
    b0 = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    loss, _ = lm.loss_fn(params, b0)
    grads = dict(zip(_flat(params), (g.numpy() for g in torch.autograd.grad(
        loss, tree_leaves(params)))))
    tcfg = TrainConfig(**tkw)
    opt = init_opt_state(params, train_lib.make_adamw_config(cfg, tcfg))
    step = train_lib.make_train_step(lm, tcfg, ParallelConfig())
    losses = []
    for b in batches:
        params, opt, m = step(params, opt, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
        losses.append(float(m["loss"]))
    # the single-device port against the JAX package's step
    jlm = JLM(jcfg, JHOST_MESH)
    jstep = jax.jit(jtrain_lib.make_train_step(jlm, JTrainConfig(**tkw),
                                               JParallelConfig()))
    jp, _, jo, _ = jtrain_lib.init_train_state(jlm, JTrainConfig(**tkw),
                                               jax.random.key(4))
    for i, b in enumerate(batches):
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v, jnp.int32)
                                    for k, v in b.items()})
        np.testing.assert_allclose(losses[i], float(jm["loss"]), rtol=RTOL)
    W.run_group(W.fsdp_train, 4, tmp_path, 2, 2, values, batches, grads,
                losses, _flat(params))


def _ep_case():
    cfg = _f32(get_config("kimi-k2-1t-a32b", smoke=True),
               capacity_factor=64.0)
    jcfg = _f32(jget_config("kimi-k2-1t-a32b", smoke=True),
                capacity_factor=64.0)
    jv = _np(split_params(jmoe.init_moe(jax.random.key(0), jcfg,
                                        JMeshInfo(2, 2), jnp.float32))[0])
    x = np.random.default_rng(1).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True)
         for k, v in jv.items()}
    y, _ = moe.apply_moe(p, torch.from_numpy(x), cfg, None)
    grads = torch.autograd.grad(y.square().sum(), list(p.values()))
    jy, _ = jmoe.apply_moe(jv, jnp.asarray(x), jcfg, None)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    jg = jax.grad(lambda v: jnp.sum(jnp.square(
        jmoe.apply_moe(v, jnp.asarray(x), jcfg, None)[0])))(jv)
    for name, g in zip(p, grads):
        assert W._rel_l2(g.numpy(), jg[name]) <= 1e-5, name
    return (jv, x, y.detach().numpy(),
            {k: g.numpy() for k, g in zip(p, grads)})


def _pad_case():
    cfg = _f32(get_config("granite-moe-3b-a800m", smoke=True),
               capacity_factor=64.0)
    jcfg = _f32(jget_config("granite-moe-3b-a800m", smoke=True),
                capacity_factor=64.0)

    def values(jm):
        return _np(split_params(jmoe.init_moe(jax.random.key(7), jcfg, jm,
                                              jnp.float32))[0])
    x = np.random.default_rng(2).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    host = values(JMeshInfo())
    y, _ = moe.apply_moe({k: torch.from_numpy(v) for k, v in host.items()},
                         torch.from_numpy(x), cfg, None)
    jy, _ = jmoe.apply_moe(host, jnp.asarray(x), jcfg, None)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    return values(JMeshInfo(2, 2)), x, y.numpy()


def _psum_case():
    """Four ranks' gradients and error buffers; the expected sum (the
    ranks' int8 payloads at the mean scale) and each rank's new error."""
    rng = np.random.default_rng(3)
    shapes = {"w": (16, 8), "b": (8,), "s": (3, 4, 5)}
    grads = {k: rng.standard_normal((4,) + s).astype(np.float32)
             for k, s in shapes.items()}
    errs = {k: (rng.standard_normal((4,) + s) * 1e-3).astype(np.float32)
            for k, s in shapes.items()}
    want_sum, want_err = {}, {}
    for k in shapes:
        qs, ss, es = [], [], []
        for r in range(4):
            corrected = torch.from_numpy(grads[k][r]) \
                + torch.from_numpy(errs[k][r])
            q, s = quantize_int8(corrected)
            qs.append(q.to(torch.int32))
            ss.append(s)
            es.append((corrected - dequantize_int8(q, s)).numpy())
            # the round trip is the JAX package's
            (jq, js), je = jcompression.compress_tree(
                grads[k][r], errs[k][r])
            np.testing.assert_array_equal(np.asarray(jq), q.numpy())
            np.testing.assert_allclose(np.asarray(je), es[-1], rtol=1e-6,
                                       atol=1e-7)
        want_sum[k] = (sum(qs).float() * (sum(ss) / 4)).numpy()
        want_err[k] = np.stack(es)
    return grads, errs, want_sum, want_err


def test_moe_ep_padding_and_psum_compressed_on_a_2x2_mesh(tmp_path):
    W.run_group(W.moe_ep, 4, tmp_path, _ep_case(), _pad_case(),
                _psum_case())


def test_one_rank_mesh_is_the_unsharded_path_bit_for_bit(tmp_path):
    W.run_group(W.one_rank_bitwise, 1, tmp_path,
                ("qwen2-1.5b", "granite-moe-3b-a800m", "zamba2-1.2b"))


def test_tensor_parallel_step_and_its_collectives(tmp_path):
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.data import make_batch as jmake_batch

    cfg = _f32(get_config("qwen2-1.5b", smoke=True))
    jcfg = _f32(jget_config("qwen2-1.5b", smoke=True))
    values = _jvalues(jcfg, JHOST_MESH, 6)
    batch = {k: np.asarray(v).astype(np.int64) for k, v in jmake_batch(
        jcfg, JShapeConfig("t", "train", 16, 2), 0, seed=6).items()}
    lm = LM(cfg, HOST_MESH, device="cpu")
    interop.load_jax_params(lm, values)
    params = lm.train_mode().values()
    loss, _ = lm.loss_fn(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, remat="none")
    grads = dict(zip(_flat(params), (g.numpy() for g in torch.autograd.grad(
        loss, tree_leaves(params)))))
    jloss, _ = JLM(jcfg, JHOST_MESH).loss_fn(
        values, {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    W.run_group(W.tp_step_collectives, 2, tmp_path, values, batch,
                loss.detach().numpy(), grads)


def _dp_case(seed):
    """qwen2-1.5b smoke in f32: the carried values, a single-device port
    holding them, and 4 x 32 random tokens (rows 0-1 data rank 0's, rows
    2-3 rank 1's)."""
    cfg = _f32(get_config("qwen2-1.5b", smoke=True))
    jcfg = _f32(jget_config("qwen2-1.5b", smoke=True))
    values = _jvalues(jcfg, JHOST_MESH, seed)
    lm = LM(cfg, HOST_MESH, device="cpu")
    interop.load_jax_params(lm, values)
    return cfg, jcfg, values, lm, _tokens(cfg, (4, 32), seed)


def test_loss_mask_is_the_global_masked_mean_over_data_ranks(tmp_path):
    _, jcfg, values, lm, tokens = _dp_case(7)
    mask = np.zeros((4, 32), np.float32)
    mask[0, [3, 17, 30]] = 1.0                 # rank 0: 3 of its 64 tokens
    mask[2:].reshape(-1)[:61] = 1.0            # rank 1: 61 of 64
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
             "loss_mask": mask}
    params = lm.train_mode().values()
    _, m = lm.loss_fn(params, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, remat="none")
    grads = dict(zip(_flat(params), (g.numpy() for g in torch.autograd.grad(
        m["ce_loss"], tree_leaves(params)))))
    _, jm = JLM(jcfg, JHOST_MESH).loss_fn(
        values, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["ce_loss"]), float(jm["ce_loss"]),
                               rtol=RTOL)
    W.run_group(W.masked_dp, 2, tmp_path, values, batch,
                m["ce_loss"].detach().numpy(), grads)


def test_int8_ef_over_two_data_ranks_equals_one_device(tmp_path):
    cfg, jcfg, values, lm, tokens = _dp_case(8)
    rng = np.random.default_rng(8)
    mask = np.ones((4, 32), np.float32)
    mask[2:] = 1e-3                            # rank 1's gradients ~1e-3
    batches = [{"tokens": t, "labels": np.roll(t, -1, axis=1),
                "loss_mask": mask}
               for t in (tokens, rng.integers(0, cfg.vocab_size, (4, 32)))]
    tcfg = TrainConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    pcfg = ParallelConfig(grad_compression="int8_ef")
    params, _, opt, _ = train_lib._state(lm, lm.train_mode().values(), tcfg,
                                         pcfg)
    step = train_lib.make_train_step(lm, tcfg, pcfg)
    metrics = []
    for b in batches:
        params, opt, m = step(params, opt, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
        metrics.append(torch.stack([m["loss"], m["grad_norm"]]).numpy())
    # the single-device masked loss is the JAX package's
    _, jm = JLM(jcfg, JHOST_MESH).loss_fn(
        values, {k: jnp.asarray(v) for k, v in batches[0].items()})
    np.testing.assert_allclose(metrics[0][0], float(jm["ce_loss"]),
                               rtol=RTOL)
    W.run_group(W.int8_ef_dp, 2, tmp_path, values, batches, metrics,
                _flat(params))


def test_seq_sharded_decode_equals_the_unsharded_decode(tmp_path):
    """Positions 7 and 8 lie on both sides of the two ranks' boundary (at
    7 rank 1 holds no visible key), 15 is the last; the unsharded port
    is held to the JAX package's ``decode_step`` on the same weights and
    cache at the families' decode tolerance (rtol = atol = 1e-4)."""
    from repro.runtime import serve_lib as jserve_lib
    from repro_torch.runtime import serve_lib

    cfg = _f32(get_config("zamba2-1.2b", smoke=True))
    jcfg = _f32(jget_config("zamba2-1.2b", smoke=True))
    values = _jvalues(jcfg, JHOST_MESH, 9)
    lm = LM(cfg, HOST_MESH, device="cpu")
    interop.load_jax_params(lm, values)
    rng = np.random.default_rng(9)
    caches = lm.init_cache(1, 16)
    for t in tree_leaves(caches):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape)
                                 .astype(np.float32) * 0.5))
    seeded = tree_map(lambda t: t.numpy().copy(), caches)
    jlm = JLM(jcfg, JHOST_MESH)
    jc, _ = split_params(jlm.init_cache(1, 16))
    jc = jax.tree.map(lambda a, b: jnp.asarray(b.reshape(a.shape)), jc,
                      _np(train_lib.stack_periods(
                          tree_map(torch.clone, caches))))
    decode = serve_lib.make_decode_step(lm)
    jdecode = jserve_lib.make_decode_step(jlm)
    tok, steps, logits = 3, [], []
    with torch.no_grad():
        for pos in (7, 8, 15):
            steps.append((tok, pos))
            nxt, lg, caches = decode(lm.values(), caches,
                                     torch.tensor([[tok]]), pos)
            _, jl, jc = jdecode(values, jc, jnp.array([[tok]]),
                                jnp.array(pos))
            np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                       rtol=1e-4, atol=1e-4)
            logits.append(lg.numpy())
            tok = int(nxt[0, 0])
    W.run_group(W.seq_sharded_decode, 2, tmp_path, values, seeded, steps,
                logits, tree_map(lambda t: t.numpy(), caches))
