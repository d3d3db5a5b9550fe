"""The port's grouped GEMM and MoE block against the JAX package, on the CPU.

The same numpy inputs go through the JAX function and its counterpart in
``repro_torch``.  The JAX package runs as its own tests run it on the CPU:
the Pallas grouped kernel with ``interpret=True``, the model path through
``grouped_gemm_ref``.  The port's wrappers run their plain versions because
the tensors lie on the CPU; the CUDA kernel itself is tested on the card by
``tests/test_torch_cuda.py``.

Tolerances: bf16 rtol = atol = 2e-2 and f32 rtol 1e-5 / atol 1e-4, as
``tests/test_kernels.py`` holds the Pallas kernel (both sum in f32 and
round once; the order of the sum differs); ``grouped_matmul`` 1e-6
relative in f32 (the fold into C changes no sum); the MoE block's y and aux
rtol = atol = 1e-5 in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import gemm as jgemm
from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels.grouped_gemm import grouped_gemm_kernel
from repro.models.common import HOST_MESH as JHOST_MESH
from repro.models.common import split_params
from repro.models.moe import apply_moe as japply_moe
from repro.models.moe import init_moe as jinit_moe
from repro_torch import gemm
from repro_torch.configs import get_config
from repro_torch.core.tpu_model import TileConfig
from repro_torch.interop import operands_from_numpy
from repro_torch.kernels import grouped_gemm as G
from repro_torch.kernels import ops
from repro_torch.kernels.gemm import MAX_SMEM_BYTES
from repro_torch.models import moe


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _tol(dt):
    return (dict(rtol=2e-2, atol=2e-2) if dt == "bfloat16"
            else dict(rtol=1e-5, atol=1e-4))


@pytest.mark.parametrize("e,c,d,f,dt", [
    (4, 128, 256, 128, "float32"),
    (8, 256, 128, 256, "bfloat16"),
    (2, 128, 512, 384, "float32"),
])
def test_grouped_plain_matches_pallas_kernel(e, c, d, f, dt):
    xn, wn = _np((e, c, d), e + c), _np((e, d, f), d + f)
    want = grouped_gemm_kernel(jnp.array(xn, dt), jnp.array(wn, dt),
                               block_c=128, block_f=128, block_k=128,
                               interpret=True)
    x, w = operands_from_numpy(xn, wn, device="cpu", dtype=dt)
    got = G.grouped_gemm(x, w)
    assert got.dtype == x.dtype and got.shape == (e, c, f)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dt))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_grouped_plain_matches_ref_at_ragged_capacity(dt):
    xn, wn = _np((5, 24, 96), 1), _np((5, 96, 40), 2)
    want = jref.grouped_gemm_ref(jnp.array(xn, dt), jnp.array(wn, dt))
    x, w = operands_from_numpy(xn, wn, device="cpu", dtype=dt)
    got = ops.grouped_gemm(x, w)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dt))


def test_grouped_gemm_expert_isolation():
    """Each expert's output depends only on its own weights."""
    x, w = operands_from_numpy(_np((4, 128, 128), 3), _np((4, 128, 128), 4),
                               device="cpu")
    w2 = w.clone()
    w2[2] = 0.0
    y1, y2 = G.grouped_gemm(x, w), G.grouped_gemm(x, w2)
    assert torch.all(y2[2] == 0)
    torch.testing.assert_close(y1[[0, 1, 3]], y2[[0, 1, 3]])


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_grouped_matmul_folds_leading_dims_into_capacity(lead):
    e, c, d, f = 5, 8, 48, 40
    xn = _np(lead + (e, c, d), 5)
    wn = _np((e, d, f), 6)
    want = jgemm.grouped_matmul(jnp.array(xn), jnp.array(wn))
    got = gemm.grouped_matmul(torch.from_numpy(xn), torch.from_numpy(wn))
    assert tuple(got.shape) == lead + (e, c, f)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_cpu_tensors_do_not_count_as_launches():
    G.reset_launch_counts()
    x = torch.randn(3, 16, 32)
    w = torch.randn(3, 32, 24)
    G.grouped_gemm(x, w)
    gemm.grouped_matmul(x[None], w)
    assert G.LAUNCHES == {"grouped_gemm": 0}


def test_grouped_tile_fits_hopper_shared_memory():
    """bc follows the capacity, bf and bk the route: bf16's wgmma tile is
    64 F columns by 64 deep, f32's CUDA-core tile 128 by 128; the JAX
    default tile would not fit a Hopper block's shared memory and is
    refused."""
    assert str(G.grouped_tile(32, torch.bfloat16)) == "32x64x64:k_inner"
    assert str(G.grouped_tile(24, torch.bfloat16)) == "32x64x64:k_inner"
    assert str(G.grouped_tile(8, torch.float32)) == "8x128x128:k_inner"
    assert str(G.grouped_tile(512, torch.float32)) == "128x128x128:k_inner"
    for c in (8, 24, 32, 128, 1024):
        for dt, s in ((torch.bfloat16, 2), (torch.float32, 4)):
            t = G.grouped_tile(c, dt)
            assert (t.bm * t.bk + t.bk * t.bn) * s <= 131072 < MAX_SMEM_BYTES
        cfg = G.check_tile(G.grouped_tile(c, torch.bfloat16), torch.bfloat16)
        assert cfg.smem_bytes <= MAX_SMEM_BYTES
    x = torch.zeros(2, 128, 512, dtype=torch.bfloat16)
    w = torch.zeros(2, 512, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        G.grouped_gemm(x, w, tile=TileConfig(128, 128, 512))


def test_grouped_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(2, 8, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="bf16 or f32"):
        G.grouped_gemm(x, torch.zeros(2, 16, 8, dtype=torch.int8))
    with pytest.raises(ValueError, match="pair"):
        G.grouped_gemm(torch.zeros(2, 8, 16), torch.zeros(3, 16, 8))
    with pytest.raises(ValueError, match="differ"):
        G.grouped_gemm(torch.zeros(2, 8, 16),
                       torch.zeros(2, 16, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="devices"):
        G.grouped_gemm(torch.zeros(2, 8, 16),
                       torch.zeros(2, 16, 8, device="meta"))


def _granite_smoke_f32():
    return (dataclasses.replace(get_config("granite-moe-3b-a800m",
                                           smoke=True),
                                compute_dtype="float32"),
            dataclasses.replace(jget_config("granite-moe-3b-a800m",
                                            smoke=True),
                                compute_dtype="float32"))


@pytest.mark.parametrize("batch,seq,seed", [(2, 16, 1), (4, 32, 1)])
def test_apply_moe_matches_jax_on_carried_weights(batch, seq, seed):
    """(4, 32) is tests/test_models.py's capacity-drop input: the capacity
    of 32 tokens x top-2 over 5 experts is 16 slots, and the routing drops
    tokens."""
    cfg, jcfg = _granite_smoke_f32()
    jp, _ = split_params(jinit_moe(jax.random.key(0), jcfg, JHOST_MESH,
                                   jnp.float32))
    xn = np.asarray(jax.random.normal(jax.random.key(seed),
                                      (batch, seq, cfg.d_model), jnp.float32))
    jy, jaux = japply_moe(jp, jnp.array(xn), jcfg)
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    y, aux = moe.apply_moe(p, torch.from_numpy(xn), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-5)
    if seq == 32:
        cap = moe._capacity(seq, cfg)
        logits = moe._masked_router_logits(p, torch.from_numpy(xn), cfg)
        idx = torch.topk(torch.softmax(logits, -1), cfg.experts_per_token,
                         dim=-1).indices.reshape(batch, -1)
        counts = torch.nn.functional.one_hot(idx, cfg.n_experts).sum(1)
        assert int(counts.max()) > cap        # tokens were dropped


def test_dropped_tokens_do_not_overwrite_slot_zero():
    """A scatter by assignment would let a dropped token's zeroed source
    overwrite its expert's slot 0; the port adds, like the JAX package."""
    cfg, _ = _granite_smoke_f32()
    cfg = dataclasses.replace(cfg, n_experts=2, experts_per_token=1,
                              capacity_factor=0.25)
    d = cfg.d_model
    p = {"router": torch.zeros(d, 2), "w_gate": torch.ones(2, d, 4),
         "w_up": torch.ones(2, d, 4), "w_down": torch.ones(2, 4, d)}
    p["router"][:, 0] = 1.0                  # every token to expert 0
    x = torch.rand(1, 64, d) + 0.1           # cap 8: 56 tokens drop
    y, _ = moe.apply_moe(p, x, cfg)
    assert moe._capacity(64, cfg) == 8
    assert torch.all(y[0, :8] != 0) and torch.all(y[0, 8:] == 0)
