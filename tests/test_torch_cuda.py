"""The CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU.  The module imports no JAX, so it also runs on a card machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: int8 exact; f32 rtol 1e-5 / atol 1e-4; bf16 k-inner 2e-2;
bf16 k-outer one bf16 ulp of the running |C| per pass.
"""
import numpy as np
import pytest
import torch

from repro_torch import gemm, measure
from repro_torch.core.tpu_model import GridOrder, TileConfig
from repro_torch.interop import operands_from_numpy
from repro_torch.kernels import gemm as K

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode "
                    "(their plain versions are tested on the CPU)")


def _operands(m, n, k, dt, seed):
    rng = np.random.default_rng(seed)
    if dt == "int8":
        a = rng.integers(-100, 100, size=(m, k)).astype(np.int8)
        b = rng.integers(-100, 100, size=(k, n)).astype(np.int8)
    else:
        a = rng.normal(size=(m, k)).astype(np.float32)
        b = rng.normal(size=(k, n)).astype(np.float32)
    return operands_from_numpy(a, b, device="cuda", dtype=dt)


def _streamed_ulp(a, b, c, bk):
    """One bf16 ulp of the largest |C| each element holds over the passes."""
    peak = c.float().abs()
    acc = c
    for k0 in range(0, a.shape[1], bk):
        acc = (acc.float() + a[:, k0:k0 + bk].float()
               @ b[k0:k0 + bk].float()).to(c.dtype)
        peak = torch.maximum(peak, acc.float().abs())
    return torch.exp2(torch.floor(torch.log2(peak.clamp_min(2.0 ** -126)))
                      - 7)


@pytest.mark.parametrize("dt", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("tile", [(64, 128, 128), (128, 128, 128),
                                  (32, 256, 128), (8, 8, 128)])
def test_kernels_match_plain_versions(dt, tile):
    m, n, k = 300, 520, 390
    ta, tb = _operands(m, n, k, dt, sum(tile))
    ti, to = TileConfig(*tile), TileConfig(*tile, GridOrder.K_OUTER)
    c0 = torch.zeros((m, n), dtype=K.out_dtype(ta.dtype), device="cuda")
    before = dict(K.LAUNCHES)
    got_i = K.gemm_k_inner(ta, tb, tile=ti)
    got_o = K.gemm_k_outer(ta, tb, c0, tile=to)
    torch.cuda.synchronize()
    passes = -(-k // tile[2])
    assert K.LAUNCHES["gemm_k_inner"] == before["gemm_k_inner"] + 1
    assert K.LAUNCHES["gemm_k_outer"] == before["gemm_k_outer"] + passes
    assert torch.equal(c0, torch.zeros_like(c0))      # caller's C untouched
    want_i = K.gemm_k_inner_plain(ta, tb)
    want_o = K.gemm_k_outer_plain(ta, tb, c0, bk=tile[2])
    if dt == "int8":
        assert torch.equal(got_i, want_i) and torch.equal(got_o, want_o)
    elif dt == "f32":
        torch.testing.assert_close(got_i, want_i, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(got_o, want_o, rtol=1e-5, atol=1e-4)
    else:
        torch.testing.assert_close(got_i.float(), want_i.float(), rtol=2e-2,
                                   atol=2e-2)
        tol = passes * _streamed_ulp(ta, tb, c0, tile[2])
        assert bool(((got_o.float() - want_o.float()).abs() <= tol).all())


def test_k_outer_streaming_costs_precision_in_bf16():
    ta, tb = _operands(128, 256, 512, "bf16", 3)
    exact = ta.double() @ tb.double()
    inner = K.gemm_k_inner(ta, tb, tile=TileConfig(64, 128, 64))
    outer = K.gemm_k_outer(ta, tb, torch.zeros(128, 256, dtype=torch.bfloat16,
                                               device="cuda"),
                           tile=TileConfig(64, 128, 64, GridOrder.K_OUTER))
    err_inner = (inner.double() - exact).abs().max().item()
    err_outer = (outer.double() - exact).abs().max().item()
    assert err_outer > 2 * err_inner


def test_planned_matmul_launches_the_kernel_and_the_harness_times_it():
    x = torch.randn(2, 96, 200, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(200, 72, device="cuda", dtype=torch.bfloat16)
    before = K.LAUNCHES["gemm_k_inner"]
    out = gemm.matmul(x, w)
    torch.cuda.synchronize()
    assert K.LAUNCHES["gemm_k_inner"] == before + 1
    assert out.shape == (2, 96, 72) and out.device.type == "cuda"
    torch.testing.assert_close(out.float(), x.float() @ w.float(), rtol=2e-2,
                               atol=2e-2)
    plan = gemm.plan((512, 512, 512), backend="cuda", machine="h100",
                     dtype="bf16")
    t = measure.get_harness("cuda").measure(plan, timing={"warmup": 1,
                                                          "rounds": 2})
    assert 0 < t.seconds < 1.0


def test_wrapper_rejects_c_in_another_dtype_on_the_card():
    ta, tb = _operands(64, 64, 128, "bf16", 0)
    with pytest.raises(ValueError, match="streams C"):
        K.gemm_k_outer(ta, tb, torch.zeros(64, 64, device="cuda"),
                       tile=TileConfig(64, 64, 128, GridOrder.K_OUTER))
