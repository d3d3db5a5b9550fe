"""The CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU.  The module imports no JAX, so it also runs on a card machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: int8 exact; f32 rtol 1e-5 / atol 1e-4; bf16 k-inner and
grouped 2e-2; bf16 k-outer one bf16 ulp of the running |C| per pass.
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


# ---------------------------------------------------------------------------
# Grouped (per-expert) GEMM
# ---------------------------------------------------------------------------

#: granite-moe-3b-a800m's expert products: decode with max_batch 4
#: (C = 4 x 8) and one request's prefill at bucket 32 (C = 8), the shapes
#: the served run launches; a prefill at bucket 512 (C = 128); a ragged C
GROUPED_SHAPES = [(40, 32, 1536, 512), (40, 32, 512, 1536),
                  (40, 8, 1536, 512), (40, 8, 512, 1536),
                  (40, 128, 1536, 512), (40, 128, 512, 1536),
                  (40, 24, 1536, 512), (3, 24, 200, 72)]


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("e,c,d,f", GROUPED_SHAPES)
def test_grouped_kernel_matches_plain_version(e, c, d, f, dt):
    from repro_torch.kernels import grouped_gemm as G

    rng = np.random.default_rng(e + c + d + f)
    # weights at the model's init scale (dense_init: std D^-1/2), so the
    # outputs are O(1) as when served
    x, w = operands_from_numpy(
        rng.normal(size=(e, c, d)).astype(np.float32),
        (rng.normal(size=(e, d, f)) * d ** -0.5).astype(np.float32),
        device="cuda", dtype=dt)
    before = G.LAUNCHES["grouped_gemm"]
    got = G.grouped_gemm(x, w)
    torch.cuda.synchronize()
    assert G.LAUNCHES["grouped_gemm"] == before + 1
    want = G.grouped_gemm_plain(x, w)
    assert got.dtype == x.dtype and got.shape == want.shape
    tol = (dict(rtol=2e-2, atol=2e-2) if dt == "bf16"
           else dict(rtol=1e-5, atol=1e-4))
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("first", ["gemm", "grouped"])
def test_gemm_and_grouped_libraries_each_configure_their_kernel(first):
    """Both libraries compile the same tile kernel from ``tile_gemm.cuh``;
    each copy must get its own shared-memory attribute, whichever library
    launches a register tile first (81,920 B here, over the 48 KB default)."""
    from repro_torch.kernels import grouped_gemm as G

    tile = TileConfig(32, 128, 256) if first == "gemm" else \
        TileConfig(32, 64, 512)
    x = torch.randn(3, 32, 520, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(3, 520, 200, device="cuda", dtype=torch.bfloat16)
    calls = [lambda: G.grouped_gemm(x, w, tile=tile),
             lambda: K.gemm_k_inner(x[0], w[0], tile=tile)]
    if first == "gemm":
        calls.reverse()
    outs = [call() for call in calls]
    torch.cuda.synchronize()
    got_g, got_k = outs if first == "grouped" else outs[::-1]
    tol = dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got_g.float(),
                               G.grouped_gemm_plain(x, w).float(), **tol)
    torch.testing.assert_close(got_k.float(),
                               K.gemm_k_inner_plain(x[0], w[0]).float(), **tol)


def test_grouped_kernel_refuses_a_tile_over_the_shared_memory_limit():
    from repro_torch.kernels import grouped_gemm as G

    x = torch.zeros(2, 128, 512, dtype=torch.bfloat16, device="cuda")
    w = torch.zeros(2, 512, 128, dtype=torch.bfloat16, device="cuda")
    before = G.LAUNCHES["grouped_gemm"]
    with pytest.raises(ValueError, match="shared memory"):
        G.grouped_gemm(x, w, tile=TileConfig(128, 128, 512))
    with pytest.raises(ValueError, match="contiguous"):
        G.grouped_gemm(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    assert G.LAUNCHES["grouped_gemm"] == before


def test_grouped_matmul_folds_the_batch_into_one_launch():
    from repro_torch.kernels import grouped_gemm as G

    x = torch.randn(4, 40, 8, 96, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(40, 96, 64, device="cuda", dtype=torch.bfloat16)
    before = G.LAUNCHES["grouped_gemm"]
    out = gemm.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert G.LAUNCHES["grouped_gemm"] == before + 1
    want = torch.einsum("becd,edf->becf", x.float(), w.float())
    torch.testing.assert_close(out.float(), want, rtol=2e-2, atol=2e-2)
