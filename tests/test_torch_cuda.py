"""The CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU.  The module imports no JAX, so it also runs on a card machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: int8 exact; f32 rtol 1e-5 / atol 1e-4; bf16 k-inner and
grouped 2e-2; bf16 k-outer one bf16 ulp of the running |C| per pass; flash
attention f32 rtol = atol = 1e-5, bf16 3e-2; RMSNorm f32 1e-5, bf16 one
bf16 ulp of |y|.
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
    return _bf16_ulp(peak)


def _bf16_ulp(y):
    return torch.exp2(torch.floor(torch.log2(y.float().abs().clamp_min(
        2.0 ** -126))) - 7)


@pytest.mark.parametrize("dt", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("tile", [(64, 128, 128), (128, 128, 128),
                                  (32, 256, 128), (8, 8, 128),
                                  (8, 256, 128), (32, 128, 128),
                                  (128, 64, 128)])
@pytest.mark.parametrize("m,n,k", [
    (300, 520, 390),     # ragged in every dimension and in the last pass
    (64, 196, 390),      # bf16: rows TMA cannot read in place (copied)
])
def test_kernels_match_plain_versions(dt, tile, m, n, k):
    ta, tb = _operands(m, n, k, dt, sum(tile))
    ti, to = TileConfig(*tile), TileConfig(*tile, GridOrder.K_OUTER)
    c0 = torch.zeros((m, n), dtype=K.out_dtype(ta.dtype), device="cuda")
    before = dict(K.LAUNCHES)
    routes = dict(K.ROUTES)
    got_i = K.gemm_k_inner(ta, tb, tile=ti)
    got_o = K.gemm_k_outer(ta, tb, c0, tile=to)
    torch.cuda.synchronize()
    passes = -(-k // tile[2])
    assert K.LAUNCHES["gemm_k_inner"] == before["gemm_k_inner"] + 1
    assert K.LAUNCHES["gemm_k_outer"] == before["gemm_k_outer"] + passes
    route = "cuda_cores" if dt == "f32" else "wgmma"
    other = "wgmma" if dt == "f32" else "cuda_cores"
    assert K.ROUTES[route] == routes[route] + 1 + passes
    assert K.ROUTES[other] == routes[other]
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


@pytest.mark.parametrize("tile", [(128, 256, 128), (128, 256, 64),
                                  (256, 256, 64)])
def test_bf16_n256_tiles_run_one_warpgroup_in_rounds(tile):
    """bf16 tiles of N = 256 with bm > 64 run one consumer warpgroup in
    rounds (two would spill), each round streaming K again; both orders
    match their plain versions at a ragged shape."""
    assert K.wgmma_config(TileConfig(*tile)).consumers == 1
    ta, tb = _operands(300, 520, 390, "bf16", sum(tile))
    c0 = torch.zeros((300, 520), dtype=torch.bfloat16, device="cuda")
    got_i = K.gemm_k_inner(ta, tb, tile=TileConfig(*tile))
    got_o = K.gemm_k_outer(ta, tb, c0,
                           tile=TileConfig(*tile, GridOrder.K_OUTER))
    torch.cuda.synchronize()
    torch.testing.assert_close(got_i.float(),
                               K.gemm_k_inner_plain(ta, tb).float(),
                               rtol=2e-2, atol=2e-2)
    tol = -(-390 // tile[2]) * _streamed_ulp(ta, tb, c0, tile[2])
    want_o = K.gemm_k_outer_plain(ta, tb, c0, bk=tile[2])
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
# f32 GEMM on the CUDA cores (csrc/tile_gemm.cuh): rtol 1e-5 / atol 1e-4
# ---------------------------------------------------------------------------

#: the f32 tiles the planner picks and its earlier picks
#: (tests/test_torch_gemm_f32.py holds the planner to these lists) and
#: phase 5's 64x128x128
F32_TILES = [(8, 128, 128), (32, 64, 128), (64, 32, 128), (64, 128, 128),
             (8, 64, 128), (16, 8, 128), (16, 16, 128), (32, 16, 128),
             (32, 32, 128), (32, 512, 128), (64, 64, 128), (128, 128, 128),
             (2048, 8, 128)]


def _f32_both_orders(ta, tb, c, tile):
    """Both loop orders on the card against their plain versions; every
    launch on the CUDA cores, one a k-outer pass."""
    m, k = ta.shape
    before, routes = dict(K.LAUNCHES), dict(K.ROUTES)
    got_i = K.gemm_k_inner(ta, tb, tile=TileConfig(*tile))
    got_o = K.gemm_k_outer(ta, tb, c,
                           tile=TileConfig(*tile, GridOrder.K_OUTER))
    torch.cuda.synchronize()
    passes = -(-k // tile[2])
    assert K.LAUNCHES["gemm_k_inner"] == before["gemm_k_inner"] + 1
    assert K.LAUNCHES["gemm_k_outer"] == before["gemm_k_outer"] + passes
    assert K.ROUTES == {"wgmma": routes["wgmma"],
                        "cuda_cores": routes["cuda_cores"] + 1 + passes}
    tol = dict(rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got_i, K.gemm_k_inner_plain(ta, tb), **tol)
    torch.testing.assert_close(
        got_o, K.gemm_k_outer_plain(ta, tb, c, bk=tile[2]), **tol)


@pytest.mark.parametrize("tile", F32_TILES)
@pytest.mark.parametrize("m,n,k", [
    (300, 520, 390),     # ragged in every dimension and in the last pass
    (33, 1000, 200),     # a few rows (decode-like), two passes
    (4133, 300, 1536),   # more m tiles than one raster group, 12 passes
])
def test_f32_kernel_matches_plain_version_at_the_planners_tiles(tile, m, n,
                                                                 k):
    """B at a weight's init scale (std K^-1/2), so C is O(1) as in the
    models: with N(0, 1) operands at K = 1536 |C| reaches ~40, and the
    kernel's and cuBLAS's sum orders then differ past atol 1e-4 (the two
    land on either side of the float64 product)."""
    ta, tb = _operands(m, n, k, "f32", sum(tile) + m)
    tb = tb * k ** -0.5
    c = torch.randn(m, n, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(m))
    _f32_both_orders(ta, tb, c, tile)


@pytest.mark.parametrize("tile", [(32, 64, 128), (64, 128, 128)])
def test_f32_kernel_is_as_close_to_float64_as_a_sequential_f32_sum(tile):
    """N(0, 1) operands at K = 4608 (|C| ~ 68), where any two f32 sum
    orders differ past atol 1e-4: each thread sums an element's products
    in k order in one f32 register, so k-inner lies no further from the
    float64 product than twice a sequential f32 sum does, and k-outer no
    further than twice the same sum restarted each pass and added to C
    (cuBLAS, which splits K its own way, lands closer than both)."""
    m, n, k = 128, 256, 4608
    ta, tb = _operands(m, n, k, "f32", k)
    exact = ta.double() @ tb.double()
    whole = torch.zeros(m, n, device="cuda")
    passes = torch.zeros(m, n, device="cuda")
    for k0 in range(0, k, tile[2]):
        part = torch.zeros(m, n, device="cuda")
        for kk in range(k0, min(k0 + tile[2], k)):
            whole.addcmul_(ta[:, kk:kk + 1], tb[kk:kk + 1])
            part.addcmul_(ta[:, kk:kk + 1], tb[kk:kk + 1])
        passes += part
    got = (K.gemm_k_inner(ta, tb, tile=TileConfig(*tile)),
           K.gemm_k_outer(ta, tb, torch.zeros(m, n, device="cuda"),
                          tile=TileConfig(*tile, GridOrder.K_OUTER)))
    torch.cuda.synchronize()
    for g, seq in zip(got, (whole, passes)):
        assert (g - exact).abs().max().item() <= \
            2 * (seq - exact).abs().max().item()


@pytest.mark.parametrize("tile", [(64, 32, 2), (2048, 2, 16), (1, 1024, 128),
                                  (16384, 1, 2), (8, 8, 1)])
def test_f32_kernel_takes_degenerate_tiles(tile):
    """Tiles no planner picks but the kernel takes: sub-slabs of one or two
    k (A's rows packed, read a float at a time), 1-row and 1-column
    tiles on the instantiations with run-time extents."""
    ta, tb = _operands(300, 70, 45, "f32", sum(tile))
    c = torch.randn(300, 70, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))
    _f32_both_orders(ta, tb, c, tile)


@pytest.mark.parametrize("case", ["k27", "n49", "strided"])
def test_f32_kernel_reads_unaligned_rows_and_strided_views(case):
    """Table-2's K = 27 (A's rows 108 bytes) and N = 49 (B's and C's rows
    196 bytes: B in 4-byte copies, C stored per element), and views whose
    base and row stride fall off 16 bytes."""
    rng = np.random.default_rng(len(case))
    if case == "k27":
        ta, tb = _operands(3000, 32, 27, "f32", 5)
        tile = (32, 64, 128)
    elif case == "n49":
        ta, tb = _operands(512, 49, 300, "f32", 6)
        tile = (64, 32, 128)
    else:
        big_a, big_b = operands_from_numpy(
            rng.normal(size=(301, 400)).astype(np.float32),
            rng.normal(size=(400, 530)).astype(np.float32), device="cuda",
            dtype="f32")
        ta, tb = big_a[1:, 3:393], big_b[5:395, 1:521]
        assert ta.data_ptr() % 16 and tb.data_ptr() % 16
        tile = (32, 64, 128)
    m, n = ta.shape[0], tb.shape[1]
    c = operands_from_numpy(rng.normal(size=(m, n)).astype(np.float32),
                            device="cuda", dtype="f32")
    _f32_both_orders(ta, tb, c, tile)


@pytest.mark.parametrize("e,c,d,f", [(40, 32, 1536, 512), (40, 32, 512, 1536),
                                     (40, 8, 1536, 512), (40, 8, 512, 1536),
                                     (40, 24, 1536, 512)])
def test_f32_grouped_experts_equal_the_gemm_kernel_on_each_expert(e, c, d,
                                                                   f):
    """The served f32 grouped shapes run the GEMM's kernel with the expert
    as blockIdx.z: each expert's rows equal, bit for bit, the f32 GEMM on
    that expert alone with the same tile (same instantiation, same sum
    order), and the plain version within tolerance."""
    from repro_torch.kernels import grouped_gemm as G

    x, w = _grouped_operands(e, c, d, f, "f32")
    tile = G.grouped_tile(c, torch.float32)
    got = G.grouped_gemm(x, w)
    alone = [K.gemm_k_inner(x[i], w[i], tile=tile) for i in range(e)]
    torch.cuda.synchronize()
    for i in range(e):
        assert torch.equal(got[i], alone[i]), f"expert {i}"
    torch.testing.assert_close(got, G.grouped_gemm_plain(x, w), rtol=1e-5,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# int8 GEMM on wgmma (csrc/wgmma_s8.cuh): exact against the plain version
# ---------------------------------------------------------------------------

def _int8_planner_tiles():
    """Every tile the planner picks on cuda for h100 for the int8 shapes
    of the slice: Table-2 and the Qwen2-1.5B GEMMs at tokens=4096."""
    from repro_torch.configs import get_config
    from repro_torch.core.autotune import model_gemm_shapes
    from repro_torch.core.mobilenet import TABLE2
    from repro_torch.core.tpu_model import GemmShape
    shapes = [GemmShape(r.m, r.n, r.k, dtype="int8") for r in TABLE2]
    shapes += [GemmShape(s.m, s.n, s.k, dtype="int8") for s in
               model_gemm_shapes(get_config("qwen2-1.5b"), tokens=4096)]
    return sorted({(d.selection.bm, d.selection.bn, d.selection.bk)
                   for d in gemm.plan_many(shapes, backend="cuda",
                                           machine="h100")})


def _int8_exact(ta, tb, tile):
    """Both orders on ``tile`` equal their plain versions, bit for bit; one
    transposed copy of B per wrapper call, every launch on wgmma."""
    m, n, k = ta.shape[0], tb.shape[1], ta.shape[1]
    c0 = torch.zeros((m, n), dtype=torch.int32, device="cuda")
    copies, routes = K.COPIES["transposed"], dict(K.ROUTES)
    got_i = K.gemm_k_inner(ta, tb, tile=TileConfig(*tile))
    got_o = K.gemm_k_outer(ta, tb, c0,
                           tile=TileConfig(*tile, GridOrder.K_OUTER))
    torch.cuda.synchronize()
    passes = -(-k // tile[2])
    assert K.COPIES["transposed"] == copies + 2
    assert K.ROUTES == {"wgmma": routes["wgmma"] + 1 + passes,
                        "cuda_cores": routes["cuda_cores"]}
    assert torch.equal(got_i, K.gemm_k_inner_plain(ta, tb))
    assert torch.equal(got_o, K.gemm_k_outer_plain(ta, tb, c0, bk=tile[2]))


def test_int8_is_exact_at_every_planner_tile():
    tiles = _int8_planner_tiles()
    assert (128, 128, 128) in tiles and len(tiles) >= 4
    for i, tile in enumerate(tiles):
        for m, n, k in ((512, 512, 512), (300, 520, 390)):
            _int8_exact(*_operands(m, n, k, "int8", 40 + i), tile)


@pytest.mark.parametrize("m,n,k,tile", [
    (300, 520, 390, (64, 128, 128)),    # ragged last k-outer pass
    (32, 12544, 27, (32, 256, 128)),    # Table-2: K = 27, A copied
    (1024, 1000, 1, (64, 128, 128)),    # Table-2: K = 1, A copied
    (512, 49, 4608, (128, 64, 128)),    # Table-2: N = 49, C direct
    (1024, 49, 512, (128, 64, 128)),
    (130, 72, 8960, (64, 128, 128)),    # Qwen2-1.5B's down-projection K
    (8, 8, 300, (8, 8, 128)),           # bm < 64, bn < 64, C direct
    (40, 300, 200, (32, 128, 64)),      # a slab under one 128-k band
    (70, 90, 60, (64, 64, 16)),         # slabs under one k32 step
])
def test_int8_ragged_edges_are_exact(m, n, k, tile):
    _int8_exact(*_operands(m, n, k, "int8", m + n + k), tile)


def test_int8_reads_strided_views_exactly():
    rng = np.random.default_rng(5)
    big_a = torch.tensor(rng.integers(-128, 128, size=(260, 420)),
                         dtype=torch.int8, device="cuda")
    big_b = torch.tensor(rng.integers(-128, 128, size=(420, 333)),
                         dtype=torch.int8, device="cuda")
    ta = big_a[3:203, 5:405]         # base off 16 bytes: A copied
    tb = big_b[7:407, 11:311]        # B read with its own row stride
    assert ta.stride(0) == 420 and tb.stride(0) == 333
    aligned = K.COPIES["aligned"]
    _int8_exact(ta, tb, (64, 128, 128))
    assert K.COPIES["aligned"] == aligned + 2


def test_int8_extremes_at_k_8960_are_exact():
    """Every operand -128 at Qwen2-1.5B's largest K: each sum is
    8960 x 16384 = 146,800,640, inside int32."""
    ta = torch.full((130, 8960), -128, dtype=torch.int8, device="cuda")
    tb = torch.full((8960, 200), -128, dtype=torch.int8, device="cuda")
    for tile in ((64, 128, 128), (128, 128, 128)):
        _int8_exact(ta, tb, tile)
    got = K.gemm_k_inner(ta, tb, tile=TileConfig(128, 128, 128))
    assert int(got.min()) == int(got.max()) == 8960 * 128 * 128


@pytest.mark.parametrize("k,n", [(27, 12544), (1, 1000), (4608, 49),
                                 (390, 520), (1536, 2048)])
def test_int8_transposed_copy_matches_its_plain_version(k, n):
    rng = np.random.default_rng(k + n)
    b = torch.tensor(rng.integers(-128, 128, size=(k, n)), dtype=torch.int8,
                     device="cuda")
    got = K.transposed_copy(b)
    want = K.transposed_copy_plain(b)
    torch.cuda.synchronize()
    kp = -(-k // 16) * 16
    assert got.shape == (n, k) and got.stride() == (kp, 1)
    assert torch.equal(got, b.t()) and torch.equal(got, want)
    padded = torch.as_strided(got, (n, kp), (kp, 1))
    assert not bool(padded[:, k:].any())     # the pad is zero


def test_int8_routes_to_wgmma_and_raises_on_an_unbuilt_tile():
    assert K.route(torch.int8) == "wgmma"
    ta, tb = _operands(64, 64, 64, "int8", 0)
    with pytest.raises(ValueError, match="power-of-two"):
        K.gemm_k_inner(ta, tb, tile=TileConfig(100, 128, 128))


# ---------------------------------------------------------------------------
# Grouped (per-expert) GEMM
# ---------------------------------------------------------------------------

#: granite-moe-3b-a800m's expert products: decode with max_batch 4
#: (C = 4 x 8) and one request's prefill at bucket 32 (C = 8), the shapes
#: the served run launches; a prefill at bucket 512 (C = 128); a ragged C;
#: a ragged D and F (rows TMA cannot read in place: both copied); the
#: benchmark's pass at 4,096 tokens (C = 819: gate+up fused, then down)
#: and a C that is a multiple of 128 (the wide design from C = 65)
GROUPED_SHAPES = [(40, 32, 1536, 512), (40, 32, 512, 1536),
                  (40, 8, 1536, 512), (40, 8, 512, 1536),
                  (40, 128, 1536, 512), (40, 128, 512, 1536),
                  (40, 24, 1536, 512), (3, 24, 200, 72), (3, 24, 201, 75),
                  (40, 819, 1536, 1024), (40, 819, 512, 1536),
                  (8, 1024, 1536, 1024)]


def _grouped_operands(e, c, d, f, dt):
    rng = np.random.default_rng(e + c + d + f)
    # weights at the model's init scale (dense_init: std D^-1/2), so the
    # outputs are O(1) as when served
    return operands_from_numpy(
        rng.normal(size=(e, c, d)).astype(np.float32),
        (rng.normal(size=(e, d, f)) * d ** -0.5).astype(np.float32),
        device="cuda", dtype=dt)


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("e,c,d,f", GROUPED_SHAPES)
def test_grouped_kernel_matches_plain_version(e, c, d, f, dt):
    """Every bf16 launch on the wgmma route (its ragged D and F copied to
    aligned rows first), on the wide design from 65 rows an expert (with F
    a multiple of 8) and on the decode design under it; every f32 one on
    the CUDA cores."""
    from repro_torch.kernels import grouped_gemm as G

    x, w = _grouped_operands(e, c, d, f, dt)
    before = G.LAUNCHES["grouped_gemm"]
    routes, copies = dict(G.ROUTES), G.COPIES["aligned"]
    designs = dict(G.DESIGNS)
    got = G.grouped_gemm(x, w)
    torch.cuda.synchronize()
    assert G.LAUNCHES["grouped_gemm"] == before + 1
    route = "wgmma" if dt == "bf16" else "cuda_cores"
    assert {r: G.ROUTES[r] - routes[r] for r in routes} == {
        r: int(r == route) for r in routes}
    design = "wide" if c > 64 and f % 8 == 0 else "decode"
    assert {k: G.DESIGNS[k] - designs[k] for k in designs} == {
        k: int(dt == "bf16" and k == design) for k in designs}
    assert G.COPIES["aligned"] - copies == (
        (d % 8 != 0) + (f % 8 != 0) if dt == "bf16" else 0)
    want = G.grouped_gemm_plain(x, w)
    assert got.dtype == x.dtype and got.shape == want.shape
    tol = (dict(rtol=2e-2, atol=2e-2) if dt == "bf16"
           else dict(rtol=1e-5, atol=1e-4))
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("f", [512, 75])
def test_grouped_kernel_keeps_each_expert_to_its_own_rows(f):
    """C = 24 on a 32-row tile: each expert's rows equal a launch of that
    expert alone (same kernel, same sum order), and the odd experts, whose
    weights are zero, stay exactly zero: no expert's store reaches its
    neighbour's rows, whether y goes out by TMA (F = 512) or from
    registers (F = 75)."""
    from repro_torch.kernels import grouped_gemm as G

    e, c, d = 6, 24, 1536
    x, w = _grouped_operands(e, c, d, f, "bf16")
    w[1::2] = 0
    got = G.grouped_gemm(x, w)
    alone = [G.grouped_gemm(x[i:i + 1].contiguous(), w[i:i + 1].contiguous())
             for i in range(e)]
    torch.cuda.synchronize()
    assert bool((got[1::2] == 0).all())
    for i in range(e):
        assert torch.equal(got[i], alone[i][0]), f"expert {i}"
    torch.testing.assert_close(got.float(), G.grouped_gemm_plain(x, w).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("f", [520, 1024])
def test_wide_kernel_keeps_each_expert_to_its_own_rows(f):
    """The wide design at C = 333 (two full 128-row tiles and 77 rows) and
    F = 520 (two 256-column tiles and 8 columns): each expert's rows equal
    a launch of that expert alone (same kernel, same sum order), and the
    odd experts, whose weights are zero, stay exactly zero: the persistent
    blocks' TMA stores clip at every expert's C and F."""
    from repro_torch.kernels import grouped_gemm as G

    e, c, d = 6, 333, 1536
    x, w = _grouped_operands(e, c, d, f, "bf16")
    w[1::2] = 0
    designs = dict(G.DESIGNS)
    got = G.grouped_gemm(x, w)
    alone = [G.grouped_gemm(x[i:i + 1].contiguous(), w[i:i + 1].contiguous())
             for i in range(e)]
    torch.cuda.synchronize()
    assert G.DESIGNS["wide"] - designs["wide"] == e + 1
    assert bool((got[1::2] == 0).all())
    for i in range(e):
        assert torch.equal(got[i], alone[i][0]), f"expert {i}"
    torch.testing.assert_close(got.float(), G.grouped_gemm_plain(x, w).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("first", ["gemm", "grouped"])
def test_gemm_and_grouped_libraries_each_configure_their_kernel(first):
    """The f32 GEMM and f32 grouped libraries compile the same tile kernel
    from ``tile_gemm.cuh`` (bf16 now runs wgmma in both); each copy must
    get its own shared-memory attribute, whichever library launches a
    register tile first (76,800 B at 64x128, an instantiation with fixed
    extents, and 203,520 B at 16x512, one with run-time extents; both over
    the 48 KB default)."""
    from repro_torch.kernels import grouped_gemm as G

    tile = TileConfig(64, 128, 128) if first == "gemm" else \
        TileConfig(16, 512, 256)
    x = torch.randn(3, 32, 520, device="cuda")
    # weights at the model's init scale, for atol 1e-4 (see above)
    w = torch.randn(3, 520, 200, device="cuda") * 520 ** -0.5
    calls = [lambda: G.grouped_gemm(x, w, tile=tile),
             lambda: K.gemm_k_inner(x[0], w[0], tile=tile)]
    if first == "gemm":
        calls.reverse()
    outs = [call() for call in calls]
    torch.cuda.synchronize()
    got_g, got_k = outs if first == "grouped" else outs[::-1]
    tol = dict(rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got_g, G.grouped_gemm_plain(x, w), **tol)
    torch.testing.assert_close(got_k, K.gemm_k_inner_plain(x[0], w[0]), **tol)


def test_grouped_kernel_refuses_a_tile_over_the_shared_memory_limit():
    from repro_torch.kernels import grouped_gemm as G

    x = torch.zeros(2, 128, 512, dtype=torch.bfloat16, device="cuda")
    w = torch.zeros(2, 512, 128, dtype=torch.bfloat16, device="cuda")
    before = G.LAUNCHES["grouped_gemm"]
    with pytest.raises(ValueError, match="shared memory"):
        G.grouped_gemm(x, w, tile=TileConfig(128, 128, 512))
    # transpose(1, 2) views of contiguous tensors are read in place; a
    # strided slice is neither
    with pytest.raises(ValueError, match="contiguous"):
        G.grouped_gemm(x[:, :, ::2], w[:, ::2])
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


# ---------------------------------------------------------------------------
# Flash attention and RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,skv,h,d", [
    (1, 32, 32, 24, 64),       # granite's served prefill at bucket 32
    (2, 256, 256, 3, 64),
    (1, 512, 512, 2, 128),
    (1, 100, 100, 2, 128),     # S past the kernel's 64-row tile
    (1, 128, 256, 2, 64),      # Skv != S: the causal mask is top-left
    (1, 256, 128, 2, 128),
])
def test_flash_attention_kernel_matches_plain_version(b, s, skv, h, d,
                                                      causal, dt):
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops

    rng = np.random.default_rng(s + skv + d)
    q, k, v = operands_from_numpy(
        *(rng.normal(size=shape).astype(np.float32)
          for shape in ((b, s, h, d), (b, skv, h, d), (b, skv, h, d))),
        device="cuda", dtype=dt)
    before = FA.LAUNCHES["flash_attention"]
    routes = dict(FA.ROUTES)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention"] == before + 1
    # bf16 on the tensor cores, f32 on the CUDA cores, one launch each
    rt = "wgmma" if dt == "bf16" else "cuda_cores"
    assert FA.ROUTES == {**routes, rt: routes[rt] + 1}
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == want.shape
    tol = 3e-2 if dt == "bf16" else 1e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_kernel_reads_strided_operands():
    """q, k, v as (B, S, H, D) views of (B, H, S, D) tensors: the kernel
    reads them through their strides, no copies."""
    from repro_torch.kernels import flash_attention as FA

    q, k, v = (torch.randn(2, 3, 128, 64, device="cuda").transpose(1, 2)
               for _ in range(3))
    got = FA.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, FA.flash_attention_plain(q, k, v),
                               rtol=1e-5, atol=1e-5)


def test_flash_attention_kernel_refuses_what_it_does_not_take():
    """Head dims up to 256 run (16 and 32 on the 64-wide instantiation,
    256 on the 256-wide one) and match the plain version; a head dim past
    256, a non-unit head-dim stride and the JAX kernel's block assert are
    refused before any launch."""
    from repro_torch.kernels import flash_attention as FA

    for d in (16, 32, 256):
        q, k, v = (torch.randn(1, 128, 2, d, device="cuda")
                   for _ in range(3))
        before = FA.LAUNCHES["flash_attention"]
        got = FA.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        assert FA.LAUNCHES["flash_attention"] == before + 1
        torch.testing.assert_close(got, FA.flash_attention_plain(q, k, v),
                                   rtol=1e-5, atol=1e-5)
    before = FA.LAUNCHES["flash_attention"]
    q = torch.zeros(1, 64, 2, 264, device="cuda")
    with pytest.raises(ValueError, match="256"):
        FA.flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 64, 2, 128, device="cuda")[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        FA.flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 192, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="multiples"):
        FA.flash_attention_fwd(q, q, q)        # 192 % min(128, 192) != 0
    assert FA.LAUNCHES["flash_attention"] == before


@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_flash_attention_kernel_takes_b_times_h_past_65535(dt):
    """B * H = 70,000 blocks of 64 queries (B * H on gridDim.x)."""
    from repro_torch.kernels import flash_attention as FA

    rng = np.random.default_rng(70000)
    q, k, v = operands_from_numpy(
        *(rng.normal(size=(1000, 64, 70, 16)).astype(np.float32)
          for _ in range(3)), device="cuda", dtype=dt)
    got = FA.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    want = FA.flash_attention_plain(q, k, v)
    tol = 3e-2 if dt == "bf16" else 1e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _f32_flash_case(q, k, v):
    """f32 flash attention on the card, causal and full: one launch on the
    CUDA cores a call, the plain version's result at rtol = atol = 1e-5."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops

    for causal in (True, False):
        FA.reset_launch_counts()
        got = ops.flash_attention(q, k, v, causal=causal, block_q=q.shape[1],
                                  block_k=k.shape[1])
        torch.cuda.synchronize()
        assert FA.LAUNCHES == {"flash_attention": 1}
        assert FA.ROUTES == {"wgmma": 0, "cuda_cores": 1}
        want = FA.flash_attention_plain(q, k, v, causal=causal)
        assert got.dtype == torch.float32 and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,skv", [(100, 100), (200, 200), (100, 200),
                                   (200, 100)])
@pytest.mark.parametrize("d", [1, 100, 160, 192, 256])
@pytest.mark.parametrize("b,h,rows", [(1, 2, 32), (2, 140, 64)])
def test_flash_attention_f32_at_every_compiled_width(d, s, skv, b, h, rows):
    """Every f32 width (d = 1, 100, 160, 192, 256 run on 64, 128, 160, 192,
    256) in both block heights (32 rows on a small grid, 64 on a large
    one), S and Skv off the tile, Skv < S and Skv > S, causal and full."""
    from repro_torch.kernels import flash_attention as FA

    assert FA.f32_rows(b, s, h) == rows
    rng = np.random.default_rng(s + skv + d + h)
    q, k, v = operands_from_numpy(
        *(rng.normal(size=shape).astype(np.float32)
          for shape in ((b, s, h, d), (b, skv, h, d), (b, skv, h, d))),
        device="cuda")
    _f32_flash_case(q, k, v)


@pytest.mark.parametrize("d,layout", [(160, "bhsd"), (192, "bhsd"),
                                      (64, "offset"), (3, "bshd"),
                                      (100, "offset")])
def test_flash_attention_f32_reads_strided_and_unaligned_operands(d, layout):
    """(B, S, H, D) views of (B, H, S, D) tensors take 16-byte copies
    through their own strides; bases off 16 bytes and rows of 36 bytes (d =
    3 over 3 heads) take the 4-byte copies."""
    g = torch.Generator("cuda").manual_seed(d)
    if layout == "bhsd":
        q, k, v = (torch.randn(2, 3, 192, d, device="cuda", generator=g)
                   .transpose(1, 2) for _ in range(3))
    elif layout == "offset":
        q, k, v = (torch.randn(2, 192, 3, d + 1, device="cuda",
                               generator=g)[..., 1:] for _ in range(3))
    else:
        q, k, v = (torch.randn(2, 192, 3, d, device="cuda", generator=g)
                   for _ in range(3))
    _f32_flash_case(q, k, v)


@pytest.mark.parametrize("d", [64, 160])
def test_flash_attention_f32_takes_b_times_h_of_70000(d):
    """B * H = 70,000 on the one-dimensional grid, 64-row blocks."""
    rng = np.random.default_rng(d)
    q, k, v = operands_from_numpy(
        *(rng.normal(size=(1000, 64, 70, d)).astype(np.float32)
          for _ in range(3)), device="cuda")
    _f32_flash_case(q, k, v)


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("shape", [(4, 1, 1536), (1, 32, 1536), (4096, 1536),
                                   (13, 128), (8, 4096), (16, 1001)])
def test_rmsnorm_reads_a_bf16_scale_as_its_f32_copy(shape, dt):
    """The kernel widens a bf16 scale in registers: its output is bit-equal
    to the output for the scale's f32 copy (what the wrapper used to
    convert and pass), on every path, and the call launches one kernel
    and no conversion."""
    from repro_torch.kernels import rmsnorm as R

    rng = np.random.default_rng(sum(shape) + 1)
    x = operands_from_numpy(rng.normal(size=shape).astype(np.float32),
                            device="cuda", dtype=dt)
    scale = operands_from_numpy(
        rng.normal(size=shape[-1]).astype(np.float32), device="cuda",
        dtype="bf16")
    rows = x.numel() // shape[-1]
    assert R.kernel_scale(scale) is scale
    # a first call outside the profiler: it may build the kernels, and
    # nvcc run inside a profiled region left later sessions recording no
    # device kernel at all
    R.rmsnorm(x, scale, eps=1e-6, block_rows=rows)
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        got = R.rmsnorm(x, scale, eps=1e-6, block_rows=rows)
        torch.cuda.synchronize()
    kernels = [ev.key for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0]
    assert len(kernels) == 1 and "rmsnorm" in kernels[0], kernels
    want = R.rmsnorm(x, scale.float(), eps=1e-6, block_rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _flash_operands(shapes, seed, dt="bf16"):
    rng = np.random.default_rng(seed)
    return operands_from_numpy(
        *(rng.normal(size=shape).astype(np.float32) for shape in shapes),
        device="cuda", dtype=dt)


@pytest.mark.parametrize("b,s,skv,h,d,copied", [
    (1, 256, 256, 4, 160, 0),     # stablelm-12b's head dim (width 256)
    (1, 256, 256, 4, 192, 0),     # xlstm-125m's
    (1, 128, 128, 2, 256, 0),     # paligemma-3b's
    (1, 200, 200, 3, 100, 3),     # d = 100: rows TMA cannot read, copied
    (2, 192, 320, 3, 64, 0),      # Skv != S, neither a multiple of a tile
])
def test_flash_attention_bf16_head_dims_on_wgmma(b, s, skv, h, d, copied):
    """bf16 at every served head-dim class on the tensor cores, causal and
    not, against the plain version at 3e-2; an operand TMA cannot read is
    copied once to aligned rows (and only then)."""
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _flash_operands(((b, s, h, d), (b, skv, h, d),
                               (b, skv, h, d)), s + skv + d)
    for causal in (True, False):
        FA.reset_launch_counts()
        got = FA.flash_attention_fwd(q, k, v, causal=causal, block_q=s,
                                     block_k=skv)
        torch.cuda.synchronize()
        assert FA.ROUTES == {"wgmma": 1, "cuda_cores": 0}
        assert FA.COPIES["aligned"] == copied
        want = FA.flash_attention_plain(q, k, v, causal=causal)
        torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                                   atol=3e-2)


def test_flash_attention_bf16_qwen2_long_sequence():
    """Qwen2-1.5B's (1, 4096, 12, 128), causal: 32 query tiles, the longest
    first, against the plain version at 3e-2."""
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _flash_operands([(1, 4096, 12, 128)] * 3, 4096)
    FA.reset_launch_counts()
    got = FA.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert FA.ROUTES == {"wgmma": 1, "cuda_cores": 0}
    want = FA.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)


def test_flash_attention_bf16_reads_strided_operands_in_place():
    """bf16 (B, S, H, D) views of (B, H, S, D) tensors go through the
    tensor maps with their own strides: no copy, the plain version's
    result."""
    from repro_torch.kernels import flash_attention as FA

    q, k, v = (torch.randn(2, 3, 256, 64, device="cuda",
                           dtype=torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    FA.reset_launch_counts()
    got = FA.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert FA.COPIES["aligned"] == 0 and FA.ROUTES["wgmma"] == 1
    torch.testing.assert_close(got.float(), FA.flash_attention_plain(
        q, k, v).float(), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("shape", [(4, 1, 1536), (1, 32, 1536), (4096, 1536),
                                   (13, 128), (2, 24, 64), (8, 4096)])
def test_rmsnorm_kernel_matches_plain_version(shape, dt):
    from repro_torch.kernels import rmsnorm as R

    rng = np.random.default_rng(sum(shape))
    x = operands_from_numpy(rng.normal(size=shape).astype(np.float32),
                            device="cuda", dtype=dt)
    scale = operands_from_numpy(
        rng.normal(size=shape[-1]).astype(np.float32), device="cuda",
        dtype=dt)
    rows = x.numel() // shape[-1]
    before = R.LAUNCHES["rmsnorm"]
    got = R.rmsnorm(x, scale, eps=1e-6, block_rows=rows)
    torch.cuda.synchronize()
    assert R.LAUNCHES["rmsnorm"] == before + 1
    want = R.rmsnorm_plain(x, scale, eps=1e-6)
    assert got.dtype == x.dtype and got.shape == x.shape
    if dt == "f32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert bool(((got.float() - want.float()).abs()
                     <= _bf16_ulp(want)).all())


def test_rmsnorm_kernel_refuses_ragged_rows_and_widths():
    """Ragged rows stay refused, as the JAX kernel asserts; ragged and wide
    widths, a sliced (non-contiguous, misaligned) x and kimi-k2-1t's 7168
    in f32 now run, each path matching the plain version."""
    from repro_torch.kernels import rmsnorm as R

    x = torch.randn(300, 1536, dtype=torch.bfloat16, device="cuda")
    s = torch.randn(1536, device="cuda")
    before = R.LAUNCHES["rmsnorm"]
    with pytest.raises(ValueError, match="rows are not a multiple"):
        R.rmsnorm(x, s)                       # 300 % min(256, 300) != 0
    assert R.LAUNCHES["rmsnorm"] == before
    wide = torch.randn(8, 12288, dtype=torch.bfloat16, device="cuda")
    kimi = torch.randn(16, 7168, device="cuda")
    for xx, ss in ((x[:, :100], s[:100]), (x[:, 8:], s[8:]),
                   (x[:, 1:], s[1:]), (wide, torch.randn(12288,
                                                         device="cuda")),
                   (kimi, torch.randn(7168, device="cuda"))):
        got = R.rmsnorm(xx, ss, block_rows=xx.shape[0])
        torch.cuda.synchronize()
        want = R.rmsnorm_plain(xx, ss)
        if xx.dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert bool(((got.float() - want.float()).abs()
                         <= _bf16_ulp(want)).all())
    assert R.LAUNCHES["rmsnorm"] == before + 5


def test_rmsnorm_takes_a_misaligned_scale_on_the_scalar_path():
    """A bf16 scale whose base is off 16 bytes is read in place, not
    cloned: element by element into registers (the direct path, 64 and
    640 rows) or into shared memory (the ring's element path, 640 rows of
    an x off 16 bytes; no bulk copy of the scale).  The name is
    historical: x keeps its own path, and the scalar path is gone."""
    from repro_torch.kernels import rmsnorm as R

    s = torch.randn(1537, device="cuda").to(torch.bfloat16)[1:]
    for rows, offset, path in ((64, 0, "direct"), (640, 0, "direct"),
                               (640, 1, "element")):
        x = torch.randn(rows * 1536 + offset, dtype=torch.bfloat16,
                        device="cuda")[offset:].view(rows, 1536)
        assert R.kernel_scale(s) is s and R.kernel_input(x)[1] == path
        got = R.rmsnorm(x, s, block_rows=64)
        torch.cuda.synchronize()
        want = R.rmsnorm_plain(x, s)
        assert bool(((got.float() - want.float()).abs()
                     <= _bf16_ulp(want)).all())


def _rmsnorm_case(x, scale, want_path):
    """One call on ``x`` in place: its path, one launch, the plain
    version's result (f32 rtol = atol = 1e-5, bf16 one ulp of |y|), y
    contiguous in x's shape."""
    from repro_torch.kernels import rmsnorm as R

    x2, path = R.kernel_input(x)
    assert path == want_path and x2.data_ptr() == x.data_ptr()
    before = R.LAUNCHES["rmsnorm"]
    got = R.rmsnorm(x, scale, eps=1e-6, block_rows=x2.shape[0])
    torch.cuda.synchronize()
    assert R.LAUNCHES["rmsnorm"] == before + 1
    assert got.is_contiguous() and got.shape == x.shape
    want = R.rmsnorm_plain(x, scale, eps=1e-6)
    if x.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert bool(((got.float() - want.float()).abs()
                     <= _bf16_ulp(want)).all())


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d,path", [
    (4096, 5120, "direct"),       # qwen2.5-32b's d_model
    (4096, 7168, "direct"),       # kimi-k2-1t's
    (200, 16384, "direct"),       # the widest row read once
    (8, 16385, "two-pass"),       # one beyond it
    (3, 16384, "direct"),         # fewer rows than SMs
    (131, 7168, "direct"),
    (4, 1536, "direct"),          # granite's served decode
])
def test_rmsnorm_ring_at_model_widths(rows, d, path, dt):
    """Aligned rows at the models' widths, up to the widest read once and
    one beyond.  The name is historical: aligned rows take the direct path
    at every row count; the ring's own widths are
    :func:`test_rmsnorm_element_path_at_model_widths`'."""
    g = torch.Generator("cuda").manual_seed(rows + d)
    x = torch.randn(rows, d, generator=g, device="cuda", dtype=dt)
    scale = torch.randn(d, generator=g, device="cuda")
    _rmsnorm_case(x, scale, path)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d,path", [
    (4096, 5120, "element"),      # several warps a row, two stages
    (4096, 7168, "element"),
    (200, 16384, "element"),      # the widest row read once: one group
    (3, 16384, "element"),        # fewer rows than SMs: a block a row
    (8, 16392, "two-pass"),       # past it, off 16 bytes
])
def test_rmsnorm_element_path_at_model_widths(rows, d, path, dt):
    """Rows whose base is off 16 bytes (columns 1 to D of a wider buffer)
    at the models' widths: the ring's groups of several warps, and the
    two-pass kernel on a row stride."""
    g = torch.Generator("cuda").manual_seed(rows + d + 1)
    x = torch.randn(rows, d + 64, generator=g, device="cuda",
                    dtype=dt)[:, 1:d + 1]
    scale = torch.randn(d, generator=g, device="cuda")
    _rmsnorm_case(x, scale, path)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [1001, 1002])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_rmsnorm_element_path_ragged_and_misaligned(d, offset, dt):
    """Ragged D at base offsets of 0-3 elements: each row one bulk copy of
    every 16-byte granule it touches, walked in shared memory from the
    row's own offset."""
    g = torch.Generator("cuda").manual_seed(d + offset)
    buf = torch.randn(600 * d + offset, generator=g, device="cuda",
                      dtype=dt)
    x = buf[offset:].view(600, d)
    scale = torch.randn(d, generator=g, device="cuda").to(dt)
    _rmsnorm_case(x, scale, "element")


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout,path", [
    ("slice", "direct"), ("offset", "element"), ("transposed", "columns"),
    ("transposed-odd", "columns"), ("batched", "direct")])
def test_rmsnorm_reads_strided_x_in_place(layout, path, dt):
    """A row-strided slice, a slice off 16 bytes, a transposed x (also
    with an odd row count: a bf16 word's second row masked) and a 3-D
    slice whose leading axes merge: one launch, no copy (one device
    kernel, y the only allocation), the plain version's result."""
    from repro_torch.kernels import rmsnorm as R

    g = torch.Generator("cuda").manual_seed(len(layout))
    if layout == "slice":
        x = torch.randn(1000, 3 * 1536, generator=g, device="cuda",
                        dtype=dt)[:, 1536:3072]
    elif layout == "offset":
        x = torch.randn(1000, 1600, generator=g, device="cuda",
                        dtype=dt)[:, 1:1537]
    elif layout == "transposed":
        x = torch.randn(1536, 1000, generator=g, device="cuda",
                        dtype=dt).t()
    elif layout == "transposed-odd":
        x = torch.randn(1536, 1002, generator=g, device="cuda",
                        dtype=dt)[:, :999].t()
    else:
        x = torch.randn(4, 250, 2048, generator=g, device="cuda",
                        dtype=dt)[..., :1536]
    scale = torch.randn(1536, generator=g, device="cuda").to(torch.bfloat16)
    _rmsnorm_case(x, scale, path)
    R.rmsnorm(x, scale, block_rows=1)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        R.rmsnorm(x, scale, block_rows=1)
        torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - before
    kernels = [ev.key for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0]
    assert len(kernels) == 1 and "rmsnorm" in kernels[0], kernels
    assert allocs == 1


def test_rmsnorm_copies_only_what_no_path_reads():
    """Neither axis unit-stride: one copy into a contiguous tensor, then
    the direct path; still one RMSNorm launch and the plain version's
    result."""
    from repro_torch.kernels import rmsnorm as R

    x = torch.randn(1536, 600, 2, device="cuda")[..., 0].t()
    assert R.path(x) == "copy"
    x2, path = R.kernel_input(x)
    assert path == "direct" and x2.is_contiguous()
    before = R.LAUNCHES["rmsnorm"]
    got = R.rmsnorm(x, torch.ones(1536, device="cuda"), block_rows=600)
    torch.cuda.synchronize()
    assert R.LAUNCHES["rmsnorm"] == before + 1
    torch.testing.assert_close(got, R.rmsnorm_plain(
        x, torch.ones(1536, device="cuda")), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The GEMM and grouped kernels' backward (gemm/autograd.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("shape", [(2, 64, 1536, 8960), (300, 520, 390)])
def test_matmul_backward_runs_on_the_kernels(shape, dt):
    """gemm.matmul's dA and dB on the card: one launch each, on the
    dtype's route, against the same products' plain versions."""
    *lead, k, n = shape
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    x = (torch.randn(*lead, k, device="cuda") * 0.5).to(tdt).requires_grad_()
    w = (torch.randn(k, n, device="cuda") * k ** -0.5).to(tdt)
    w.requires_grad_()
    K.reset_launch_counts()
    y = gemm.matmul(x, w)
    dy = torch.randn_like(y)
    gx, gw = torch.autograd.grad(y, (x, w), dy)
    torch.cuda.synchronize()
    assert K.LAUNCHES["gemm_k_inner"] == 3
    assert K.ROUTES == ({"wgmma": 3, "cuda_cores": 0} if dt == "bf16"
                        else {"wgmma": 0, "cuda_cores": 3})
    a2, d2 = x.detach().reshape(-1, k), dy.reshape(-1, n)
    tol = (dict(rtol=2e-2, atol=2e-2) if dt == "bf16"
           else dict(rtol=1e-5, atol=1e-4))
    torch.testing.assert_close(
        gx.reshape(-1, k), K.gemm_k_inner_plain(d2, w.detach().t()), **tol)
    torch.testing.assert_close(gw, K.gemm_k_inner_plain(a2.t(), d2), **tol)


@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_grouped_matmul_backward_runs_on_the_kernel(dt):
    from repro_torch.kernels import grouped_gemm as G

    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    x = torch.randn(4, 40, 32, 1536, device="cuda").to(tdt)
    w = (torch.randn(40, 1536, 512, device="cuda") * 1536 ** -0.5).to(tdt)
    x.requires_grad_()
    w.requires_grad_()
    G.reset_launch_counts()
    y = gemm.grouped_matmul(x, w)
    dy = torch.randn_like(y)
    gx, gw = torch.autograd.grad(y, (x, w), dy)
    torch.cuda.synchronize()
    assert G.LAUNCHES["grouped_gemm"] == 3
    assert G.ROUTES[G.route(tdt)] == 3
    # the forward at 4 x 32 rows an expert is wide; dx and dw keep the
    # decode design
    assert G.DESIGNS == ({"decode": 2, "wide": 1} if dt == "bf16"
                         else {"decode": 0, "wide": 0})
    x3 = x.detach().transpose(0, 1).reshape(40, -1, 1536)
    d3 = dy.transpose(0, 1).reshape(40, -1, 512)
    tol = (dict(rtol=2e-2, atol=2e-2) if dt == "bf16"
           else dict(rtol=1e-5, atol=1e-4))
    torch.testing.assert_close(
        gx.transpose(0, 1).reshape(40, -1, 1536),
        G.grouped_gemm_plain(d3, w.detach().transpose(1, 2).contiguous()),
        **tol)
    torch.testing.assert_close(
        gw, G.grouped_gemm_plain(x3.transpose(1, 2).contiguous(), d3), **tol)


def test_loss_fn_gradients_on_the_card_match_the_cpu():
    """One f32 step of gradients of qwen2-1.5b (smoke) on the card against
    the same step on the CPU (plain versions): 1e-4 relative L2 a leaf."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.interop import _flatten
    from repro_torch.models.model import LM

    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              compute_dtype="float32")
    batch = make_batch(cfg, ShapeConfig("t", "train", 32, 2), 0)
    cpu, card = LM(cfg, device="cpu"), LM(cfg, device="cuda")
    cpu.init(torch.Generator().manual_seed(0))
    card.init(torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        for p, q in zip(card.parameters(), cpu.parameters(), strict=True):
            p.copy_(q)
    grads = {}
    for dev, lm in (("cpu", cpu), ("cuda", card)):
        values = lm.train_mode().values()
        loss, _ = lm.loss_fn(values, {k: v.to(dev) for k, v in batch.items()})
        leaves = _flatten(values)
        grads[dev] = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
    for path, g in grads["cpu"].items():
        got = grads["cuda"][path].cpu()
        assert ((got - g).norm() / g.norm()).item() <= 1e-4, path


# ---------------------------------------------------------------------------
# Transposed operands read in place: the backward products' layouts
# ---------------------------------------------------------------------------

def _transposed_operands(m, n, k, which, seed):
    """bf16 (A, B) of an m x n x k product, ``which`` of them ("a" or "b")
    the ``.t()`` of a row-major matrix: A^T stored (k, m), or B^T stored
    (n, k)."""
    a, b = _operands(m, n, k, "bf16", seed)
    if which == "a":
        return a.t().contiguous().t(), b
    return a, b.t().contiguous().t()


#: (m, n, k, tile): ragged in every dimension (A^T's rows of 300 and B^T's
#: of 390 are copied to aligned rows), a slab shallower than a k16 step,
#: tiles narrower than 8 rows or columns, N = 256 in rounds
BACKWARD_CASES = [(300, 520, 390, (64, 128, 128)),
                  (300, 520, 392, (128, 128, 128)),
                  (256, 256, 200, (64, 128, 8)),
                  (37, 200, 136, (4, 64, 64)),
                  (200, 37, 136, (64, 4, 64)),
                  (300, 520, 390, (128, 256, 64))]


@pytest.mark.parametrize("which", ["a", "b"])
@pytest.mark.parametrize("m,n,k,tile", BACKWARD_CASES)
def test_backward_layouts_match_plain_versions(which, m, n, k, tile):
    """A read MN-major, or B read K-major, in place (no transposed copy),
    in both loop orders, against the plain version on the same views:
    k-inner within bf16 2e-2, k-outer within one bf16 ulp a pass."""
    a, b = _transposed_operands(m, n, k, which, m + n + k)
    assert K.wgmma_layout(a, b) == ((1, 1) if which == "a" else (0, 0))
    ti, to = TileConfig(*tile), TileConfig(*tile, GridOrder.K_OUTER)
    c0 = torch.zeros((m, n), dtype=torch.bfloat16, device="cuda")
    copies, routes = dict(K.COPIES), K.ROUTES["wgmma"]
    got_i = K.gemm_k_inner(a, b, tile=ti)
    got_o = K.gemm_k_outer(a, b, c0, tile=to)
    torch.cuda.synchronize()
    passes = -(-k // tile[2])
    assert K.ROUTES["wgmma"] == routes + 1 + passes
    assert K.COPIES["transposed"] == copies["transposed"]
    stored = (a.t(), b) if which == "a" else (a, b.t())
    assert K.COPIES["aligned"] - copies["aligned"] == 2 * sum(
        K.needs_aligned_copy(t) for t in stored)
    torch.testing.assert_close(got_i.float(),
                               K.gemm_k_inner_plain(a, b).float(),
                               rtol=2e-2, atol=2e-2)
    tol = passes * _streamed_ulp(a, b, c0, tile[2])
    want_o = K.gemm_k_outer_plain(a, b, c0, bk=tile[2])
    assert bool(((got_o.float() - want_o.float()).abs() <= tol).all())


@pytest.mark.parametrize("which", ["a", "b"])
def test_backward_walk_covers_more_tiles_than_blocks(which):
    """At 128x128x128 an MN-major A walks 512 tiles with the blocks one
    SM each holds (a K-major B runs one tile a block); every tile is
    computed once."""
    m, n, k, tile = 2048, 4096, 256, TileConfig(128, 128, 128)
    a, b = _transposed_operands(m, n, k, which, 7)
    cfg = K.wgmma_config(tile, ta=int(which == "a"), tb=int(which == "a"))
    assert cfg.walk == (which == "a")
    assert (K.launch_blocks(m, n, tile, cfg) < 512) == (which == "a")
    got = K.gemm_k_inner(a, b, tile=tile)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(),
                               K.gemm_k_inner_plain(a, b).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("m", [4, 1024])
def test_backward_tied_head_reads_the_table_in_place(m):
    """The tied logits head: x @ table.t() reads the (V, D) table K-major
    at the planner's tile (a decode and a training batch of rows)."""
    table = (torch.randn(49408, 1536, device="cuda") * 0.02).to(
        torch.bfloat16)
    x = torch.randn(m, 1536, device="cuda").to(torch.bfloat16)
    copies = dict(K.COPIES)
    got = gemm.matmul(x, table.t())
    torch.cuda.synchronize()
    assert K.COPIES == copies
    torch.testing.assert_close(got.float(),
                               K.gemm_k_inner_plain(x, table.t()).float(),
                               rtol=2e-2, atol=2e-2)


#: (E, C, D, F): Moonlight-16B-A3B's expert products as one card of eight
#: holds them, 8 experts at their mean load of 768 rows: gate and up (D
#: 2048, F 1408) and down (D 1408, F 2048).  1,408 is no multiple of the
#: wide design's 256-wide tile, nor of the decode design's 64-deep slab.
MOONLIGHT_GROUPED = [(8, 768, 2048, 1408), (8, 768, 1408, 2048)]


@pytest.mark.parametrize("direction", ["forward", "dx", "dw"])
@pytest.mark.parametrize("e,c,d,f", MOONLIGHT_GROUPED)
def test_grouped_kernel_at_moonlight_expert_shapes(direction, e, c, d, f):
    """The forward on the wide design, dx (w K-major) and dw (x MN-major)
    on the decode design, each against ``torch.bmm`` in f32 on the same
    bf16 operands, within bf16 2e-2."""
    from repro_torch.kernels import grouped_gemm as G

    x, w = _grouped_operands(e, c, d, f, "bf16")
    dy = torch.randn(e, c, f, device="cuda").to(torch.bfloat16)
    p, q = {"forward": (x, w), "dx": (dy, w.transpose(1, 2)),
            "dw": (x.transpose(1, 2), dy)}[direction]
    assert G.plan(p, q).design == ("wide" if direction == "forward"
                                   else "decode")
    copies = dict(G.COPIES)
    got = G.grouped_gemm(p, q)
    torch.cuda.synchronize()
    assert G.COPIES == copies
    torch.testing.assert_close(got.float(), torch.bmm(p.float(), q.float()),
                               rtol=2e-2, atol=2e-2)


#: (E, C, D, F): granite's training shapes (C = 256), D and F no multiple
#: of 8 (the stored rows are copied to aligned ones), C not a multiple of 8
GROUPED_BACKWARD = [(40, 256, 1536, 512), (40, 256, 512, 1536),
                    (3, 24, 201, 75), (3, 21, 200, 72)]


@pytest.mark.parametrize("direction", ["dx", "dw"])
@pytest.mark.parametrize("e,c,d,f", GROUPED_BACKWARD)
def test_grouped_backward_layouts_match_plain_versions(direction, e, c, d,
                                                        f):
    """dx = dy·wᵀ reads w K-major and dw = xᵀ·dy reads x MN-major (walking
    the tiles of every expert), in place; within bf16 2e-2 of the plain
    version on the same views."""
    from repro_torch.kernels import grouped_gemm as G

    x, w = _grouped_operands(e, c, d, f, "bf16")
    dy = torch.randn(e, c, f, device="cuda").to(torch.bfloat16)
    p, q = ((dy, w.transpose(1, 2)) if direction == "dx"
            else (x.transpose(1, 2), dy))
    assert G.layout(p, q) == ((0, 0) if direction == "dx" else (1, 1))
    routes, copies = G.ROUTES["wgmma"], G.COPIES["transposed"]
    got = G.grouped_gemm(p, q)
    torch.cuda.synchronize()
    assert G.ROUTES["wgmma"] == routes + 1
    assert G.COPIES["transposed"] == copies
    torch.testing.assert_close(got.float(),
                               G.grouped_gemm_plain(p, q).float(),
                               rtol=2e-2, atol=2e-2)
