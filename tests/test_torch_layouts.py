"""The wgmma kernels' operand layouts (``csrc/wgmma_gemm.cuh``), on the CPU.

The bf16 GEMM and grouped GEMM read a transposed operand in place: A stored
(K, M) as MN-major (``ta = 1``), or B stored (N, K) as K-major (``tb = 0``);
both keep a deeper ring than the row-major layout, and MN-major A walks its
tiles persistently.  What the CPU can hold them
to: the Python mirror of the kernel's stage geometry in each layout (shared
memory, stages, blocks an SM, blocks a launch), the tiles the planner picks
for the backward products' shapes taken in their layouts, the layout read
from an operand's strides, the copies a route makes of what it does not
read in place, and the plain versions on the transposed views against a
float64 product.  The kernels themselves run on the card
(``tests/test_torch_cuda.py -k backward``).

    PYTHONPATH=src python -m pytest -q tests/test_torch_layouts.py

Tolerances against float64: bf16 rtol = atol = 2e-2, f32 rtol 1e-5 / atol
1e-5 (both sum in f32 and round once).
"""
import numpy as np
import pytest
import torch

from repro_torch import gemm
from repro_torch.configs import get_config
from repro_torch.core.autotune import model_gemm_shapes
from repro_torch.core.tpu_model import GridOrder, TileConfig
from repro_torch.kernels import gemm as K
from repro_torch.kernels import grouped_gemm as G

ROW, A_T, B_T = (0, 1), (1, 1), (0, 0)


@pytest.mark.parametrize("layout", [ROW, A_T, B_T])
def test_the_planners_backward_tile_in_each_layout(layout):
    """At 128x128x128 (the cuda planner's tile for every Qwen2-1.5B
    backward product at 1,024 tokens) a stage is 64 KB in every layout
    (A 128 x 128 and B 128 x 128 bf16).  The row-major layout keeps two
    stages; a transposed one three, which still hold one block an SM
    (with the 32 KB C tile); MN-major A walks its tiles: at most 132
    blocks."""
    cfg = K.wgmma_config(TileConfig(128, 128, 128), ta=layout[0],
                         tb=layout[1])
    assert cfg.stage_bytes == 64 * 1024 and cfg.consumers == 2
    stages = 2 if layout == ROW else 3
    assert cfg.stages == stages and cfg.walk == (layout == A_T)
    # the stages with their two 8-byte mbarriers, the C tile, its mbarrier
    assert cfg.smem_bytes == stages * (64 * 1024 + 16) + 128 * 128 * 2 + 8
    assert cfg.smem_bytes <= K.MAX_SMEM_BYTES and cfg.blocks_per_sm == 1
    tile = TileConfig(128, 128, 128)
    # dB of gate_up at 1,024 tokens: 1,680 tiles
    assert K.launch_blocks(1536, 17920, tile, cfg) == (
        K.SMS if layout == A_T else 1680)
    assert K.launch_blocks(1024, 1536, tile, cfg) == 96


@pytest.mark.parametrize("tile,layout,a,b,pad", [
    # bm = 32: K-major A is two 64-column bands of 32 rows and the pad an
    # m64 read reaches into; MN-major A one band of 64 M columns, 128 rows
    ((32, 128, 128), ROW, 2 * 32 * 128, 2 * 128 * 128, 32 * 128),
    ((32, 128, 128), A_T, 1 * 128 * 128, 2 * 128 * 128, 0),
    # bn = 32: MN-major B one band of 64 N columns; K-major B two bands of
    # 64 rows (the instruction reads N = 64 rows)
    ((64, 32, 128), ROW, 2 * 64 * 128, 1 * 128 * 128, 0),
    ((64, 32, 128), B_T, 2 * 64 * 128, 2 * 64 * 128, 0),
    # a slab of 8 (ks < 16): one k16 step of rows, one band of columns
    ((64, 128, 8), A_T, 1 * 16 * 128, 2 * 16 * 128, 0),
    ((64, 128, 8), B_T, 1 * 64 * 128, 1 * 128 * 128, 0),
])
def test_stage_geometry_mirrors_geom(tile, layout, a, b, pad):
    """``_wgmma_stage`` lays a stage out as ``Geom`` in
    csrc/wgmma_gemm.cuh does, 128 bytes a row, in each layout."""
    bm, bn, bk = tile
    stage, rest = K._wgmma_stage(bm, bn, bk, True, *layout)
    assert stage == a + b
    assert rest == -(-bm * bn * 2 // 128) * 128 + pad + 8


def _backward_shapes():
    """(m, n, k, layout) of every backward product of Qwen2-1.5B at 1,024
    and 4,096 tokens (dA reads B^T, dB reads A^T; the tied head's dA reads
    the table as stored and its dB computes (dC^T.A)^T) and of the tied
    head's forward at serving's batches (B the table's .t())."""
    qwen = get_config("qwen2-1.5b")
    out = []
    for tokens in (1024, 4096):
        for i, s in enumerate(model_gemm_shapes(qwen, tokens=tokens)):
            tied = i == 4
            out.append((s.m, s.k, s.n, ROW if tied else B_T))
            out.append((s.n, s.k, s.m, A_T) if tied
                       else (s.k, s.n, s.m, A_T))
    out += [(m, qwen.padded_vocab, qwen.d_model, B_T) for m in (1, 4, 32)]
    return out


@pytest.mark.parametrize("m,n,k,layout", _backward_shapes())
def test_the_planners_picks_run_in_the_products_layout(m, n, k, layout):
    """The cuda planner prices the row-major layout; every tile it picks
    for a backward product (or the tied head) is taken in the layout that
    product reads, within a block's shared memory."""
    t = gemm.plan((m, n, k), backend="cuda", dtype="bf16").selection
    k_outer = t.order is GridOrder.K_OUTER
    cfg = K.check_tile(t, "bf16", k_outer=k_outer, layout=layout)
    assert cfg.smem_bytes <= K.MAX_SMEM_BYTES
    assert cfg.walk == (layout == A_T and not k_outer)
    assert cfg.stages >= (2 if cfg.walk else 1)


def test_a_transposed_layout_needs_two_stages_and_one_transposed_operand():
    with pytest.raises(ValueError, match="one transposed operand"):
        K.wgmma_config(TileConfig(64, 128, 128), ta=1, tb=0)
    with pytest.raises(ValueError, match="one slab late"):
        # one 66 KB stage and the 128 KB C tile fit; two stages do not
        K.wgmma_config(TileConfig(2048, 32, 128), ta=1, tb=1)
    # a k-outer pass of one slab holds one stage, released at its end
    cfg = K.wgmma_config(TileConfig(128, 128, 128, GridOrder.K_OUTER),
                         k_outer=True, ta=1, tb=1)
    assert cfg.stages == 1 and not cfg.walk


def test_grouped_backward_config_at_granites_training_shapes():
    """dx = dy.w^T (C = 256 rows) and dw = x^T.dy (D = 1,536 or 512 rows)
    run the route's 128 x 64 x 64 tile: a 24 KB stage in every layout; the
    row-major ring of two stages holds three blocks an SM, a transposed
    one of four two; dw walks every expert's tiles."""
    for c in (256, 1536, 512):
        tile = G.grouped_tile(c, torch.bfloat16)
        assert (tile.bm, tile.bn, tile.bk) == (128, 64, 64)
        for layout in (ROW, A_T, B_T):
            cfg = G.grouped_config(tile, layout)
            assert cfg.stage_bytes == 24 * 1024
            assert cfg.walk == (layout == A_T)
            assert (cfg.stages, G.resident_blocks(cfg)) == (
                (2, 3) if layout == ROW else (4, 2))
    cfg = G.grouped_config(G.grouped_tile(1536, torch.bfloat16), A_T)
    tiles = 40 * (1536 // 128) * (512 // 64)
    assert K.launch_blocks(1536, 512, TileConfig(128, 64, 64), cfg, 40) == \
        min(tiles, cfg.blocks_per_sm * K.SMS) < tiles


def test_layout_is_read_from_the_strides():
    a = torch.zeros(6, 8, dtype=torch.bfloat16)
    b = torch.zeros(8, 5, dtype=torch.bfloat16)
    at = torch.zeros(8, 6, dtype=torch.bfloat16).t()
    bt = torch.zeros(5, 8, dtype=torch.bfloat16).t()
    assert K.wgmma_layout(a, b) == ROW
    assert K.wgmma_layout(at, b) == A_T
    assert K.wgmma_layout(a, bt) == B_T
    assert K.wgmma_layout(at, bt) == (1, 0)
    with pytest.raises(ValueError, match="transposes"):
        K.wgmma_layout(torch.zeros(6, 16, dtype=torch.bfloat16)[:, ::2], b)
    x = torch.zeros(2, 6, 8, dtype=torch.bfloat16)
    w = torch.zeros(2, 8, 5, dtype=torch.bfloat16)
    xt = torch.zeros(2, 8, 6, dtype=torch.bfloat16).transpose(1, 2)
    wt = torch.zeros(2, 5, 8, dtype=torch.bfloat16).transpose(1, 2)
    assert G.layout(x, w) == ROW and G.layout(xt, w) == A_T
    assert G.layout(x, wt) == B_T
    assert G.layout(xt, wt) == B_T            # x is copied first
    assert G.layout(xt.float(), wt.float()) == ROW   # f32 reads row-major
    with pytest.raises(ValueError, match="transpose"):
        G.layout(x[:, :, ::2], w[:, ::2])


@pytest.mark.parametrize("dtype,copied", [
    (torch.bfloat16, {(1, 0): 1, (1, 1): 0, (0, 0): 0}),
    (torch.float32, {(1, 0): 2, (1, 1): 1, (0, 0): 1}),
    (torch.int8, {(1, 0): 2, (1, 1): 1, (0, 0): 1}),
])
def test_what_a_route_does_not_read_in_place_is_copied_and_counted(dtype,
                                                                    copied):
    """bf16 reads one transposed operand in place (with two, A is copied);
    f32 and int8 read row-major operands only.  Every copy counts in
    ``COPIES["transposed"]`` and holds the same values."""
    a = torch.arange(48, dtype=torch.float32).reshape(6, 8).to(dtype)
    b = torch.arange(40, dtype=torch.float32).reshape(8, 5).to(dtype)
    for (ta, tb), n in copied.items():
        x = a.t().contiguous().t() if ta else a
        y = b if tb else b.t().contiguous().t()
        K.reset_launch_counts()
        x2, y2, layout = K._as_read(x, y)
        assert K.COPIES["transposed"] == n
        assert torch.equal(x2, a) and torch.equal(y2, b)
        if dtype == torch.bfloat16:
            assert layout == ((0, 0) if (ta, tb) == (1, 0) else (ta, tb))
        else:
            assert layout == ROW


def test_grouped_copies_what_its_route_does_not_read_in_place():
    x = torch.randn(2, 6, 8)
    w = torch.randn(2, 8, 5)
    xt, wt = x.transpose(1, 2).contiguous(), w.transpose(1, 2).contiguous()
    for dt, want in ((torch.bfloat16, 1), (torch.float32, 2)):
        xv, wv = xt.to(dt).transpose(1, 2), wt.to(dt).transpose(1, 2)
        p = G.plan(xv, wv)
        G.reset_launch_counts()
        x2, w2 = G._as_read(xv, wv, p)
        assert G.COPIES["transposed"] == want
        assert torch.equal(x2, x.to(dt)) and torch.equal(w2, w.to(dt))


def test_map_key_keys_on_the_layout():
    tile = TileConfig(128, 64, 64)
    args = ("x", 0x7F0000001000, 256, 1536, 40, 1536, 256 * 1536, tile)
    assert G.map_key(*args) == G.map_key(*args, False)
    assert G.map_key(*args, True) != G.map_key(*args)


def _f64(x, y):
    return x.double() @ y.double()


@pytest.mark.parametrize("dt,tol", [("bfloat16", 2e-2), ("float32", 1e-5)])
def test_plain_versions_on_transposed_views_match_float64(dt, tol):
    """The plain versions (what a CPU tensor runs, and what the card's
    kernels are held to) on the backward products' views: dA = dC.B^T,
    dB = A^T.dC, the tied head's (dC^T.A)^T, grouped dx = dy.w^T and
    dw = x^T.dy."""
    rng = np.random.default_rng(0)
    dtype = getattr(torch, dt)

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(size=shape) * scale).to(dtype)

    a, b, dc = t(33, 40), t(40, 24, scale=40 ** -0.5), t(33, 24)
    for x, y in ((dc, b.t()), (a.t(), dc), (dc.t(), a)):
        got = K.gemm_k_inner_plain(x, y)
        np.testing.assert_allclose(got.double().numpy(),
                                   _f64(x, y).to(dtype).double().numpy(),
                                   rtol=tol, atol=tol)
    xg, wg, dy = t(3, 21, 40), t(3, 40, 24, scale=40 ** -0.5), t(3, 21, 24)
    for x, y in ((dy, wg.transpose(1, 2)), (xg.transpose(1, 2), dy)):
        got = G.grouped_gemm(x, y)
        np.testing.assert_allclose(got.double().numpy(),
                                   _f64(x, y).to(dtype).double().numpy(),
                                   rtol=tol, atol=tol)
