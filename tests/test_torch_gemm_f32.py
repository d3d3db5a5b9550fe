"""The f32 GEMM's CUDA-core kernel (``csrc/tile_gemm.cuh``), on the CPU.

What the CPU can hold the kernel to: its configuration (``launch_config``
at every tile the planner picks and every feasible tile of the h100
lattice, and every tile the register-tiled kernel it replaced took), the
instantiations the source compiles for those tiles, the wrapper's host path
through a stand-in library (one library resolution a call, one launch per
k-outer pass, each pass's k range), and the plain versions against the JAX
package's Pallas kernels in interpret mode.  The kernel itself runs only
on the card (``tests/test_torch_cuda.py``).
"""
import contextlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tpu_model import GridOrder as JGridOrder
from repro.core.tpu_model import TileConfig as JTileConfig
from repro.kernels.gemm import gemm_k_inner as jax_k_inner
from repro.kernels.gemm import gemm_k_outer as jax_k_outer
from repro.kernels.ops import matmul as jax_matmul
from repro_torch import gemm
from repro_torch import machines as tmachines
from repro_torch.configs import get_config
from repro_torch.core.autotune import _feasible_mask, _lattice
from repro_torch.core.autotune import model_gemm_shapes
from repro_torch.core.mobilenet import TABLE2
from repro_torch.core.tpu_model import GemmShape, GridOrder, TileConfig
from repro_torch.kernels import build
from repro_torch.kernels import gemm as K

#: the f32 tiles the planner (the Hopper tile model) picks on cuda for
#: h100: 128x128x128 for every Qwen2-1.5B GEMM at tokens=4096 and
#: granite-moe-3b-a800m's logits at M = 32, the others for Table-2 and the
#: logits at decode (M <= 8)
PLANNED_F32 = [(8, 64, 128), (16, 8, 128), (16, 16, 128), (32, 16, 128),
               (32, 32, 128), (32, 512, 128), (64, 64, 128), (128, 128, 128),
               (2048, 8, 128)]
#: the TPU model's earlier f32 picks (phase 5 of chip_smoke.py still times
#: 32x64x128), still compiled with fixed extents
EARLIER_F32 = [(8, 128, 128), (32, 64, 128), (64, 32, 128)]


def _planner_f32_tiles():
    granite = get_config("granite-moe-3b-a800m")
    shapes = [GemmShape(s.m, s.n, s.k, dtype="f32") for s in
              model_gemm_shapes(get_config("qwen2-1.5b"), tokens=4096)]
    shapes += [GemmShape(r.m, r.n, r.k, dtype="f32") for r in TABLE2]
    shapes += [GemmShape(m, granite.padded_vocab, granite.d_model,
                         dtype="f32") for m in (1, 2, 4, 8, 32)]
    return sorted({(d.selection.bm, d.selection.bn, d.selection.bk)
                   for d in gemm.plan_many(shapes, backend="cuda",
                                           machine="h100")})


def _lattice_f32_tiles():
    h100 = tmachines.get("h100")
    tiles = set()
    for shape in ((1 << 20, 1 << 20, 1 << 20), (100, 100, 100), (8, 8, 8)):
        m, n, k = (np.array([[x]]) for x in shape)
        mask = _feasible_mask(m, n, k, np.array([[4]]),
                              h100.capacity("L1"))[0]
        bm, bn, bk, _ = _lattice()
        tiles |= {(int(bm[i]), int(bn[i]), int(bk[i]))
                  for i in np.flatnonzero(mask)}
    return sorted(tiles)


def _check_config(tile, cfg):
    bm, bn, bk = tile.bm, tile.bn, tile.bk
    assert cfg.rm * cfg.rn <= K.MAX_REGISTER_TILE
    assert bm % cfg.rm == 0 and bn % cfg.rn == 0
    assert cfg.threads == (bm // cfg.rm) * (bn // cfg.rn) <= K.MAX_THREADS
    assert bk % cfg.ks == 0 and cfg.ks <= 32
    assert 2 <= cfg.stages <= K.CORE_STAGES
    assert cfg.smem_bytes <= K.MAX_SMEM_BYTES == 232448
    assert cfg.blocks_per_sm >= 1


def test_the_planner_picks_the_listed_f32_tiles():
    assert _planner_f32_tiles() == PLANNED_F32


@pytest.mark.parametrize("k_outer", [False, True])
@pytest.mark.parametrize("t", EARLIER_F32 + [(64, 128, 128)] + PLANNED_F32)
def test_launch_config_at_the_planners_f32_tiles(t, k_outer):
    """At the planner's tiles, its earlier ones and phase 5's 64x128x128,
    whole sub-slabs divide the plan's slab; where a tile has 2,048 or more
    elements of C a thread owns 4 or more rows (2 at the 8-row tiles) and
    columns in 4-wide fragments; at the earlier tiles and 64x128x128 at
    least two blocks share an SM."""
    tile = TileConfig(*t)
    cfg = K.launch_config(tile, "f32", k_outer=k_outer)
    _check_config(tile, cfg)
    if tile.bm * tile.bn >= 2048:
        assert cfg.rn >= 4 and cfg.rm >= (2 if tile.bm == 8 else 4)
    assert cfg.blocks_per_sm >= (1 if t in PLANNED_F32 else 2)
    assert K.smem_bytes(tile, "f32", k_outer=k_outer) == cfg.smem_bytes


@pytest.mark.parametrize("k_outer", [False, True])
def test_launch_config_takes_every_feasible_h100_f32_tile(k_outer):
    tiles = _lattice_f32_tiles()
    assert len(tiles) > 30
    for t in tiles:
        tile = TileConfig(*t)
        _check_config(tile, K.launch_config(tile, "f32", k_outer=k_outer))


def test_the_blocks_the_design_names():
    """8x8 at 64x128 on 128 threads, in 32-deep sub-slabs through three
    stages of A's 64 rows of 36 floats and B's 32 rows of 128: 76,800 B,
    three blocks an SM by shared memory (k-inner); k-outer adds the 32 KB C
    tile and keeps two.  4x8 at 32x64 on 64 threads."""
    inner = K.launch_config(TileConfig(64, 128, 128))
    outer = K.launch_config(TileConfig(64, 128, 128), k_outer=True)
    assert inner[:5] == outer[:5] == (128, 8, 8, 32, 3)
    assert inner.smem_bytes == 3 * (64 * 36 + 32 * 128) * 4 == 76800
    assert outer.smem_bytes == inner.smem_bytes + 64 * 128 * 4
    assert (inner.blocks_per_sm, outer.blocks_per_sm) == (3, 2)
    small = K.launch_config(TileConfig(32, 64, 128))
    assert small[:5] == (64, 4, 8, 32, 3)
    assert small.smem_bytes == 3 * (32 * 36 + 32 * 64) * 4
    # decode's and the MoE experts' narrow tile: 128 threads of 2x4
    assert K.launch_config(TileConfig(8, 128, 128))[:4] == (128, 2, 4, 32)
    # a k-outer pass of one sub-slab keeps two stages, not three
    one = K.launch_config(TileConfig(32, 64, 32), k_outer=True)
    assert (one.ks, one.stages) == (32, 2)


def _taken_before(bm, bn, bk):
    """Whether the register-tiled kernel this one replaced took the f32
    tile (its launch_config and its C dispatch): TX = min(bn, 32) threads
    across, at most 256 in all, RM x RN <= 64 with RN <= 32, the whole
    bm x bk and bk x bn slabs in shared memory."""
    threads = min(256, bm * bn)
    tx = min(bn, 32)
    rm, rn = bm // (threads // tx), bn // tx
    return (1 <= rm and rm * rn <= 64 and rn <= 32
            and (bm * bk + bk * bn) * 4 <= 232448)


def _compiled(kind):
    """The (args) of each REPRO_TILE_<kind>(...) line of tile_gemm.cuh."""
    with open(os.path.join(build.CSRC, "tile_gemm.cuh")) as f:
        text = f.read()
    return {tuple(int(x) for x in m.group(1).split(","))
            for m in re.finditer(rf"REPRO_TILE_{kind}\((\d+(?:, *\d+)*)\)",
                                 text)}


def test_the_compiled_register_tiles_are_the_ones_tiles_reach():
    """The source instantiates, with run-time extents, exactly the register
    tiles some tile launch_config takes is given (no unreachable kernel
    costs build time)."""
    reached = set()
    for a in range(15):
        for b in range(15 - a):
            reached.add(K.register_tile(1 << a, 1 << b))
    assert _compiled("ANY") == reached


def test_every_tile_taken_before_is_still_taken_and_compiled():
    """No plan stops running: every power-of-two tile the old kernel took
    is taken, in both orders, and its register tile is one the source
    instantiates with run-time extents."""
    anywhere = _compiled("ANY")
    taken = [(1 << a, 1 << b, 1 << c) for a in range(15) for b in range(15)
             for c in range(15) if _taken_before(1 << a, 1 << b, 1 << c)]
    assert len(taken) > 800
    for t in taken:
        for k_outer in (False, True):
            cfg = K.launch_config(TileConfig(*t), "f32", k_outer=k_outer)
            _check_config(TileConfig(*t), cfg)
            assert (cfg.rm, cfg.rn) in anywhere, t


def test_the_fixed_instantiations_are_the_planners_tiles():
    """Each instantiation with compile-time extents is reached: its
    sub-slab depth is the one launch_config gives the tile at bk = 128,
    and it covers every f32 tile the planner picks."""
    fixed = _compiled("FIXED")
    for bm, bn, ks in fixed:
        assert K.launch_config(TileConfig(bm, bn, 128)).ks == ks
    assert {(bm, bn) for bm, bn, _ in fixed} >= {(bm, bn) for bm, bn, _ in
                                                 PLANNED_F32 + EARLIER_F32}


@pytest.mark.parametrize("tile,match", [
    (TileConfig(256, 128, 128), "register tiles"),
    (TileConfig(64, 96, 128), "power-of-two"),
])
def test_launch_config_refuses_what_the_kernel_does_not_take(tile, match):
    with pytest.raises(ValueError, match=match):
        K.launch_config(tile, "f32")


# ---------------------------------------------------------------------------
# The wrapper's host path, through a stand-in library
# ---------------------------------------------------------------------------

class _Lib:
    """Stands in for the f32 library: records every launch, succeeds."""

    def __init__(self):
        self.launches = []

    def repro_gemm_tile(self, a, b, cin, cout, *args):
        self.launches.append((a, b, cin, cout, *args))
        return 0


@pytest.fixture
def lib(monkeypatch):
    """The wrapper's CUDA path on CPU tensors, launching into ``_Lib``;
    counts how often the library is resolved."""
    fake = _Lib()
    loads = []

    def load(name):
        loads.append(name)
        return fake

    monkeypatch.setattr(build, "load", load)
    monkeypatch.setattr(K, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(K, "on_device", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(K, "raw_stream", lambda t: 7)
    K.reset_launch_counts()
    fake.loads = loads
    yield fake
    K.reset_launch_counts()


def test_k_inner_is_one_launch_over_the_whole_depth(lib):
    a, b = torch.zeros((300, 390)), torch.zeros((390, 520))
    out = K.gemm_k_inner(a, b, tile=TileConfig(32, 64, 128))
    assert out.shape == (300, 520) and out.dtype == torch.float32
    # M, N, k0, k1, lda, ldb, ldc, bm, bn, bk, group, stream
    assert [l[4:] for l in lib.launches] == [
        (300, 520, 0, 390, 390, 520, 520, 32, 64, 128,
         K.raster_group(300, 390, 32, 4), 7)]
    assert lib.launches[0][2] is None
    assert lib.loads == ["gemm_f32"]
    assert K.LAUNCHES == {"gemm_k_inner": 1, "gemm_k_outer": 0}
    assert K.ROUTES == {"wgmma": 0, "cuda_cores": 1}


def test_k_outer_launches_once_a_pass_with_its_k_range(lib):
    """300 x 520 x 390 on 64x128x128: four passes over the same operands
    (no slices of A or B), the last one 6 deep, each adding into the
    clone of C; the library is resolved once for all of them."""
    a, b = torch.zeros((300, 390)), torch.zeros((390, 520))
    c = torch.ones((300, 520))
    out = K.gemm_k_outer(a, b, c, tile=TileConfig(64, 128, 128,
                                                  GridOrder.K_OUTER))
    assert lib.loads == ["gemm_f32"]
    assert [(l[6], l[7]) for l in lib.launches] == [
        (0, 128), (128, 256), (256, 384), (384, 390)]
    ptrs = {(l[0], l[1], l[2], l[3]) for l in lib.launches}
    assert ptrs == {(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                     out.data_ptr())}
    assert out.data_ptr() != c.data_ptr()
    assert {l[-2] for l in lib.launches} == {K.raster_group(300, 128, 64, 4)}
    assert K.LAUNCHES == {"gemm_k_inner": 0, "gemm_k_outer": 4}
    assert K.ROUTES == {"wgmma": 0, "cuda_cores": 4}


@pytest.mark.parametrize("k,bk,passes", [(1536, 128, 12), (8960, 128, 70),
                                         (27, 128, 1), (390, 256, 2)])
def test_k_outer_pass_count_is_ceil_k_over_bk(lib, k, bk, passes):
    a, b = torch.zeros((8, k)), torch.zeros((k, 8))
    K.gemm_k_outer(a, b, torch.zeros((8, 8)),
                   tile=TileConfig(8, 128, bk, GridOrder.K_OUTER))
    assert K.LAUNCHES["gemm_k_outer"] == passes == -(-k // bk)
    bounds = [(l[6], l[7]) for l in lib.launches]
    assert bounds == [(k0, min(k0 + bk, k)) for k0 in range(0, k, bk)]


def test_zero_depth_and_empty_products(lib):
    """K = 0: k-inner still launches once (the kernel writes the zeros),
    k-outer none; an empty C launches nothing."""
    K.gemm_k_inner(torch.zeros((8, 0)), torch.zeros((0, 8)),
                   tile=TileConfig(8, 128, 128))
    assert [(l[6], l[7]) for l in lib.launches] == [(0, 0)]
    c = torch.ones((8, 8))
    out = K.gemm_k_outer(torch.zeros((8, 0)), torch.zeros((0, 8)), c,
                         tile=TileConfig(8, 128, 128, GridOrder.K_OUTER))
    assert torch.equal(out, c) and len(lib.launches) == 1
    K.gemm_k_inner(torch.zeros((0, 5)), torch.zeros((5, 8)),
                   tile=TileConfig(8, 128, 128))
    assert len(lib.launches) == 1


def test_a_failed_launch_raises_with_the_pass(lib, monkeypatch):
    monkeypatch.setattr(lib, "repro_gemm_tile", lambda *args: 1)
    lib.repro_cuda_error_string = lambda err: b"invalid argument"
    with pytest.raises(RuntimeError, match=r"k 0\.\.128.*invalid argument"):
        K.gemm_k_outer(torch.zeros((8, 256)), torch.zeros((256, 8)),
                       torch.zeros((8, 8)),
                       tile=TileConfig(8, 128, 128, GridOrder.K_OUTER))
    assert K.LAUNCHES["gemm_k_outer"] == 0


# ---------------------------------------------------------------------------
# The plain versions against the JAX package's Pallas kernels
# ---------------------------------------------------------------------------

def _f32_operands(m, n, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32),
            rng.normal(size=(m, n)).astype(np.float32))


@pytest.mark.parametrize("order", [GridOrder.K_INNER, GridOrder.K_OUTER])
@pytest.mark.parametrize("m,n,k,tile", [
    (70, 90, 150, (32, 64, 128)),       # ragged in M, N, K and the last pass
    (40, 49, 27, (64, 32, 128)),        # Table-2's K = 27 and N = 49
])
def test_f32_ragged_shapes_match_the_padded_pallas_kernels(m, n, k, tile,
                                                           order):
    """The port masks ragged edges; the JAX package pads to the tile
    (``ops.matmul``) and slices.  k-outer adds C once per pass."""
    a_np, b_np, c_np = _f32_operands(m, n, k, m + n + k)
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    t = TileConfig(*tile, order)
    jt = JTileConfig(*tile, JGridOrder(order.value))
    if order is GridOrder.K_INNER:
        got = K.gemm_k_inner(a, b, tile=t)
        want = jax_matmul(jnp.array(a_np), jnp.array(b_np), tile=jt,
                          interpret=True)
    else:
        got = K.gemm_k_outer(a, b, torch.from_numpy(c_np), tile=t)
        want = jnp.array(c_np) + jax_matmul(jnp.array(a_np), jnp.array(b_np),
                                            tile=jt, interpret=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("m,n,k,tile", [(64, 128, 256, (32, 64, 128)),
                                        (128, 64, 384, (64, 32, 128))])
def test_f32_matches_the_pallas_loop_orders(m, n, k, tile):
    """Divisible shapes straight through the two Pallas kernels: k-inner's
    one rounding and k-outer's per-pass sum into C."""
    a_np, b_np, c_np = _f32_operands(m, n, k, 11)
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    got = K.gemm_k_inner(a, b, tile=TileConfig(*tile))
    want = jax_k_inner(jnp.array(a_np), jnp.array(b_np),
                       tile=JTileConfig(*tile, JGridOrder.K_INNER),
                       interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    got = K.gemm_k_outer(a, b, torch.from_numpy(c_np),
                         tile=TileConfig(*tile, GridOrder.K_OUTER))
    want = jax_k_outer(jnp.array(a_np), jnp.array(b_np), jnp.array(c_np),
                       tile=JTileConfig(*tile, JGridOrder.K_OUTER),
                       interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
