"""The int8 GEMM's tensor-core route (``csrc/wgmma_s8.cuh``), on the CPU.

What the CPU can hold the route to: its configuration (every tile the
planner picks is taken, and the shared memory it claims is the layout
written out below), the 16-byte row rule for int8 operands, the transposed
copy of B that 8-bit wgmma needs (its plain version), the wrapper's host
path through a stand-in library (copies, maps and launches per call), and
the C launchers' signatures.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``); on the CPU the wrappers run the plain
versions, which are held here bit for bit against the JAX package's Pallas
kernels in interpret mode.
"""
import contextlib
import ctypes
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

#: the int8 tiles the planner picks on cuda for h100: Table-2's four and
#: 128x128x128 for every Qwen2-1.5B GEMM at tokens=4096
PLANNED_INT8 = [(32, 256, 128), (64, 128, 128), (128, 128, 128),
                (128, 64, 128)]


def _int8_operands(m, n, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, size=(m, k)).astype(np.int8),
            rng.integers(-128, 128, size=(k, n)).astype(np.int8))


def test_int8_runs_on_the_tensor_cores():
    assert K.route(torch.int8) == K.route("int8") == "wgmma"
    assert K.route(torch.bfloat16) == "wgmma"
    assert K.route(torch.float32) == "cuda_cores"


def test_the_planner_picks_the_tiles_listed_here():
    shapes = [GemmShape(r.m, r.n, r.k, dtype="int8") for r in TABLE2]
    shapes += [GemmShape(s.m, s.n, s.k, dtype="int8") for s in
               model_gemm_shapes(get_config("qwen2-1.5b"), tokens=4096)]
    picks = {(d.selection.bm, d.selection.bn, d.selection.bk)
             for d in gemm.plan_many(shapes, backend="cuda", machine="h100")}
    assert picks == set(PLANNED_INT8)


#: k-inner's stages at each planner tile: as many as fit without fewer
#: blocks an SM than two stages leave (233,472 bytes an SM, 1,024 of them
#: reserved per block)
K_INNER_STAGES = {(32, 256, 128): 2, (64, 128, 128): 3, (128, 128, 128): 5,
                  (128, 64, 128): 3}


@pytest.mark.parametrize("k_outer", [False, True])
@pytest.mark.parametrize("tile", PLANNED_INT8)
def test_int8_config_is_the_written_out_layout(tile, k_outer):
    """A stage is one 128-k band of A (max(bm, 8) rows) and of B transposed
    (max(bn, 64) rows), 128 bytes a row; after the stages (each with a full
    and an empty 8-byte mbarrier) come the int32 C tile and its mbarrier.
    A k-outer pass (bk = 128) is one slab, so one stage."""
    bm, bn, bk = tile
    cfg = K.int8_config(TileConfig(*tile), k_outer=k_outer)
    stage = (max(bm, 8) + max(bn, 64)) * 128
    stages = 1 if k_outer else K_INNER_STAGES[tile]
    assert (cfg.ks, cfg.stage_bytes, cfg.stages) == (bk, stage, stages)
    assert cfg.smem_bytes == stages * (stage + 16) + bm * bn * 4 + 8
    if not k_outer:
        def blocks(n):
            return 233472 // (n * (stage + 16) + bm * bn * 4 + 8 + 1024)
        assert blocks(stages) == blocks(2)
        assert stages == K.S8_STAGES or blocks(stages + 1) < blocks(2) \
            or (stages + 1) * (stage + 16) + bm * bn * 4 + 8 > 232448
    assert cfg.smem_bytes <= K.MAX_SMEM_BYTES == 232448
    assert cfg.nw == min(max(bn, 64), 256)
    assert cfg.consumers == (2 if bm >= 128 else 1)
    assert cfg.threads == 128 * cfg.consumers + 32
    assert K.check_tile(TileConfig(*tile), torch.int8,
                        k_outer=k_outer) == cfg


def test_the_planners_qwen_tile_and_bf16s_tile_in_int8():
    """At 64x128x128 one stage is 24 KB (half bf16's 48 KB: one byte an
    element); three stages and the 32 KB C tile still leave room for two
    blocks per SM.  At 128x128x128, 32 KB stages and a 64 KB C tile: one
    block an SM whatever the ring, so it takes all five stages that fit."""
    inner = K.int8_config(TileConfig(64, 128, 128))
    assert (inner.stage_bytes, inner.stages) == (24 * 1024, 3)
    assert inner.smem_bytes == 3 * (24 * 1024 + 16) + 32 * 1024 + 8
    assert 2 * (inner.smem_bytes + 1024) <= 233472
    wide = K.int8_config(TileConfig(128, 128, 128))
    assert (wide.stage_bytes, wide.consumers, wide.stages) == (
        32 * 1024, 2, 5)
    assert wide.smem_bytes == 5 * (32 * 1024 + 16) + 64 * 1024 + 8


def test_the_stage_cap_bounds_the_int8_ring(monkeypatch):
    monkeypatch.setattr(K, "S8_STAGES", 2)
    assert K.int8_config(TileConfig(64, 128, 128)).stages == 2
    assert K.int8_config(TileConfig(128, 128, 128)).stages == 2
    monkeypatch.setattr(K, "S8_STAGES", 1)
    assert K.int8_config(TileConfig(128, 128, 128)).stages == 1


@pytest.mark.parametrize("shape", [(1 << 20, 1 << 20, 1 << 20),
                                   (100, 100, 100), (8, 8, 8)])
def test_int8_route_takes_every_feasible_h100_tile(shape):
    """No int8 plan the planner can return on h100 is refused."""
    m, n, k = (np.array([[x]]) for x in shape)
    mask = _feasible_mask(m, n, k, np.array([[1]]),
                          tmachines.get("h100").capacity("L1"))[0]
    bm, bn, bk, _ = _lattice()
    tiles = {(int(bm[i]), int(bn[i]), int(bk[i]))
             for i in np.flatnonzero(mask)}
    assert tiles
    for t in tiles:
        for k_outer in (False, True):
            cfg = K.int8_config(TileConfig(*t), k_outer=k_outer)
            assert cfg.smem_bytes <= K.MAX_SMEM_BYTES and cfg.stages >= 1


def test_a_deep_slab_that_does_not_fit_twice_is_staged_shallower():
    """128 x 64 x 1024: two 192 KB slabs cannot fit beside the 32 KB C
    tile; the slab is staged 512 deep (four bands), the pass stays 1024
    deep, two slabs of it."""
    cfg = K.int8_config(TileConfig(128, 64, 1024))
    assert (cfg.ks, cfg.stages, cfg.stage_bytes) == (512, 2, 4 * 192 * 128)
    assert K.int8_config(TileConfig(128, 64, 1024), k_outer=True).stages == 2


@pytest.mark.parametrize("tile,match", [
    (TileConfig(100, 128, 128), "power-of-two"),
    (TileConfig(1024, 1024, 128), "shared memory"),
])
def test_int8_route_refuses_what_it_does_not_take(tile, match):
    with pytest.raises(ValueError, match=match):
        K.int8_config(tile)
    with pytest.raises(ValueError, match=match):
        K.gemm_k_inner(torch.ones(8, 8, dtype=torch.int8),
                       torch.ones(8, 8, dtype=torch.int8), tile=tile)


@pytest.mark.parametrize("cols,copied", [(27, True), (1, True), (32, False),
                                         (16, False), (48, False),
                                         (8, True)])
def test_int8_rows_need_16_bytes(cols, copied):
    t = torch.zeros((5, cols), dtype=torch.int8)
    assert K.needs_aligned_copy(t) == copied
    if copied:
        c = K.aligned_copy(t)
        assert c.stride(0) % 16 == 0 and not K.needs_aligned_copy(c)
        assert torch.equal(c, t)
    # a single row is never stepped: no copy whatever its width
    assert not K.needs_aligned_copy(torch.zeros((1, cols), dtype=torch.int8))
    assert K._tma_row_stride(torch.zeros((1, cols), dtype=torch.int8)) == \
        -(-cols // 16) * 16


def test_bf16_rows_still_need_8_elements():
    assert K.needs_aligned_copy(torch.zeros((4, 12), dtype=torch.bfloat16))
    assert not K.needs_aligned_copy(torch.zeros((4, 16),
                                                dtype=torch.bfloat16))
    c = K.aligned_copy(torch.zeros((4, 12), dtype=torch.bfloat16))
    assert c.stride(0) == 16


@pytest.mark.parametrize("k,n", [(27, 49), (1, 1000), (32, 8), (390, 520),
                                 (17, 3)])
def test_plain_transposed_copy_is_b_transposed_with_a_zero_pad(k, n):
    rng = np.random.default_rng(k * n)
    b = torch.tensor(rng.integers(-128, 128, size=(k, n)), dtype=torch.int8)
    bt = K.transposed_copy(b)             # CPU: the plain version
    kp = -(-k // 16) * 16
    assert bt.shape == (n, k) and bt.stride() == (kp, 1)
    assert torch.equal(bt, b.t())
    padded = torch.as_strided(bt, (n, kp), (kp, 1))
    assert not bool(padded[:, k:].any())
    assert not K.needs_aligned_copy(bt)
    # a strided view of B transposes the same
    big = torch.zeros((k + 3, n + 5), dtype=torch.int8)
    big[2:2 + k, 1:1 + n] = b
    assert torch.equal(K.transposed_copy_plain(big[2:2 + k, 1:1 + n]),
                       b.t())


@pytest.mark.parametrize("m,k,bm,want", [
    (4096, 1536, 128, 32),      # all of A's rows fit the L2 budget
    (4096, 8960, 128, 14),      # 16 MB / (128 x 8960 x 1 B)
    (4096, 8960, 64, 29),       # bf16 would take 14 at this tile
    (32, 27, 32, 1),
])
def test_raster_group_with_one_byte_elements(m, k, bm, want):
    assert K.raster_group(m, k, bm, 1) == want
    assert K.raster_group(m, k, bm, 1) >= K.raster_group(m, k, bm)


_CTYPE_OF = {"int64_t": ctypes.c_int64, "int": ctypes.c_int}


@pytest.mark.parametrize("name", ["repro_gemm_s8", "repro_gemm_s8_encode",
                                  "repro_transpose_s8"])
def test_int8_library_functions_match_their_c_signatures(name):
    spec = build.target("gemm_int8")
    funcs = dict([(spec.launcher, spec.argtypes), *spec.helpers])
    assert set(funcs) == {"repro_gemm_s8", "repro_gemm_s8_encode",
                          "repro_transpose_s8"}
    with open(os.path.join(build.CSRC, spec.source)) as f:
        text = f.read()
    found = re.search(rf"\bint\s+{name}\s*\(([^)]*)\)", text)
    assert found, f"{name} is not defined in {spec.source}"
    params = [p.strip() for p in found.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in p
            else _CTYPE_OF[p.rsplit(None, 1)[0].replace("const", "").strip()]
            for p in params]
    assert list(funcs[name]) == want


def test_the_int8_build_no_longer_takes_the_cuda_core_tile():
    with open(os.path.join(build.CSRC, "tile_gemm.cuh")) as f:
        text = f.read()
    assert "int8" not in text.split("\n", 3)[-1] and "INT8" not in text
    assert build.target("gemm_f32").launcher == "repro_gemm_tile"


# ---------------------------------------------------------------------------
# The wrapper's host path, through a stand-in library
# ---------------------------------------------------------------------------

class _Lib:
    """Stands in for the int8 library: records every transpose, encode and
    launch, and succeeds."""

    def __init__(self):
        self.transposes, self.encodes, self.launches = [], [], []

    def repro_transpose_s8(self, b, bt, k, n, ldb, ldbt, stream):
        self.transposes.append((k, n, ldb, ldbt))
        return 0

    def repro_gemm_s8_encode(self, a, bt, c, *args):
        self.encodes.append(args[:-1])  # M, N, K, lda, ldbt, ldc, bm, bn, ks
        return 0

    def repro_gemm_s8(self, maps, cin, cout, *args):
        self.launches.append((cin is not None, *args))
        return 0


@pytest.fixture
def lib(monkeypatch):
    """The wrapper's CUDA path on CPU tensors, launching into ``_Lib``."""
    fake = _Lib()
    monkeypatch.setattr(build, "load", lambda name: fake)
    monkeypatch.setattr(K, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(K, "on_device",
                        lambda t: contextlib.nullcontext())
    monkeypatch.setattr(K, "raw_stream", lambda t: 0)
    K.reset_launch_counts()
    yield fake
    K.reset_launch_counts()


def test_k_inner_transposes_b_once_and_launches_once(lib):
    a = torch.zeros((4096, 1536), dtype=torch.int8)
    b = torch.zeros((1536, 2048), dtype=torch.int8)
    K.gemm_k_inner(a, b, tile=TileConfig(128, 128, 128))
    cfg = K.int8_config(TileConfig(128, 128, 128))
    assert lib.transposes == [(1536, 2048, 2048, 1536)]
    assert lib.encodes == [(4096, 2048, 1536, 1536, 1536, 2048, 128, 128,
                            cfg.ks)]
    # M, N, K, ldc, k0, k1, bm, bn, ks, stages, group, stream
    assert lib.launches == [(False, 4096, 2048, 1536, 2048, 0, 1536, 128,
                             128, cfg.ks, cfg.stages,
                             K.raster_group(4096, 1536, 128, 1), 0)]
    assert K.LAUNCHES == {"gemm_k_inner": 1, "gemm_k_outer": 0}
    assert K.ROUTES == {"wgmma": 1, "cuda_cores": 0}
    assert K.COPIES == {"aligned": 0, "transposed": 1}


def test_k_outer_passes_share_one_transposed_b(lib):
    """300 x 520 x 390 on 64x128x128: A's rows (390 bytes) are copied to
    400-byte rows, B is transposed once into rows of 400, and four passes
    stream C, the last one 6 deep."""
    a = torch.zeros((300, 390), dtype=torch.int8)
    b = torch.zeros((390, 520), dtype=torch.int8)
    c = torch.zeros((300, 520), dtype=torch.int32)
    K.gemm_k_outer(a, b, c, tile=TileConfig(64, 128, 128, GridOrder.K_OUTER))
    assert lib.transposes == [(390, 520, 520, 400)]
    assert [e[3:5] for e in lib.encodes] == [(400, 400)]
    assert [(cin, l[4], l[5]) for cin, *l in lib.launches] == [
        (True, 0, 128), (True, 128, 256), (True, 256, 384), (True, 384, 390)]
    assert K.LAUNCHES == {"gemm_k_inner": 0, "gemm_k_outer": 4}
    assert K.ROUTES == {"wgmma": 4, "cuda_cores": 0}
    assert K.COPIES == {"aligned": 1, "transposed": 1}


def test_a_zero_depth_product_launches_nothing(lib):
    out = K.gemm_k_inner(torch.zeros((8, 0), dtype=torch.int8),
                         torch.zeros((0, 8), dtype=torch.int8),
                         tile=TileConfig(64, 128, 128))
    assert torch.equal(out, torch.zeros((8, 8), dtype=torch.int32))
    assert lib.launches == [] and lib.transposes == []


# ---------------------------------------------------------------------------
# The plain versions against the JAX package's Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,k,tile", [
    (128, 256, 256, (64, 128, 128)),
    (256, 256, 384, (128, 128, 128)),
])
def test_int8_matches_the_pallas_kernels_bit_for_bit(m, n, k, tile):
    a_np, b_np = _int8_operands(m, n, k, m + n + k)
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    ja, jb = jnp.array(a_np), jnp.array(b_np)
    jt = JTileConfig(*tile, JGridOrder.K_INNER)
    got = K.gemm_k_inner(a, b, tile=TileConfig(*tile))
    want = np.asarray(jax_k_inner(ja, jb, tile=jt, interpret=True))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    c_np = np.random.default_rng(3).integers(-1000, 1000, size=(m, n)) \
        .astype(np.int32)
    got = K.gemm_k_outer(a, b, torch.from_numpy(c_np),
                         tile=TileConfig(*tile, GridOrder.K_OUTER))
    want = np.asarray(jax_k_outer(ja, jb, jnp.array(c_np),
                                  tile=JTileConfig(*tile, JGridOrder.K_OUTER),
                                  interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("order", [GridOrder.K_INNER, GridOrder.K_OUTER])
@pytest.mark.parametrize("m,n,k,tile", [
    (32, 256, 27, (32, 256, 128)),      # Table-2's K = 27 (N cut to 256)
    (64, 49, 512, (128, 64, 128)),      # Table-2's N = 49 (M cut to 64)
    (16, 200, 1, (64, 128, 128)),       # Table-2's K = 1
])
def test_int8_ragged_table2_shapes_match_the_padded_pallas_kernels(
        m, n, k, tile, order):
    """The port masks ragged edges; the JAX package pads to the tile
    (``ops.matmul``) and slices: the same integers either way."""
    a_np, b_np = _int8_operands(m, n, k, m * n + k)
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    t = TileConfig(*tile, order)
    if order is GridOrder.K_INNER:
        got = K.gemm_k_inner(a, b, tile=t)
    else:
        got = K.gemm_k_outer(a, b, torch.zeros((m, n), dtype=torch.int32),
                             tile=t)
    want = np.asarray(jax_matmul(
        jnp.array(a_np), jnp.array(b_np),
        tile=JTileConfig(*tile, JGridOrder(order.value)), interpret=True))
    assert want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_count_no_launch_and_no_copy():
    K.reset_launch_counts()
    a = torch.ones((40, 27), dtype=torch.int8)
    b = torch.ones((27, 49), dtype=torch.int8)
    K.gemm_k_inner(a, b, tile=TileConfig(32, 256, 128))
    K.gemm_k_outer(a, b, torch.zeros((40, 49), dtype=torch.int32),
                   tile=TileConfig(32, 256, 128, GridOrder.K_OUTER))
    assert K.LAUNCHES == {"gemm_k_inner": 0, "gemm_k_outer": 0}
    assert K.ROUTES == {"wgmma": 0, "cuda_cores": 0}
    assert K.COPIES == {"aligned": 0, "transposed": 0}
