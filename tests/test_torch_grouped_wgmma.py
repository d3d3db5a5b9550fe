"""The bf16 grouped GEMM's tensor-core route, on the CPU.

``csrc/grouped_gemm.cu`` runs the bf16 MoE expert products on the kernel
body of ``csrc/wgmma_gemm.cuh`` with the expert as ``blockIdx.z`` and rank-3
tensor maps.  What the CPU can hold that route to: the route per dtype,
its configuration at every shape the card tests launch (shared memory,
stages, blocks per SM, blocks per launch), the aligned copies of operands
TMA cannot read in place, the tensor-map cache's key, the launch counters
and the C launchers' signatures.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``); on the CPU the wrapper runs its plain
version, held here against the JAX package's Pallas kernel (interpret mode)
at a ragged D and F, on the operands as given and on their aligned copies.

    PYTHONPATH=src python -m pytest tests/test_torch_grouped_wgmma.py -q

Tolerances against the Pallas kernel: bf16 rtol = atol = 2e-2, f32 rtol
1e-5 / atol 1e-4 (both sum in f32 and round once; the order differs).
"""
import ast
import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_gemm import grouped_gemm_kernel
from repro_torch.core.tpu_model import TileConfig
from repro_torch.interop import operands_from_numpy
from repro_torch.kernels import build
from repro_torch.kernels import gemm as K
from repro_torch.kernels import grouped_gemm as G

HERE = os.path.dirname(os.path.abspath(__file__))


def _card_shapes():
    """``GROUPED_SHAPES`` of ``tests/test_torch_cuda.py``, read from its
    source (that module is the card's)."""
    with open(os.path.join(HERE, "test_torch_cuda.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "GROUPED_SHAPES"
                for t in node.targets):
            return [tuple(s) for s in ast.literal_eval(node.value)]
    raise AssertionError("tests/test_torch_cuda.py has no GROUPED_SHAPES")


CARD_SHAPES = _card_shapes()
#: granite-moe-3b-a800m's expert products in the served run: decode at
#: max_batch 4 (C = 32) and one request's prefill at bucket 32 (C = 8)
SERVED = [(40, 32, 1536, 512), (40, 32, 512, 1536), (40, 8, 1536, 512),
          (40, 8, 512, 1536)]
#: D and F no multiple of 8: both operands' rows need aligned copies
RAGGED_DF = (3, 24, 201, 75)
#: the benchmark's granite pass at 4,096 tokens (819 rows an expert) and a
#: C that is a multiple of 128: the wide design's shapes
WIDE = [(40, 819, 1536, 1024), (40, 819, 512, 1536), (8, 1024, 1536, 1024)]
#: the decode design's configuration at the served shapes before the wide
#: design was added: (tile, stages, shared memory, threads)
SERVED_CONFIG = {8: (TileConfig(8, 64, 64), 3, 35896, 160),
                 32: (TileConfig(32, 64, 64), 3, 45112, 160)}


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wgmma"),
                                        (torch.float32, "cuda_cores")])
def test_route_per_dtype(dtype, want):
    assert G.route(dtype) == want


@pytest.mark.parametrize("dtype", [torch.int8, torch.float16])
def test_route_refuses_other_dtypes(dtype):
    with pytest.raises(ValueError, match="bf16 or f32"):
        G.route(dtype)


def test_the_card_tests_cover_the_served_and_ragged_shapes():
    assert set(SERVED) <= set(CARD_SHAPES)
    assert RAGGED_DF in CARD_SHAPES
    assert set(WIDE) <= set(CARD_SHAPES)


def _meta(e, c, d, f, dtype=torch.bfloat16):
    return (torch.empty(e, c, d, dtype=dtype, device="meta"),
            torch.empty(e, d, f, dtype=dtype, device="meta"))


@pytest.mark.parametrize("e,c,d,f", CARD_SHAPES)
def test_route_config_at_every_card_shape(e, c, d, f):
    """Under :data:`WIDE_MIN_C` rows an expert the bf16 tile is the decode
    design's: it fits a Hopper block's shared memory with a ring of at
    least two stages, three blocks share an SM, and every served shape
    launches more blocks than the card has SMs.  From it, the wide
    design's 128 x 256 x 64 tile, one 384-thread block an SM.  The f32
    tile is one the CUDA-core kernel takes."""
    p = G.plan(*_meta(e, c, d, f))
    tile = p.tile
    if c < G.WIDE_MIN_C:
        assert p.design == "decode" and tile == G.grouped_tile(
            c, torch.bfloat16)
        assert tile.bm >= min(c, G.MAX_BLOCK_C) and tile.bm < 2 * max(c, 1)
        assert (tile.bn, tile.bk) == (G.WGMMA_BLOCK_F, G.WGMMA_BLOCK_K)
        cfg = G.check_tile(tile, torch.bfloat16)
        assert cfg.smem_bytes <= K.MAX_SMEM_BYTES
        assert 2 <= cfg.stages <= G.WGMMA_MAX_STAGES and cfg.ks == tile.bk
        assert G.resident_blocks(cfg) >= G.WGMMA_BLOCKS_PER_SM
        assert cfg.threads == 128 * cfg.consumers + 32 and cfg.nw == 64
    else:
        assert p.design == "wide" and tile == G.WIDE_TILE
        cfg = G.wide_config()
        assert cfg.smem_bytes <= K.MAX_SMEM_BYTES and cfg.walk
        assert (cfg.nw, cfg.consumers, cfg.threads) == (256, 2, 384)
    assert (p.ks, p.stages) == (cfg.ks, cfg.stages)
    if (e, c, d, f) in SERVED:
        assert G.grid_blocks(e, c, f, tile) >= G.SMS
    threads = G.check_tile(G.grouped_tile(c, torch.float32),
                           torch.float32).threads
    assert threads <= K.MAX_THREADS


@pytest.mark.parametrize("c,want", [
    (8, "decode"), (32, "decode"), (64, "decode"), (65, "wide"),
    (128, "wide"), (819, "wide"), (1024, "wide")])
@pytest.mark.parametrize("f", [512, 1024, 1536])
def test_the_design_turns_wide_at_the_threshold(c, want, f):
    """The row-major forward takes the wide design from 65 rows an expert,
    where the decode design's tile is 128 rows too; an F that is no
    multiple of 8 (y's tiles not stored by TMA) keeps the decode design."""
    assert G.WIDE_MIN_C == 65
    assert G.design(c, f) == want
    assert G.design(c, f + 3) == "decode"
    assert G.plan(*_meta(40, c, 512, f)).design == want
    assert G.plan(*_meta(40, c, 512, f, torch.float32)).design is None


@pytest.mark.parametrize("c", [32, 256, 819])
@pytest.mark.parametrize("lay", [(0, 0), (1, 1)])
def test_the_backward_layouts_keep_the_decode_design(c, lay):
    """dx reads w K-major (0, 0) and dw reads x MN-major (1, 1) at any C:
    their plans are the decode design's, configured as before."""
    assert G.design(c, 1536, lay) == "decode"
    x, w = _meta(40, c, 512, 1536)
    p = G.plan(x, w, lay=lay)
    assert p.design == "decode" and p.layout == lay
    cfg = G.grouped_config(G.grouped_tile(c, torch.bfloat16), lay)
    assert (p.tile, p.ks, p.stages) == (G.grouped_tile(c, torch.bfloat16),
                                        cfg.ks, cfg.stages)
    dx = (torch.empty(40, c, 1536, dtype=torch.bfloat16, device="meta"),
          torch.empty(40, 512, 1536, dtype=torch.bfloat16,
                      device="meta").transpose(1, 2))
    dw = (torch.empty(40, c, 512, dtype=torch.bfloat16,
                      device="meta").transpose(1, 2),
          torch.empty(40, c, 1536, dtype=torch.bfloat16, device="meta"))
    assert G.layout(*dx) == (0, 0) and G.layout(*dw) == (1, 1)
    assert G.design_of(*dx) == G.design_of(*dw) == "decode"


@pytest.mark.parametrize("e,c,d,f", SERVED)
def test_the_served_shapes_keep_their_configuration(e, c, d, f):
    """Decode (C = 32) and a bucket-32 prefill (C = 8) run the decode
    design exactly as they did before the wide design was added."""
    p = G.plan(*_meta(e, c, d, f))
    cfg = G.grouped_config(p.tile)
    assert p.design == "decode" == G.design(c, f)
    assert (p.tile, p.stages, cfg.smem_bytes, cfg.threads) == \
        SERVED_CONFIG[c]


def test_the_wide_config():
    """Two consumer warpgroups of m64n256k16 and a producer warpgroup (384
    threads); three 49,152 B stages (x's 128 x 64 box, w's four 64 x 64
    boxes) beside the 65,536 B C tile and the mbarriers: 213,048 B of the
    232,448 B a block may claim, one block an SM; a fourth stage does not
    fit."""
    cfg = G.wide_config()
    assert G.WIDE_TILE == TileConfig(128, 256, 64)
    assert (cfg.nw, cfg.consumers, cfg.rounds, cfg.ks) == (256, 2, 1, 64)
    assert (cfg.stages, cfg.stage_bytes) == (3, 49152)
    assert cfg.smem_bytes == 3 * (49152 + 16) + 65536 + 8 == 213048
    assert cfg.smem_bytes <= K.MAX_SMEM_BYTES
    assert cfg.smem_bytes + 49152 + 16 > K.MAX_SMEM_BYTES
    assert (cfg.threads, cfg.blocks_per_sm, cfg.walk) == (384, 1, True)
    assert G.resident_blocks(cfg) == 1


@pytest.mark.parametrize("c,stages", [(8, 3), (24, 3), (32, 3), (128, 2)])
def test_the_ring_is_three_stages_or_what_fits_a_third_of_an_sm(c, stages):
    """A stage is the token slab (bc rows) and the weight slab (64 x 64);
    the ring holds three, or as many as fit a third of the SM's 233,472 B
    less the 1 KB each block reserves (two at bc = 128)."""
    cfg = G.grouped_config(G.grouped_tile(c, torch.bfloat16))
    assert cfg.stages == stages
    assert cfg.smem_bytes <= G.SM_SMEM_BYTES // 3 - G.BLOCK_RESERVED_SMEM


def test_a_tile_the_route_does_not_take_raises():
    """The JAX default 128/128/512: one stage is 262,144 B; and a tile of
    no power of two."""
    with pytest.raises(ValueError, match="shared memory"):
        G.check_tile(TileConfig(128, 128, 512), torch.bfloat16)
    with pytest.raises(ValueError, match="power-of-two"):
        G.check_tile(TileConfig(24, 64, 64), torch.bfloat16)
    x = torch.zeros(2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        G.grouped_gemm(x, torch.zeros(2, 64, 8, dtype=torch.bfloat16),
                       tile=TileConfig(128, 128, 512))


@pytest.mark.parametrize("e,c,d,f,copied", [
    (3, 24, 201, 75, {"x", "w"}),      # rows of 402 and 150 bytes
    (3, 24, 200, 75, {"w"}),
    (3, 24, 201, 72, {"x"}),
    (3, 24, 200, 72, set()),
    (40, 32, 1536, 512, set()),
])
def test_aligned_copy_choice(e, c, d, f, copied):
    """x and w are read as their experts stacked on the rows, (E*C, D) and
    (E*D, F); a row that is not a multiple of 16 bytes is copied once to
    aligned rows, which hold the same values."""
    x = torch.from_numpy(_np((e, c, d), 1)).to(torch.bfloat16)
    w = torch.from_numpy(_np((e, d, f), 2)).to(torch.bfloat16)
    got = set()
    for name, t, cols in (("x", x, d), ("w", w, f)):
        rows, ld, was_copied = G.tma_rows(t, cols)
        assert was_copied == K.needs_aligned_copy(t.view(-1, cols))
        assert ld % 8 == 0 and torch.equal(rows.reshape(t.shape), t)
        if was_copied:
            got.add(name)
            assert rows.data_ptr() % 16 == 0 and rows.stride(0) == ld
    assert got == copied


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_ragged_df_matches_the_pallas_kernel(dt):
    """At (3, 24, 201, 75) the port (the plain version, on CPU tensors)
    matches the Pallas kernel in interpret mode, on the operands as given
    and on the aligned copies the wgmma route reads (viewed back as
    (E, C, D) and (E, D, F))."""
    e, c, d, f = RAGGED_DF
    xn, wn = _np((e, c, d), 3), _np((e, d, f), 4) * d ** -0.5
    want = np.asarray(grouped_gemm_kernel(jnp.array(xn, dt), jnp.array(wn, dt),
                                          interpret=True), np.float32)
    x, w = operands_from_numpy(xn, wn, device="cpu", dtype=dt)
    got = G.grouped_gemm(x, w)
    xa = G.tma_rows(x, d)[0].view(e, c, d)
    wa = G.tma_rows(w, f)[0].view(e, d, f)
    assert torch.equal(G.grouped_gemm_plain(xa, wa), got)
    tol = (dict(rtol=2e-2, atol=2e-2) if dt == "bfloat16"
           else dict(rtol=1e-5, atol=1e-4))
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(3, 24, 201, 75), (3, 16, 32, 24)])
def test_cpu_tensors_count_nothing_on_either_route(dtype, shape):
    e, c, d, f = shape
    G.reset_launch_counts()
    G.grouped_gemm(torch.ones(e, c, d, dtype=dtype),
                   torch.ones(e, d, f, dtype=dtype))
    assert G.LAUNCHES == {"grouped_gemm": 0}
    assert G.ROUTES == {"wgmma": 0, "cuda_cores": 0}
    assert G.DESIGNS == {"decode": 0, "wide": 0}
    assert G.COPIES == {"aligned": 0, "transposed": 0}


def test_reset_zeroes_the_design_counts():
    G.DESIGNS["decode"] += 3
    G.DESIGNS["wide"] += 2
    G.reset_launch_counts()
    assert G.DESIGNS == {"decode": 0, "wide": 0}


def test_map_key_hits_on_the_same_values_and_misses_on_a_changed_stride():
    tile = TileConfig(32, 64, 64)
    key = G.map_key("w", 0x7F0000001000, 1536, 512, 40, 512, 1536 * 512,
                    tile)
    assert key == G.map_key("w", 0x7F0000001000, 1536, 512, 40, 512,
                            1536 * 512, tile)
    for other in (
            G.map_key("w", 0x7F0000001000, 1536, 512, 40, 520, 1536 * 520,
                      tile),                              # row stride
            G.map_key("w", 0x7F0000001000, 1536, 512, 40, 512, 1537 * 512,
                      tile),                              # expert stride
            G.map_key("w", 0x7F0000002000, 1536, 512, 40, 512, 1536 * 512,
                      tile),                              # base
            G.map_key("x", 0x7F0000001000, 1536, 512, 40, 512, 1536 * 512,
                      tile),                              # box and swizzle
            G.map_key("w", 0x7F0000001000, 1536, 512, 40, 512, 1536 * 512,
                      TileConfig(32, 64, 128))):          # box rows
        assert other != key


def test_a_call_signature_is_planned_once():
    """Shapes, dtypes and tile decide the checks and the configuration, so
    a second call with them reuses the plan; a pair the kernels do not
    take raises every time, and nothing is kept for it."""
    x = torch.zeros(40, 32, 1536, dtype=torch.bfloat16)
    w = torch.zeros(40, 1536, 512, dtype=torch.bfloat16)
    p = G.plan(x, w)
    assert G.plan(x.clone(), w.clone()) is p
    assert (p.e, p.c, p.d, p.f, p.route) == (40, 32, 1536, 512, "wgmma")
    cfg = G.grouped_config(p.tile)
    assert (p.tile, p.ks, p.stages) == (G.grouped_tile(32, torch.bfloat16),
                                        cfg.ks, cfg.stages)
    assert G.plan(x.float(), w.float()).route == "cuda_cores"
    assert G.plan(x, w, TileConfig(32, 128, 64)) is not p
    for _ in range(2):
        with pytest.raises(ValueError, match="pair"):
            G.plan(x, w[:, :100])


class _EncodeOnly:
    """Stands in for the bf16 library's encoder: counts the encodes."""

    def __init__(self):
        self.calls = []

    def repro_grouped_encode(self, m, *args):
        self.calls.append(args)
        return 0


def test_the_map_cache_encodes_once_per_key(monkeypatch):
    """The weights' map is encoded once whatever the call; a changed row
    stride encodes anew; the cache drops its oldest map past its bound."""
    monkeypatch.setattr(G, "_MAPS", {})
    monkeypatch.setattr(G, "MAX_MAPS", 3)
    lib, tile = _EncodeOnly(), TileConfig(32, 64, 64)
    first = G._tensor_map(lib, "w", 4096, 1536, 512, 40, 512, tile)
    assert G._tensor_map(lib, "w", 4096, 1536, 512, 40, 512, tile) is first
    assert len(lib.calls) == 1
    assert lib.calls[0] == (4096, 1536, 512, 40, 512, 1536 * 512,
                            G.OPERANDS["w"], 32, 64, 64, 0)
    G._tensor_map(lib, "w", 4096, 1536, 512, 40, 520, tile)
    assert len(lib.calls) == 2
    G._tensor_map(lib, "x", 8192, 32, 1536, 40, 1536, tile)
    G._tensor_map(lib, "y", 16384, 32, 512, 40, 512, tile)
    assert len(G._MAPS) == 3 and len(lib.calls) == 4
    G._tensor_map(lib, "w", 4096, 1536, 512, 40, 512, tile)
    assert len(lib.calls) == 5                  # the oldest had been dropped


_CTYPE_OF = {"int64_t": ctypes.c_int64, "int": ctypes.c_int}


@pytest.mark.parametrize("name", ["repro_grouped_gemm_wgmma",
                                  "repro_grouped_encode",
                                  "repro_grouped_gemm_wide"])
def test_grouped_library_functions_match_their_c_signatures(name):
    spec = build.target("grouped_gemm_bf16")
    funcs = dict([(spec.launcher, spec.argtypes), *spec.helpers])
    with open(os.path.join(build.CSRC, spec.source)) as f:
        text = f.read()
    found = re.search(rf"\bint\s+{name}\s*\(([^)]*)\)", text)
    assert found, f"{name} is not defined in {spec.source}"
    params = [p.strip() for p in found.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in p
            else _CTYPE_OF[p.rsplit(None, 1)[0].replace("const", "").strip()]
            for p in params]
    assert list(funcs[name]) == want
    assert build.target("grouped_gemm_f32").launcher == "repro_grouped_gemm"
