"""The bf16 GEMM's tensor-core route (``csrc/wgmma_gemm.cuh``), on the CPU.

What the CPU can hold the route to: its configuration (every tile the
planner picks is taken and fits a Hopper block's shared memory), the
aligned copy the wrappers make of operands TMA cannot read in place, the
launch counters, and the C launchers' signatures.  The kernel itself runs
only on the card (``tests/test_torch_cuda.py``); on the CPU the wrappers
run the plain versions, which are held against the JAX package's Pallas
kernels here (the aligned copies) and in ``tests/test_torch_kernels.py``.
"""
import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tpu_model import GridOrder as JGridOrder
from repro.core.tpu_model import TileConfig as JTileConfig
from repro.kernels.ops import matmul as jax_matmul
from repro_torch import gemm
from repro_torch import machines as tmachines
from repro_torch.configs import get_config
from repro_torch.core.autotune import _feasible_mask, _lattice
from repro_torch.core.autotune import model_gemm_shapes
from repro_torch.core.mobilenet import TABLE2
from repro_torch.core.tpu_model import GemmShape, GridOrder, TileConfig
from repro_torch.interop import operands_from_numpy
from repro_torch.kernels import build
from repro_torch.kernels import gemm as K

GRANITE = get_config("granite-moe-3b-a800m")

#: the shapes whose planner tiles the route must take: the Qwen2-1.5B
#: GEMMs at tokens=4096, granite's logits GEMM at decode and prefill
#: batches, and Table-2
PLANNED = ([(s.m, s.n, s.k) for s in model_gemm_shapes(
    get_config("qwen2-1.5b"), tokens=4096)]
    + [(m, GRANITE.padded_vocab, GRANITE.d_model) for m in (4, 8, 32, 128)]
    + [(r.m, r.n, r.k) for r in TABLE2])

#: the Table-2 operands TMA cannot read in place: A (M, K) with K = 27 or
#: 1, B (K, N) with N = 49 or 196 (row strides not a multiple of 16 bytes);
#: B (1, 1000) is a single row, whose stride is never stepped
UNALIGNED = {(32, 12544, 27): "a", (1024, 1000, 1): "a",
             (256, 196, 2304): "b", (512, 196, 256): "b",
             (512, 196, 4608): "b", (512, 196, 512): "b",
             (512, 49, 4608): "b", (1024, 49, 512): "b",
             (1024, 49, 9216): "b", (1024, 49, 1024): "b"}


def _planned_tile(m, n, k):
    return gemm.plan(GemmShape(m, n, k, dtype="bf16"), backend="cuda",
                     machine="h100").selection


@pytest.mark.parametrize("m,n,k", PLANNED)
def test_route_takes_every_planner_tile(m, n, k):
    """Every bf16 tile the planner picks (on the Hopper tile model, which
    searches the tiles ``check_tile`` takes) runs on the tensor-core route,
    in both loop orders, and fits the 232,448 bytes of shared memory a
    Hopper block may claim."""
    t = _planned_tile(m, n, k)
    tile = TileConfig(t.bm, t.bn, t.bk)
    assert K.check_tile(tile, "bf16") == K.wgmma_config(tile)
    for k_outer in (False, True):
        cfg = K.wgmma_config(tile, k_outer=k_outer)
        assert cfg.smem_bytes <= K.MAX_SMEM_BYTES
        assert cfg.stages >= 1 and cfg.consumers in (1, 2)
        assert cfg.threads == 128 * cfg.consumers + 32
        assert cfg.nw in (64, 128, 256) and cfg.nw >= min(t.bn, 256)


@pytest.mark.parametrize("shape", [(1 << 20, 1 << 20, 1 << 20),
                                   (100, 100, 100), (8, 8, 8)])
def test_route_takes_every_feasible_h100_tile(shape):
    """As ``tests/test_torch_gemm.py`` holds the CUDA-core kernels to the
    planner's feasible lattice on h100, so for the bf16 route: no plan the
    planner can return is refused."""
    m, n, k = (np.array([[x]]) for x in shape)
    mask = _feasible_mask(m, n, k, np.array([[2]]),
                          tmachines.get("h100").capacity("L1"))[0]
    bm, bn, bk, _ = _lattice()
    tiles = {(int(bm[i]), int(bn[i]), int(bk[i]))
             for i in np.flatnonzero(mask)}
    assert tiles
    for t in tiles:
        tile = TileConfig(*t)
        try:
            K.launch_config(tile, "bf16")
        except ValueError:
            continue
        for k_outer in (False, True):
            assert K.wgmma_config(tile, k_outer=k_outer).smem_bytes \
                <= K.MAX_SMEM_BYTES


def test_the_planners_tile_is_the_block_tile():
    """At the planner's 64x128x128 one stage is the plan's whole slab, 48 KB
    (A 64 x 128 and B 128 x 128 in bf16); k-inner keeps two such stages
    (two blocks fit an SM), k-outer one per pass; both add the 16 KB C
    tile."""
    inner = K.wgmma_config(TileConfig(64, 128, 128))
    outer = K.wgmma_config(TileConfig(64, 128, 128, GridOrder.K_OUTER),
                           k_outer=True)
    assert inner.stage_bytes == outer.stage_bytes == 48 * 1024
    assert (inner.ks, inner.stages, inner.nw) == (128, 2, 128)
    assert (outer.ks, outer.stages) == (128, 1)
    # the stages with their two 8-byte mbarriers, the C tile, its mbarrier
    assert inner.smem_bytes == 2 * (48 * 1024 + 16) + 64 * 128 * 2 + 8
    assert outer.smem_bytes == 48 * 1024 + 16 + 64 * 128 * 2 + 8
    assert 2 * (inner.smem_bytes + 1024) <= 233472   # two blocks per SM
    # bm = 128: two consumer warpgroups, one m64 product each
    assert K.wgmma_config(TileConfig(128, 128, 128)).consumers == 2


@pytest.mark.parametrize("tile,match", [
    (TileConfig(100, 128, 128), "power-of-two"),
    (TileConfig(16384, 1, 4), "shared memory"),
])
def test_route_refuses_what_it_does_not_take(tile, match):
    with pytest.raises(ValueError, match=match):
        K.wgmma_config(tile)
    with pytest.raises(ValueError, match=match):
        K.gemm_k_inner(torch.ones(8, 8, dtype=torch.bfloat16),
                       torch.ones(8, 8, dtype=torch.bfloat16), tile=tile)


def test_the_stage_cap_bounds_the_ring(monkeypatch):
    """``WGMMA_STAGES`` caps the ring; below the cap, shared memory does:
    four 48 KB stages fit at 64x128x128, three 64 KB ones at 128x128x128."""
    monkeypatch.setattr(K, "WGMMA_STAGES", 4)
    assert K.wgmma_config(TileConfig(64, 128, 128)).stages == 4
    assert K.wgmma_config(TileConfig(128, 128, 128)).stages == 3
    monkeypatch.setattr(K, "WGMMA_STAGES", 1)
    assert K.wgmma_config(TileConfig(64, 128, 128)).stages == 1


def test_a_slab_that_does_not_fit_twice_is_staged_shallower():
    """512 x 32 x 128: two full slabs (2 x 144 KB) exceed a block's shared
    memory, so the slab is staged 64 deep; the pass is still 128 deep."""
    cfg = K.wgmma_config(TileConfig(512, 32, 128))
    assert cfg.ks == 64 and cfg.rounds == 4 and cfg.consumers == 2


@pytest.mark.parametrize("m,n,k", [(r.m, r.n, r.k) for r in TABLE2])
def test_aligned_copy_picks_exactly_the_unaligned_table2_operands(m, n, k):
    a = torch.zeros((m, k), dtype=torch.bfloat16)
    b = torch.zeros((k, n), dtype=torch.bfloat16)
    picked = {name for name, t in (("a", a), ("b", b))
              if K.needs_aligned_copy(t)}
    assert picked == set(UNALIGNED.get((m, n, k), ""))
    for t in (a, b):
        if K.needs_aligned_copy(t):
            c = K.aligned_copy(t)
            assert not K.needs_aligned_copy(c)
            assert c.shape == t.shape and c.stride(0) % 8 == 0


@pytest.mark.parametrize("m,n,k", sorted(UNALIGNED))
def test_aligned_copy_keeps_the_product(m, n, k):
    """The plain version on the aligned copies equals the plain version on
    the operands as given, and the JAX package's Pallas kernel (interpret
    mode, pad-and-slice) on the same inputs.  M is cut to 64 rows."""
    m = min(m, 64)
    rng = np.random.default_rng(m + n + k)
    a_np = rng.normal(size=(m, k)).astype(np.float32)
    b_np = rng.normal(size=(k, n)).astype(np.float32)
    a, b = operands_from_numpy(a_np, b_np, device="cpu", dtype="bf16")
    ca = K.aligned_copy(a) if K.needs_aligned_copy(a) else a
    cb = K.aligned_copy(b) if K.needs_aligned_copy(b) else b
    assert torch.equal(ca, a) and torch.equal(cb, b)
    got = K.gemm_k_inner_plain(ca, cb)
    assert torch.equal(got, K.gemm_k_inner_plain(a, b))
    want = jax_matmul(jnp.array(a_np, jnp.bfloat16),
                      jnp.array(b_np, jnp.bfloat16),
                      tile=JTileConfig(64, 128, 128, JGridOrder.K_INNER),
                      interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_a_single_row_needs_no_copy_whatever_its_stride():
    row = torch.zeros((1, 1000), dtype=torch.bfloat16)
    assert not K.needs_aligned_copy(row)
    assert not K.needs_aligned_copy(torch.zeros(4, 1, dtype=torch.bfloat16)
                                    .t())
    shifted = torch.zeros(65, dtype=torch.bfloat16)[1:].view(8, 8)
    assert K.needs_aligned_copy(shifted)       # a base off 16 bytes


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "cuda_cores"),
                                         (torch.int8, "wgmma")])
def test_cpu_tensors_count_no_launch_on_either_route(dtype, route):
    assert K.route(dtype) == route
    K.reset_launch_counts()
    a = torch.ones((40, 300), dtype=dtype)
    b = torch.ones((300, 49), dtype=dtype)
    tile = TileConfig(32, 128, 128)
    K.gemm_k_inner(a, b, tile=tile)
    K.gemm_k_outer(a, b, torch.zeros((40, 49), dtype=K.out_dtype(dtype)),
                   tile=TileConfig(32, 128, 128, GridOrder.K_OUTER))
    assert K.LAUNCHES == {"gemm_k_inner": 0, "gemm_k_outer": 0}
    assert K.ROUTES == {"wgmma": 0, "cuda_cores": 0}
    assert K.COPIES == {"aligned": 0, "transposed": 0}


@pytest.mark.parametrize("m,k,bm,want", [
    (4096, 1536, 64, 64),       # all of A's rows fit the L2 budget
    (4096, 8960, 64, 14),       # 16 MB / (64 x 8960 x 2 B)
    (4, 1536, 8, 1),
    (4096, 128, 64, 64),        # one k-outer pass reads 128 columns
])
def test_raster_group(m, k, bm, want):
    assert K.raster_group(m, k, bm) == want


_CTYPE_OF = {"int64_t": ctypes.c_int64, "int": ctypes.c_int}


@pytest.mark.parametrize("name", ["repro_gemm_wgmma",
                                  "repro_gemm_wgmma_encode"])
def test_bf16_library_functions_match_their_c_signatures(name):
    spec = build.target("gemm_bf16")
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
