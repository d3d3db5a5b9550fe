"""The bf16 flash attention route on Hopper's tensor cores, on the CPU.

What the wrapper decides before a launch is held here: the configuration
per compiled head-dim width (shared memory, warpgroups, keys per step),
the route by dtype, which operands get a TMA-aligned copy, the launch and
copy counters, the per-signature plan and the tensor-map cache, and the C
signatures ``kernels/build.py`` binds.  The launches themselves go to a
stand-in library that records them; the kernel runs only on the card
(``tests/test_torch_cuda.py``).  On the CPU the entry point runs its plain
version, held against the JAX package's Pallas kernel (interpret mode)
and its ``ops.flash_attention`` at a causal Skv != S and at d = 100:

    PYTHONPATH=src python -m pytest tests/test_torch_flash_wgmma.py -q

Tolerances are ``tests/test_kernels.py``'s: bf16 rtol = atol = 3e-2, f32
1e-5.
"""
import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as jflash_fwd
from repro.kernels.ops import flash_attention as jflash_ops
from repro_torch.interop import operands_from_numpy
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as FA

#: a Hopper block's dynamic shared-memory limit
MAX_SMEM = 232448


@pytest.mark.parametrize("d", [1, 16, 32, 64, 100, 128, 160, 192, 256])
def test_bf16_config_fits_a_block_and_tiles_in_m64_units(d):
    cfg = FA.wgmma_config(d)
    assert cfg.width == FA.compiled_width(d) >= d
    assert cfg.smem_bytes <= MAX_SMEM
    # the layout of FlashGeom: q tile, the K/V slots, three mbarriers a
    # slot pair and q's
    assert cfg.q_bytes == cfg.width * cfg.block_q * 2
    assert cfg.stage_bytes == 2 * cfg.width * cfg.block_k * 2
    assert cfg.smem_bytes == (cfg.q_bytes + cfg.stages * cfg.stage_bytes
                              + 8 * (1 + 2 * cfg.stages))
    # m64 rows per consumer warpgroup, k16 steps of keys, 64-column boxes
    assert cfg.block_q == 64 * cfg.consumers and cfg.consumers in (1, 2)
    assert cfg.block_k % 16 == 0 and cfg.block_k <= 256
    assert cfg.width % 64 == 0
    assert cfg.threads == 128 * (cfg.consumers + 1)
    # every band of 128-byte rows starts on a 1024-byte swizzle atom
    assert cfg.q_bytes % 1024 == 0 and cfg.stage_bytes % 2048 == 0


def test_every_compiled_width_has_one_bf16_configuration():
    """The widths, their keys per step and their consumers are the three
    instantiations the C launcher takes."""
    got = {w: (FA.wgmma_config(w).block_k, FA.wgmma_config(w).consumers)
           for w in FA.HEAD_DIMS}
    assert got == {64: (128, 2), 128: (64, 2), 256: (64, 1)}
    with open(os.path.join(build.CSRC, "flash_attention.cu")) as f:
        text = f.read()
    for w, (bk, nc) in got.items():
        assert f"launch_flash<{w}, {bk}, {nc}>" in text


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "cuda_cores")])
def test_route_by_dtype(dtype, route):
    assert FA.route(dtype) == route
    q = torch.zeros(1, 256, 4, 64, dtype=dtype)
    p = FA.plan(q, q, q)
    assert p.route == route
    assert (p.cfg == FA.wgmma_config(64)) if route == "wgmma" \
        else p.cfg is None
    with pytest.raises(ValueError, match="bf16 or f32"):
        FA.route(torch.float16)


def _view(shape, *, transpose=False, offset=0, pad=0):
    """A bf16 (B, S, H, D) operand: contiguous, a (B, H, S, D) tensor's
    transposed view, or a slice of rows padded by ``pad`` starting
    ``offset`` elements in."""
    b, s, h, d = shape
    if transpose:
        return torch.zeros(b, h, s, d, dtype=torch.bfloat16).transpose(1, 2)
    base = torch.zeros(b, s, h, d + pad, dtype=torch.bfloat16)
    return base[..., offset:offset + d]


@pytest.mark.parametrize("t,copied", [
    (_view((1, 32, 24, 64)), False),              # granite's served prefill
    (_view((1, 64, 4, 160)), False),              # stablelm-12b's head dim
    (_view((1, 64, 4, 16)), False),               # the smoke configs'
    (_view((2, 64, 3, 64), transpose=True), False),   # strided, in place
    (_view((1, 64, 4, 100)), True),               # rows of 200 bytes
    (_view((1, 64, 4, 3)), True),                 # rows of 6 bytes
    (_view((1, 64, 4, 64), offset=1, pad=8), True),   # base 2 bytes off
    (_view((1, 64, 4, 64), offset=8, pad=8), False),  # base 16 bytes off
])
def test_which_operands_get_an_aligned_copy(t, copied):
    assert FA.needs_aligned_copy(t) == copied
    c = FA.aligned_copy(t)
    assert torch.equal(c, t) and not FA.needs_aligned_copy(c)
    assert c.stride(2) % 8 == 0 and c.data_ptr() % 16 == 0


def test_a_dimension_of_size_one_never_forces_a_copy():
    """B = 1 and H = 1 are never stepped, so whatever stride a view gives
    them, the map takes one that TMA reads."""
    t = torch.zeros(64 * 64 + 8, dtype=torch.bfloat16).as_strided(
        (1, 64, 1, 64), (3, 64, 5, 1))
    assert not FA.needs_aligned_copy(t)
    assert all(st % 8 == 0 and st > 0 for st in FA._tma_strides(t))


class _Lib:
    """Stands in for the bf16 and f32 libraries: records every encode and
    launch, and succeeds."""

    def __init__(self):
        self.encodes, self.launches, self.f32 = [], [], []

    def repro_flash_encode(self, m, ptr, *args):
        self.encodes.append(args)     # d, rows, heads, batch, strides, box
        return 0

    def repro_flash_attention_wgmma(self, mq, mk, mv, o, *args):
        self.launches.append((mq, mk, mv, args))
        return 0

    def repro_flash_attention(self, *args):
        self.f32.append(args)
        return 0


@pytest.fixture
def lib(monkeypatch):
    """The wrapper's CUDA path on CPU tensors, launching into ``_Lib``."""
    fake = _Lib()
    monkeypatch.setattr(build, "load", lambda name: fake)
    monkeypatch.setattr(FA, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(FA, "on_device", lambda t: __import__(
        "contextlib").nullcontext())
    monkeypatch.setattr(FA, "raw_stream", lambda t: 0)
    monkeypatch.setattr(FA, "_MAPS", {})
    monkeypatch.setattr(FA, "_PLANS", {})
    FA.reset_launch_counts()
    yield fake
    FA.reset_launch_counts()


def test_bf16_launches_the_wgmma_route_with_its_configuration(lib):
    q, k, v = (_view((1, 4096, 12, 256)) for _ in range(3))
    FA.flash_attention_fwd(q, k, v, causal=True)
    assert FA.LAUNCHES == {"flash_attention": 1}
    assert FA.ROUTES == {"wgmma": 1, "cuda_cores": 0}
    assert FA.COPIES == {"aligned": 0} and lib.f32 == []
    cfg = FA.wgmma_config(256)
    (_, _, _, args), = lib.launches
    assert args[:5] == (1, 4096, 4096, 12, 256)          # B, S, Skv, H, d
    assert args[5:9] == (cfg.width, cfg.block_k, cfg.consumers, cfg.stages)
    assert args[9] == 1                                   # causal
    # q's boxes are the block's query rows, k's and v's a step's keys;
    # (sequence, head, batch) strides of the (B, S, H, D) layout
    strides = (12 * 256, 256, 4096 * 12 * 256)
    assert lib.encodes == [(256, 4096, 12, 1, *strides, cfg.block_q)] + \
        [(256, 4096, 12, 1, *strides, cfg.block_k)] * 2


def test_f32_launches_the_cuda_core_route(lib):
    q = torch.zeros(1, 256, 4, 64)
    FA.flash_attention_fwd(q, q, q, causal=False)
    assert FA.ROUTES == {"wgmma": 0, "cuda_cores": 1}
    assert lib.launches == [] and lib.encodes == [] and len(lib.f32) == 1


def test_operands_tma_cannot_read_are_copied_once_each(lib):
    q, k, v = (_view((1, 256, 4, 100)) for _ in range(3))
    FA.flash_attention_fwd(q, k, v)
    assert FA.COPIES == {"aligned": 3} and FA.ROUTES["wgmma"] == 1
    # the maps read the copies: rows of 104 elements, d = 100 columns
    assert len(lib.encodes) == 3
    assert {e[:2] for e in lib.encodes} == {(100, 256)}
    assert {e[4:7] for e in lib.encodes} == {(4 * 104, 104, 256 * 4 * 104)}


def test_a_call_signature_is_planned_once():
    q = torch.zeros(1, 256, 4, 64, dtype=torch.bfloat16)
    p = FA.plan(q, q, q)
    assert FA.plan(q.clone(), q.clone(), q.clone()) is p
    assert (p.b, p.s, p.skv, p.h, p.d) == (1, 256, 256, 4, 64)
    assert FA.plan(q, q, q, 64, 64) is not p
    assert FA.plan(q.float(), q.float(), q.float()).route == "cuda_cores"
    for _ in range(2):
        with pytest.raises(ValueError, match="multiples"):
            FA.plan(q, q[:, :192], q[:, :192])    # 192 % min(128, 192)


def test_the_map_cache_encodes_once_per_key(lib, monkeypatch):
    """A map is encoded once for each (base, shape, strides, box); a
    changed stride encodes anew; the cache drops its oldest map past its
    bound."""
    monkeypatch.setattr(FA, "MAX_MAPS", 3)
    q, kv = _view((1, 256, 4, 64)), _view((1, 256, 4, 64))
    for _ in range(3):
        FA.flash_attention_fwd(q, kv, kv)
    assert len(lib.encodes) == 2 and len(lib.launches) == 3
    t = _view((1, 256, 4, 64), transpose=True)
    key = FA.map_key(t.data_ptr(), t.shape, t.stride(), 128)
    assert key == (t.data_ptr(), 1, 256, 4, 64, 4 * 256 * 64, 64, 256 * 64,
                   1, 128)
    FA.flash_attention_fwd(t, kv, kv)       # a changed stride: a new map
    assert len(lib.encodes) == 3 and len(FA._MAPS) == 3
    FA.flash_attention_fwd(_view((1, 256, 4, 64)), kv, kv)
    assert len(lib.encodes) == 4 and len(FA._MAPS) == 3
    # q's map, the oldest, had been dropped; its new one drops kv's
    FA.flash_attention_fwd(q, kv, kv)
    assert len(lib.encodes) == 6


def test_cpu_tensors_count_no_launch_on_either_route():
    FA.reset_launch_counts()
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn(1, 64, 2, 64).to(dt)
        FA.flash_attention_fwd(q, q, q)
    assert FA.LAUNCHES == {"flash_attention": 0}
    assert FA.ROUTES == {"wgmma": 0, "cuda_cores": 0}
    assert FA.COPIES == {"aligned": 0}


_CTYPE_OF = {"int64_t": ctypes.c_int64, "int": ctypes.c_int}


@pytest.mark.parametrize("name", ["repro_flash_attention_wgmma",
                                  "repro_flash_encode"])
def test_bf16_library_functions_match_their_c_signatures(name):
    spec = build.target("flash_attention_bf16")
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
    assert build.target("flash_attention_f32").launcher == \
        "repro_flash_attention"


def _qkv(b, s, skv, h, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, skv, h, d)).astype(np.float32),
            rng.normal(size=(b, skv, h, d)).astype(np.float32))


@pytest.mark.parametrize("b,s,skv,h,d,bq,bk,dt", [
    (1, 128, 256, 2, 64, 128, 128, "bfloat16"),    # Skv > S, top-left mask
    (1, 256, 128, 2, 128, 128, 64, "bfloat16"),    # Skv < S
    (1, 128, 128, 2, 100, 64, 64, "bfloat16"),     # the copied head dim
    (1, 128, 128, 2, 100, 64, 64, "float32"),
])
def test_causal_and_ragged_cases_match_the_pallas_kernel(b, s, skv, h, d,
                                                         bq, bk, dt):
    arrays = _qkv(b, s, skv, h, d, s + skv + d)
    jq, jk, jv = (jnp.array(x, dt) for x in arrays)
    tq, tk, tv = operands_from_numpy(*arrays, device="cpu", dtype=dt)
    got = ops.flash_attention(tq, tk, tv, causal=True, block_q=bq,
                              block_k=bk)
    tol = 3e-2 if dt == "bfloat16" else 1e-5
    for want in (jflash_fwd(jq, jk, jv, causal=True, block_q=bq, block_k=bk,
                            interpret=True),
                 jflash_ops(jq, jk, jv, causal=True, block_q=bq,
                            block_k=bk)):
        np.testing.assert_allclose(
            np.asarray(got.float()), np.asarray(want, np.float32),
            rtol=tol, atol=tol)
