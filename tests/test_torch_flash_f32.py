"""The f32 flash attention route on Hopper's CUDA cores, on the CPU.

What the wrapper and its Python mirror decide is held here against the
CUDA source (``csrc/flash_attention.cu``, read as text): the kernel's
constants and instantiated widths, the configuration per width (tile,
cp.async ring, shared memory, blocks an SM) at every head dim from 1 to
256, the f32 width rule (160 and 192 on widths of their own; bf16's rule
unchanged), the query rows a block takes by grid size, and the arguments
the wrapper passes the launcher, through a stand-in library that computes
the kernel's function from the pointers and strides it is given.  The
kernel itself runs only on the card (``tests/test_torch_cuda.py``).  On the
CPU the entry point runs its plain version, held against the JAX package's
Pallas kernel (interpret mode) at d = 160 and 192 and at ragged S with
Skv != S, at ``tests/test_kernels.py``'s f32 tolerance (1e-5):

    PYTHONPATH=src python -m pytest tests/test_torch_flash_f32.py -q
"""
import contextlib
import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as jflash_fwd
from repro_torch.interop import operands_from_numpy
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.grouped_gemm import SMS

#: a Hopper block's dynamic shared-memory limit
MAX_SMEM = 232448


def _f32_source():
    """The f32 part of the CUDA source."""
    with open(os.path.join(build.CSRC, "flash_attention.cu")) as f:
        text = f.read()
    start = text.index("#if defined(REPRO_ELEM_F32)\n\nconstexpr")
    return text[start:text.index("#else  // REPRO_ELEM_BF16", start)]


def _constants():
    """``constexpr int NAME = EXPR;`` of the f32 part, evaluated in order
    (each EXPR an integer expression over the names before it)."""
    names = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                 _f32_source(), re.M):
        names[name] = eval(expr.replace("/", "//"), {"__builtins__": {}},
                           dict(names))
    return names


def test_the_constants_mirror_the_cuda_source():
    c = _constants()
    assert c["kBK"] == FA.BLOCK_K == 64
    assert c["kThreads"] == FA.F32_THREADS == c["kTY"] * c["kTX"] == 128
    assert c["kTX"] == FA.F32_TX and c["kRN"] == FA.F32_KEYS == 8
    assert c["kTY"] * FA.F32_ROWS == FA.BLOCK_Q
    assert c["kDS"] == FA.F32_K_SLAB and c["kStages"] == FA.F32_STAGES
    assert c["kLK"] == FA.F32_K_SLAB + FA.F32_ROW_PAD
    assert c["kLP"] == FA.BLOCK_K + FA.F32_P_PAD
    assert c["kSlot"] * 4 == FA.f32_config(64).slot_bytes
    assert c["kSMs"] == SMS and c["kMinBlocks"] == FA.F32_MIN_BLOCKS
    src = _f32_source()
    assert f"kLQ = W + {FA.F32_ROW_PAD};" in src
    assert "__launch_bounds__(kThreads, kMinBlocks)" in src


def test_the_instantiated_widths_are_the_f32_head_dims():
    """The launcher dispatches d to the smallest of exactly these widths,
    in order; each runs both block heights (32 and 64 rows)."""
    with open(os.path.join(build.CSRC, "flash_attention.cu")) as f:
        widths = [int(w) for w in re.findall(r"REPRO_FLASH_F32\((\d+)\)",
                                             f.read())]
    src = _f32_source()
    assert tuple(widths) == FA.F32_HEAD_DIMS
    assert "launch_rows<W, 2, true>" in src and "launch_rows<W, 4, true>" \
        in src


@pytest.mark.parametrize("block_q", [FA.BLOCK_Q, FA.BLOCK_Q // 2])
def test_the_config_fits_two_blocks_an_sm_at_every_head_dim(block_q):
    for d in range(1, FA.MAX_HEAD_DIM + 1):
        cfg = FA.f32_config(d, block_q)
        assert cfg.width == FA.f32_width(d) >= d
        assert cfg.smem_bytes == cfg.q_bytes + cfg.p_bytes \
            + cfg.stages * cfg.slot_bytes <= MAX_SMEM
        assert cfg.blocks_per_sm >= 2
        assert cfg.rows * 16 == cfg.block_q and cfg.keys * 8 == cfg.block_k
        assert cfg.columns * FA.F32_TX == cfg.width
        assert cfg.width % cfg.k_slab == 0 and cfg.width % 32 == 0
        # the V piece: the most keys (a power of two, whole groups of
        # four) whose rows of the width fit a slot
        vs = cfg.v_slab
        assert vs & (vs - 1) == 0 and vs % 4 == 0 and cfg.block_k % vs == 0
        assert 4 * vs * cfg.width <= cfg.slot_bytes \
            < 4 * 2 * vs * cfg.width
    assert FA.smem_bytes(256) == FA.f32_config(256).smem_bytes


def test_the_blocks_the_design_names():
    """64 rows: q (rows of W + 4), p (64 x 72) and three slots of 64 x 36
    floats: 63,488 B at W = 64 (three blocks an SM by shared memory) to
    112,640 B at W = 256 (two)."""
    small, big = FA.f32_config(64), FA.f32_config(256)
    assert small.smem_bytes == 4 * (64 * 68 + 64 * 72 + 3 * 64 * 36) == 63488
    assert big.smem_bytes == 4 * (64 * 260 + 64 * 72 + 3 * 64 * 36) == 112640
    assert (small.blocks_per_sm, big.blocks_per_sm) == (3, 2)
    assert [FA.f32_config(w).v_slab for w in FA.F32_HEAD_DIMS] == \
        [32, 16, 8, 8, 8]
    assert [FA.f32_config(w).blocks_per_sm for w in (128, 160, 192)] == \
        [2, 2, 2]
    assert FA.f32_config(100, 32)[:8] == (128, 32, 64, 128, 2, 8, 16, 32)


@pytest.mark.parametrize("d,f32,bf16", [
    (1, 64, 64), (64, 64, 64), (65, 128, 128), (128, 128, 128),
    (129, 160, 256), (160, 160, 256), (161, 192, 256), (192, 192, 256),
    (193, 256, 256), (256, 256, 256)])
def test_f32_has_its_own_width_rule(d, f32, bf16):
    """160 and 192 no longer run 256 columns in f32; bf16's widths (and
    its configuration) are unchanged."""
    assert FA.f32_width(d) == f32
    assert FA.compiled_width(d) == bf16 == FA.wgmma_config(d).width
    assert FA.HEAD_DIMS == (64, 128, 256)


@pytest.mark.parametrize("d", [0, 257, 320])
def test_f32_head_dims_past_256_raise_naming_256(d):
    with pytest.raises(ValueError, match="256"):
        FA.f32_width(d)
    with pytest.raises(ValueError, match="256"):
        FA.f32_config(d)


@pytest.mark.parametrize("b,s,h,rows", [
    (1, 4096, 24, 64),      # granite: 1,536 blocks of 64 rows
    (1, 4096, 12, 64),      # Qwen2-1.5B: 768
    (1, 2048, 32, 64),      # stablelm-12b: 1,024
    (1, 2048, 8, 32),       # paligemma-3b: 256 < 264, so 512 of 32
    (1, 2048, 4, 32),       # xlstm-125m: 128, so 256 of 32
    (1, 32, 24, 32),        # the served prefill
    (1, 64 * 263, 1, 32),   # 263 tiles of 64: under two an SM
    (1, 64 * 264, 1, 64),
])
def test_rows_a_block_by_grid_size(b, s, h, rows):
    assert FA.f32_rows(b, s, h) == rows
    assert 2 * SMS == 264


def test_the_rows_rule_mirrors_the_cuda_source():
    src = _f32_source()
    rule = "(static_cast<int64_t>(S) + 63) / 64 * B * H < 2 * kSMs ? 32 : 64"
    assert rule in src
    with pytest.raises(ValueError, match="64 or 32"):
        FA.f32_config(64, 16)


def _view(ptr, shape, strides):
    """A float32 numpy view of CPU memory at ``ptr`` with element
    strides."""
    span = sum((n - 1) * st for n, st in zip(shape, strides)) + 1
    base = np.ctypeslib.as_array((ctypes.c_float * span).from_address(ptr))
    return np.lib.stride_tricks.as_strided(
        base, shape, [4 * st for st in strides])


class _Lib:
    """Stands in for the f32 library: computes the kernel's function from
    the pointers, sizes and strides it is given (the plain version on
    views of that memory) and writes o contiguous (B, S, H, d)."""

    def __init__(self, fail=0):
        self.calls, self.fail = [], fail

    def repro_flash_attention(self, q, k, v, o, b, s, skv, h, d, *rest):
        st, causal, _stream = rest[:9], rest[9], rest[10]
        self.calls.append((b, s, skv, h, d, st, causal))
        if self.fail:
            return self.fail
        qv = _view(q, (b, s, h, d), (st[0], st[1], st[2], 1))
        kv = _view(k, (b, skv, h, d), (st[3], st[4], st[5], 1))
        vv = _view(v, (b, skv, h, d), (st[6], st[7], st[8], 1))
        out = ref.flash_attention_ref(*(torch.from_numpy(np.array(x))
                                        for x in (qv, kv, vv)),
                                      causal=bool(causal))
        _view(o, (b, s, h, d), (s * h * d, h * d, d, 1))[...] = out.numpy()
        return 0

    def repro_cuda_error_string(self, code):
        return b"stand-in error"


@pytest.fixture
def lib(monkeypatch):
    """The wrapper's CUDA path on CPU tensors, launching into ``_Lib``."""
    fake = _Lib()
    monkeypatch.setattr(build, "load", lambda name: fake)
    monkeypatch.setattr(FA, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(FA, "on_device", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(FA, "raw_stream", lambda t: 0)
    monkeypatch.setattr(FA, "_PLANS", {})
    FA.reset_launch_counts()
    yield fake
    FA.reset_launch_counts()


def _operands(b, s, skv, h, d, layout, seed):
    g = torch.Generator().manual_seed(seed)
    if layout == "bhsd":     # (B, S, H, D) views of (B, H, S, D) tensors
        return [torch.randn(b, h, n, d, generator=g).transpose(1, 2)
                for n in (s, skv, skv)]
    if layout == "offset":   # bases 4 bytes past 16-byte alignment
        return [torch.randn(b, n, h, d + 1, generator=g)[..., 1:]
                for n in (s, skv, skv)]
    return [torch.randn(b, n, h, d, generator=g) for n in (s, skv, skv)]


@pytest.mark.parametrize("b,s,skv,h,d,layout", [
    (1, 256, 256, 4, 64, "bshd"),
    (2, 100, 300, 3, 160, "bshd"),      # ragged S, Skv > S
    (1, 200, 100, 2, 192, "bhsd"),      # Skv < S, strided views
    (1, 64, 64, 3, 1, "bshd"),          # d = 1: rows of 12 bytes
    (2, 96, 96, 2, 100, "offset"),
])
def test_the_launcher_gets_each_operands_own_strides(lib, b, s, skv, h, d,
                                                     layout):
    """One launch on the CUDA cores per call, with (B, S, Skv, H, d), the
    (batch, sequence, head) strides of q, k and v as they are (no copy) and
    the causal flag; computed from exactly those, the output equals the
    plain version's."""
    q, k, v = _operands(b, s, skv, h, d, layout, s + skv + d)
    for causal in (True, False):
        FA.reset_launch_counts()
        got = ops.flash_attention(q, k, v, causal=causal, block_q=s,
                                  block_k=skv)
        assert FA.LAUNCHES == {"flash_attention": 1}
        assert FA.ROUTES == {"wgmma": 0, "cuda_cores": 1}
        assert FA.COPIES == {"aligned": 0}
        assert lib.calls[-1] == (b, s, skv, h, d, tuple(
            x for t in (q, k, v) for x in (t.stride(0), t.stride(1),
                                           t.stride(2))), int(causal))
        assert got.is_contiguous() and got.shape == (b, s, h, d)
        torch.testing.assert_close(
            got, FA.flash_attention_plain(q, k, v, causal=causal),
            rtol=0, atol=0)


def test_a_failed_launch_raises_with_the_shapes(lib):
    lib.fail = 1
    q = torch.zeros(1, 64, 2, 160)
    with pytest.raises(RuntimeError, match=r"\(1, 64, 2, 160\).*stand-in"):
        FA.flash_attention_fwd(q, q, q)
    assert FA.LAUNCHES == {"flash_attention": 0}


def test_what_the_f32_route_refuses_raises_before_any_launch(lib):
    for q in (torch.zeros(1, 64, 2, 264), torch.zeros(1, 64, 2, 512)):
        with pytest.raises(ValueError, match="256"):
            FA.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="unit stride"):
        q = torch.zeros(1, 64, 2, 128)[..., ::2]
        FA.flash_attention_fwd(q, q, q)
    assert lib.calls == [] and FA.LAUNCHES == {"flash_attention": 0}


def _qkv(b, s, skv, h, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, skv, h, d)).astype(np.float32),
            rng.normal(size=(b, skv, h, d)).astype(np.float32))


@pytest.mark.parametrize("b,s,skv,h,d,bq,bk,causal", [
    (1, 128, 128, 2, 160, 64, 64, True),     # stablelm-12b's head dim
    (1, 128, 128, 2, 192, 128, 64, False),   # xlstm-125m's
    (1, 96, 96, 1, 192, 96, 96, True),
    (1, 100, 300, 2, 64, 100, 100, True),    # ragged S, Skv > S
    (1, 200, 100, 2, 160, 200, 100, True),   # Skv < S
    (2, 100, 100, 2, 160, 100, 100, False),
])
def test_f32_matches_the_pallas_kernel(b, s, skv, h, d, bq, bk, causal):
    arrays = _qkv(b, s, skv, h, d, s + skv + d)
    jq, jk, jv = (jnp.array(x) for x in arrays)
    tq, tk, tv = operands_from_numpy(*arrays, device="cpu")
    assert FA.route(tq.dtype) == "cuda_cores"
    got = ops.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                              block_k=bk)
    want = jflash_fwd(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                      interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
