"""The port's RMSNorm entry point against the JAX package, on the CPU.

The same numpy inputs go through ``repro.kernels.rmsnorm.rmsnorm`` (the
Pallas kernel with ``interpret=True``, as the JAX package's own tests run
it) and ``repro_torch.kernels.rmsnorm.rmsnorm``, whose wrapper runs its
plain version because the tensors lie on the CPU; the CUDA kernel itself
is tested on the card by ``tests/test_torch_cuda.py``.

Tolerances: f32 rtol = atol = 1e-5, as ``tests/test_kernels.py``; bf16 one
bf16 ulp of |y|, since XLA and PyTorch sum the squares in another f32
order, and one last-bit difference can cross a bf16 rounding boundary.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import rmsnorm as jrmsnorm
from repro_torch.configs import get_config
from repro_torch.interop import operands_from_numpy
from repro_torch.kernels import build, ref
from repro_torch.kernels import rmsnorm as R
from repro_torch.models import layers


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _bf16_ulp(y):
    y = np.maximum(np.abs(y), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(y)) - 7)


def _assert_close(got, want, dt):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    if dt == "bfloat16":
        assert np.all(np.abs(got - want) <= _bf16_ulp(want))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,dt,br", [
    ((4, 64, 128), "float32", 64),
    ((512, 256), "bfloat16", 128),
    ((2, 128, 512), "bfloat16", 32),
    # widths past the register path: a D no multiple of the vector width,
    # kimi-k2-1t's d_model 7168 in f32
    ((16, 1001), "bfloat16", 16),
    ((8, 7168), "float32", 8),
])
def test_rmsnorm_matches_pallas_kernel(shape, dt, br):
    """The three cases of ``test_rmsnorm_kernel_matches_ref``, with the f32
    scale that test passes (also beside bf16 x)."""
    xn, sn = _np(shape, sum(shape)), _np(shape[-1], br)
    want = jrmsnorm(jnp.array(xn, dt), jnp.array(sn, jnp.float32),
                    block_rows=br, interpret=True)
    tx = operands_from_numpy(xn, device="cpu", dtype=dt)
    ts = operands_from_numpy(sn, device="cpu")
    before = R.LAUNCHES["rmsnorm"]
    got = R.rmsnorm(tx, ts, block_rows=br)
    assert R.LAUNCHES["rmsnorm"] == before             # CPU: plain version
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _assert_close(got, want, dt)


def test_rmsnorm_matches_model_norm():
    """The counterpart of ``test_rmsnorm_kernel_matches_model_norm``."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    x = operands_from_numpy(_np((4, 16, cfg.d_model), 1), device="cpu")
    scale = operands_from_numpy(_np(cfg.d_model, 2), device="cpu")
    got = R.rmsnorm(x, scale, block_rows=32, eps=cfg.norm_eps)
    want = layers.apply_norm({"scale": scale}, x, cfg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_bf16_scale_is_taken_as_f32(dt):
    """The models pass a bf16 scale; it widens to f32 exactly."""
    x = torch.from_numpy(_np((8, 96), 4)).to(dt)
    scale = torch.from_numpy(_np(96, 5)).to(torch.bfloat16)
    got = R.rmsnorm(x, scale, eps=1e-6)
    assert torch.equal(got, ref.rmsnorm_ref(x, scale.float(), eps=1e-6))
    assert torch.equal(got, R.rmsnorm_plain(x, scale, eps=1e-6))


@pytest.mark.parametrize("shape,br", [((3, 100, 128), 256), ((300, 64), 128),
                                      ((5, 7, 64), 4)])
def test_row_refusals_match_the_jax_assert(shape, br):
    xn, sn = _np(shape, 0), _np(shape[-1], 1)
    with pytest.raises(AssertionError):
        jrmsnorm(jnp.array(xn), jnp.array(sn), block_rows=br, interpret=True)
    x, s = operands_from_numpy(xn, sn, device="cpu")
    before = R.LAUNCHES["rmsnorm"]
    with pytest.raises(ValueError, match="rows are not a multiple"):
        R.rmsnorm(x, s, block_rows=br)
    assert R.LAUNCHES["rmsnorm"] == before


def test_wrapper_refuses_what_neither_path_takes():
    x, s = operands_from_numpy(_np((4, 64), 0), _np(64, 1), device="cpu")
    with pytest.raises(ValueError, match="last axis"):
        R.rmsnorm(x, s[:32])
    with pytest.raises(ValueError, match="bf16 or f32"):
        R.rmsnorm(x.double(), s)
    with pytest.raises(ValueError, match="CUDA tensors"):
        R.rmsnorm(x.to("meta"), s.to("meta"))


def test_widest_row_per_dtype():
    """The widest row read once, the same in both dtypes (the name is
    historical: it once differed by dtype), and the elements of a 16-byte
    vector in each."""
    assert R.MAX_DIM == 16384
    assert R.vector_elems(torch.bfloat16) == 8
    assert R.vector_elems(torch.float32) == 4


def _cuda_constant(name: str, known: dict) -> int:
    """The value of ``constexpr int name = ...;`` in csrc/rmsnorm.cu, its
    expression evaluated over the constants in ``known``."""
    with open(os.path.join(build.CSRC, "rmsnorm.cu")) as f:
        text = f.read()
    found = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert found, f"{name} is not defined in rmsnorm.cu"
    expr = found.group(1)
    for k, v in known.items():
        expr = re.sub(rf"\b{k}\b", str(v), expr)
    assert re.fullmatch(r"[\d\s+\-*/()]+", expr), expr
    return int(eval(expr.replace("/", "//")))


@pytest.mark.parametrize("mirror,name", [("MAX_DIM", "kMaxD"),
                                         ("COLUMNS_SMEM", "kColumnsSmem")])
def test_mirrored_constants_match_the_cuda_source(mirror, name):
    """The launcher's constants that :func:`path` mirrors, read from the
    CUDA source, so that neither copy drifts."""
    known = {"kSmemLimit": _cuda_constant("kSmemLimit", {})}
    assert getattr(R, mirror) == _cuda_constant(name, known)


@pytest.mark.parametrize("shape,dt,offset,want", [
    # whole 16-byte vectors, aligned: registers, no ring, at any row count
    ((32, 1536), torch.bfloat16, 0, "direct"),
    ((32, 8192), torch.bfloat16, 0, "direct"),
    ((32, 8200), torch.bfloat16, 0, "direct"),
    ((4, 7168), torch.float32, 0, "direct"),
    ((4, 4096), torch.float32, 0, "direct"),
    ((16, 1001), torch.bfloat16, 0, "element"),
    ((16, 1002), torch.float32, 0, "element"),
    ((32, 1536), torch.bfloat16, 1, "element"),    # base off 16 bytes
    ((4, 16384), torch.float32, 0, "direct"),      # the widest read once
    ((4, 16385), torch.float32, 0, "two-pass"),
    ((4, 16392), torch.bfloat16, 3, "two-pass"),
    # a row for every SM and more: the same paths
    ((132, 1536), torch.bfloat16, 0, "direct"),
    ((132, 7168), torch.float32, 0, "direct"),
    ((131, 7168), torch.float32, 0, "direct"),
    ((200, 16384), torch.float32, 0, "direct"),
    ((200, 1001), torch.bfloat16, 0, "element"),
])
def test_kernel_path_follows_width_and_alignment(shape, dt, offset, want):
    n = shape[0] * shape[1]
    x = torch.zeros(n + offset, dtype=dt)[offset:].view(shape)
    got, path = R.kernel_input(x)
    assert got.data_ptr() == x.data_ptr() and got.shape == shape
    assert path == want and R.path(x) == want


def _strided(layout, dt):
    if layout == "slice":          # the middle third of a fused buffer
        return torch.zeros(200, 3 * 1536, dtype=dt)[:, 1536:3072]
    if layout == "offset":         # each row's base off 16 bytes
        return torch.zeros(200, 1600, dtype=dt)[:, 1:1537]
    if layout == "transposed":
        return torch.zeros(1536, 200, dtype=dt).t()
    if layout == "transposed-odd":  # bf16: a column stride of 402 bytes
        return torch.zeros(1536, 201, dtype=dt)[:, :200].t()
    if layout == "batched":        # leading axes that merge
        return torch.zeros(4, 50, 2048, dtype=dt)[..., :1536]
    if layout == "wide-transposed":
        return torch.zeros(R.max_columns_dim() + 1, 64, dtype=dt).t()
    return torch.zeros(1536, 200, 4, dtype=dt)[..., 0].t()  # no unit axis


@pytest.mark.parametrize("layout,dt,want", [
    ("slice", torch.bfloat16, "direct"),
    ("slice", torch.float32, "direct"),
    ("offset", torch.bfloat16, "element"),
    ("offset", torch.float32, "element"),
    ("transposed", torch.bfloat16, "columns"),
    ("transposed", torch.float32, "columns"),
    ("batched", torch.bfloat16, "direct"),
    ("transposed-odd", torch.bfloat16, "copy"),
    ("transposed-odd", torch.float32, "columns"),
    ("wide-transposed", torch.float32, "copy"),
    ("neither", torch.float32, "copy"),
])
def test_kernel_path_of_strided_x(layout, dt, want):
    """A layout a path reads is read in place (a view of x); any other is
    copied once into a contiguous tensor, which a path reads in place."""
    x = _strided(layout, dt)
    assert R.path(x) == want
    got, path = R.kernel_input(x)
    if want == "copy":
        assert got.is_contiguous() and got.data_ptr() != x.data_ptr()
        assert path in ("direct", "element", "two-pass")
        assert torch.equal(got, x.reshape(got.shape))
    else:
        assert path == want and got.data_ptr() == x.data_ptr()
        assert torch.equal(got, x.reshape(got.shape))


def test_columns_tile_narrows_with_the_width():
    """A columns block stages 16 words of rows (32 bf16 or 16 f32 rows) at
    granite's 1536, fewer as D grows, within half a SM's shared memory."""
    assert R.column_rows(torch.bfloat16, 1536) == 32
    assert R.column_rows(torch.float32, 1536) == 16
    assert R.column_rows(torch.float32, 7168) == 2
    d = R.max_columns_dim()
    assert R.column_rows(torch.float32, d) == 1
    assert R.column_rows(torch.float32, d + 1) == 0


def test_non_contiguous_x_is_copied_once_and_matches_the_jax_kernel():
    """A transposed x is read in place (the columns path, no copy); the
    result equals the JAX kernel's on the same values.  The name is
    historical: x was once copied before the kernel ran."""
    xn, sn = _np((1536, 64), 7), _np(1536, 8)
    x = operands_from_numpy(xn, device="cpu").t()
    assert not x.is_contiguous()
    got_x, path = R.kernel_input(x)
    assert got_x.data_ptr() == x.data_ptr() and torch.equal(got_x, x)
    assert path == "columns"
    want = jrmsnorm(jnp.array(xn.T.copy()), jnp.array(sn), block_rows=64,
                    interpret=True)
    got = R.rmsnorm(x, operands_from_numpy(sn, device="cpu"), block_rows=64)
    _assert_close(got, want, "float32")


@pytest.mark.parametrize("case", ["slice", "qwen2.5-32b", "kimi-k2-1t"])
def test_rmsnorm_matches_pallas_kernel_strided_and_wide(case):
    """f32 against the JAX kernel in interpret mode: a row-strided slice of
    a fused buffer (read in place), qwen2.5-32b's d_model 5120 and
    kimi-k2-1t's 7168 (read once on the card, on the direct path)."""
    if case == "slice":
        buf = _np((2, 16, 3 * 512), 3)
        xn = buf[..., 512:1024]
        x = operands_from_numpy(buf, device="cpu")[..., 512:1024]
        assert R.kernel_input(x)[0].data_ptr() == x.data_ptr()
    else:
        d = 5120 if case == "qwen2.5-32b" else 7168
        xn = _np((2, 4, d), d)
        x = operands_from_numpy(xn, device="cpu")
    assert R.path(x) == "direct"
    sn = _np(xn.shape[-1], 9)
    want = jrmsnorm(jnp.array(np.ascontiguousarray(xn)), jnp.array(sn),
                    block_rows=8, interpret=True)
    got = R.rmsnorm(x, operands_from_numpy(sn, device="cpu"), block_rows=8)
    assert got.shape == x.shape
    _assert_close(got, want, "float32")


@pytest.mark.parametrize("name", ["as-is", "ring", "direct-few",
                                  "direct-many"])
def test_launcher_variants_apply_to_the_source(name):
    """tools/rmsnorm_variants.py's edits each find their text in
    csrc/rmsnorm.cu exactly once, so the variants it times on the card are
    the launcher's own."""
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "rmsnorm_variants.py")
    spec = importlib.util.spec_from_file_location("rmsnorm_variants", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert sorted(tool.VARIANTS) == sorted(["as-is", "ring", "direct-few",
                                            "direct-many"])
    with open(os.path.join(build.CSRC, "rmsnorm.cu")) as f:
        text = f.read()
    got = tool.variant_source(text, name)
    assert (got == text) == (name == "as-is")
