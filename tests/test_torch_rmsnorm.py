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
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import rmsnorm as jrmsnorm
from repro_torch.configs import get_config
from repro_torch.interop import operands_from_numpy
from repro_torch.kernels import ref
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
    assert R.max_dim(torch.bfloat16) == 8192
    assert R.max_dim(torch.float32) == 4096
    assert R.vector_elems(torch.bfloat16) == 8
    assert R.vector_elems(torch.float32) == 4


@pytest.mark.parametrize("shape,dt,offset,want", [
    ((32, 1536), torch.bfloat16, 0, "registers"),
    ((32, 8192), torch.bfloat16, 0, "registers"),
    ((32, 8200), torch.bfloat16, 0, "two-pass"),
    ((4, 7168), torch.float32, 0, "two-pass"),
    ((4, 4096), torch.float32, 0, "registers"),
    ((16, 1001), torch.bfloat16, 0, "scalar"),
    ((16, 1002), torch.float32, 0, "scalar"),
    ((32, 1536), torch.bfloat16, 1, "scalar"),     # base off 16 bytes
])
def test_kernel_path_follows_width_and_alignment(shape, dt, offset, want):
    n = shape[0] * shape[1]
    x = torch.zeros(n + offset, dtype=dt)[offset:].view(shape)
    got, path = R.kernel_input(x)
    assert got is x and path == want


def test_non_contiguous_x_is_copied_once_and_matches_the_jax_kernel():
    """A transposed x reaches the kernel as one contiguous copy; the
    result equals the JAX kernel's on the same values."""
    xn, sn = _np((1536, 64), 7), _np(1536, 8)
    x = operands_from_numpy(xn, device="cpu").t()
    assert not x.is_contiguous()
    got_x, path = R.kernel_input(x)
    assert got_x.is_contiguous() and torch.equal(got_x, x)
    assert path == "registers"
    want = jrmsnorm(jnp.array(xn.T.copy()), jnp.array(sn), block_rows=64,
                    interpret=True)
    got = R.rmsnorm(x, operands_from_numpy(sn, device="cpu"), block_rows=64)
    _assert_close(got, want, "float32")
