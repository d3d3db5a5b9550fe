"""The port's flash attention entry point against the JAX package, on the CPU.

The same numpy inputs go through the JAX function and its counterpart in
``repro_torch``.  The JAX package runs as its own tests run it on the CPU:
the Pallas kernel with ``interpret=True``, and ``repro.kernels.ops
.flash_attention``, which off the TPU runs ``ref.flash_attention_ref``.  The
port's wrapper runs its plain version because the tensors lie on the CPU;
the CUDA kernel itself is tested on the card by ``tests/test_torch_cuda.py``.

Tolerances are ``tests/test_kernels.py``'s: f32 rtol = atol = 1e-5 against
the kernel, 2e-5 against the model's blockwise attention; bf16 3e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as jflash_fwd
from repro.kernels.ops import flash_attention as jflash_ops
from repro_torch.interop import operands_from_numpy
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import blockwise_attention


def _qkv(b, s, skv, h, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, skv, h, d)).astype(np.float32),
            rng.normal(size=(b, skv, h, d)).astype(np.float32))


def _tol(dt):
    return 3e-2 if dt == "bfloat16" else 1e-5


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


#: tests/test_kernels.py's three causal cases, its non-causal case, and
#: causal cases with Skv != S (the mask is top-left aligned)
CASES = [
    (2, 256, 256, 3, 64, 64, 64, "float32", True),
    (1, 512, 512, 2, 128, 128, 128, "float32", True),
    (2, 256, 256, 4, 64, 128, 64, "bfloat16", True),
    (1, 128, 128, 2, 64, 64, 64, "float32", False),
    (1, 128, 256, 2, 64, 64, 64, "float32", True),
    (1, 256, 128, 2, 128, 128, 64, "bfloat16", True),
    # head dims the kernel runs past its compiled widths (the smoke
    # configs' 16, stablelm-12b's 160, paligemma-3b's 256)
    (2, 128, 128, 2, 16, 64, 64, "float32", True),
    (1, 128, 128, 2, 160, 64, 64, "bfloat16", True),
    (1, 64, 64, 1, 256, 64, 64, "float32", False),
]


@pytest.mark.parametrize("b,s,skv,h,d,bq,bk,dt,causal", CASES)
def test_flash_attention_matches_pallas_kernel_and_jax_ops(
        b, s, skv, h, d, bq, bk, dt, causal):
    arrays = _qkv(b, s, skv, h, d, s + skv + d)
    jq, jk, jv = (jnp.array(x, dt) for x in arrays)
    tq, tk, tv = operands_from_numpy(*arrays, device="cpu", dtype=dt)
    before = FA.LAUNCHES["flash_attention"]
    got = ops.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                              block_k=bk)
    assert FA.LAUNCHES["flash_attention"] == before    # CPU: plain version
    assert got.dtype == tq.dtype and tuple(got.shape) == (b, s, h, d)
    kernel = jflash_fwd(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                        interpret=True)
    reference = jflash_ops(jq, jk, jv, causal=causal, block_q=bq,
                           block_k=bk)
    for want in (kernel, reference):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=_tol(dt),
                                   atol=_tol(dt))


def test_flash_attention_matches_model_blockwise():
    """The counterpart of ``test_flash_attention_matches_model_blockwise``:
    the entry point and the model's blockwise attention compute the same
    function."""
    tq, tk, tv = operands_from_numpy(*_qkv(2, 128, 128, 2, 64, 11),
                                     device="cpu")
    a = ops.flash_attention(tq, tk, tv, causal=True, block_q=64, block_k=64)
    b = blockwise_attention(tq, tk, tv, chunk=64, causal=True)
    torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)


def test_plain_version_is_the_oracle():
    tq, tk, tv = operands_from_numpy(*_qkv(1, 64, 96, 2, 64, 5),
                                     device="cpu")
    got = FA.flash_attention_fwd(tq, tk, tv, causal=True, block_q=64,
                                 block_k=32)
    assert torch.equal(got, FA.flash_attention_plain(tq, tk, tv))
    assert torch.equal(got, ref.flash_attention_ref(tq, tk, tv, causal=True))


@pytest.mark.parametrize("s,skv,bq,bk", [
    (192, 192, 128, 128),     # S not a multiple of block_q
    (128, 192, 64, 128),      # Skv not a multiple of block_k
    (96, 96, 64, 64),
])
def test_divisibility_refusals_match_the_jax_assert(s, skv, bq, bk):
    arrays = _qkv(1, s, skv, 2, 64, 3)
    jq, jk, jv = (jnp.array(x) for x in arrays)
    tq, tk, tv = operands_from_numpy(*arrays, device="cpu")
    with pytest.raises(AssertionError):
        jflash_fwd(jq, jk, jv, block_q=bq, block_k=bk, interpret=True)
    before = FA.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="multiples"):
        ops.flash_attention(tq, tk, tv, block_q=bq, block_k=bk)
    assert FA.LAUNCHES["flash_attention"] == before


@pytest.mark.parametrize("s", [32, 100, 128])
def test_short_sequences_take_one_block_as_in_jax(s):
    """S <= block_q is one block in both packages, whatever S divides."""
    arrays = _qkv(1, s, s, 2, 64, s)
    jq, jk, jv = (jnp.array(x) for x in arrays)
    tq, tk, tv = operands_from_numpy(*arrays, device="cpu")
    got = ops.flash_attention(tq, tk, tv)
    want = jflash_fwd(jq, jk, jv, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_what_neither_path_takes():
    tq, tk, tv = operands_from_numpy(*_qkv(1, 64, 64, 2, 64, 1),
                                     device="cpu")
    with pytest.raises(ValueError, match="dtypes differ"):
        ops.flash_attention(tq, tk.to(torch.bfloat16), tv)
    with pytest.raises(ValueError, match="bf16 or f32"):
        ops.flash_attention(tq.double(), tk.double(), tv.double())
    with pytest.raises(ValueError, match=r"\(B, S, H, D\)"):
        ops.flash_attention(tq, tk[:, :, :1], tv[:, :, :1])
    meta = [t.to("meta") for t in (tq, tk, tv)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_attention(*meta)


@pytest.mark.parametrize("d,width", [(1, 64), (16, 64), (32, 64), (64, 64),
                                     (65, 128), (100, 128), (128, 128),
                                     (129, 256), (160, 256), (192, 256),
                                     (256, 256)])
def test_head_dim_runs_on_the_smallest_compiled_width(d, width):
    """bf16 runs d on the smallest of its widths; f32 on the smallest of
    its own (160 and 192 have widths of their own there), and its shared
    memory is that width's."""
    assert FA.compiled_width(d) == width
    assert FA.smem_bytes(d) == FA.smem_bytes(FA.f32_width(d)) <= 232448


@pytest.mark.parametrize("d", [0, 257, 320, 512])
def test_head_dims_past_256_raise_naming_256(d):
    with pytest.raises(ValueError, match="256"):
        FA.compiled_width(d)


def test_the_grid_takes_any_b_times_h():
    """The f32 grid is one dimension of ceil(S / BLOCK_Q) * B * H blocks
    (2^31 - 1): B * H = 70,000 is taken, and so is S past the 65,535 query
    tiles the old two-dimensional grid allowed; a grid of 2^31 blocks is
    not."""
    FA._check_grid(1000, 64, 70, 64)
    FA._check_grid(1, 65535 * FA.BLOCK_Q + 1, 1, 64)
    s = 2 ** 31 - 1                           # 2^25 query tiles
    FA._check_grid(63, s, 1, 64)
    for args in ((64, s, 1, 64), (1, 2 ** 31, 1, 64), (1, 64, 1, 2 ** 31)):
        with pytest.raises(ValueError, match="grid"):
            FA._check_grid(*args)
