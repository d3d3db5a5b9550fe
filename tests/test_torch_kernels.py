"""The port's GEMM kernels (``repro_torch.kernels``) against the JAX package.

On the CPU the kernels' wrappers run their plain PyTorch versions (the
tensors lie on the CPU); those are held against the Pallas kernels of
``repro.kernels.gemm`` run with ``interpret=True``, on the same numpy
inputs, with ``tests/test_kernels.py``'s tolerances.  The CUDA kernels
themselves are tested on the card by ``tests/test_torch_cuda.py``.
"""
import ctypes
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.tpu_model import GridOrder as JGridOrder
from repro.core.tpu_model import TileConfig as JTileConfig
from repro.kernels import ref as jref
from repro.kernels.gemm import gemm_k_inner as jax_k_inner
from repro.kernels.gemm import gemm_k_outer as jax_k_outer
from repro.kernels.ops import matmul as jax_matmul
from repro_torch.core.tpu_model import GridOrder, TileConfig
from repro_torch.interop import operands_from_numpy
from repro_torch.kernels import gemm as K
from repro_torch.kernels import build, ops, ref


GEMM_CASES = [
    (128, 128, 128, "float32"), (256, 128, 512, "float32"),
    (128, 384, 256, "bfloat16"), (512, 256, 128, "bfloat16"),
    (128, 128, 256, "int8"), (256, 512, 128, "int8"),
]


def _np_operands(shape_a, shape_b, dt, seed):
    rng = np.random.default_rng(seed)
    if dt == "int8":
        return (rng.integers(-100, 100, size=shape_a).astype(np.int8),
                rng.integers(-100, 100, size=shape_b).astype(np.int8))
    return (rng.normal(size=shape_a).astype(np.float32),
            rng.normal(size=shape_b).astype(np.float32))


def _both(arrays, dt):
    """The same numpy arrays as jax arrays and as CPU tensors of ``dt``."""
    jx = [jnp.array(x, dtype=dt) for x in arrays]
    tx = operands_from_numpy(*arrays, device="cpu", dtype=dt)
    return jx, (tx if isinstance(tx, tuple) else (tx,))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _bf16_ulp(x):
    x = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(x)) - 7)


def _streamed_peak(a, b, c, bk):
    """Largest |C| each element holds over the passes of the streamed
    product — the scale of one bf16 ulp of the running C."""
    peak = c.float().abs()
    acc = c
    for k0 in range(0, a.shape[1], bk):
        acc = (acc.float() + a[:, k0:k0 + bk].float()
               @ b[k0:k0 + bk].float()).to(c.dtype)
        peak = torch.maximum(peak, acc.float().abs())
    return peak.numpy()


@pytest.mark.parametrize("m,n,k,dt", GEMM_CASES)
def test_k_inner_plain_matches_pallas_kernel(m, n, k, dt):
    (ja, jb), (ta, tb) = _both(_np_operands((m, k), (k, n), dt, m + n + k),
                               dt)
    got = K.gemm_k_inner(ta, tb, tile=TileConfig(64, 128, 64))
    want = jax_k_inner(ja, jb, tile=JTileConfig(64, 128, 64), interpret=True)
    if dt == "int8":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        assert got.dtype == ta.dtype
        tol = 2e-2 if dt == "bfloat16" else 1e-5
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol,
                                   atol=2e-2 if dt == "bfloat16" else 1e-4)


@pytest.mark.parametrize("m,n,k,dt", GEMM_CASES[:4])
def test_k_outer_plain_matches_pallas_kernel_and_streamed_ref(m, n, k, dt):
    """Per-pass rounding of C survives the port: bf16 within one bf16 ulp
    of the running |C|, f32 at 1e-5."""
    arrays = _np_operands((m, k), (k, n), dt, 7 * m + k)
    c0 = np.random.default_rng(n).normal(size=(m, n)).astype(np.float32)
    (ja, jb, jc), (ta, tb, tc) = _both([*arrays, c0], dt)
    tile = TileConfig(64, 128, 64, GridOrder.K_OUTER)
    got = K.gemm_k_outer(ta, tb, tc, tile=tile)
    assert got.dtype == tc.dtype and not torch.equal(got, tc)
    want_kernel = jax_k_outer(ja, jb, jc, tile=JTileConfig(
        64, 128, 64, JGridOrder.K_OUTER), interpret=True)
    want_ref = jref.gemm_ref_streamed(ja, jb, jc, bk=64)
    for want in (want_kernel, want_ref):
        if dt == "bfloat16":
            tol = _bf16_ulp(_streamed_peak(ta, tb, tc, 64))
            assert np.all(np.abs(_f32(got) - _f32(want)) <= tol)
        else:
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5,
                                       atol=1e-5)


def test_k_outer_streaming_costs_precision_in_bf16():
    """The finding of tests/test_kernels.py on the port's plain versions:
    rounding C to bf16 every k pass costs more than twice the error of the
    output-stationary order."""
    a, b = _np_operands((128, 512), (512, 256), "bfloat16", 3)
    ta, tb = operands_from_numpy(a, b, device="cpu", dtype="bf16")
    exact = ta.double() @ tb.double()
    inner = K.gemm_k_inner(ta, tb, tile=TileConfig(64, 128, 64))
    outer = K.gemm_k_outer(ta, tb, torch.zeros(128, 256, dtype=torch.bfloat16),
                           tile=TileConfig(64, 128, 64, GridOrder.K_OUTER))
    err_inner = (inner.double() - exact).abs().max().item()
    err_outer = (outer.double() - exact).abs().max().item()
    assert err_outer > 2 * err_inner


@pytest.mark.parametrize("m,n,k", [(1, 1, 1), (37, 300, 129), (300, 17, 260),
                                   (64, 128, 64), (130, 129, 200)])
@pytest.mark.parametrize("order", list(GridOrder))
def test_cuda_plan_any_shape_matches_pallas_pad_and_slice(m, n, k, order):
    """Any (m, n, k) through the port's ``cuda`` plan (CPU tensors: the
    plain versions; the kernels mask ragged edges) equals the ``pallas``
    plan's pad-and-slice in interpret mode."""
    a = (np.arange(m * k).reshape(m, k) % 7).astype(np.float32)
    b = (np.arange(k * n).reshape(k, n) % 5).astype(np.float32)
    ta, tb = operands_from_numpy(a, b, device="cpu")
    got = ops.matmul(ta, tb, tile=TileConfig(64, 128, 64, order))
    want = jax_matmul(jnp.array(a), jnp.array(b),
                      tile=JTileConfig(64, 128, 64, JGridOrder(order.value)),
                      interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_int8_plain_versions_accumulate_exactly_in_int32():
    a, b = _np_operands((96, 300), (300, 80), "int8", 11)
    ta, tb = operands_from_numpy(a, b, device="cpu")
    want = a.astype(np.int64) @ b.astype(np.int64)
    inner = K.gemm_k_inner(ta, tb, tile=TileConfig(32, 64, 128))
    outer = K.gemm(ta, tb, tile=TileConfig(32, 64, 128, GridOrder.K_OUTER))
    for got in (inner, outer):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_run_plain_versions_without_counting_launches():
    K.reset_launch_counts()
    a, b = torch.ones(64, 64), torch.ones(64, 64)
    K.gemm(a, b, tile=TileConfig(64, 64, 128))
    K.gemm(a, b, tile=TileConfig(64, 64, 128, GridOrder.K_OUTER))
    assert K.LAUNCHES == {"gemm_k_inner": 0, "gemm_k_outer": 0}


def test_k_outer_never_mutates_callers_c():
    a, b = torch.randn(64, 256), torch.randn(256, 64)
    c = torch.randn(64, 64)
    before = c.clone()
    out = K.gemm(a, b, c, tile=TileConfig(64, 64, 128, GridOrder.K_OUTER))
    assert torch.equal(c, before)
    torch.testing.assert_close(out, c + a @ b, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("tile,match", [
    (TileConfig(100, 128, 128), "power-of-two"),
    (TileConfig(256, 256, 128), "register tiles"),
    (TileConfig(8, 4096, 128), "register tiles"),
])
def test_wrapper_rejects_tiles_the_kernels_do_not_take(tile, match):
    with pytest.raises(ValueError, match=match):
        K.gemm_k_inner(torch.ones(8, 8), torch.ones(8, 8), tile=tile)


@pytest.mark.parametrize("a,b,match", [
    (torch.ones(8, 8), torch.ones(8, 8, dtype=torch.bfloat16), "dtypes"),
    (torch.ones(8, 8), torch.ones(9, 8), "pair"),
    (torch.ones(8, 8, device="meta"), torch.ones(8, 8, device="meta"),
     "meta"),
    (torch.ones(8, 8, dtype=torch.float64),
     torch.ones(8, 8, dtype=torch.float64), "bf16, f32 or int8"),
])
def test_wrapper_rejects_operands_it_does_not_take(a, b, match):
    with pytest.raises(ValueError, match=match):
        K.gemm_k_inner(a, b, tile=TileConfig(8, 8, 128))


def test_plain_oracles_match_jnp_oracles():
    a, b = _np_operands((70, 90), (90, 50), "float32", 5)
    c = np.ones((70, 50), np.float32)
    ta, tb, tc = operands_from_numpy(a, b, c, device="cpu")
    np.testing.assert_allclose(
        ref.gemm_ref(ta, tb, tc).numpy(),
        np.asarray(jref.gemm_ref(jnp.array(a), jnp.array(b), jnp.array(c))),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# kernels/build.py: per-target launcher signatures
# ---------------------------------------------------------------------------

_CTYPE_OF = {"int64_t": ctypes.c_int64, "int": ctypes.c_int,
             "float": ctypes.c_float}


def _c_signature(source: str, launcher: str) -> list:
    """The ctypes types of ``launcher``'s parameters, read from its
    ``extern "C"`` definition in ``csrc/<source>``: pointers are c_void_p."""
    with open(os.path.join(build.CSRC, source)) as f:
        text = f.read()
    found = re.search(rf"\bint\s+{launcher}\s*\(([^)]*)\)", text)
    assert found, f"{launcher} is not defined in {source}"
    types = []
    for param in found.group(1).split(","):
        decl = param.rsplit(None, 1)[0] if "*" not in param else "*"
        types.append(ctypes.c_void_p if decl == "*"
                     else _CTYPE_OF[decl.replace("const", "").strip()])
    return types


@pytest.mark.parametrize("name", sorted(build.TARGETS))
def test_every_target_names_its_launcher_and_signature(name):
    spec = build.target(name)
    assert os.path.isfile(os.path.join(build.CSRC, spec.source))
    assert spec.launcher.startswith("repro_") and spec.define
    assert list(spec.argtypes) == _c_signature(spec.source, spec.launcher)


def test_unknown_target_raises_before_building():
    with pytest.raises(ValueError, match="no CUDA library"):
        build.load("flash_attention_int8")
    with pytest.raises(ValueError, match="no CUDA library"):
        build.build_log("not_a_target")
