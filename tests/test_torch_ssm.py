"""The port's Mamba2 / SSD core against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through ``repro.models.ssm``
and ``repro_torch.models.ssm``.  Tolerances: the SSD core and the causal
conv in f32 at rtol 1e-5 / atol 1e-6 (another order of the same f32
sums); the Mamba2 block at rtol = atol = 1e-5 in f32 and 2e-2 in bf16
(``tests/test_kernels.py``'s bf16 tolerance); chunked against the step
recurrence in the port at 1e-4, as ``tests/test_models.py`` holds the JAX
package.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jget_config
from repro.models import ssm as jssm
from repro.models.common import HOST_MESH as JHOST_MESH
from repro.models.common import cast_for_compute as jcast
from repro.models.common import split_params
from repro_torch.configs import get_config
from repro_torch.models import ssm
from repro_torch.models.common import HOST_MESH, cast_for_compute

F32 = dict(rtol=1e-5, atol=1e-6)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(seed, B, S, H, P, N, decay=0.3):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(B, S, H, P)).astype(np.float32)
    a = (-np.abs(rng.normal(size=(B, S, H))) * decay).astype(np.float32)
    dt = np.abs(rng.normal(size=(B, S, H))).astype(np.float32)
    Bm = rng.normal(size=(B, S, H, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, H, N)).astype(np.float32)
    return xh, a, dt, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(np.array(x)) for x in arrays]


@pytest.mark.parametrize("s,chunk,with_h0", [
    (16, 16, False), (40, 16, False), (37, 8, True), (5, 16, True),
    (64, 32, False)])
def test_ssd_chunked_matches_jax(s, chunk, with_h0):
    xh, a, dt, Bm, Cm = _inputs(s, 2, s, 3, 5, 4)
    h0 = (np.random.default_rng(9).normal(size=(2, 3, 5, 4))
          .astype(np.float32) if with_h0 else None)
    jy, jh = jssm.ssd_chunked(*map(jnp.array, (xh, a, dt, Bm, Cm)), chunk,
                              h0=None if h0 is None else jnp.array(h0))
    y, h = ssm.ssd_chunked(*_t(xh, a, dt, Bm, Cm), chunk,
                           h0=None if h0 is None else torch.from_numpy(h0))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **F32)


def test_ssd_chunked_keeps_the_upper_triangle_finite():
    """Strong decay makes seg above the diagonal large and positive: its
    exp overflows unless clamped, and a multiplied mask would turn inf * 0
    into nan."""
    xh, a, dt, Bm, Cm = _inputs(3, 1, 32, 2, 4, 4, decay=200.0)
    y, h = ssm.ssd_chunked(*_t(xh, a, dt, Bm, Cm), 32)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    jy, _ = jssm.ssd_chunked(*map(jnp.array, (xh, a, dt, Bm, Cm)), 32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)


def test_ssd_chunked_returns_its_inputs_dtype():
    xh, a, dt, Bm, Cm = _inputs(4, 1, 12, 2, 4, 4)
    y, h = ssm.ssd_chunked(torch.from_numpy(xh).bfloat16(),
                           *_t(a, dt, Bm, Cm), 8)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(5)
    B, H, P, N = 3, 4, 6, 5
    h = rng.normal(size=(B, H, P, N)).astype(np.float32)
    x = rng.normal(size=(B, H, P)).astype(np.float32)
    a = -np.abs(rng.normal(size=(B, H))).astype(np.float32)
    dt = np.abs(rng.normal(size=(B, H))).astype(np.float32)
    Bt = rng.normal(size=(B, H, N)).astype(np.float32)
    Ct = rng.normal(size=(B, H, N)).astype(np.float32)
    jy, jh = jssm.ssd_decode_step(*map(jnp.array, (h, x, a, dt, Bt, Ct)))
    y, hn = ssm.ssd_decode_step(*_t(h, x, a, dt, Bt, Ct))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(hn.numpy(), np.asarray(jh), **F32)


@pytest.mark.parametrize("s", [1, 2, 3, 9])
def test_causal_conv_and_its_step_match_jax(s):
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, 7)).astype(np.float32)
    w = rng.normal(size=(4, 7)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    np.testing.assert_allclose(
        ssm.causal_conv(*_t(x, w, b)).numpy(),
        np.asarray(jssm.causal_conv(*map(jnp.array, (x, w, b)))), **F32)
    cache = rng.normal(size=(2, 3, 7)).astype(np.float32)
    xt = x[:, :1]
    jy, jc = jssm.causal_conv_step(*map(jnp.array, (cache, xt, w, b)))
    y, c = ssm.causal_conv_step(*_t(cache, xt, w, b))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2 ** 16), s=st.integers(3, 40),
       chunk=st.sampled_from([4, 8, 16]))
def test_ssd_chunked_equals_the_recurrence(seed, s, chunk):
    xh, a, dt, Bm, Cm = _t(*_inputs(seed, 2, s, 3, 5, 4))
    y_chunk, h_chunk = ssm.ssd_chunked(xh, a, dt, Bm, Cm, chunk=chunk)
    h = torch.zeros((2, 3, 5, 4))
    ys = []
    for t in range(s):
        y_t, h = ssm.ssd_decode_step(h, xh[:, t], a[:, t], dt[:, t],
                                     Bm[:, t], Cm[:, t])
        ys.append(y_t)
    np.testing.assert_allclose(y_chunk.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h_chunk.numpy(), h.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_ssd_state_passes_across_calls():
    xh, a, dt, Bm, Cm = _t(*_inputs(3, 1, 24, 2, 4, 4, decay=0.2))
    y_all, h_all = ssm.ssd_chunked(xh, a, dt, Bm, Cm, chunk=8)
    y1, h1 = ssm.ssd_chunked(xh[:, :12], a[:, :12], dt[:, :12],
                             Bm[:, :12], Cm[:, :12], chunk=8)
    y2, h2 = ssm.ssd_chunked(xh[:, 12:], a[:, 12:], dt[:, 12:],
                             Bm[:, 12:], Cm[:, 12:], chunk=8, h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_all.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h2.numpy(), h_all.numpy(), rtol=1e-4,
                               atol=1e-4)


def _mamba2(dtype, seed=0):
    """(port params, JAX params, config pair) at zamba2's smoke widths,
    the JAX package's weights in both, cast for compute in ``dtype``."""
    cfg = get_config("zamba2-1.2b", smoke=True)
    jcfg = jget_config("zamba2-1.2b", smoke=True)
    jp, _ = split_params(jssm.init_mamba2(jax.random.key(seed), jcfg,
                                          JHOST_MESH, jnp.float32))
    rng = np.random.default_rng(seed)
    # non-zero biases exercise their adds
    jp = dict(jp, dt_bias=jnp.array(rng.normal(size=jp["dt_bias"].shape)
                                    .astype(np.float32)),
              conv_b=jnp.array(rng.normal(size=jp["conv_b"].shape)
                               .astype(np.float32) * 0.1))
    jp = jcast(jp, jnp.dtype(dtype))
    p = cast_for_compute({k: torch.from_numpy(np.array(v, np.float32))
                          for k, v in jp.items()}, getattr(torch, dtype))
    p = {k: v.to(getattr(torch, dtype)) if jp[k].dtype == jnp.bfloat16
         else v for k, v in p.items()}
    return p, jp, cfg, jcfg


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return (jnp.array(x).astype(jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [2, 20])
def test_mamba2_apply_matches_jax(dtype, s):
    p, jp, cfg, jcfg = _mamba2(dtype)
    jx, x = _x((2, s, cfg.d_model), dtype, 1)
    jy, jh, jconv = jssm.apply_mamba2(jp, jx, jcfg)
    y, h, conv = ssm.apply_mamba2(p, x, cfg)
    assert y.dtype == x.dtype and h.dtype == torch.float32
    assert conv.shape == (2, cfg.ssm_conv - 1, cfg.d_inner)
    _close(y, jy, dtype)
    _close(h, jh, dtype)
    _close(conv, jconv, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_matches_jax(dtype):
    p, jp, cfg, jcfg = _mamba2(dtype, seed=2)
    b = 3
    jcache, _ = split_params(jssm.init_mamba2_cache(jcfg, JHOST_MESH, b,
                                                    jnp.dtype(dtype)))
    rng = np.random.default_rng(4)
    hist = {k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in jcache.items()}
    jcache = {k: jnp.array(v).astype(jcache[k].dtype)
              for k, v in hist.items()}
    cache = ssm.init_mamba2_cache(cfg, HOST_MESH, b, getattr(torch, dtype),
                                  "cpu")
    for k in cache:
        cache[k].copy_(torch.from_numpy(hist[k]))
    for step in range(3):
        jx, x = _x((b, 1, cfg.d_model), dtype, 10 + step)
        jy, jcache = jssm.decode_mamba2(jp, jcache, jx, jcfg)
        y, new = ssm.decode_mamba2(p, cache, x, cfg)
        assert new is cache                       # updated in place
        _close(y, jy, dtype)
        for k in cache:
            _close(cache[k], jcache[k], dtype)


def test_mamba2_init_has_the_jax_layout():
    cfg = get_config("zamba2-1.2b", smoke=True)
    jcfg = jget_config("zamba2-1.2b", smoke=True)
    jp, _ = split_params(jssm.init_mamba2(jax.random.key(0), jcfg,
                                          JHOST_MESH, jnp.float32))
    p = ssm.init_mamba2(torch.Generator().manual_seed(0), cfg, HOST_MESH,
                        torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    # log(1..H): the two libraries' logs may differ in the last bit
    np.testing.assert_allclose(p["A_log"].numpy(), np.asarray(jp["A_log"]),
                               **F32)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
