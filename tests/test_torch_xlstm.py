"""The port's xLSTM blocks (mLSTM, sLSTM) against the JAX package's.

The JAX package's weights at xlstm-125m's smoke widths, the same numpy
inputs, made from a seed, through ``repro.models.xlstm`` and
``repro_torch.models.xlstm``, prefill and decode.  Tolerances as for the
Mamba2 block (``tests/test_torch_ssm.py``): rtol = atol = 1e-5 in f32,
2e-2 in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import xlstm as jxlstm
from repro.models.common import HOST_MESH as JHOST_MESH
from repro.models.common import cast_for_compute as jcast
from repro.models.common import split_params
from repro_torch.configs import get_config
from repro_torch.models import ssm, xlstm
from repro_torch.models.common import HOST_MESH

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
INIT = {"mlstm": (jxlstm.init_mlstm, xlstm.init_mlstm),
        "slstm": (jxlstm.init_slstm, xlstm.init_slstm)}
CACHE = {"mlstm": (jxlstm.init_mlstm_cache, xlstm.init_mlstm_cache),
         "slstm": (jxlstm.init_slstm_cache, xlstm.init_slstm_cache)}


def _params(kind, dtype, seed=0):
    """(port params, JAX params, cfg, jcfg): the JAX package's weights in
    both, biases made non-zero, cast for compute in ``dtype``."""
    cfg = get_config("xlstm-125m", smoke=True)
    jcfg = jget_config("xlstm-125m", smoke=True)
    jp, _ = split_params(INIT[kind][0](jax.random.key(seed), jcfg,
                                       JHOST_MESH, jnp.float32))
    rng = np.random.default_rng(seed)
    for name in ("f_bias", "bias", "conv_b"):
        if name in jp:
            jp[name] = jp[name] + jnp.array(
                rng.normal(size=jp[name].shape).astype(np.float32) * 0.5)
    jp = jcast(jp, jnp.dtype(dtype))
    p = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
        for k, v in jp.items()}
    return p, jp, cfg, jcfg


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return (jnp.array(x).astype(jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [2, 21])
def test_mlstm_apply_matches_jax(dtype, s):
    p, jp, cfg, jcfg = _params("mlstm", dtype)
    jx, x = _x((2, s, cfg.d_model), dtype, 1)
    jy, jh, jconv = jxlstm.apply_mlstm(jp, jx, jcfg)
    y, h, conv = xlstm.apply_mlstm(p, x, cfg)
    assert y.dtype == x.dtype and h.dtype == torch.float32
    p_ = cfg.mlstm_inner // cfg.lstm_heads
    assert h.shape == (2, cfg.lstm_heads, p_ + 1, p_)
    _close(y, jy, dtype)
    _close(h, jh, dtype)
    _close(conv, jconv, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 9])
def test_slstm_apply_matches_jax(dtype, s):
    p, jp, cfg, jcfg = _params("slstm", dtype)
    jx, x = _x((2, s, cfg.d_model), dtype, 2)
    jy, jstate = jxlstm.apply_slstm(jp, jx, jcfg)
    y, state = xlstm.apply_slstm(p, x, cfg)
    assert y.dtype == x.dtype
    _close(y, jy, dtype)
    for got, want in zip(state, jstate):
        assert got.dtype == torch.float32
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_matches_jax(kind, dtype):
    p, jp, cfg, jcfg = _params(kind, dtype, seed=3)
    b = 3
    jcache, _ = split_params(CACHE[kind][0](jcfg, JHOST_MESH, b,
                                            jnp.dtype(dtype)))
    rng = np.random.default_rng(4)
    hist = {k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in jcache.items()}
    if kind == "slstm":                 # a normaliser state of its sign
        hist["n"] = np.abs(hist["n"]) + 0.5
    jcache = {k: jnp.array(v).astype(jcache[k].dtype)
              for k, v in hist.items()}
    cache = CACHE[kind][1](cfg, HOST_MESH, b, getattr(torch, dtype), "cpu")
    for k in cache:
        cache[k].copy_(torch.from_numpy(hist[k]))
    decode = {"mlstm": (jxlstm.decode_mlstm, xlstm.decode_mlstm),
              "slstm": (jxlstm.decode_slstm, xlstm.decode_slstm)}[kind]
    for step in range(3):
        jx, x = _x((b, 1, cfg.d_model), dtype, 10 + step)
        jy, jcache = decode[0](jp, jcache, jx, jcfg)
        y, new = decode[1](p, cache, x, cfg)
        assert new is cache                       # updated in place
        _close(y, jy, dtype)
        for k in cache:
            _close(cache[k], jcache[k], dtype)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_prefill_then_decode_equals_one_longer_prefill(kind):
    """The port against itself in f32: a prefill's final state carried
    into decode gives the next position of a longer prefill."""
    p, _, cfg, _ = _params(kind, "float32", seed=5)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 11, cfg.d_model)).astype(np.float32))
    if kind == "mlstm":
        y_full, _, _ = xlstm.apply_mlstm(p, x, cfg)
        _, h, conv = xlstm.apply_mlstm(p, x[:, :-1], cfg)
        cache = {"h": h, "conv": conv}
        y, _ = xlstm.decode_mlstm(p, cache, x[:, -1:], cfg)
    else:
        y_full, _ = xlstm.apply_slstm(p, x, cfg)
        _, (h, c, n) = xlstm.apply_slstm(p, x[:, :-1], cfg)
        y, _ = xlstm.decode_slstm(p, {"h": h, "c": c, "n": n}, x[:, -1:],
                                  cfg)
    np.testing.assert_allclose(y.numpy(), y_full[:, -1:].numpy(), rtol=1e-4,
                               atol=1e-4)


def test_the_blocks_share_the_ssd_core_and_the_jax_layout():
    assert xlstm.ssd_chunked is ssm.ssd_chunked
    assert xlstm.ssd_decode_step is ssm.ssd_decode_step
    cfg = get_config("xlstm-125m", smoke=True)
    for kind, (jinit, init) in INIT.items():
        jp, _ = split_params(jinit(jax.random.key(0),
                                   jget_config("xlstm-125m", smoke=True),
                                   JHOST_MESH, jnp.float32))
        p = init(torch.Generator().manual_seed(0), cfg, HOST_MESH,
                 torch.float32, "cpu")
        assert {k: tuple(v.shape) for k, v in p.items()} == \
            {k: tuple(v.shape) for k, v in jp.items()}, kind
        assert {k: str(v.dtype) for k, v in p.items()} == \
            {k: "torch." + str(v.dtype) for k, v in jp.items()}, kind
