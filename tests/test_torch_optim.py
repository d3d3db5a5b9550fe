"""The port's AdamW, LR schedule and int8 error-feedback compression
against the JAX package, on the CPU.

The same numpy trees go through ``repro.optim`` and ``repro_torch.optim``:
``adamw_update`` (new parameters, moments, step and the pre-clip gradient
norm), ``lr_schedule``, ``global_norm`` at f32 rtol 1e-6 (parameters with
atol 1e-7 beside it, moments 1e-9: an update that cancels an O(1)
parameter to near zero leaves a last-bit difference of the subtraction
relative to the small result); ``quantize_int8``
and ``compress_tree`` with their int8 values exact and scales and error
buffers at f32 rtol 1e-6.  Then the twins of ``tests/test_runtime.py``'s
optimizer and compression tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import optim as joptim
from repro.optim import compression as jcomp
from repro_torch.optim import (
    AdamWConfig,
    adamw_update,
    compress_tree,
    decompress_tree,
    global_norm,
    init_error_buffer,
    init_opt_state,
    lr_schedule,
    quantize_int8,
)

RTOL = 1e-6


def _tree(seed, scale=1.0):
    """Sorted keys: the JAX package flattens dicts in key order."""
    rng = np.random.default_rng(seed)
    return {"a": (rng.normal(size=(8, 16)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(5,)) * scale).astype(np.float32),
                  "d": (rng.normal(size=(3, 4, 2)) * scale
                        ).astype(np.float32)}}


def _torch(tree):
    return jax.tree.map(lambda x: torch.tensor(np.asarray(x)), tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_tree(got, want, rtol=RTOL, atol=0.0):
    for g, w in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got)),
                    jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol)


@pytest.mark.parametrize("clip,decay", [(1.0, 0.1), (0.0, 0.0), (50.0, 0.1)])
def test_adamw_update_matches_the_reference_over_three_steps(clip, decay):
    jcfg = joptim.AdamWConfig(weight_decay=decay, grad_clip=clip)
    cfg = AdamWConfig(weight_decay=decay, grad_clip=clip)
    jp, jo = _jax(_tree(0)), joptim.init_opt_state(_jax(_tree(0)), jcfg)
    p, o = _torch(_tree(0)), init_opt_state(_torch(_tree(0)), cfg)
    for i in range(3):
        g = _tree(10 + i, 3.0)
        lr = 1e-2 * (i + 1)
        jp, jo, jm = joptim.adamw_update(_jax(g), jo, jp, lr, jcfg)
        p, o, m = adamw_update(_torch(g), o, p, torch.tensor(lr), cfg)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=RTOL)
        assert o["step"].item() == int(jo["step"]) == i + 1
        _assert_tree(p, jp, atol=1e-7)
        _assert_tree(o["m"], jo["m"], atol=1e-9)
        _assert_tree(o["v"], jo["v"], atol=1e-9)


def test_adamw_updates_in_place_and_decays_matrices_only():
    cfg = AdamWConfig(weight_decay=0.5, grad_clip=0.0)
    params = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    opt = init_opt_state(params, cfg)
    ids = [id(params["w"]), id(opt["m"]["w"])]
    zeros = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    out, opt, _ = adamw_update(zeros, opt, params, 0.1, cfg)
    assert [id(out["w"]), id(opt["m"]["w"])] == ids
    assert torch.allclose(params["w"], torch.full((2, 2), 0.95))
    assert torch.equal(params["b"], torch.ones(2))


@pytest.mark.parametrize("warmup,total", [(100, 1000), (5, 4), (1, 50)])
def test_lr_schedule_matches_the_reference(warmup, total):
    steps = np.arange(0, max(total, warmup) + 3)
    want = jax.vmap(lambda t: joptim.lr_schedule(
        t, base_lr=3e-3, warmup=warmup, total=total))(jnp.asarray(steps))
    got = lr_schedule(torch.tensor(steps), base_lr=3e-3, warmup=warmup,
                      total=total)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-12)
    assert lr_schedule(0, base_lr=3e-3, warmup=warmup, total=total) == 0.0


def test_global_norm_matches_the_reference():
    t = _tree(3, 7.0)
    np.testing.assert_allclose(global_norm(_torch(t)).item(),
                               float(joptim.global_norm(_jax(t))), rtol=RTOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_matches_the_reference_exactly(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(64, 33)) * rng.uniform(0.01, 100)).astype(
        np.float32)
    jq, js = joptim.quantize_int8(jnp.asarray(x))
    q, s = quantize_int8(torch.tensor(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.item(), float(js), rtol=RTOL)


def test_compress_tree_and_error_feedback_match_the_reference():
    g = _tree(4, 0.3)
    jerr = jcomp.init_error_buffer(_jax(g))
    err = init_error_buffer(_torch(g))
    for i in range(3):
        g = _tree(20 + i, 0.3)
        jq, jerr = jcomp.compress_tree(_jax(g), jerr)
        q, err = compress_tree(_torch(g), err)
        for (qt, st_), (jqt, jst) in zip(
                jax.tree.leaves(q, is_leaf=lambda x: isinstance(x, tuple)),
                jax.tree.leaves(jq, is_leaf=lambda x: isinstance(x, tuple)),
                strict=True):
            np.testing.assert_array_equal(qt.numpy(), np.asarray(jqt))
            np.testing.assert_allclose(st_.item(), float(jst), rtol=RTOL)
        _assert_tree(err, jerr, atol=1e-9)
        _assert_tree(decompress_tree(q, _torch(g)),
                     jcomp.decompress_tree(jq, _jax(g)), atol=1e-9)


# ---------------------------------------------------------------------------
# Twins of tests/test_runtime.py's optimizer and compression tests
# ---------------------------------------------------------------------------


def test_adamw_decreases_quadratic():
    cfg = AdamWConfig(weight_decay=0.0, grad_clip=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = init_opt_state(params, cfg)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(grads, opt, params, 0.1, cfg)
    assert float(params["w"].abs().max()) < 0.5


def test_grad_clip_caps_update_norm():
    cfg = AdamWConfig(grad_clip=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    opt = init_opt_state(params, cfg)
    _, _, m = adamw_update({"w": torch.full((4,), 1e6)}, opt, params, 1e-3,
                           cfg)
    assert m["grad_norm"] > 1e6  # reported pre-clip


def test_lr_schedule_shape():
    lr = lr_schedule(torch.arange(0, 1000), base_lr=1.0, warmup=100,
                     total=1000)
    assert float(lr[0]) == 0.0
    assert float(lr[99]) == pytest.approx(0.99, abs=0.02)
    assert float(lr.max()) <= 1.0 + 1e-6
    assert float(lr[-1]) == pytest.approx(0.1, abs=0.01)   # min_ratio floor
    assert bool((lr[100:] >= 0.1 - 1e-6).all())


def test_moment_dtype_configurable():
    cfg = AdamWConfig(moment_dtype="bfloat16")
    opt = init_opt_state({"w": torch.zeros(4, 4)}, cfg)
    assert opt["m"]["w"].dtype == torch.bfloat16


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2 ** 16))
def test_quantize_int8_bounded_error(seed):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=128) * rng.uniform(0.01, 100),
                     dtype=torch.float32)
    q, s = quantize_int8(x)
    err = (x - q.float() * s).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-9


def test_error_feedback_converges():
    """Repeatedly compressing the same gradient with error feedback must
    transmit the full signal over time (mean reconstructed -> true grad)."""
    g = {"w": torch.tensor([1e-4, 3e-2, -0.7, 0.9])}
    ebuf = init_error_buffer(g)
    acc = torch.zeros(4)
    n = 50
    for _ in range(n):
        q, ebuf = compress_tree(g, ebuf)
        acc = acc + decompress_tree(q, g)["w"]
    step = float(g["w"].abs().max()) / 127
    np.testing.assert_allclose((acc / n).numpy(), g["w"].numpy(),
                               rtol=5e-2, atol=step / 10)
