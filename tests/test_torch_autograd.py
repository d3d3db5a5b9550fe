"""The port's differentiable GEMMs and ``LM.loss_fn`` against the JAX
package, on the CPU.

``gemm.matmul`` and ``gemm.grouped_matmul`` are ``torch.autograd.Function``s
(``repro_torch.gemm.autograd``) whose backward products run on the same
planned kernels as the forward, on views of the saved operands (no
transposed copies); on CPU tensors those are the kernels' plain versions,
so these tests check the backward formula the card runs.  The JAX side is
``jax.vjp`` of ``repro.gemm.matmul`` / ``grouped_matmul`` (the
``reference`` backend, jnp products, as the JAX package runs on the CPU) and
``jax.value_and_grad`` of ``repro.models.model.LM.loss_fn`` on the same
weights (``interop.load_jax_params``) and the same batch.

Tolerances: the products f32 rtol 1e-5 (atol 1e-5), bf16 rtol = atol = 2e-2
(both sum in f32 and round once); the loss f32 rtol 1e-5; the gradients
rtol 1e-4 / atol 1e-6 per element of each leaf for qwen2-1.5b and
granite-moe-3b-a800m.  The recurrent families are held per leaf by relative
L2: xlstm-125m at 1e-5 (one element of 30 k sits 1.8e-6 from the JAX
package's, beyond the elementwise atol, while both packages lie as close
to a float64 run); zamba2-1.2b at 1e-4 (the worst leaf measures 4.4e-5).
Both packages' f32 gradients of zamba2 lie 2-4e-5 (relative L2) from the
JAX package's float64 run on the same weights and batch, the port's no
further than the JAX package's: each leaf is held to at most twice the JAX
package's distance, plus 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import gemm as jgemm
from repro.configs import get_config as jget_config
from repro.models.common import HOST_MESH as JHOST_MESH
from repro.models.common import split_params
from repro.models.model import LM as JLM
from repro_torch import gemm
from repro_torch.configs import get_config
from repro_torch.gemm import autograd as GA
from repro_torch.interop import _flatten, _unstack, load_jax_params
from repro_torch.models.common import HOST_MESH
from repro_torch.models.model import LM

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _t(x, dt):
    return torch.from_numpy(x).to(getattr(torch, dt)).requires_grad_()


def _close(got, want, dt):
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), **TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("xs,n", [((64, 96), 80), ((2, 9, 40), 24),
                                  ((33, 17), 5)])
def test_matmul_gradients_match_jax_vjp(xs, n, dt):
    k = xs[-1]
    xn, wn, gn = _np(xs, 1), _np((k, n), 2, k ** -0.5), _np(xs[:-1] + (n,), 3)
    out, vjp = jax.vjp(jgemm.matmul, jnp.asarray(xn, dt), jnp.asarray(wn, dt))
    dx, dw = vjp(jnp.asarray(gn, dt))
    x, w = _t(xn, dt), _t(wn, dt)
    y = gemm.matmul(x, w)
    gx, gw = torch.autograd.grad(y, (x, w), torch.from_numpy(gn).to(y.dtype))
    _close(y, out, dt)
    assert gx.dtype == x.dtype and gw.dtype == w.dtype
    _close(gx, dx, dt)
    _close(gw, dw, dt)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_grouped_matmul_gradients_match_jax_vjp(lead, dt):
    e, c, d, f = 4, 24, 48, 40
    xn = _np(lead + (e, c, d), 4)
    wn, gn = _np((e, d, f), 5, d ** -0.5), _np(lead + (e, c, f), 6)
    out, vjp = jax.vjp(jgemm.grouped_matmul, jnp.asarray(xn, dt),
                       jnp.asarray(wn, dt))
    dx, dw = vjp(jnp.asarray(gn, dt))
    x, w = _t(xn, dt), _t(wn, dt)
    y = gemm.grouped_matmul(x, w)
    gx, gw = torch.autograd.grad(y, (x, w), torch.from_numpy(gn).to(y.dtype))
    _close(y, out, dt)
    _close(gx, dx, dt)
    _close(gw, dw, dt)


def _spy_products(monkeypatch):
    """Records every ``GA.product`` call: (A's shape, B's shape, backend,
    A's and B's storage, A's and B's strides)."""
    seen = []
    real = GA.product

    def spy(a, b, backend):
        seen.append((tuple(a.shape), tuple(b.shape), backend, a.data_ptr(),
                     b.data_ptr(), a.stride(), b.stride()))
        return real(a, b, backend)

    monkeypatch.setattr(GA, "product", spy)
    return seen


def test_backward_products_are_planned_and_copies_counted(monkeypatch):
    """dA = dC·Bᵀ and dB = Aᵀ·dC each go through ``gemm.plan`` on their own
    shape (on the forward's backend), on views of the saved operands: no
    copy is made.  A transposed B (the tied head's ``table.t()``) gives dA
    on the table as stored and dB = (dCᵀ·A)ᵀ, contiguous where the table
    is."""
    seen = _spy_products(monkeypatch)
    x = torch.randn(6, 8, requires_grad=True)
    w = torch.randn(8, 5, requires_grad=True)
    gemm.matmul(x, w, backend="reference").sum().backward()
    assert [s[:3] for s in seen] == [((6, 8), (8, 5), "reference"),
                                     ((6, 5), (5, 8), "reference"),
                                     ((8, 6), (6, 5), "reference")]
    assert seen[1][4] == w.data_ptr() and seen[1][6] == (1, 5)      # w.t()
    assert seen[2][3] == x.data_ptr() and seen[2][5] == (1, 8)      # x.t()
    seen.clear()
    x.grad = None
    table = torch.randn(5, 8, requires_grad=True)
    gemm.matmul(x, table.t()).sum().backward()
    assert [s[:2] for s in seen] == [((6, 8), (8, 5)), ((6, 5), (5, 8)),
                                     ((5, 6), (6, 8))]
    assert seen[0][4] == table.data_ptr() and seen[0][6] == (1, 8)
    assert seen[1][4] == table.data_ptr() and seen[1][6] == (8, 1)
    assert seen[2][5] == (1, 5) and seen[2][4] == x.data_ptr()
    torch.testing.assert_close(x.grad, torch.ones(6, 5) @ table.detach())
    torch.testing.assert_close(table.grad, torch.ones(5, 6) @ x.detach())
    assert table.grad.is_contiguous()


def test_tied_head_gradient_flows_to_the_table_without_a_copy_for_dx(
        monkeypatch):
    """The head is the table's ``.t()`` (a view): the forward and dX read
    the table as stored, dTable reads the activations as stored, and no
    product receives a copy of either."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    assert cfg.tie_embeddings
    from repro_torch.models import layers
    seen = _spy_products(monkeypatch)
    table = torch.randn(cfg.padded_vocab, cfg.d_model, requires_grad=True)
    x = torch.randn(2, 3, cfg.d_model, requires_grad=True)
    head = layers.head_matrix({"table": table}, cfg)
    assert head.data_ptr() == table.data_ptr() and head.t().is_contiguous()
    logits = layers.logits_head({"table": table}, x, cfg)
    (logits.square().sum()).backward()
    assert len(seen) == 3
    assert seen[0][4] == seen[1][4] == table.data_ptr()   # forward, dX
    assert seen[2][4] == x.data_ptr()                     # dTable
    x2 = x.detach().requires_grad_()
    t2 = table.detach().requires_grad_()
    (x2 @ t2.t()).square().sum().backward()
    torch.testing.assert_close(x.grad, x2.grad, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(table.grad, t2.grad, rtol=1e-5, atol=1e-4)


def test_serving_calls_record_nothing():
    """Frozen parameters (serving) take the direct path: no autograd
    Function, no graph."""
    x, w = torch.randn(4, 8), torch.randn(8, 3)
    assert gemm.matmul(x, w).grad_fn is None
    assert gemm.grouped_matmul(torch.randn(2, 4, 8),
                               torch.randn(2, 8, 3)).grad_fn is None
    y = gemm.matmul(x.requires_grad_(), w)
    assert type(y.grad_fn).__name__ == "PlannedMatmulBackward"


def test_int8_products_have_no_backward():
    class Ctx:
        saved_tensors = (torch.zeros(2, 2, dtype=torch.int8),
                         torch.zeros(2, 2, dtype=torch.int8))
        needs_input_grad = (True, True, False, False)
        backend = "cuda"

    with pytest.raises(TypeError, match="floating point"):
        GA.PlannedMatmul.backward(Ctx, torch.zeros(2, 2, dtype=torch.int32))


# ---------------------------------------------------------------------------
# LM.loss_fn against jax.value_and_grad
# ---------------------------------------------------------------------------


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32",
                               kv_cache_dtype="float32")


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "audio_stub":
        out["frames"] = _np((b, s, cfg.d_model), seed + 1, 0.02)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    if cfg.frontend == "vision_stub":
        out["patches"] = _np((b, cfg.num_prefix_tokens, cfg.d_model),
                             seed + 2, 0.02)
    return out


def _carried(arch, seed=0):
    jlm = JLM(_f32(jget_config(arch, smoke=True)), JHOST_MESH)
    jvalues, _ = split_params(jlm.init(jax.random.key(seed)))
    lm = LM(_f32(get_config(arch, smoke=True)), HOST_MESH, device="cpu")
    values = load_jax_params(lm, jax.tree.map(np.array, jvalues))
    return lm.train_mode(), values, jlm, jvalues


def _grads(lm, values, batch, remat="block"):
    loss, metrics = lm.loss_fn(values, {k: torch.from_numpy(v)
                                        for k, v in batch.items()},
                               remat=remat)
    leaves = _flatten(values)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    return loss, metrics, dict(zip(leaves, grads))


#: per arch: None holds each element at rtol 1e-4 / atol 1e-6, a number
#: bounds each leaf's relative L2 (module docstring)
GRAD_BOUND = {"qwen2-1.5b": None, "granite-moe-3b-a800m": None,
              "xlstm-125m": 1e-5, "zamba2-1.2b": 1e-4}


@pytest.mark.parametrize("arch", sorted(GRAD_BOUND))
def test_loss_fn_and_gradients_match_jax_value_and_grad(arch):
    lm, values, jlm, jvalues = _carried(arch)
    batch = _batch(lm.cfg, 2, 16, 7)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda v: jlm.loss_fn(v, {k: jnp.asarray(x)
                                  for k, x in batch.items()}),
        has_aux=True))(jvalues)
    loss, metrics, grads = _grads(lm, values, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    aux = torch.as_tensor(metrics["aux_loss"]).detach()
    np.testing.assert_allclose(float(aux), float(jmetrics["aux_loss"]),
                               rtol=1e-5, atol=1e-7)
    want = _unstack(jax.tree.map(np.array, jgrads))
    assert set(want) == set(grads)
    bound = GRAD_BOUND[arch]
    for path, g in grads.items():
        got, ref = g.numpy(), want[path]
        if bound is None:
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6,
                                       err_msg=str(path))
        else:
            rel = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
            assert rel <= bound, (path, rel)


def test_zamba2_gradients_are_as_close_to_float64_as_the_jax_packages():
    """The JAX package's zamba2 smoke model run in float64 (every dtype of
    its config, under ``jax.enable_x64``) on the carried weights and batch
    is the yardstick: each leaf of the port's f32 gradient lies at most
    twice as far from it (relative L2) as the JAX package's f32 gradient,
    plus 1e-6."""
    arch = "zamba2-1.2b"
    lm, values, jlm, jvalues = _carried(arch)
    batch = _batch(lm.cfg, 2, 16, 7)

    def jax_grads(model, params):
        _, g = jax.jit(jax.value_and_grad(
            lambda v: model.loss_fn(v, {k: jnp.asarray(x)
                                        for k, x in batch.items()}),
            has_aux=True))(params)
        return _unstack(jax.tree.map(np.array, g))

    want32 = jax_grads(jlm, jvalues)
    with jax.enable_x64(True):
        cfg64 = dataclasses.replace(jget_config(arch, smoke=True),
                                    param_dtype="float64",
                                    compute_dtype="float64",
                                    kv_cache_dtype="float64")
        want64 = jax_grads(JLM(cfg64, JHOST_MESH), jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), jvalues))
    _, _, grads = _grads(lm, values, batch)
    assert set(grads) == set(want64)
    for path, g in grads.items():
        ref = want64[path]
        assert ref.dtype == np.float64, path
        norm = max(np.linalg.norm(ref), 1e-30)
        port = np.linalg.norm(g.numpy().astype(np.float64) - ref) / norm
        jax_ = np.linalg.norm(want32[path].astype(np.float64) - ref) / norm
        assert port <= 2 * jax_ + 1e-6, (path, port, jax_)


def _record_backward(monkeypatch):
    """Wraps both Functions' ``backward`` and the products they call:
    records each backward product as (kind, A, B, the storage of the
    backward's saved operands)."""
    rec = {"products": [], "saved": None}

    class Ctx:
        """The backward's ctx, noting the saved operands' storage when the
        backward unpacks them (once: a remat block's recompute runs then,
        before anything is noted, and is not recorded)."""

        def __init__(self, ctx):
            self._ctx = ctx

        def __getattr__(self, name):
            return getattr(self._ctx, name)

        @property
        def saved_tensors(self):
            ts = self._ctx.saved_tensors
            rec["saved"] = {t.data_ptr() for t in ts}
            return ts

    for fn, name in ((GA.PlannedMatmul, "product"),
                     (GA.GroupedMatmul, "grouped_product")):
        def backward(ctx, grad, _real=fn.backward):
            try:
                return _real(Ctx(ctx), grad)
            finally:
                rec["saved"] = None

        def spy(a, b, *rest, _real=getattr(GA, name), _name=name):
            if rec["saved"] is not None:
                rec["products"].append((_name, a, b, rec["saved"]))
            return _real(a, b, *rest)
        monkeypatch.setattr(fn, "backward", staticmethod(backward))
        monkeypatch.setattr(GA, name, spy)
    return rec


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-3b-a800m"])
def test_a_loss_fn_step_makes_no_transposed_copy(arch, dt, monkeypatch):
    """Every backward product of a smoke ``loss_fn`` step reads one of the
    backward's saved operands in place, a view sharing its storage, beside
    the incoming gradient; and every one has a transposed operand (``b.t()``,
    ``a.t()``, ``w.transpose(1, 2)``, ``x.transpose(1, 2)``, the tied
    head's ``dlogits.t()``) but the tied head's dX, which reads the table
    as stored."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype=dt)
    lm = LM(cfg, HOST_MESH, device="cpu")
    values = lm.init(torch.Generator().manual_seed(3))
    lm.train_mode()
    rec = _record_backward(monkeypatch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 8, 5).items()}
    loss, _ = lm.loss_fn(values, batch)
    torch.autograd.grad(loss, list(_flatten(values).values()),
                        allow_unused=True)
    kinds = {"product": 0, "grouped_product": 0}
    row_major = 0
    for kind, a, b, saved in rec["products"]:
        kinds[kind] += 1
        assert a.data_ptr() in saved or b.data_ptr() in saved, (
            kind, a.shape, b.shape)
        row_major += not any(GA.stored_transposed(t) for t in (a, b))
        assert a.dtype == b.dtype == getattr(torch, dt)
    assert kinds["product"] > 0
    assert (kinds["grouped_product"] > 0) == (arch != "qwen2-1.5b")
    assert row_major == int(cfg.tie_embeddings)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-3b-a800m"])
def test_remat_policies_give_the_same_gradients(arch, monkeypatch):
    """"block" recomputes every product, "dots" keeps the GEMM and grouped
    outputs (no product launched twice), "none" keeps everything: the
    gradients are the same, bit for bit."""
    lm, values, _, _ = _carried(arch)
    batch = _batch(lm.cfg, 2, 8, 3)
    calls = {"n": 0}
    for name in ("product", "grouped_product"):
        real = getattr(GA, name)

        def counting(*a, _real=real):
            calls["n"] += 1
            return _real(*a)
        monkeypatch.setattr(GA, name, counting)
    out = {}
    for remat in ("none", "block", "dots"):
        calls["n"] = 0
        loss, _, grads = _grads(lm, values, batch, remat)
        out[remat] = (loss.item(), grads, calls["n"])
    assert out["block"][2] > out["dots"][2] == out["none"][2]
    for remat in ("block", "dots"):
        assert out[remat][0] == out["none"][0]
        for path, g in out["none"][1].items():
            assert torch.equal(g, out[remat][1][path]), (remat, path)


def test_train_mode_makes_parameters_trainable_and_serving_keeps_them_frozen():
    lm = LM(get_config("qwen2-1.5b", smoke=True), device="cpu")
    lm.init(torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in lm.parameters())
    assert lm.train_mode() is lm
    assert all(p.requires_grad for p in lm.parameters())
    lm.train_mode(False)
    assert not any(p.requires_grad for p in lm.parameters())


def test_compute_params_stays_differentiable_and_rebuilds_the_tied_head():
    lm = LM(_f32(get_config("qwen2-1.5b", smoke=True)), device="cpu")
    values = lm.init(torch.Generator().manual_seed(1))
    lm.train_mode()
    cp = lm.compute_params(values)
    assert cp["embed"]["head"].grad_fn is not None
    cp["embed"]["head"].sum().backward()
    assert torch.equal(values["embed"]["table"].grad,
                       torch.ones_like(values["embed"]["table"]))
