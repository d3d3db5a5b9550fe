"""Autograd for the planned GEMM and the grouped GEMM.

The CUDA kernels are ``ctypes`` launches that autograd cannot see through,
so the two products every model trains through are
``torch.autograd.Function``s whose backward products run on the same
kernels:

* :class:`PlannedMatmul` (``gemm.matmul``): forward ``C = A·B`` planned on
  its shape and executed on its backend, as before; backward
  ``dA = dC·Bᵀ`` and ``dB = Aᵀ·dC``, each planned with ``gemm.plan`` on
  its own shape and executed on the same backend, so the backward products
  get the paper's tile selection too.
* :class:`GroupedMatmul` (``gemm.grouped_matmul``): forward
  ``y[e] = x[e]·w[e]``; backward ``dx[e] = dy[e]·w[e]ᵀ`` and
  ``dw[e] = x[e]ᵀ·dy[e]``, both through the grouped kernel.

The transposed operands are views of the saved tensors (``b.t()``,
``a.t()``, ``w.transpose(1, 2)``, ``x.transpose(1, 2)``), never copies:
the bf16 kernels read them in place (wgmma's transposed layouts,
``kernels.gemm.wgmma_layout``), and the f32 CUDA-core route copies one
inside its wrapper (counted in ``kernels.gemm.COPIES``).  When the
forward's B (w) is itself a transposed view, as the tied logits head's
``table.t()`` is, ``dB`` is computed in B's storage layout, ``(dCᵀ·A)ᵀ``,
so that the gradient comes out contiguous where the parameter is.  CPU
tensors run the kernels' plain versions on the same views inside the same
``forward`` / ``backward``, so the CPU tests check the backward formula
the card runs.  An int8 product has no backward: the models never train
in int8.

Remat's ``"dots"`` policy keeps these products' outputs and recomputes the
rest: :func:`dots_context` is the ``context_fn`` of
``torch.utils.checkpoint``; under it the first forward records each
Function's output in order and the recompute hands them back instead of
launching again.
"""
from __future__ import annotations

import torch

#: the active "dots" recording or replay, innermost last
_DOTS: list["_Dots"] = []


def stored_transposed(t) -> bool:
    """Whether ``t`` is the transpose of a row-major tensor (its last two
    axes swapped: unit stride on the second last), not row-major itself."""
    return t.stride(-1) != 1 and t.stride(-2) == 1 and t.shape[-1] > 1


def wanted(*ts) -> bool:
    """Whether a product of ``ts`` must be recorded for autograd."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def product(a, b, backend: str):
    """``a @ b`` (2-D, each row-major or the ``.t()`` of a row-major
    matrix) planned on its own shape and executed on ``backend``."""
    from repro_torch.gemm.backends import dtype_tag
    from repro_torch.gemm.planner import plan

    m, k = a.shape
    return plan((m, b.shape[1], k), backend=backend,
                dtype=dtype_tag(a.dtype)).execute(a, b)


def grouped_product(x, w):
    """``x[e] @ w[e]`` for every expert, through the grouped kernel."""
    from repro_torch.kernels import ops

    return ops.grouped_gemm(x, w)


def _no_int8(t, what: str) -> None:
    if not t.is_floating_point():
        raise TypeError(f"{what} has no backward for {t.dtype} operands: "
                        f"the models train in floating point only")


class PlannedMatmul(torch.autograd.Function):
    """``a (m, k) @ b (k, n)`` on ``backend``; ``out``, when given, is the
    already computed product (a ``"dots"`` recompute)."""

    @staticmethod
    def forward(ctx, a, b, backend, out):
        ctx.backend = backend
        ctx.save_for_backward(a, b)
        return product(a, b, backend) if out is None else out

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        _no_int8(a, "gemm.matmul")
        dc = dc.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = product(dc, b.t(), ctx.backend)
        if ctx.needs_input_grad[1]:
            db = (product(dc.t(), a, ctx.backend).t()
                  if stored_transposed(b) else product(a.t(), dc,
                                                       ctx.backend))
        return da, db, None, None


class GroupedMatmul(torch.autograd.Function):
    """``x (E, C, D) @ w (E, D, F)`` through the grouped kernel; ``out`` as
    in :class:`PlannedMatmul`."""

    @staticmethod
    def forward(ctx, x, w, out):
        ctx.save_for_backward(x, w)
        return grouped_product(x, w) if out is None else out

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        _no_int8(x, "gemm.grouped_matmul")
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grouped_product(dy, w.transpose(1, 2))
        if ctx.needs_input_grad[1]:
            dw = (grouped_product(dy.transpose(1, 2), x).transpose(1, 2)
                  if stored_transposed(w) else
                  grouped_product(x.transpose(1, 2), dy))
        return dx, dw, None


class _Dots:
    """One period's ``"dots"`` context: records outputs in the forward,
    hands them back in order in the recompute."""

    def __init__(self, kept: list, replay: bool):
        self.kept, self.replay = kept, replay

    def __enter__(self):
        _DOTS.append(self)
        return self

    def __exit__(self, *exc):
        _DOTS.remove(self)
        return False


def dots_context():
    """``context_fn`` for ``torch.utils.checkpoint``: (the forward's
    recording context, the recompute's replaying one)."""
    kept: list = []
    return _Dots(kept, replay=False), _Dots(kept, replay=True)


def _apply(fn, *args):
    dots = _DOTS[-1] if _DOTS else None
    if dots is not None and dots.replay:
        return fn.apply(*args, dots.kept.pop(0))
    out = fn.apply(*args, None)
    if dots is not None:
        dots.kept.append(out.detach())
    return out


def planned_matmul(a, b, backend: str):
    """The differentiable ``a @ b`` (2-D) on ``backend``."""
    return _apply(PlannedMatmul, a, b, backend)


def grouped_matmul(x, w):
    """The differentiable grouped product (3-D)."""
    return _apply(GroupedMatmul, x, w)
