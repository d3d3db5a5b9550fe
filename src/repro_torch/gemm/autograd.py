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

The kernels take row-major operands only, so each transposed operand is a
row-major copy (:func:`transposed`, counted in ``COPIES``).  A caller that
already holds ``Bᵀ`` row-major passes it as ``b_t`` and ``dA`` needs no
copy: the tied logits head multiplies by ``table.t()`` and passes the
table.  CPU tensors run the kernels' plain versions inside the same
``forward`` / ``backward``, so the CPU tests check the backward formula the
card runs.  An int8 product has no backward: the models never train in
int8.

Remat's ``"dots"`` policy keeps these products' outputs and recomputes the
rest: :func:`dots_context` is the ``context_fn`` of
``torch.utils.checkpoint``; under it the first forward records each
Function's output in order and the recompute hands them back instead of
launching again.
"""
from __future__ import annotations

import torch

#: row-major copies of transposed operands made for backward products
COPIES = {"transposed": 0}

#: the active "dots" recording or replay, innermost last
_DOTS: list["_Dots"] = []


def reset_copy_counts() -> None:
    COPIES["transposed"] = 0


def transposed(t):
    """The row-major copy of ``t`` with its last two axes swapped."""
    COPIES["transposed"] += 1
    return t.transpose(-2, -1).contiguous()


def wanted(*ts) -> bool:
    """Whether a product of ``ts`` must be recorded for autograd."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def product(a, b, backend: str):
    """``a @ b`` (2-D, row-major) planned on its own shape and executed on
    ``backend``."""
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
    """``a (m, k) @ b (k, n)`` on ``backend``; ``b_t``, when given, is
    ``b.t()`` row-major (used for ``dA`` only, never differentiated);
    ``out``, when given, is the already computed product (a ``"dots"``
    recompute)."""

    @staticmethod
    def forward(ctx, a, b, b_t, backend, out):
        ctx.backend = backend
        ctx.save_for_backward(a, b, b_t)
        return product(a, b, backend) if out is None else out

    @staticmethod
    def backward(ctx, dc):
        a, b, b_t = ctx.saved_tensors
        _no_int8(a, "gemm.matmul")
        dc = dc.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = product(dc, transposed(b) if b_t is None else b_t,
                         ctx.backend)
        if ctx.needs_input_grad[1]:
            db = product(transposed(a), dc, ctx.backend)
        return da, db, None, None, None


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
            dx = grouped_product(dy, transposed(w))
        if ctx.needs_input_grad[1]:
            dw = grouped_product(transposed(x), dy)
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


def planned_matmul(a, b, backend: str, b_t=None):
    """The differentiable ``a @ b`` (2-D) on ``backend``."""
    return _apply(PlannedMatmul, a, b, b_t, backend)


def grouped_matmul(x, w):
    """The differentiable grouped product (3-D)."""
    return _apply(GroupedMatmul, x, w)
