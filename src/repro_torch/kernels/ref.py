"""Plain PyTorch oracles for the GEMM kernels (the allclose ground truth).

The same functions as ``repro.kernels.ref.gemm_ref`` /
``gemm_ref_streamed`` / ``grouped_gemm_ref``: int8 operands accumulate
exactly in int32 (computed in float64, which is exact while every partial
sum stays below 2**53, and ``torch.matmul`` takes no integer tensors on
CUDA), floating operands accumulate in float32 and round once to the input
dtype.
"""
from __future__ import annotations

import torch


def _is_int(t) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulator dtype of a GEMM on ``dtype`` operands."""
    return torch.int32 if not dtype.is_floating_point else torch.float32


def dot(a, b):
    """``a @ b`` accumulated in the accumulator dtype (int32 or float32)."""
    if _is_int(a):
        return (a.double() @ b.double()).to(torch.int32)
    return a.float() @ b.float()


def gemm_ref(a, b, c=None):
    out = dot(a, b)
    out = out if _is_int(a) else out.to(a.dtype)
    return out if c is None else c + out


def gemm_ref_streamed(a, b, c, bk: int):
    """Oracle for the C-streamed (k-outer) variant: C is rounded to its
    storage dtype after every k-block pass — the exact function
    ``gemm_k_outer`` computes (and the numerical price of the paper's
    C3B2A0/B3C2A0 loop orders on reduced-precision storage)."""
    k = a.shape[1]
    acc = acc_dtype(a.dtype)
    for kk in range(0, k, bk):
        part = dot(a[:, kk:kk + bk], b[kk:kk + bk])
        c = (c.to(acc) + part).to(c.dtype)
    return c


def grouped_gemm_ref(x, w):
    """x: (E, C, D); w: (E, D, F) -> (E, C, F), summed in float32 and
    rounded once to ``x.dtype``."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
