"""The plain reference of a GEMM pass's products, and its control.

Plain PyTorch, importing nothing of the program.  A bf16 product is
computed in float32 with TF32 off from the same bf16 operands; an int8
product exactly, in float64 (every partial sum of int8 products over
K <= 2**37 / 127**2 terms is an integer below 2**53, so float64 gives what
int64 gives, on a device that multiplies float64 matrices).  Large outputs
are computed in blocks of columns.

The control is the reference put in the program's place one precision
lower: bf16 operands rounded to float8 e4m3 (one scale a tensor, amax to
448, products summed in float32, rounded to bf16), int8 operands rounded to
int4 (one scale of 16: each value to the nearest multiple of 16 in
[-128, 112], summed exactly).
"""
from __future__ import annotations

import contextlib
import math

import torch

#: output columns a reference block computes at most
BLOCK_ELEMS = 1 << 28
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """float32 products in float32 (TF32 off) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _mm(a, b):
    """``a @ b`` for (m, k) @ (k, n) or (g, m, k) @ (g, k, n)."""
    return torch.bmm(a, b) if a.ndim == 3 else a @ b


def _blocks(n: int, m: int):
    step = max(1, BLOCK_ELEMS // max(1, m))
    for j in range(0, n, step):
        yield j, min(n, j + step)


def product(a, b, dtype: str, j0: int, j1: int):
    """The reference of columns ``[j0, j1)`` of ``a @ b``: float32 for
    bf16 operands, float64 (exact) for int8."""
    hi = torch.float64 if dtype == "int8" else torch.float32
    with exact_f32():
        return _mm(a.to(hi), b[..., j0:j1].to(hi))


def _fp8(t):
    """``t`` rounded to float8 e4m3 at one scale a tensor, back in f32."""
    f = t.float()
    scale = f.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (f / scale).to(torch.float8_e4m3fn).float() * scale


def _int4(t):
    """int8 ``t`` at int4's 16 levels a sign (scale 16), as float64."""
    return ((t.double() / 16).round().clamp(-8, 7)) * 16


def control(a, b, dtype: str, j0: int, j1: int):
    """The control's columns ``[j0, j1)``, in the program's output dtype."""
    with exact_f32():
        if dtype == "int8":
            return _mm(_int4(a), _int4(b[..., j0:j1])).to(torch.int32)
        return _mm(_fp8(a), _fp8(b[..., j0:j1])).to(torch.bfloat16)


def compare(out, a, b, dtype: str) -> dict:
    """The numbers of one product's output against the reference:
    ``mismatches`` (int8: elements that differ), else ``rel_l2`` (the
    distance over the reference's norm) and ``max_err`` (the largest
    distance of one element over the reference's root mean square); an
    output that holds a NaN reads ``inf`` in both."""
    n, m = b.shape[-1], out.numel() // b.shape[-1]
    mism, d2, r2, dmax = 0, 0.0, 0.0, 0.0
    for j0, j1 in _blocks(n, m):
        ref = product(a, b, dtype, j0, j1)
        got = out[..., j0:j1].to(ref.dtype)
        if dtype == "int8":
            mism += int((got != ref).sum())
            continue
        diff = got - ref
        d2 += float(diff.double().square().sum())
        r2 += float(ref.double().square().sum())
        # torch's max keeps a NaN; Python's would drop one that comes second
        dmax = float(torch.tensor([dmax, float(diff.abs().max())]).max())
        del ref, got, diff
    if dtype == "int8":
        return {"mismatches": float(mism)}
    rms = (r2 / out.numel()) ** 0.5
    nums = {"rel_l2": (d2 / r2) ** 0.5 if r2 else math.inf,
            "max_err": dmax / rms if rms else math.inf}
    # an output that holds a NaN is as far off as can be
    return {k: math.inf if math.isnan(v) else v for k, v in nums.items()}


def control_output(a, b, dtype: str):
    """The whole control product (for the calibration and its test)."""
    n, m = b.shape[-1], a.numel() // a.shape[-1]
    return torch.cat([control(a, b, dtype, j0, j1)
                      for j0, j1 in _blocks(n, m)], dim=-1)
